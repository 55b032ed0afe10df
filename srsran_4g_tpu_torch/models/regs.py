"""Control-region REG (resource element group) mapping, TS 36.211 §6.2.4.

Port counterpart of ``srsran_4g_tpu/models/regs.py`` (the reference's
`lib/src/phy/phch/regs.c`): enumerates the REGs of the PDCCH control region
(symbols 0..CFI-1), assigns the PCFICH and PHICH REGs, and gives the
remaining REGs in the (k, l) order of the PDCCH quadruplet mapping.  Host
index tables only (numpy).
"""

from __future__ import annotations

import functools

import numpy as np

from srsran_4g_tpu_torch.models import grid as G
from srsran_4g_tpu_torch.models.pcfich import pcfich_re_indices
from srsran_4g_tpu_torch.utils import constants as C


@functools.lru_cache(maxsize=64)
def regs_in_symbol(cell: G.CellConfig, l: int) -> np.ndarray:
    """(n_regs, 4) subcarrier indices of the REGs in control symbol l.

    Symbol 0 always has CRS (2 REGs/PRB of 4 REs among 6 SCs); symbol 1 has
    CRS only with 4 ports (else 3 REGs/PRB of 4 consecutive SCs); symbols
    2, 3 have no CRS in the control region.
    """
    has_crs = l == 0 or (l == 1 and cell.nof_ports == 4)
    crs_mod3 = (cell.cell_id % 6) % 3
    regs = []
    for prb in range(cell.nof_prb):
        if has_crs:
            for half in range(2):
                ks = prb * C.NRE + half * 6 + np.arange(6)
                regs.append(ks[(ks % 3) != crs_mod3][:4])
        else:
            for third in range(3):
                regs.append(prb * C.NRE + third * 4 + np.arange(4))
    return np.stack(regs)


@functools.lru_cache(maxsize=64)
def phich_reg_indices(cell: G.CellConfig, ng: float = 1.0) -> np.ndarray:
    """(n_groups, 3, 4) flat RE indices of the PHICH groups (normal
    duration, all in symbol 0), TS 36.211 §6.9.3."""
    n_groups = int(np.ceil(ng * cell.nof_prb / 8.0))
    sym0 = regs_in_symbol(cell, 0)
    pcfich_ks = set(pcfich_re_indices(cell).tolist())
    free = [i for i in range(sym0.shape[0]) if not (set(sym0[i].tolist()) & pcfich_ks)]
    n0 = len(free)
    out = np.zeros((n_groups, 3, 4), dtype=np.int64)
    used = set()
    for m in range(n_groups):
        for i in range(3):
            # normal PHICH duration: n_i = (N_ID + m' + floor(i·n0/3)) mod n0,
            # probing linearly on a collision (only tiny bandwidths have one)
            n_i = (cell.cell_id + m + (i * n0) // 3) % n0
            while n_i in used:
                n_i = (n_i + 1) % n0
            used.add(n_i)
            out[m, i] = sym0[free[n_i]]  # symbol 0: flat index == subcarrier
    return out


@functools.lru_cache(maxsize=64)
def pdcch_regs(cell: G.CellConfig, cfi: int, ng: float = 1.0) -> np.ndarray:
    """(n_pdcch_regs, 4) flat RE indices of the PDCCH REGs in (k, l) order
    (k first, then l — TS 36.211 §6.8.5)."""
    pcfich_ks = set(pcfich_re_indices(cell).tolist())
    phich_res = set(phich_reg_indices(cell, ng).reshape(-1).tolist())
    entries = []  # (k0 nominal, l, flat REs)
    # cells of 10 PRB or fewer signal CFI but use CFI+1 control symbols
    # (36.211 §6.7, reference regs.c nof_ctrl_symbols)
    nsyms = cfi + 1 if cell.nof_prb <= 10 else cfi
    for l in range(nsyms):
        regs = regs_in_symbol(cell, l)
        n_per_prb = regs.shape[0] // cell.nof_prb
        for j, r in enumerate(regs):
            flat = l * cell.nre + r
            if l == 0 and (set(r.tolist()) & pcfich_ks or set(flat.tolist()) & phich_res):
                continue
            # the nominal REG start (reference regs_reg_init k0 = j·12/n), not
            # the first non-CRS subcarrier: the (k, l) sort uses this
            prb, jj = divmod(j, n_per_prb)
            entries.append((prb * C.NRE + jj * (C.NRE // n_per_prb), l, flat))
    entries.sort(key=lambda e: (e[0], e[1]))
    return np.stack([e[2] for e in entries])


@functools.lru_cache(maxsize=64)
def pdcch_interleave_order(cell: G.CellConfig, cfi: int, ng: float = 1.0) -> np.ndarray:
    """Permutation π: quadruplet i of the PDCCH bit sequence lands on REG
    π(i) — the §6.8.5 sub-block interleaver (32 columns, RM_PERM_CC) then
    the cell-id cyclic shift."""
    n_regs = pdcch_regs(cell, cfi, ng).shape[0]
    rows = (n_regs + 31) // 32
    kp = rows * 32
    y = np.full(kp, -1, dtype=np.int64)
    y[kp - n_regs:] = np.arange(n_regs)
    v = y.reshape(rows, 32)[:, C.RM_PERM_CC].T.reshape(-1)
    w = v[v >= 0]  # w[p] = quadruplet index at interleaver position p
    # physical REG i (k, l order) carries z(i) = w((i + N_ID) mod M), so
    # quadruplet q lands on REG (w^-1(q) - N_ID) mod M (regs.c:114-127)
    pos = np.empty(n_regs, dtype=np.int64)
    pos[w] = np.arange(n_regs)
    return (pos - cell.cell_id) % n_regs


def n_pdcch_cces(cell: G.CellConfig, cfi: int, ng: float = 1.0) -> int:
    return pdcch_regs(cell, cfi, ng).shape[0] // 9
