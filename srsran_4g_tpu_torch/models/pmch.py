"""PMCH / MBSFN: multicast channel over extended-CP subframes (36.211 §6.5).

Port counterpart of ``srsran_4g_tpu/models/pmch.py`` (the reference's
`lib/src/phy/phch/pmch.c` and the MBSFN path of `lib/src/phy/dft/ofdm.c`):
MBSFN subframes use extended CP (12 symbols); the first 2 symbols carry the
(non-MBSFN) control region, the MBSFN region carries PMCH over every RE
except the MBSFN reference signals (port 4, symbols {2, 6, 10}, every 2nd
subcarrier, Gold-seeded by the MBSFN area id).  Transport coding is the
DL-SCH turbo chain (``sch.dlsch_encode``/``dlsch_decode``, so the decode
runs the turbo kernels) scrambled by the area id instead of an RNTI.

The RS and data RE indices are built once per config with numpy and kept on
the device with the scrambling sequence and the RS values.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.models import equalizer, sch
from srsran_4g_tpu_torch.models.pdsch import _on_device
from srsran_4g_tpu_torch.ops import modem, scrambling, sequence
from srsran_4g_tpu_torch.utils import constants as C

MBSFN_RS_SYMS = (2, 6, 10)   # extended-CP subframe symbols with MBSFN-RS
NSYMB_EXT = 12
CONTROL_SYMS = 2

BITS_PER_SYMBOL = {"qpsk": 2, "16qam": 4, "64qam": 6, "256qam": 8}


@dataclass(frozen=True)
class PmchConfig:
    nof_prb: int
    area_id: int
    subframe: int
    mod: str
    tbs: int

    @property
    def nre(self) -> int:
        return self.nof_prb * C.NRE

    @functools.cached_property
    def rs_indices(self) -> np.ndarray:
        """Flat (sym*nre + k) indices of MBSFN-RS REs (36.211 §6.10.2.2:
        symbols {2, 6, 10}, subcarrier offsets {0, 1, 0}, density 2)."""
        return np.concatenate([l * self.nre + np.arange(fidx, self.nre, 2)
                               for l, fidx in zip(MBSFN_RS_SYMS, (0, 1, 0))]).astype(np.int32)

    @functools.cached_property
    def data_indices(self) -> np.ndarray:
        """Every RE of the MBSFN region but the RS, in (symbol, subcarrier)
        order."""
        region = np.arange(CONTROL_SYMS * self.nre, NSYMB_EXT * self.nre)
        return np.setdiff1d(region, self.rs_indices).astype(np.int32)

    @property
    def nof_re(self) -> int:
        return int(self.data_indices.shape[0])

    @property
    def qm(self) -> int:
        return BITS_PER_SYMBOL[self.mod]

    @property
    def g_bits(self) -> int:
        return self.nof_re * self.qm

    @functools.cached_property
    def plan(self) -> sch.DlschPlan:
        return sch.dlsch_plan(self.tbs, self.g_bits, self.qm, 0)

    @functools.cached_property
    def scramble_seq(self) -> np.ndarray:
        # 36.211 §6.5.1: c_init = floor(ns/2)·2^9 + N_MBSFN_ID
        cinit = ((self.subframe << 9) + self.area_id) % (1 << 31)
        return sequence.gold_sequence_np(cinit, self.g_bits)


@functools.lru_cache(maxsize=64)
def mbsfn_rs(area_id: int, subframe: int, nre: int) -> np.ndarray:
    """MBSFN reference symbols for the 3 RS-bearing symbols {2, 6, 10}
    (36.211 §6.10.2.1): c_init = 512·(7·(ns'+1)+l'+1)·(2·N_id+1) + N_id with
    l' = l mod 6 and ns' = 2·sf for symbol 2, 2·sf+1 for symbols 6/10; 6
    pilots per PRB drawn from the centre of a virtual 110-PRB grid."""
    nof_prb = nre // C.NRE
    out = []
    for l, slot_add in zip(MBSFN_RS_SYMS, (0, 1, 1)):
        lp = l % 6
        slot = 2 * subframe + slot_add
        cinit = (512 * (7 * (slot + 1) + lp + 1) * (2 * area_id + 1)
                 + area_id) % (1 << 31)
        c = sequence.gold_sequence_np(cinit, 20 * C.MAX_PRB).astype(np.float32)
        m = np.arange(6 * nof_prb) + 3 * (C.MAX_PRB - nof_prb)
        r = ((1 - 2 * c[2 * m]) + 1j * (1 - 2 * c[2 * m + 1])) / np.sqrt(2)
        out.append(r)
    return np.concatenate(out).astype(np.complex64)


@functools.lru_cache(maxsize=64)
def _tables(cfg: PmchConfig, device: torch.device) -> dict[str, torch.Tensor]:
    return dict(rs_idx=torch.as_tensor(cfg.rs_indices, dtype=torch.int64, device=device),
                data_idx=torch.as_tensor(cfg.data_indices, dtype=torch.int64, device=device),
                k_of_re=torch.as_tensor(cfg.data_indices % cfg.nre, dtype=torch.int64,
                                        device=device),
                rs=torch.as_tensor(mbsfn_rs(cfg.area_id, cfg.subframe, cfg.nre)
                                   [:len(cfg.rs_indices)], device=device),
                seq=torch.as_tensor(cfg.scramble_seq, device=device))


def encode(cfg: PmchConfig, tb_bits: torch.Tensor | np.ndarray,
           device: torch.device | str | None = None) -> torch.Tensor:
    """(B, tbs) -> (B, 12, nre) extended-CP MBSFN subframe grid.  A tensor
    input stays on its device; other inputs go to ``device`` (default
    CUDA)."""
    bits = _on_device(tb_bits, device)
    tab = _tables(cfg, bits.device)
    b = bits.shape[0]
    cw = sch.dlsch_encode(cfg.plan, bits)
    syms = modem.modulate(cfg.mod, scrambling.scramble_bits(cw, tab["seq"]))
    flat = torch.zeros((b, NSYMB_EXT * cfg.nre), dtype=torch.complex64, device=bits.device)
    flat[:, tab["data_idx"]] = syms
    flat[:, tab["rs_idx"]] = tab["rs"]
    return flat.reshape(b, NSYMB_EXT, cfg.nre)


def decode(cfg: PmchConfig, rx_grid: torch.Tensor, n_iter: int = 4) -> dict:
    """UE-side PMCH receiver: MBSFN-RS LS chest + MMSE + turbo decode, on
    the grid's device."""
    tab = _tables(cfg, rx_grid.device)
    b = rx_grid.shape[0]
    flat = rx_grid.reshape(b, -1)
    h_ls = flat[:, tab["rs_idx"]] * tab["rs"].conj()
    # smooth across the (dense) RS grid; average over symbols
    h_avg = torch.mean(h_ls.reshape(b, len(MBSFN_RS_SYMS), -1), dim=1)
    hp = torch.cat([h_avg[:, :1], h_avg, h_avg[:, -1:]], dim=-1)  # edge padding
    h_sm = 0.25 * hp[:, :-2] + 0.5 * hp[:, 1:-1] + 0.25 * hp[:, 2:]
    nv = torch.mean((h_avg - h_sm).abs() ** 2, dim=-1) / 0.375 + 1e-9
    # interpolate comb-2 -> full band (nearest via repeat)
    h_full = torch.repeat_interleave(h_sm, 2, dim=-1)[:, :cfg.nre]
    x, eff_nv = equalizer.equalize_single(flat[:, tab["data_idx"]], h_full[:, tab["k_of_re"]],
                                          nv[:, None])
    llr = modem.demodulate_soft(cfg.mod, x, eff_nv).reshape(b, cfg.g_bits)
    llr = scrambling.descramble_llrs(llr, tab["seq"])
    bits, ok, _ = sch.dlsch_decode(cfg.plan, llr, n_iter=n_iter)
    return dict(bits=bits, crc_ok=ok, noise_var=nv)
