"""PCFICH: control format indicator channel, TS 36.211 §6.7 / 36.212 §5.3.4.

Port counterpart of ``srsran_4g_tpu/models/pcfich.py`` (the reference's
`lib/src/phy/phch/pcfich.c`).  The CFI value (1..3) selects one of three
fixed 32-bit codewords; after cell/subframe scrambling and QPSK it occupies
4 REGs (16 REs) of symbol 0 at cell-id-derived positions.  Decoding is a
correlation against the three candidate codewords (soft max-likelihood, as
pcfich.c:cfi_decode).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srsran_4g_tpu_torch.models import equalizer, mimo
from srsran_4g_tpu_torch.models import grid as G
from srsran_4g_tpu_torch.ops import modem, scrambling
from srsran_4g_tpu_torch.ops.sequence import gold_sequence_np
from srsran_4g_tpu_torch.utils import constants as C

# TS 36.212 Table 5.3.4-1
_CFI_CODEWORDS = np.array(
    [
        [0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0,
         1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1],
        [1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1,
         0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0],
        [1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1,
         1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1],
    ],
    dtype=np.int8,
)


@functools.lru_cache(maxsize=64)
def pcfich_re_indices(cell: G.CellConfig) -> np.ndarray:
    """Flat indices of the 16 PCFICH REs (4 REGs in symbol 0)."""
    nrb = cell.nof_prb
    vshift = cell.cell_id % 6
    k_bar = (C.NRE // 2) * (cell.cell_id % (2 * nrb))
    crs_mod3 = vshift % 3
    out = []
    for i in range(4):
        k0 = (k_bar + (i * nrb // 2) * (C.NRE // 2)) % (nrb * C.NRE)
        # REG = the 4 non-CRS REs among 6 consecutive subcarriers
        ks = k0 + np.arange(6)
        out.append(ks[(ks % 3) != crs_mod3][:4])  # symbol 0 → flat index == subcarrier
    return np.concatenate(out)


@functools.lru_cache(maxsize=64)
def _seq(cell: G.CellConfig, subframe: int) -> np.ndarray:
    return gold_sequence_np(scrambling.pcfich_cinit(subframe, cell.cell_id), 32)


def encode(cell: G.CellConfig, cfi: torch.Tensor, subframe: int) -> torch.Tensor:
    """cfi (B,) int ∈ {1,2,3} → 16 QPSK symbols (B, 16), on cfi's device."""
    dev = cfi.device
    cw = torch.as_tensor(_CFI_CODEWORDS, device=dev)[cfi.long() - 1]
    scr = scrambling.scramble_bits(cw, torch.as_tensor(_seq(cell, subframe), device=dev))
    return modem.modulate("qpsk", scr)


def put_into_grid(cell: G.CellConfig, grid_tx: torch.Tensor,
                  pcfich_syms: torch.Tensor) -> torch.Tensor:
    return mimo.scatter_ctrl_syms(grid_tx, pcfich_re_indices(cell), pcfich_syms)


def decode(cell: G.CellConfig, rx_grid: torch.Tensor, h: torch.Tensor, noise_var,
           subframe: int, h1: torch.Tensor | None = None) -> dict:
    """Soft CFI detection. Returns dict(cfi (B,), corr (B, 3)).

    With ``h1`` (port-1 estimates) the 16 REs are SFBC-combined pairwise
    (2-port TX diversity, as `pcfich.c` via predecoding_diversity)."""
    dev = rx_grid.device
    idx = torch.as_tensor(pcfich_re_indices(cell), device=dev)
    b = rx_grid.shape[0]
    y = rx_grid.reshape(b, -1)[:, idx]
    h_re = h.reshape(b, -1)[:, idx]
    if h1 is not None:
        x, eff_nv = equalizer.alamouti_decode_2x1(y, h_re, h1.reshape(b, -1)[:, idx],
                                                  noise_var)
    else:
        x, eff_nv = equalizer.equalize_single(y, h_re, noise_var)
    llr = modem.demodulate_soft("qpsk", x, eff_nv)
    llr = scrambling.descramble_llrs(llr, torch.as_tensor(_seq(cell, subframe), device=dev))
    # correlate: codeword bits ±1 vs LLR sign
    cw = torch.as_tensor(2.0 * _CFI_CODEWORDS - 1.0, dtype=torch.float32, device=dev)
    corr = torch.einsum("bn,cn->bc", llr, cw)
    cfi = torch.argmax(corr, dim=-1).to(torch.int32) + 1
    return dict(cfi=cfi, corr=corr)
