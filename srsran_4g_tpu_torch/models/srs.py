"""SRS: sounding reference signal generation + eNB-side channel sounding.

Port counterpart of ``srsran_4g_tpu/models/srs.py`` (the SRS parts of the
reference's `lib/src/phy/ch_estimation/refsignal_ul.c`): comb-2 mapping in
the last SC-FDMA symbol, base sequences with cyclic shifts, and the wideband
channel estimate the eNB derives from them.  The sequence and subcarriers
are host tables, cached on the device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.models import grid as G
from srsran_4g_tpu_torch.models.refsignal_ul import base_sequence, group_hopping_pattern
from srsran_4g_tpu_torch.utils.constants import NRE

SRS_SYMBOL = 13  # last symbol of the subframe (normal CP)


@dataclass(frozen=True)
class SrsConfig:
    cell: G.CellConfig
    n_prb_srs: int = 16  # sounding bandwidth in PRB (multiple of 4)
    k_tc: int = 0  # transmission comb (0/1)
    cyclic_shift: int = 0  # 0..7
    prb_offset: int = 0


def srs_sequence(cfg: SrsConfig, subframe: int) -> np.ndarray:
    """SRS sequence (comb-2 → M_sc = n_prb_srs*12/2 values)."""
    m_sc = cfg.n_prb_srs * NRE // 2
    u = int(group_hopping_pattern(cfg.cell.cell_id)[2 * subframe])
    r = base_sequence(u, 0, m_sc)
    alpha = 2 * np.pi * cfg.cyclic_shift / 8.0
    return (r * np.exp(1j * alpha * np.arange(m_sc))).astype(np.complex64)


def srs_subcarriers(cfg: SrsConfig) -> np.ndarray:
    k0 = cfg.prb_offset * NRE + cfg.k_tc
    return k0 + 2 * np.arange(cfg.n_prb_srs * NRE // 2)


@functools.lru_cache(maxsize=64)
def _tables(cfg: SrsConfig, subframe: int, device: torch.device):
    return (torch.as_tensor(srs_sequence(cfg, subframe), device=device),
            torch.as_tensor(srs_subcarriers(cfg), device=device))


def put_srs(cfg: SrsConfig, grid_tx: torch.Tensor, subframe: int) -> torch.Tensor:
    """A copy of the grid (..., 14, nre) with the SRS in its last symbol, on
    the grid's device."""
    seq, ks = _tables(cfg, subframe, grid_tx.device)
    g = grid_tx.clone()
    g[..., SRS_SYMBOL, ks] = seq
    return g


def estimate_srs(cfg: SrsConfig, rx_grid: torch.Tensor, subframe: int) -> dict:
    """eNB sounding: LS estimate over the sounded band + wideband SNR."""
    seq, ks = _tables(cfg, subframe, rx_grid.device)
    h_ls = rx_grid[..., SRS_SYMBOL, ks] * seq.conj()
    # light smoothing for noise estimation
    hp = torch.cat([h_ls[..., :1], h_ls, h_ls[..., -1:]], dim=-1)  # edge padding
    h_sm = 0.25 * hp[..., :-2] + 0.5 * hp[..., 1:-1] + 0.25 * hp[..., 2:]
    nv = torch.mean((h_ls - h_sm).abs() ** 2, dim=-1) / 0.375
    snr_db = 10 * torch.log10(torch.clamp(torch.mean(h_sm.abs() ** 2, dim=-1), min=1e-12)
                              / torch.clamp(nv, min=1e-12))
    return dict(h=h_sm, noise_var=nv, snr_db=snr_db)
