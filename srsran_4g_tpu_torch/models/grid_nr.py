"""NR carrier/slot grid and DMRS generation (TS 38.211).

Port counterpart of ``srsran_4g_tpu/models/grid_nr.py``: numerology/slot
math, the type-1 DMRS comb mapping for PDSCH/PUSCH mapping type A, and the
per-symbol Gold sequence seeds.  One slot = 14 OFDM symbols (normal CP);
the compute grid is (batch, 14, 12*N_RB) complex64, batched over slots.
Sequences and RE indices are host numpy, cached; the DMRS goes onto the
device once per (carrier, slot, symbols, device).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.ops import sequence

NRE = 12
NSYMB = 14


@dataclass(frozen=True)
class NrCarrierConfig:
    nof_prb: int = 52           # e.g. 10 MHz at 15 kHz SCS
    pci: int = 1                # physical cell id (0..1007)
    scs_khz: int = 15           # 15/30/60/120 (mu = log2(scs/15))
    cp: str = "normal"

    @property
    def mu(self) -> int:
        return {15: 0, 30: 1, 60: 2, 120: 3}[self.scs_khz]

    @property
    def nre(self) -> int:
        return self.nof_prb * NRE

    @property
    def slots_per_frame(self) -> int:
        return 10 << self.mu

    @property
    def symbol_sz(self) -> int:
        n = 128
        while n < self.nre:
            n *= 2
        return n


def dmrs_cinit(slot: int, symbol: int, n_id: int, n_scid: int = 0) -> int:
    """38.211 7.4.1.1.1 c_init for PDSCH/PUSCH DMRS."""
    return ((1 << 17) * (NSYMB * slot + symbol + 1) * (2 * n_id + 1)
            + 2 * n_id + n_scid) % (1 << 31)


@functools.lru_cache(maxsize=512)
def dmrs_symbols_type1(nof_prb: int, slot: int, symbol: int, n_id: int) -> np.ndarray:
    """Type-1 DMRS QPSK sequence for one symbol over nof_prb PRBs
    (comb-2: 6 RE per PRB)."""
    m = 6 * nof_prb
    c = sequence.gold_sequence_np(dmrs_cinit(slot, symbol, n_id), 2 * m)
    c = c.astype(np.float32)  # uint8 would wrap under 1 - 2*c
    r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)
    return r.astype(np.complex64)


def dmrs_re_indices_type1(nof_prb: int, delta: int = 0) -> np.ndarray:
    """Subcarrier indices of type-1 DMRS (comb 2, CDM group delta)."""
    return (2 * np.arange(6 * nof_prb) + delta).astype(np.int32)


@functools.lru_cache(maxsize=64)
def dmrs_type1_t(cfg: NrCarrierConfig, slot: int, dmrs_syms: tuple[int, ...],
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(symbols (S,), comb subcarriers (6*N_RB,), DMRS (S, 6*N_RB)) on device."""
    r = np.stack([dmrs_symbols_type1(cfg.nof_prb, slot, l, cfg.pci) for l in dmrs_syms])
    return (torch.as_tensor(dmrs_syms, dtype=torch.int64, device=device),
            torch.as_tensor(dmrs_re_indices_type1(cfg.nof_prb), dtype=torch.int64, device=device),
            torch.as_tensor(r, device=device))


def put_dmrs_type1(grid: torch.Tensor, cfg: NrCarrierConfig, slot: int,
                   dmrs_syms: tuple[int, ...] = (2, 11)) -> torch.Tensor:
    """Insert type-1 DMRS into a (B, 14, nre) slot grid; returns a new grid."""
    syms, ks, r = dmrs_type1_t(cfg, slot, tuple(dmrs_syms), grid.device)
    out = grid.clone()
    out[:, syms[:, None], ks[None, :]] = r
    return out


def data_re_indices_type1(cfg: NrCarrierConfig,
                          dmrs_syms: tuple[int, ...] = (2, 11),
                          start_sym: int = 1,
                          nof_syms: int = 13,
                          rb_start: int = 0,
                          nof_rb: int | None = None) -> np.ndarray:
    """Flat (symbol*nre + k) indices of PDSCH data REs in a slot with
    type-1 DMRS symbols fully reserved (no data on DMRS symbols).

    rb_start/nof_rb restrict the frequency-domain allocation (type-1 RA
    from DCI 1_0/0_0 RIV); default is the full carrier."""
    nof_rb = cfg.nof_prb - rb_start if nof_rb is None else nof_rb
    k = np.arange(rb_start * NRE, (rb_start + nof_rb) * NRE)
    syms = [l for l in range(start_sym, start_sym + nof_syms) if l not in dmrs_syms]
    return (np.asarray(syms, np.int64)[:, None] * cfg.nre + k).reshape(-1).astype(np.int32)
