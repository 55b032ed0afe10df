"""OFDM modulation/demodulation with cyclic prefix, TS 36.211 §6.12.

Port counterpart of ``srsran_4g_tpu/ops/ofdm.py`` (the reference's
FFTW-based `lib/src/phy/dft/ofdm.c`).  A whole subframe, or a batch of
them, is one tensor program:

- modulate: grid (..., 14, nre) → one batched inverse FFT over (..., 14, N)
  → CP insertion by slicing and concatenating per symbol;
- demodulate: samples (..., sf_len) → the 14 symbol bodies gathered with a
  precomputed index matrix → one batched FFT → subcarrier de-mapping; an
  optional receive-window offset is applied as a precomputed phase ramp
  (ofdm.c:156-158).

The DC subcarrier is skipped by default (LTE DL; ofdm.c:84-85 keeps it
empty): grid sc k < nre/2 → bin N - nre/2 + k (negative frequencies),
k >= nre/2 → bin k - nre/2 + 1.

The FFTs are ``torch.fft`` (cuFFT on a card), sizes 128..2048 including
1536 = 512·3 for 15 MHz; the JAX package runs its FFTs outside any Pallas
kernel too.  Index tables and ramps are built once per config on the host
(numpy) and cached per device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.utils import constants as C


@dataclass(frozen=True)
class OfdmConfig:
    nof_prb: int
    normal_cp: bool = True
    skip_dc: bool = True
    rx_window_offset: float = 0.0  # fraction of the normal-symbol CP
    # NB-IoT anchor carriers sit half a subcarrier off the channel centre:
    # the time signal is de-rotated by exp(-jπ(t-cp)/N) per symbol before
    # the FFT and subcarriers map symmetrically with no DC null
    # (reference ofdm.c srsran_ofdm_set_freq_shift, factor -0.5).
    half_sc_shift: bool = False
    # Explicit DFT size override for the reference's reduced sample rates
    # (srsran_symbol_sz with use_standard_symbol_size=false, e.g. 768 at
    # 50 PRB = 11.52 Msps) — None selects the TS 36.104 size.
    custom_symbol_sz: int | None = None

    def __post_init__(self):
        if self.half_sc_shift:
            object.__setattr__(self, "skip_dc", False)

    @property
    def nre(self) -> int:
        return self.nof_prb * C.NRE

    @property
    def symbol_sz(self) -> int:
        if self.custom_symbol_sz is not None:
            return self.custom_symbol_sz
        return C.symbol_sz(self.nof_prb)

    @property
    def nsymb_slot(self) -> int:
        return C.CP_NORM_NSYMB if self.normal_cp else C.CP_EXT_NSYMB

    @property
    def nsymb_sf(self) -> int:
        return 2 * self.nsymb_slot

    @property
    def sf_len(self) -> int:
        return 2 * self.slot_len

    @property
    def slot_len(self) -> int:
        n = self.symbol_sz
        if self.normal_cp:
            return C.cp_len_norm(0, n) + n + (self.nsymb_slot - 1) * (C.cp_len_norm(1, n) + n)
        return self.nsymb_slot * (C.cp_len_ext(n) + n)

    def cp_len(self, sym_in_slot: int) -> int:
        n = self.symbol_sz
        return C.cp_len_norm(sym_in_slot, n) if self.normal_cp else C.cp_len_ext(n)


@functools.lru_cache(maxsize=32)
def _symbol_offsets(cfg: OfdmConfig) -> np.ndarray:
    """Start-of-body sample offset of each of the subframe's symbols."""
    offs = []
    pos = 0
    for _slot in range(2):
        for l in range(cfg.nsymb_slot):
            cp = cfg.cp_len(l)
            offs.append(pos + cp)
            pos += cp + cfg.symbol_sz
    assert pos == cfg.sf_len
    return np.asarray(offs, dtype=np.int64)


@functools.lru_cache(maxsize=32)
def _sc_to_bin(cfg: OfdmConfig) -> np.ndarray:
    """FFT bin index for each of the nre grid subcarriers."""
    n, nre = cfg.symbol_sz, cfg.nre
    k = np.arange(nre)
    if cfg.skip_dc:
        return np.where(k < nre // 2, n - nre // 2 + k, k - nre // 2 + 1)
    return np.where(k < nre // 2, n - nre // 2 + k, k - nre // 2)


def _window_shift(cfg: OfdmConfig) -> int:
    return int(round(cfg.rx_window_offset * cfg.cp_len(1)))


@functools.lru_cache(maxsize=32)
def _gather_index(cfg: OfdmConfig) -> np.ndarray:
    """(nsymb_sf, symbol_sz) sample indices of each symbol body, shifted by
    the rx window offset (taking samples from inside the CP)."""
    offs = _symbol_offsets(cfg) - _window_shift(cfg)
    return offs[:, None] + np.arange(cfg.symbol_sz)[None, :]


@functools.lru_cache(maxsize=32)
def _window_phase(cfg: OfdmConfig) -> np.ndarray | None:
    """Phase ramp compensating the rx window shift (ofdm.c:156-158)."""
    w = _window_shift(cfg)
    if w == 0:
        return None
    # Shifting the FFT window left by w rotates bin b by exp(+j 2π b w / N).
    return np.exp(2j * np.pi * w * _sc_to_bin(cfg) / cfg.symbol_sz).astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _half_sc_ramp(cfg: OfdmConfig) -> np.ndarray:
    """(sf_len,) de-rotation ramp for the NB-IoT -0.5-subcarrier offset:
    exp(j·2π·(t-cp_len)·(-0.5)/N) per symbol, phase zero at the first body
    sample (reference ofdm.c freq-shift buffer)."""
    n = cfg.symbol_sz
    ramp = np.empty(cfg.sf_len, np.complex64)
    pos = 0
    for l in range(cfg.nsymb_sf):
        cp = cfg.cp_len(l % cfg.nsymb_slot)
        t = np.arange(cp + n, dtype=np.float64) - cp
        ramp[pos:pos + cp + n] = np.exp(-1j * np.pi * t / n)
        pos += cp + n
    return ramp


@functools.lru_cache(maxsize=64)
def _on(device: torch.device, fn, *args) -> torch.Tensor:
    """A host table ``fn(*args)`` as a tensor on ``device``, cached."""
    return torch.as_tensor(fn(*args), device=device)


def _scale(n: int) -> float:
    """sqrt(N) rounded to float32, as the JAX package computes it."""
    return float(np.sqrt(np.float32(n), dtype=np.float32))


def modulate(cfg: OfdmConfig, grid: torch.Tensor) -> torch.Tensor:
    """OFDM-modulate a resource grid into time samples.

    Args:
      cfg: static OFDM configuration.
      grid: (..., nsymb_sf, nre) complex64 frequency-domain grid.

    Returns:
      (..., sf_len) complex64 time-domain samples (one subframe).
    """
    n = cfg.symbol_sz
    bins = _on(grid.device, _sc_to_bin, cfg)
    freq = grid.new_zeros(grid.shape[:-1] + (n,), dtype=torch.complex64)
    freq[..., bins] = grid.to(torch.complex64)
    # The reference normalises the IFFT by 1/sqrt(N) (AGC-friendly unit
    # power): torch's ifft divides by N, so multiply by sqrt(N).
    time = torch.fft.ifft(freq, dim=-1) * _scale(n)
    pieces = []
    for l in range(cfg.nsymb_sf):
        cp = cfg.cp_len(l % cfg.nsymb_slot)
        sym = time[..., l, :]
        pieces += [sym[..., n - cp:], sym]
    out = torch.cat(pieces, dim=-1)
    if cfg.half_sc_shift:
        out = out * _on(out.device, _half_sc_ramp, cfg).conj()
    return out


def demodulate(cfg: OfdmConfig, samples: torch.Tensor) -> torch.Tensor:
    """OFDM-demodulate one subframe of samples into a resource grid.

    Args:
      samples: (..., sf_len) complex64.

    Returns:
      (..., nsymb_sf, nre) complex64 grid.
    """
    dev = samples.device
    if cfg.half_sc_shift:
        samples = samples * _on(dev, _half_sc_ramp, cfg)
    syms = samples[..., _on(dev, _gather_index, cfg)]  # (..., nsymb_sf, N)
    grid = _fft_bins(cfg, syms)
    ramp = _window_phase(cfg)
    if ramp is not None:
        grid = grid * _on(dev, _window_phase, cfg)
    return grid


def _fft_bins(cfg: OfdmConfig, syms: torch.Tensor) -> torch.Tensor:
    """FFT of symbol bodies (..., N), unit-power scaled, at the grid's bins."""
    freq = torch.fft.fft(syms.to(torch.complex64), dim=-1) / _scale(cfg.symbol_sz)
    return freq[..., _on(syms.device, _sc_to_bin, cfg)]


@functools.lru_cache(maxsize=8)
def _mbsfn_symbol_offsets(cfg: OfdmConfig, non_mbsfn_region: int) -> np.ndarray:
    """Start-of-body offsets for an MBSFN subframe (12 ext-CP symbols).

    The reference's layout (ofdm_rx_slot_mbsfn, ofdm.c:522-534): the first
    `non_mbsfn_region` symbols of slot 0 use normal-CP lengths, followed by
    a guard of 2·cp_ext − cp0_norm − cp1_norm samples
    (SRSRAN_NON_MBSFN_REGION_GUARD_LENGTH), then extended-CP symbols; slot 1
    is all extended CP.  cfg must be an extended-CP config."""
    assert not cfg.normal_cp
    n = cfg.symbol_sz
    cp_e = C.cp_len_ext(n)
    offs, pos = [], 0
    for l in range(6):  # slot 0: normal-CP region, guard, extended-CP region
        if l < non_mbsfn_region:
            cp = C.cp_len_norm(l, n)
        else:
            if l == non_mbsfn_region:
                pos += (non_mbsfn_region * cp_e
                        - sum(C.cp_len_norm(i, n) for i in range(non_mbsfn_region)))
            cp = cp_e
        offs.append(pos + cp)
        pos += cp + n
    for _ in range(6):  # slot 1: plain extended CP
        offs.append(pos + cp_e)
        pos += cp_e + n
    assert pos == cfg.sf_len, (pos, cfg.sf_len)
    return np.asarray(offs, np.int64)


def _mbsfn_index(cfg: OfdmConfig, non_mbsfn_region: int) -> np.ndarray:
    offs = _mbsfn_symbol_offsets(cfg, non_mbsfn_region)
    return offs[:, None] + np.arange(cfg.symbol_sz)[None, :]


def demodulate_mbsfn(cfg: OfdmConfig, samples: torch.Tensor,
                     non_mbsfn_region: int = 2) -> torch.Tensor:
    """Demodulate one MBSFN subframe: (..., sf_len) → (..., 12, nre).

    Counterpart of srsran_ofdm_rx_sf on an MBSFN subframe (ofdm.c:560-563):
    mixed normal/extended CP in slot 0, extended CP in slot 1."""
    idx = _on(samples.device, _mbsfn_index, cfg, non_mbsfn_region)
    return _fft_bins(cfg, samples[..., idx])

