"""Sample-rate conversion: FFT integer resampler + polyphase arbitrary.

Port counterpart of ``srsran_4g_tpu/ops/resampling.py`` (the reference's
`lib/src/phy/resampling/{resampler.c,resample_arb.c}`, used by the radio
layer to convert between the PHY rate and the device rate).

- ``resample_fft``: rational L/M resampling in the frequency domain — one
  batched FFT, spectrum truncate/zero-pad, inverse FFT.
- ``resample_polyphase``: arbitrary-ratio polyphase interpolation with a
  windowed-sinc filter bank: output n gathers a length-``n_taps`` input
  window and dots it with the phase-selected filter.  The filter bank and the
  gather indices are host numpy, built once per (length, rate, bank) and
  cached on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def resample_fft(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Rational resample along the last axis: out_len = len * up // down."""
    n = x.shape[-1]
    n_out = n * up // down
    xf = torch.fft.fft(x, dim=-1)
    half = min(n, n_out) // 2
    yf = xf.new_zeros(x.shape[:-1] + (n_out,))
    yf[..., :half] = xf[..., :half]
    yf[..., n_out - half:] = xf[..., n - half:]
    return (torch.fft.ifft(yf, dim=-1) * (n_out / n)).to(torch.complex64)


@functools.lru_cache(maxsize=64)
def _polyphase_bank(n_phases: int, n_taps: int, cutoff: float) -> np.ndarray:
    """(n_phases, n_taps) windowed-sinc interpolation filter bank."""
    idx = np.arange(n_phases * n_taps)
    t = (idx - n_phases * n_taps / 2) / n_phases
    h = np.sinc(cutoff * t) * cutoff
    h *= np.hamming(idx.size)
    bank = h.reshape(n_taps, n_phases).T[::-1]  # phase-major
    return np.ascontiguousarray(bank / bank.sum(axis=1, keepdims=True)).astype(
        np.float32
    )


@functools.lru_cache(maxsize=16)
def _polyphase_tables(n_in: int, rate: float, n_phases: int, n_taps: int,
                      device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(gather indices (n_out, T), coefficients (n_out, T)) on the device."""
    n_out = int(np.floor(n_in * rate))
    bank = _polyphase_bank(n_phases, n_taps, min(1.0, rate))
    t = np.arange(n_out) / rate  # fractional input positions
    base = np.floor(t).astype(np.int64)
    phase = np.minimum(((t - base) * n_phases).astype(np.int64), n_phases - 1)
    # gather windows [base - n_taps/2 + 1 .. base + n_taps/2]
    offs = np.arange(n_taps) - n_taps // 2 + 1
    gidx = np.clip(base[:, None] + offs[None, :], 0, n_in - 1)
    return (torch.as_tensor(gidx, device=device),
            torch.as_tensor(bank[phase], device=device))


def resample_polyphase(x: torch.Tensor, rate: float, n_phases: int = 32,
                       n_taps: int = 8) -> torch.Tensor:
    """Arbitrary-ratio resampler (rate = f_out / f_in), batched over the
    leading dims."""
    gidx, coef = _polyphase_tables(x.shape[-1], float(rate), n_phases, n_taps, x.device)
    return torch.sum(x[..., gidx] * coef.to(x.dtype), dim=-1)
