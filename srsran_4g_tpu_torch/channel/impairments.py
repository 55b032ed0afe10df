"""Channel impairments: delay sweep, high-speed-train Doppler, periodic RLF.

Port counterpart of ``srsran_4g_tpu/channel/impairments.py`` (the
reference's `lib/src/phy/channel/{delay.c,hst.c,rlf.c}`: the
fault-injection blocks wired into the UE/eNB rx paths,
srsue/src/phy/sync.cc:88-90).  Every function runs on the device of the
samples or times it is given, in float32 / complex64 as the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DelayConfig:
    """Periodic delay sweep between min and max (delay.c)."""

    min_samples: float
    max_samples: float
    period_s: float
    srate_hz: float


def delay_at(cfg: DelayConfig, t_s: torch.Tensor) -> torch.Tensor:
    """Triangular sweep of the current delay in samples."""
    phase = (t_s / cfg.period_s) % 1.0
    tri = 1.0 - torch.abs(2.0 * phase - 1.0)
    return cfg.min_samples + (cfg.max_samples - cfg.min_samples) * tri


def apply_delay(samples: torch.Tensor, delay_samples) -> torch.Tensor:
    """Fractional delay via frequency-domain phase ramp (per batch row)."""
    n = samples.shape[-1]
    dev = samples.device
    f = torch.fft.fftfreq(n, device=dev).to(torch.float32)
    d = torch.as_tensor(delay_samples, dtype=torch.float32, device=dev)
    ph = torch.exp((-2j * math.pi) * (d[..., None] * f)).to(torch.complex64)
    return torch.fft.ifft(torch.fft.fft(samples, dim=-1) * ph, dim=-1).to(torch.complex64)


@dataclass(frozen=True)
class HstConfig:
    """High-speed-train Doppler profile (hst.c / TS 36.101 B.3)."""

    fd_hz: float  # max Doppler
    period_s: float = 7.2
    init_time_s: float = 0.0


def hst_doppler_at(cfg: HstConfig, t_s: torch.Tensor) -> torch.Tensor:
    """fs(t) per TS 36.101 B.3A piecewise cosine trajectory."""
    ds, dmin = 300.0, 2.0
    v = 300.0 / 3.6
    t = (t_s + cfg.init_time_s) % cfg.period_s
    half = cfg.period_s / 2
    x1 = ds / 2 - v * t
    x2 = -ds / 2 + v * (t - half)
    cos1 = x1 / torch.sqrt(dmin**2 + x1**2)
    cos2 = -x2 / torch.sqrt(dmin**2 + x2**2)
    return cfg.fd_hz * torch.where(t < half, cos1, cos2)


def apply_hst(cfg: HstConfig, samples: torch.Tensor, t0_s: float,
              srate_hz: float) -> torch.Tensor:
    n = samples.shape[-1]
    t = t0_s + torch.arange(n, dtype=torch.float32, device=samples.device) / srate_hz
    fs = hst_doppler_at(cfg, t)
    ph = torch.exp((2j * math.pi) * torch.cumsum(fs, dim=0) / srate_hz).to(torch.complex64)
    return samples * ph


@dataclass(frozen=True)
class RlfConfig:
    """Periodic radio-link-failure injector (rlf.c:25-55): the signal is
    zeroed for t_off out of every t_on + t_off period."""

    t_on_ms: float
    t_off_ms: float


def apply_rlf(cfg: RlfConfig, samples: torch.Tensor, t0_ms: float,
              srate_hz: float) -> torch.Tensor:
    n = samples.shape[-1]
    t = t0_ms + torch.arange(n, dtype=torch.float32, device=samples.device) / srate_hz * 1e3
    period = cfg.t_on_ms + cfg.t_off_ms
    on = (t % period) < cfg.t_on_ms
    return samples * on.to(samples.dtype)
