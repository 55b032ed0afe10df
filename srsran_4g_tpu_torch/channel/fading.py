"""Tapped-delay-line fading channel with 3GPP profiles and Doppler.

Port counterpart of ``srsran_4g_tpu/channel/fading.py`` (the reference's
`lib/src/phy/channel/fading.c`: EPA/EVA/ETU tap tables, fading.c:33-69).
Per-tap Rayleigh processes are a sum of sinusoids (Jakes) whose frequencies
and phases come from numpy's RNG on the host, so both packages draw the same
sinusoids for a seed; the phases are evaluated in float32 on the device of
the times given, as the JAX package does, and the channel is applied in the
frequency domain per OFDM symbol.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

# 3GPP TS 36.101 Annex B.2 tapped delay line profiles: (delay ns, power dB)
DELAY_PROFILES = {
    "epa": ((0, 0.0), (30, -1.0), (70, -2.0), (90, -3.0), (110, -8.0),
            (190, -17.2), (410, -20.8)),
    "eva": ((0, 0.0), (30, -1.5), (150, -1.4), (310, -3.6), (370, -0.6),
            (710, -9.1), (1090, -7.0), (1730, -12.0), (2510, -16.9)),
    "etu": ((0, -1.0), (50, -1.0), (120, -1.0), (200, 0.0), (230, 0.0),
            (500, 0.0), (1600, -3.0), (2300, -5.0), (5000, -7.0)),
}


@dataclass(frozen=True)
class FadingConfig:
    profile: str  # "epa" | "eva" | "etu"
    doppler_hz: float
    srate_hz: float
    n_sinusoids: int = 16

    @property
    def taps(self) -> tuple[np.ndarray, np.ndarray]:
        prof = DELAY_PROFILES[self.profile]
        delays = np.asarray([p[0] for p in prof]) * 1e-9 * self.srate_hz
        powers = 10 ** (np.asarray([p[1] for p in prof]) / 10.0)
        powers = powers / powers.sum()
        return delays, powers


@functools.lru_cache(maxsize=32)
def _jakes_params(cfg: FadingConfig, seed: int) -> tuple[np.ndarray, ...]:
    """Random sinusoid frequencies/phases per tap (host, deterministic)."""
    delays, powers = cfg.taps
    rng = np.random.default_rng(seed)
    n_taps = len(delays)
    n = cfg.n_sinusoids
    theta = rng.uniform(0, 2 * np.pi, size=(n_taps, n))
    phi = rng.uniform(0, 2 * np.pi, size=(n_taps, n))
    f = cfg.doppler_hz * np.cos(theta)  # per-sinusoid Doppler shift
    return delays, powers, f, phi


@functools.lru_cache(maxsize=32)
def _jakes_tensors(cfg: FadingConfig, seed: int, device: torch.device
                   ) -> dict[str, torch.Tensor]:
    """The Jakes parameters as float32 tensors on ``device``: f and phi
    (taps, n, 1), the tap amplitudes (taps, 1), sqrt(n) and the tap delays in
    samples (taps,)."""
    delays, powers, f, phi = _jakes_params(cfg, seed)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return dict(f=f32(f)[..., None], phi=f32(phi)[..., None],
                amp=torch.sqrt(f32(powers))[:, None].to(torch.complex64),
                sqrt_n=torch.sqrt(f32(cfg.n_sinusoids)).to(torch.complex64),
                delays=f32(delays))


def tap_gains(cfg: FadingConfig, seed: int, t: torch.Tensor) -> torch.Tensor:
    """Complex tap gains (n_taps, len(t)) at times ``t`` (seconds, float32),
    on t's device."""
    tab = _jakes_tensors(cfg, seed, t.device)
    ph = (2 * math.pi) * tab["f"] * t[None, None, :] + tab["phi"]
    g = torch.mean(torch.exp(1j * ph.to(torch.complex64)), dim=1)
    # the mean of n unit phasors has variance 1/n per component: times sqrt(n)
    return g * tab["amp"] * tab["sqrt_n"]


def freq_response(cfg: FadingConfig, seed: int, t: torch.Tensor,
                  freqs: torch.Tensor) -> torch.Tensor:
    """Channel frequency response H (len(t), len(freqs)) complex64.

    freqs in cycles/sample (e.g. FFT bin / N); taps at fractional sample
    delays contribute exp(-j2π f d).
    """
    d = _jakes_tensors(cfg, seed, t.device)["delays"]
    g = tap_gains(cfg, seed, t)  # (taps, T)
    steer = torch.exp((-2j * math.pi) * (d[:, None] * freqs[None, :]).to(torch.complex64))
    return torch.einsum("pt,pf->tf", g, steer)


def apply_grid(cfg: FadingConfig, seed: int, grid_tx: torch.Tensor,
               symbol_times: np.ndarray, sc_freqs: np.ndarray
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply fading per OFDM symbol in the frequency domain, on the grid's
    device.

    Valid while the channel is static over one symbol (Doppler ≪ 15 kHz),
    the standard assumption for these profiles.

    Args:
      grid_tx: (..., nsymb, nre).
      symbol_times: (nsymb,) seconds.
      sc_freqs: (nre,) cycles/sample of each subcarrier.

    Returns:
      (faded grid, H (nsymb, nre)).
    """
    dev = grid_tx.device
    h = freq_response(cfg, seed, torch.as_tensor(symbol_times, dtype=torch.float32, device=dev),
                      torch.as_tensor(sc_freqs, dtype=torch.float32, device=dev))
    return grid_tx * h, h
