"""Equalisation: single-port MMSE/ZF and the SFBC (TM2) diversity decoders.

Port counterpart of ``srsran_4g_tpu/models/equalizer.py``.  Element-wise
complex math on (..., N) tensors.
"""

from __future__ import annotations

import math

import torch

_SQRT2 = math.sqrt(2.0)


def _noise_var_like(noise_var, y: torch.Tensor) -> torch.Tensor:
    """noise_var as float32 on y's device, with trailing axes to y's rank."""
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=y.device)
    while nv.ndim < y.ndim:
        nv = nv[..., None]
    return nv


def equalize_single(
    y: torch.Tensor,
    h: torch.Tensor,
    noise_var: torch.Tensor | float,
    method: str = "mmse",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-port equalisation.

    Args:
      y: (..., N) received REs.
      h: (..., N) channel estimate.
      noise_var: scalar or (...,) broadcastable complex-noise variance.

    Returns:
      (x_hat (..., N) complex64, eff_noise_var (..., N) float32): the
      per-RE effective noise variance for the soft demodulator (ZF-
      normalised so the constellation stays unit energy).
    """
    hh = torch.clamp(h.abs() ** 2, min=1e-12)
    nv = _noise_var_like(noise_var, y)
    if method == "zf":
        x = y * h.conj() / hh.to(torch.complex64)
    elif method == "mmse":  # MMSE with ZF-consistent (unbiased) normalisation
        x = y * h.conj() / (hh + nv).to(torch.complex64)
        bias = hh / (hh + nv)
        x = x / torch.clamp(bias, min=1e-6).to(torch.complex64)
    else:
        raise ValueError(f"unknown equaliser {method!r}")
    eff_nv = (nv / hh).to(torch.float32)
    return x.to(torch.complex64), eff_nv


def alamouti_decode_2x1(
    y: torch.Tensor, h0: torch.Tensor, h1: torch.Tensor,
    noise_var: torch.Tensor | float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SFBC (TM2) decode for 2 TX ports, 1 RX antenna (TS 36.211 §6.3.4.3).

    The mapping over an RE pair (k even, k+1) is port0: [x0, x1],
    port1: [-x1*, x0*], each scaled 1/sqrt(2); h is taken constant over the
    pair.

    Args:
      y: (..., N) with N even — received REs in mapping order.
      h0/h1: (..., N) per-port channel estimates.

    Returns:
      (x_hat (..., N) complex64, eff_noise_var (..., N) float32).
    """
    y0, y1 = y[..., 0::2], y[..., 1::2]
    g0, g1 = h0[..., 0::2], h1[..., 0::2]
    denom = torch.clamp(g0.abs() ** 2 + g1.abs() ** 2, min=1e-12)
    x0 = (g0.conj() * y0 + g1 * y1.conj()) / denom * _SQRT2
    # (conj(g1)·y0 − g0·conj(y1)) = −(|g0|²+|g1|²)·x1*/√2 → negate+conjugate
    x1 = -((g1.conj() * y0 - g0 * y1.conj()) / denom).conj() * _SQRT2
    x = torch.stack([x0, x1], dim=-1).reshape(y.shape)
    eff = 2.0 * _noise_var_like(noise_var, y) / denom
    eff_nv = torch.stack([eff, eff], dim=-1).reshape(y.shape).to(torch.float32)
    return x.to(torch.complex64), eff_nv


def sfbc_fstd_decode_4x1(
    y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor | float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SFBC-FSTD (TM2, 4 TX ports) decode for 1 RX antenna.

    Alamouti pairs on ports (0, 2) over REs (4i, 4i+1) and on (1, 3) over
    REs (4i+2, 4i+3), 1/sqrt(2) power split per active pair (reference
    precoding.c:1961, TS 36.211 §6.3.4.3).

    Args:
      y: (..., N) received REs, N a multiple of 4.
      h: (..., 4, N) per-port channel estimates.

    Returns (x_hat (..., N) complex64, eff_noise_var (..., N) float32).
    """
    def pair(ya, yb, ga, gb):
        den = torch.clamp(ga.abs() ** 2 + gb.abs() ** 2, min=1e-12)
        xa = (ga.conj() * ya + gb * yb.conj()) / den * _SQRT2
        xb = (ga.conj() * yb - gb * ya.conj()) / den * _SQRT2
        return xa, xb, den

    y0, y1, y2, y3 = (y[..., i::4] for i in range(4))
    x0, x1, d02 = pair(y0, y1, h[..., 0, 0::4], h[..., 2, 0::4])
    x2, x3, d13 = pair(y2, y3, h[..., 1, 2::4], h[..., 3, 2::4])
    x = torch.stack([x0, x1, x2, x3], dim=-1).reshape(y.shape)
    nv = _noise_var_like(noise_var, y)
    e02, e13 = 2.0 * nv / d02, 2.0 * nv / d13
    eff_nv = torch.stack([e02, e02, e13, e13], dim=-1).reshape(y.shape)
    return x.to(torch.complex64), eff_nv.to(torch.float32)
