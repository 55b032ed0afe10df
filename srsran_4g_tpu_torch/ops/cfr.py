"""Crest-factor reduction (reference: lib/src/phy/cfr/cfr.c).

Port counterpart of ``srsran_4g_tpu/ops/cfr.py``: clip-and-filter CFR —
hard-clip samples above a PAPR-derived threshold, then remove the
out-of-band clipping noise with an FFT-domain brick-wall filter over the
occupied subcarriers, batched over symbols.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class CfrConfig:
    symbol_sz: int
    nof_re: int  # occupied subcarriers
    alpha: float = 1.5  # clip threshold relative to RMS
    skip_dc: bool = True


def _inband_mask(cfg: CfrConfig) -> np.ndarray:
    m = np.zeros(cfg.symbol_sz, dtype=np.float32)
    h = cfg.nof_re // 2
    m[:h + 1] = 1.0
    m[-h:] = 1.0
    if cfg.skip_dc:
        m[0] = 0.0
    return m


@functools.lru_cache(maxsize=16)
def _inband_mask_t(cfg: CfrConfig, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_inband_mask(cfg), device=device).to(torch.complex64)


def cfr_apply(cfg: CfrConfig, symbols_time: torch.Tensor) -> torch.Tensor:
    """Apply clip-and-filter CFR per OFDM symbol body (..., symbol_sz)."""
    mag = symbols_time.abs()
    rms = torch.sqrt(torch.mean(mag ** 2, dim=-1, keepdim=True))
    thr = cfg.alpha * rms
    scale = torch.where(mag > thr, thr / torch.clamp(mag, min=1e-12), 1.0)
    clipped = symbols_time * scale.to(symbols_time.dtype)
    # remove out-of-band clipping products
    f = torch.fft.fft(clipped, dim=-1) * _inband_mask_t(cfg, symbols_time.device)
    return torch.fft.ifft(f, dim=-1).to(torch.complex64)


def papr_db(x: torch.Tensor) -> torch.Tensor:
    p = x.abs() ** 2
    return 10.0 * torch.log10(torch.amax(p, dim=-1)
                              / torch.clamp(torch.mean(p, dim=-1), min=1e-12))
