"""Automatic gain control (reference: lib/src/phy/agc/agc.c).

Port counterpart of ``srsran_4g_tpu/ops/agc.py``: a batched peak estimator
and an exponential-tracking gain update; the returned gain multiplies the
sample stream.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AgcConfig:
    target: float = 0.3  # target peak amplitude
    bandwidth: float = 0.7  # loop smoothing factor
    max_gain_db: float = 90.0
    min_gain_db: float = 0.0


def agc_step(cfg: AgcConfig, samples: torch.Tensor, gain_db: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One AGC update per batch row.

    Args:
      samples: (..., N) frame of samples (pre-gain).
      gain_db: (...,) current gain, on the samples' device.

    Returns: (scaled samples, new gain_db).
    """
    gain_db = gain_db.to(torch.float32)
    y = samples * torch.pow(10.0, gain_db[..., None] / 20.0).to(samples.dtype)
    peak = torch.amax(y.abs(), dim=-1)
    err_db = 20.0 * torch.log10(torch.clamp(peak, min=1e-9) / cfg.target)
    new_gain = torch.clamp(gain_db - cfg.bandwidth * err_db, cfg.min_gain_db,
                           cfg.max_gain_db)
    return y, new_gain
