"""PyTorch/CUDA port of srsran_4g_tpu for NVIDIA Hopper GPUs.

The module tree mirrors ``srsran_4g_tpu/`` file for file.  The package
imports torch and numpy only; the windowed max-log-MAP half-iteration runs
in hand-written CUDA kernels, one for each of its dataflows and metric types
(``csrc/turbo_*.cu``, bound in ``ops/cuda/turbo_map.py``).

Entry points that create tensors default to the CUDA device and raise when
no card is present unless the caller passes ``device="cpu"``; functions that
take tensors run on the device of their inputs.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device a tensor-creating entry point should use (default CUDA)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
