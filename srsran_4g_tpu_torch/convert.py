"""Hand state of the JAX package to the port and back.

The receiver has no learned weights.  What persists between calls is the
static per-config tables, which the port rebuilds from the config, and the
HARQ soft-buffers ``dict[int, (B, 3, K+4)]``.  The configs arrive as
``dataclasses.asdict`` of the JAX package's ``PdschConfig`` /
``PdschMimoConfig`` / ``ChestConfig`` (a nested ``cell`` dict included), so
neither side imports the other.
"""

from __future__ import annotations

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.models.chest import ChestConfig
from srsran_4g_tpu_torch.models.grid import CellConfig
from srsran_4g_tpu_torch.models.pdsch import PdschConfig
from srsran_4g_tpu_torch.models.pdsch_mimo import PdschMimoConfig


def pdsch_config_from_dict(d: dict) -> PdschConfig | PdschMimoConfig | ChestConfig:
    """Rebuild a ``PdschConfig`` (or a ``PdschMimoConfig``, told apart by its
    ``tbs0`` key, or a ``ChestConfig``, by its ``smooth_len`` key) from
    ``dataclasses.asdict`` of the JAX one."""
    fields = dict(d)
    fields["cell"] = CellConfig(**fields["cell"])
    if "smooth_len" in fields:
        return ChestConfig(**fields)
    if fields.get("prb_alloc") is not None:
        fields["prb_alloc"] = tuple(fields["prb_alloc"])
    return PdschMimoConfig(**fields) if "tbs0" in fields else PdschConfig(**fields)


def softbuffers_from_numpy(d: dict, device: torch.device | str | None = None
                           ) -> dict[int, torch.Tensor]:
    """Per-CB soft-buffers (arrays of (B, 3, K+4)) → float32 tensors on
    ``device`` (default CUDA)."""
    dev = resolve_device(device)
    return {int(k): torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
            for k, v in d.items()}


def softbuffers_to_numpy(d: dict[int, torch.Tensor]) -> dict[int, np.ndarray]:
    """The port's soft-buffers → float32 numpy arrays, keyed by CB index."""
    return {int(k): v.detach().to("cpu", torch.float32).numpy() for k, v in d.items()}
