"""Hand state of the JAX package to the port and back.

The receiver has no learned weights.  What persists between calls is the
static per-config tables, which the port rebuilds from the config, the
HARQ soft-buffers ``dict[int, (B, 3, K+4)]``, and the host state of the UE's
loops (``UeSyncState``, ``PowerCtrlState``).  The configs and states arrive
as ``dataclasses.asdict`` of the JAX package's dataclasses (nested ``cell``,
``uci`` and ``cfg`` dicts included), so neither side imports the other.
"""

from __future__ import annotations

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.models.chest import ChestConfig
from srsran_4g_tpu_torch.models.grid import CellConfig
from srsran_4g_tpu_torch.models.meas import PowerCtrlConfig, PowerCtrlState
from srsran_4g_tpu_torch.models.pdsch import PdschConfig
from srsran_4g_tpu_torch.models.pdsch_mimo import PdschMimoConfig
from srsran_4g_tpu_torch.models.pmch import PmchConfig
from srsran_4g_tpu_torch.models.prach import PrachConfig
from srsran_4g_tpu_torch.models.pucch import PucchConfig
from srsran_4g_tpu_torch.models.pusch import PuschConfig
from srsran_4g_tpu_torch.models.srs import SrsConfig
from srsran_4g_tpu_torch.models.uci import UciCfg
from srsran_4g_tpu_torch.models.ue_sync import UeSyncState


def pdsch_config_from_dict(d: dict) -> PdschConfig | PdschMimoConfig | ChestConfig:
    """Rebuild a ``PdschConfig`` (or a ``PdschMimoConfig``, told apart by its
    ``tbs0`` key, or a ``ChestConfig``, by its ``smooth_len`` key) from
    ``dataclasses.asdict`` of the JAX one."""
    fields = _with_cell(d)
    if "smooth_len" in fields:
        return ChestConfig(**fields)
    if fields.get("prb_alloc") is not None:
        fields["prb_alloc"] = tuple(fields["prb_alloc"])
    return PdschMimoConfig(**fields) if "tbs0" in fields else PdschConfig(**fields)


def _with_cell(d: dict) -> dict:
    fields = dict(d)
    fields["cell"] = CellConfig(**fields["cell"])
    return fields


def pusch_config_from_dict(d: dict) -> PuschConfig:
    """``PuschConfig`` from ``dataclasses.asdict`` of the JAX one, with its
    nested cell and UCI config."""
    fields = _with_cell(d)
    if fields.get("uci") is not None:
        fields["uci"] = UciCfg(**fields["uci"])
    return PuschConfig(**fields)


def pmch_config_from_dict(d: dict) -> PmchConfig:
    return PmchConfig(**d)


def pucch_config_from_dict(d: dict) -> PucchConfig:
    return PucchConfig(**_with_cell(d))


def prach_config_from_dict(d: dict) -> PrachConfig:
    return PrachConfig(**d)


def srs_config_from_dict(d: dict) -> SrsConfig:
    return SrsConfig(**_with_cell(d))


def ue_sync_state_from_dict(d: dict) -> UeSyncState:
    """The FSM state of a JAX ``UeSync`` (``asdict(us.s)``), for a port
    ``UeSync(nof_prb, state=...)`` to take over mid-stream."""
    return UeSyncState(**d)


def power_ctrl_state_from_dict(d: dict) -> PowerCtrlState:
    """A JAX ``PowerCtrlState`` (its config and closed-loop accumulators)."""
    fields = dict(d)
    cfg = dict(fields["cfg"])
    cfg["delta_f_pucch"] = tuple(cfg["delta_f_pucch"])
    fields["cfg"] = PowerCtrlConfig(**cfg)
    return PowerCtrlState(**fields)


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
