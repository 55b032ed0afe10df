"""Hand state of the JAX package to the port and back.

The receiver has no learned weights.  What persists between calls is the
static per-config tables, which the port rebuilds from the config, the
HARQ soft-buffers ``dict[int, (B, 3, K+4)]``, and the host state of the UE's
loops (``UeSyncState``, ``PowerCtrlState``).  The configs and states arrive
as ``dataclasses.asdict`` of the JAX package's dataclasses (nested ``cell``,
``uci`` and ``cfg`` dicts included), so neither side imports the other.  The
channel emulator's configs and the system air (``LteAirPhy``) are built the
same way from the dicts that build the JAX ones.
"""

from __future__ import annotations

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.channel.fading import FadingConfig
from srsran_4g_tpu_torch.channel.impairments import DelayConfig, HstConfig, RlfConfig
from srsran_4g_tpu_torch.models.chest import ChestConfig
from srsran_4g_tpu_torch.models.coreset0 import Coreset0
from srsran_4g_tpu_torch.models.csi_nr import CsiRsConfig
from srsran_4g_tpu_torch.models.grid import CellConfig
from srsran_4g_tpu_torch.models.grid_nr import NrCarrierConfig
from srsran_4g_tpu_torch.models.meas import PowerCtrlConfig, PowerCtrlState
from srsran_4g_tpu_torch.models.nbiot_data import NpdschConfig
from srsran_4g_tpu_torch.models.pdsch import PdschConfig
from srsran_4g_tpu_torch.models.pdsch_mimo import PdschMimoConfig
from srsran_4g_tpu_torch.models.pdcch_nr import CoresetConfig
from srsran_4g_tpu_torch.models.pdsch_nr import PdschNrConfig
from srsran_4g_tpu_torch.models.pmch import PmchConfig
from srsran_4g_tpu_torch.models.prach import PrachConfig
from srsran_4g_tpu_torch.models.pucch import PucchConfig
from srsran_4g_tpu_torch.models.pucch_nr import PucchNrF0Config, PucchNrF1Config, PucchNrF2Config
from srsran_4g_tpu_torch.models.pusch import PuschConfig
from srsran_4g_tpu_torch.models.pusch_nr import NrUciCfg, PuschNrConfig, PuschNrUciConfig
from srsran_4g_tpu_torch.models.sch_nr import NrSegm
from srsran_4g_tpu_torch.models.sidelink import MibSl, PscchConfig, PsschConfig
from srsran_4g_tpu_torch.models.sl_rx import SlPool
from srsran_4g_tpu_torch.models.srs import SrsConfig
from srsran_4g_tpu_torch.models.ssb import SsbConfig
from srsran_4g_tpu_torch.models.uci import UciCfg
from srsran_4g_tpu_torch.models.ue_sync import UeSyncState
from srsran_4g_tpu_torch.runtime.lte_air import LteAirPhy


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


def pdsch_nr_config_from_dict(d: dict) -> PdschNrConfig:
    """``PdschNrConfig`` from ``dataclasses.asdict`` of the JAX one, with its
    nested carrier."""
    fields = dict(d)
    fields["carrier"] = NrCarrierConfig(**fields["carrier"])
    return PdschNrConfig(**fields)


def pusch_nr_config_from_dict(d: dict) -> PuschNrConfig | PuschNrUciConfig:
    """``PuschNrConfig`` from ``dataclasses.asdict`` of the JAX one, or
    ``PuschNrUciConfig`` when the dict has a ``uci`` key (its nested
    ``NrUciCfg`` dict, or None)."""
    fields = dict(d)
    fields["carrier"] = NrCarrierConfig(**fields["carrier"])
    if "uci" not in fields:
        return PuschNrConfig(**fields)
    if fields["uci"] is not None:
        fields["uci"] = NrUciCfg(**fields["uci"])
    return PuschNrUciConfig(**fields)


def pucch_nr_f0_config_from_dict(d: dict) -> PucchNrF0Config:
    return PucchNrF0Config(**d)


def pucch_nr_f1_config_from_dict(d: dict) -> PucchNrF1Config:
    return PucchNrF1Config(**d)


def pucch_nr_f2_config_from_dict(d: dict) -> PucchNrF2Config:
    return PucchNrF2Config(**d)


def coreset_config_from_dict(d: dict) -> CoresetConfig:
    return CoresetConfig(**d)


def ssb_config_from_dict(d: dict) -> SsbConfig:
    return SsbConfig(**d)


def nr_segm_from_dict(d: dict) -> NrSegm:
    """``NrSegm`` from ``dataclasses.asdict`` of the JAX one (its per-CB
    tuples come back as tuples, so the result hashes like one the port made)."""
    fields = dict(d)
    fields["e_bits"] = tuple(fields["e_bits"])
    fields["data_lens"] = tuple(fields["data_lens"])
    return NrSegm(**fields)


def pscch_config_from_dict(d: dict) -> PscchConfig:
    return PscchConfig(**d)


def pssch_config_from_dict(d: dict) -> PsschConfig:
    return PsschConfig(**d)


def sl_pool_from_dict(d: dict) -> SlPool:
    """``SlPool`` from ``dataclasses.asdict`` of the JAX one, its subframe
    bitmaps as int8 arrays."""
    fields = dict(d)
    for k in ("pscch_sf_bitmap", "pssch_sf_bitmap"):
        fields[k] = np.asarray(fields[k], np.int8)
    return SlPool(**fields)


def mib_sl_from_dict(d: dict) -> MibSl:
    return MibSl(**d)


def npdsch_config_from_dict(d: dict) -> NpdschConfig:
    return NpdschConfig(**d)


def coreset0_from_dict(d: dict) -> Coreset0:
    return Coreset0(**d)


def csi_rs_config_from_dict(d: dict) -> CsiRsConfig:
    """``CsiRsConfig`` from ``dataclasses.asdict`` of the JAX one, with its
    nested carrier."""
    fields = dict(d)
    fields["carrier"] = NrCarrierConfig(**fields["carrier"])
    return CsiRsConfig(**fields)


def softbuffers_from_numpy(d: dict, device: torch.device | str | None = None
                           ) -> dict[int, torch.Tensor]:
    """Per-CB soft-buffers (arrays of (B, 3, K+4) for LTE, (B, Nfull*Z) for
    NR) → float32 tensors on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    return {int(k): torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
            for k, v in d.items()}


def softbuffers_to_numpy(d: dict[int, torch.Tensor]) -> dict[int, np.ndarray]:
    """The port's soft-buffers → float32 numpy arrays, keyed by CB index."""
    return {int(k): v.detach().to("cpu", torch.float32).numpy() for k, v in d.items()}


def fading_config_from_dict(d: dict) -> FadingConfig:
    return FadingConfig(**d)


def delay_config_from_dict(d: dict) -> DelayConfig:
    return DelayConfig(**d)


def hst_config_from_dict(d: dict) -> HstConfig:
    return HstConfig(**d)


def rlf_config_from_dict(d: dict) -> RlfConfig:
    return RlfConfig(**d)


def lte_air_phy_from_dict(d: dict, device: torch.device | str | None = None) -> LteAirPhy:
    """The port's ``LteAirPhy`` from the keyword arguments of a JAX one
    (``fading`` as ``dataclasses.asdict`` of its ``FadingConfig``, or None),
    on ``device`` (default CUDA)."""
    kw = dict(d)
    if kw.get("fading") is not None:
        kw["fading"] = fading_config_from_dict(kw["fading"])
    return LteAirPhy(**kw, device=device)
