"""NR CSI-RS generation + CSI measurement/reporting (TS 38.211 7.4.1.5,
TS 38.214 5.2).

Port counterpart of ``srsran_4g_tpu/models/csi_nr.py`` (the reference's
`lib/src/phy/ch_estimation/csi_rs.c` and `lib/src/phy/phch/csi.c`): NZP
CSI-RS (row-1, single port: one RE per PRB per configured symbol, density 3
simplified to 1), channel/SINR measurement on the CSI-RS REs, and the CQI/RI
wideband report (the LTE SNR->CQI map).  The measurement runs on the device
over a batch of slots; the CQI map is the host table of ``models/cqi``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.models import cqi as cqi_mod
from srsran_4g_tpu_torch.models import grid_nr
from srsran_4g_tpu_torch.ops import sequence

NRE = 12


@dataclass(frozen=True)
class CsiRsConfig:
    carrier: grid_nr.NrCarrierConfig
    symbol: int = 4
    subcarrier_offset: int = 0   # k0 within each PRB
    slot: int = 0
    scrambling_id: int = 0

    @functools.cached_property
    def re_indices(self) -> np.ndarray:
        return (self.subcarrier_offset
                + NRE * np.arange(self.carrier.nof_prb)).astype(np.int32)


@functools.lru_cache(maxsize=128)
def _csi_rs_seq(nof_prb: int, slot: int, symbol: int, scrambling_id: int) -> np.ndarray:
    cinit = ((1 << 10) * (grid_nr.NSYMB * slot + symbol + 1)
             * (2 * scrambling_id + 1) + scrambling_id) % (1 << 31)
    c = sequence.gold_sequence_np(cinit, 2 * nof_prb).astype(np.float32)
    r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)
    return r.astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _tables(cfg: CsiRsConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    r = _csi_rs_seq(cfg.carrier.nof_prb, cfg.slot, cfg.symbol, cfg.scrambling_id)
    return (torch.as_tensor(cfg.re_indices.astype(np.int64), device=device),
            torch.as_tensor(r, device=device))


def put_csi_rs(cfg: CsiRsConfig, grid: torch.Tensor) -> torch.Tensor:
    """Insert NZP CSI-RS into a (B, 14, nre) slot grid (a new tensor)."""
    ks, r = _tables(cfg, grid.device)
    out = grid.clone()
    out[:, cfg.symbol, ks] = r
    return out


def measure(cfg: CsiRsConfig, rx_grid: torch.Tensor) -> dict:
    """CSI measurement on the CSI-RS REs: RSRP, noise, SINR (csi_rs.c
    srsran_csi_rs_nzp_measure)."""
    ks, r = _tables(cfg, rx_grid.device)
    h_ls = rx_grid[:, cfg.symbol, ks] * r.conj()
    h_avg = h_ls.mean(dim=-1, keepdim=True)
    rsrp = (h_ls.abs() ** 2).mean(dim=-1)
    noise = ((h_ls - h_avg).abs() ** 2).mean(dim=-1) + 1e-12
    sinr_db = 10.0 * torch.log10((rsrp - noise).clamp(min=1e-12) / noise)
    return dict(rsrp=rsrp, noise_var=noise, sinr_db=sinr_db)


def generate_report(sinr_db: torch.Tensor) -> dict:
    """Wideband CSI report (38.214 5.2.2): CQI from SINR, RI=1, PMI=0 for
    the single-port row-1 resource; on the device of ``sinr_db``."""
    cqi = torch.as_tensor(cqi_mod.cqi_from_snr(sinr_db.cpu().numpy()), device=sinr_db.device)
    return dict(cqi=cqi, ri=torch.ones_like(cqi), pmi=torch.zeros_like(cqi))
