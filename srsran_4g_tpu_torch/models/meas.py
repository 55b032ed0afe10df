"""Neighbour-cell search and measurement + UL power control.

Port counterpart of ``srsran_4g_tpu/models/meas.py`` (the reference's
`srsue/src/phy/scell/scell_recv.cc` find_cells, `intra_measure_lte.cc` +
`lib/src/phy/sync/refsignal_dl_sync.c` CRS measurement of a known PCI, and
`lib/src/phy/ue/ue_ul.c:354-433` TS 36.213 §5.1 power control).

The neighbour search correlates all three PSS roots in one batched FFT
matched filter (``sync.find_pss``'s (B, 3, N) surface, keeping the per-root
peaks) and walks that surface on the host after one device-to-host copy;
CRS measurement is a gather and means over the pilot lattice.  Power control
is host-side scalar math.

At 6 PRB the port follows the JAX package exactly.  Above 6 PRB a neighbour's
PSS and SSS share their symbols with the serving cell's PDSCH on the same
subcarriers: a neighbour 6 dB weaker than a fully loaded serving cell sees
-6 dB on its sync signals, and the JAX package's single-capture search did
not reliably find one at 100 PRB.  There the port deviates in three ways:

- the CFO comes from the cyclic-prefix correlation of the whole capture
  (x*(t)·x(t+N) summed over every t: the CP of every symbol of every cell
  adds up, the rest averages out), not from the halves of the candidate's
  PSS symbol, which also carries the serving cell's subcarriers.  Every cell
  on the carrier shares the UE's oscillator offset, and a neighbour's own CP
  is too weak: the CP estimate of a subframe aligned at a neighbour 6 dB
  under a loaded serving cell was off by up to half a subcarrier;
- the PSS correlation surface is folded over the capture's whole
  half-frames (the root mean square of |corr| at the same position in each
  5 ms; a cell sends its PSS once per half-frame), so the interference
  averages down before the peak/RMS test; a capture shorter than two
  half-frames is not folded;
- the SSS of each half-frame is equalised by the PSS channel averaged over
  its 62 subcarriers (per-subcarrier zero forcing divides by estimates the
  interference dominates), and the 336 correlations of the half-frames are
  summed, sf0/sf5 hypotheses swapped on every second half-frame.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from srsran_4g_tpu_torch.models import grid as G, sync, ue_dl
from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig, demodulate

PSS_THRESHOLD = 2.0  # peak/RMS, scell_recv.cc:53


# --- neighbour-cell search (scell_recv.find_cells) ----------------------------

def find_neighbour_cells(samples: torch.Tensor, nof_prb: int,
                         serving_cell_id: int | None = None,
                         threshold: float = PSS_THRESHOLD) -> list[dict]:
    """Search a capture (B=1, N) for neighbour cells: per-N_ID_2 PSS peaks
    above `threshold` (peak/RMS of the correlation surface), each confirmed
    and completed by SSS (above 6 PRB as the module docstring says).

    Returns a list of dicts (cell_id, n_id_2, offset, peak_ratio, phase,
    cfo), excluding `serving_cell_id`, strongest first."""
    cfg = OfdmConfig(nof_prb=nof_prb)
    n = cfg.symbol_sz
    corr = sync.find_pss(samples, n)["corr"][0]  # (3, N)
    half_frame = 5 * cfg.sf_len
    n_half = samples.shape[-1] // half_frame if nof_prb > 6 else 0
    if n_half >= 2:
        corr = corr[:, :n_half * half_frame].reshape(3, n_half, half_frame)
        corr = torch.sqrt(torch.mean(corr ** 2, dim=1))
    corr_np = corr.cpu().numpy()  # the one copy of the surface to the host
    cells: list[dict] = []
    for n_id_2 in range(3):
        c = corr_np[n_id_2]
        peak_idx = int(np.argmax(c))
        rms = float(np.sqrt(np.mean(c ** 2)) + 1e-12)
        ratio = float(c[peak_idx]) / rms
        if ratio < threshold:
            continue
        if nof_prb <= 6:
            out, cfo = _sss_6prb(samples, cfg, peak_idx, n_id_2)
        else:
            out, cfo = _sss_wide(samples, cfg, peak_idx, n_id_2, max(n_half, 1))
        # SSS confirmation (scell_recv's sss threshold): the winning
        # hypothesis must stand out from the 336-candidate noise floor
        sss_corr = out["corr"][0].abs()
        sss_max, sss_mean, n_id_1, phase, cfo_v = torch.stack([
            sss_corr.max().double(), sss_corr.mean().double(), out["n_id_1"][0].double(),
            out["phase"][0].double(), cfo.double()]).tolist()
        if sss_max / (sss_mean + 1e-12) < 3.0:
            continue
        cell_id = 3 * int(n_id_1) + n_id_2
        if cell_id == serving_cell_id:
            continue
        cells.append(dict(cell_id=cell_id, n_id_2=n_id_2, offset=peak_idx,
                          peak_ratio=ratio, phase=int(phase), cfo=cfo_v))
    return sorted(cells, key=lambda c: -c["peak_ratio"])


def _centre62(g: torch.Tensor, symbol: int) -> torch.Tensor:
    mid = g.shape[-1] // 2
    return g[..., symbol, mid - 31:mid + 31]


def _sss_6prb(samples: torch.Tensor, cfg: OfdmConfig, peak_idx: int, n_id_2: int):
    """The JAX package's SSS step: CFO from the PSS halves, the capture
    corrected and aligned at the peak, the SSS zero-forced by the PSS channel
    per subcarrier.  Returns (sss_detect's dict, CFO (,))."""
    n, nsy = cfg.symbol_sz, cfg.nsymb_slot
    off = torch.tensor([peak_idx], device=samples.device)
    cfo = sync.pss_cfo_estimate(ue_dl._take(samples, off, n), n_id_2, n)
    g = demodulate(cfg, ue_dl.align_subframe(sync.cfo_correct(samples, cfo, n), off, cfg))
    h_pss = _centre62(g, nsy - 1) * sync.pss_freq_refs(samples.device)[n_id_2].conj()
    sss_eq = _centre62(g, nsy - 2) * h_pss.conj() / torch.clamp(h_pss.abs() ** 2, min=1e-9)
    return sync.sss_detect(sss_eq, n_id_2), cfo[0]


def _sss_wide(samples: torch.Tensor, cfg: OfdmConfig, peak_idx: int, n_id_2: int,
              n_half: int):
    """Above 6 PRB: the subframe at the peak in each of ``n_half``
    half-frames, corrected by the capture's CFO, its SSS equalised by the PSS channel
    averaged over the 62 subcarriers, the correlations summed over the
    half-frames (sf0/sf5 swapped on odd ones).  Returns (a dict as
    sss_detect's, with the first half-frame's phase; the CFO (,))."""
    n, nsy = cfg.symbol_sz, cfg.nsymb_slot
    dev = samples.device
    offs = peak_idx + 5 * cfg.sf_len * torch.arange(n_half, device=dev)
    sf = ue_dl.align_subframe(samples.expand(n_half, -1), offs, cfg)
    z = torch.sum(samples[0, :-n].conj() * samples[0, n:])
    cfo = (torch.angle(z) / (2 * math.pi)).expand(n_half)
    g = demodulate(cfg, sync.cfo_correct(sf, cfo, n))
    h = torch.mean(_centre62(g, nsy - 1) * sync.pss_freq_refs(dev)[n_id_2].conj(), dim=-1,
                   keepdim=True)
    corr = sync.sss_detect(_centre62(g, nsy - 2) * h.conj() / torch.clamp(h.abs() ** 2, min=1e-9),
                           n_id_2)["corr"].reshape(n_half, 168, 2)
    corr[1::2] = corr[1::2].flip(-1)
    corr = corr.sum(dim=0).reshape(1, 336)
    best = torch.argmax(corr, dim=-1)
    return dict(n_id_1=best // 2, phase=best % 2, corr=corr), cfo[0]


# --- CRS-based cell measurement (intra_measure / refsignal_dl_sync) ----------

def measure_cell(rx_grid: torch.Tensor, cell: G.CellConfig, subframe: int) -> dict:
    """RSRP / RSSI / RSRQ / SNR / CFO of a known PCI from one aligned
    subframe grid (B, 14, nre) — TS 36.214 §5.1.1/5.1.3 definitions.

    CFO is estimated from the CRS phase rotation between the two slots
    (0.5 ms apart ⇒ ±1 kHz unambiguous).
    """
    dev = rx_grid.device
    ls, ks = G.crs_pattern(cell, 0)
    vals = torch.as_tensor(G.crs_values(cell, 0, subframe), device=dev)
    ls_t = torch.as_tensor(ls, device=dev)
    y = rx_grid[..., ls_t[:, None], torch.as_tensor(ks, device=dev)]
    h_ls = y * vals.conj()  # (B, S, P)

    rsrp = torch.mean(torch.mean(h_ls, dim=-1).abs() ** 2, dim=-1)
    # RSSI per TS 36.214: total power over CRS-bearing symbols, whole band
    rssi = torch.mean(rx_grid[..., ls_t, :].abs() ** 2, dim=(-1, -2)) * cell.nre
    rsrq = cell.nof_prb * rsrp / torch.clamp(rssi, min=1e-12)

    # noise: residual after removing the per-symbol mean channel
    resid = h_ls - torch.mean(h_ls, dim=-1, keepdim=True)
    noise = torch.mean(resid.abs() ** 2, dim=(-1, -2))
    snr_db = 10.0 * torch.log10(torch.clamp(rsrp, min=1e-12) / torch.clamp(noise, min=1e-12))

    # CFO from slot-0 ↔ slot-1 CRS phase drift (symbols 0 and 7)
    half = len(ls) // 2
    z = torch.sum(h_ls[..., half:, :] * h_ls[..., :half, :].conj(), dim=(-1, -2))
    cfo_hz = torch.angle(z) / (2.0 * math.pi * 0.5e-3)

    return dict(
        rsrp=rsrp.to(torch.float32),
        rsrp_dbfs=10.0 * torch.log10(torch.clamp(rsrp, min=1e-12)),
        rssi=rssi.to(torch.float32),
        rsrq_db=10.0 * torch.log10(torch.clamp(rsrq, min=1e-12)),
        snr_db=snr_db.to(torch.float32),
        cfo_hz=cfo_hz.to(torch.float32),
    )


# --- UL power control (TS 36.213 §5.1, ue_ul.c:354-433) -----------------------

PC_MAX_DBM = 23.0  # class-3 UE


@dataclass
class PowerCtrlConfig:
    p0_nominal_pusch: float = -85.0
    p0_ue_pusch: float = 0.0
    alpha: float = 0.8
    p0_nominal_pucch: float = -107.0
    p0_ue_pucch: float = 0.0
    delta_f_pucch: tuple = (0.0, 0.0, 1.0, 0.0, 0.0)  # F1,F1a/b,F2,F2a,F2b
    delta_preamble_msg3: float = 6.0
    p_srs_offset: float = 0.0
    accumulation_enabled: bool = True


@dataclass
class PowerCtrlState:
    """Closed-loop accumulators f(i)/g(i) driven by TPC commands."""
    cfg: PowerCtrlConfig = field(default_factory=PowerCtrlConfig)
    f_pusch: float = 0.0
    g_pucch: float = 0.0

    TPC_DB = {0: -1.0, 1: 0.0, 2: 1.0, 3: 3.0}

    def apply_tpc_pusch(self, tpc: int) -> None:
        d = self.TPC_DB[tpc]
        self.f_pusch = self.f_pusch + d if self.cfg.accumulation_enabled else d

    def apply_tpc_pucch(self, tpc: int) -> None:
        self.g_pucch += self.TPC_DB[tpc]

    def pusch_power(self, n_prb: int, pathloss_db: float,
                    p0_preamble: float | None = None) -> float:
        """P_PUSCH = min(Pcmax, 10log10(M) + P0 + α·PL + f) — 36.213
        5.1.1.1; msg3 uses preamble P0 + delta_preamble_msg3 and α=1."""
        if p0_preamble is not None:
            p0 = p0_preamble + self.cfg.delta_preamble_msg3
            alpha = 1.0
        else:
            p0 = self.cfg.p0_nominal_pusch + self.cfg.p0_ue_pusch
            alpha = self.cfg.alpha
        p = 10.0 * np.log10(n_prb) + p0 + alpha * pathloss_db + self.f_pusch
        return float(min(PC_MAX_DBM, p))

    def pucch_power(self, pathloss_db: float, fmt: str = "1",
                    n_cqi: int = 0, n_harq: int = 0) -> float:
        """P_PUCCH = min(Pcmax, P0 + PL + h(n) + ΔF + g) — 36.213 5.1.2.1."""
        fmt_idx = {"1": 0, "1a": 1, "1b": 1, "2": 2, "2a": 3, "2b": 4}[fmt]
        delta_f = self.cfg.delta_f_pucch[fmt_idx]
        if fmt in ("1", "1a", "1b"):
            h = 0.0
        else:
            h = 10.0 * np.log10(n_cqi / 4.0) if n_cqi >= 4 else 0.0
        p0 = self.cfg.p0_nominal_pucch + self.cfg.p0_ue_pucch
        p = p0 + pathloss_db + h + delta_f + self.g_pucch
        return float(min(PC_MAX_DBM, p))

    def srs_power(self, n_prb: int, pathloss_db: float) -> float:
        """P_SRS = min(Pcmax, P_SRS_OFFSET + 10log10(M) + P0 + α·PL + f)."""
        p0 = self.cfg.p0_nominal_pusch + self.cfg.p0_ue_pusch
        p = (self.cfg.p_srs_offset + 10.0 * np.log10(n_prb) + p0
             + self.cfg.alpha * pathloss_db + self.f_pusch)
        return float(min(PC_MAX_DBM, p))
