"""UE synchronisation FSM: FIND -> TRACK with CFO/timing loops + MIB.

Port counterpart of ``srsran_4g_tpu/models/ue_sync.py`` (the reference's
`lib/src/phy/ue/ue_sync.c` srsran_ue_sync_zerocopy FIND/TRACK state
machine, `ue/ue_cell_search.c`, `ue/ue_mib.c`, and the UE sync thread of
`srsue/src/phy/sync.cc`).  The host FSM holds only Python scalars (state,
subframe counters, CFO accumulator); each call hands one subframe's samples
to the batched find/track tensor programs and reads back one scalar (the
PSS peak) per subframe that decides the next state, plus the values the
state keeps.

Two deviations from the JAX FSM, above 6 PRB only; at 6 PRB the port
follows the JAX FSM exactly.  Above 6 PRB the PSS symbol also carries PDSCH
on the other subcarriers, so

- TRACK takes its CFO update from the cyclic prefix of the subframe aligned
  at the PSS it found (``sync.cp_cfo_estimate``), not from the halves of the
  received PSS symbol, which that estimate takes as part of the PSS (the
  port's ``cell_search`` makes the same choice for FIND);
- the PSS peak that FIND and TRACK hold against their thresholds (0.5 and
  0.3, set for 6 PRB) is measured on the samples low-passed to 1.92 Msps
  (``resampling.resample_fft``, the centre 128 subcarriers), where the PSS
  holds about half the energy as at 6 PRB it holds most of it.  On the full
  band the matched filter's normalised peak is about sqrt(62/1200) = 0.23 at
  100 PRB even for a clean signal, so the JAX thresholds never pass there.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from srsran_4g_tpu_torch.models import chest, pbch, sync, ue_dl
from srsran_4g_tpu_torch.models import grid as G
from srsran_4g_tpu_torch.ops import ofdm, resampling
from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig

PEAK_SYMBOL_SZ = 128  # the FFT size at 1.92 Msps, where the PSS peak is measured

FIND, TRACK = "FIND", "TRACK"


@dataclass
class UeSyncState:
    state: str = FIND
    sf_idx: int = 0            # 0..9 within the radio frame
    sfn: int = 0
    cell_id: int = -1
    cfo_hz_acc: float = 0.0    # integrated CFO (subcarrier units)
    sample_offset: int = 0
    out_of_sync_count: int = 0
    frames_tracked: int = 0


def _scalars(*xs: torch.Tensor) -> list[float]:
    """The first element of each (B,) tensor, in one device-to-host read."""
    return torch.stack([x[0].to(torch.float64) for x in xs]).tolist()


class UeSync:
    """Per-subframe state machine (the srsran_ue_sync_zerocopy equivalent).

    FIND does not advance the subframe counter: the subframe it found comes
    back as ``sf_samples`` (and its PSS body start in the capture as
    ``offset``, a port addition), and the next call is taken to be that
    subframe again.  ``state`` may be a ``UeSyncState`` taken over from
    another FSM (``convert.ue_sync_state_from_dict``)."""

    PSS_THRESHOLD = 0.5
    CFO_ALPHA = 0.2            # CFO loop gain (ue_sync.c CFO EMA)

    def __init__(self, nof_prb: int, state: UeSyncState | None = None) -> None:
        self.cfg = OfdmConfig(nof_prb=nof_prb)
        self.nof_prb = nof_prb
        self.s = state if state is not None else UeSyncState()

    @property
    def sf_len(self) -> int:
        return self.cfg.sf_len

    def radio_error(self) -> None:
        """RF error callback → immediate resync (an overflow, underflow or
        late burst invalidates the sample timeline)."""
        self.s.state = FIND
        self.s.out_of_sync_count = 0

    def _peak(self, samples: torch.Tensor, found: dict, key: str) -> torch.Tensor:
        """The PSS peak (B,) to hold against the thresholds: ``found[key]``
        at 6 PRB, else the peak on the samples low-passed to 1.92 Msps (see
        the module docstring)."""
        factor = self.cfg.symbol_sz // PEAK_SYMBOL_SZ
        if self.nof_prb <= 6 or factor <= 1:
            return found[key]
        low = resampling.resample_fft(samples, 1, factor)
        return sync.find_pss(low, PEAK_SYMBOL_SZ)["peak"]

    def _track_cfo(self, corr: torch.Tensor, found: dict) -> torch.Tensor:
        """The CFO left after correction (B,), in subcarriers (see the
        module docstring for the choice above 6 PRB)."""
        n = self.cfg.symbol_sz
        if self.nof_prb <= 6:
            pss = ue_dl._take(corr, found["offset"], n)
            return sync.pss_cfo_estimate(pss, found["n_id_2"], n)
        return sync.cp_cfo_estimate(self.cfg, ue_dl.align_subframe(corr, found["offset"],
                                                                   self.cfg))

    def zerocopy(self, samples: torch.Tensor) -> dict:
        """Process one subframe-or-more of samples; returns a status dict
        with 'in_sync', and the CFO-corrected samples when tracking."""
        if self.s.state == FIND:
            found = ue_dl.cell_search(samples[None], self.nof_prb)
            # one read of the four scalars (the float32 CFO is exact in float64)
            peak, cell_id, cfo, phase = _scalars(
                self._peak(samples[None], found, "pss_peak"), found["cell_id"], found["cfo"],
                found["phase"])
            if peak < self.PSS_THRESHOLD:
                return dict(in_sync=False, state=FIND, peak=peak)
            self.s.cell_id = int(cell_id)
            self.s.cfo_hz_acc = cfo
            # PSS sits in the last symbol of slot 0 -> subframe 0 or 5
            self.s.sf_idx = 0 if int(phase) == 0 else 5
            self.s.state = TRACK
            self.s.out_of_sync_count = 0
            return dict(in_sync=True, state=TRACK, cell_id=self.s.cell_id, peak=peak,
                        sf_samples=found["sf_samples"][0], offset=found["offset"][0])
        # TRACK: correct CFO, verify PSS at the expected position
        corr = sync.cfo_correct(samples[None], [self.s.cfo_hz_acc], self.cfg.symbol_sz)
        if self.s.sf_idx in (0, 5):
            found = sync.find_pss(corr, self.cfg.symbol_sz)
            # the CFO is estimated whether or not the peak passes, so that
            # the subframe costs one read
            peak, cfo_new = _scalars(self._peak(corr, found, "peak"),
                                     self._track_cfo(corr, found))
            if peak < self.PSS_THRESHOLD * 0.6:
                self.s.out_of_sync_count += 1
                if self.s.out_of_sync_count > 5:
                    self.s.state = FIND  # resync (radio_error recovery)
                in_sync = False
            else:
                self.s.out_of_sync_count = 0
                self.s.cfo_hz_acc += self.CFO_ALPHA * cfo_new
                in_sync = True
        else:
            in_sync = True
        out = dict(in_sync=in_sync, state=self.s.state, sf_idx=self.s.sf_idx,
                   sfn=self.s.sfn, sf_samples=corr[0])
        self.s.sf_idx = (self.s.sf_idx + 1) % 10
        if self.s.sf_idx == 0:
            self.s.sfn = (self.s.sfn + 1) % 1024
            self.s.frames_tracked += 1
        return out


def decode_mib(cell_id: int, sf_samples: torch.Tensor) -> dict:
    """ue_mib.c: OFDM-demodulate subframe 0, CRS-estimate the channel over
    the centre 6 PRB and decode the PBCH.

    ``sf_samples`` (B, sf_len) is one subframe at the rate of any LTE
    bandwidth, told by its length: at 1.92 Msps (6 PRB) exactly as the JAX
    package does; at a wider bandwidth the port demodulates at that
    bandwidth and keeps the centre 72 subcarriers, which carry the same PBCH
    and CRS values as a 6 PRB cell (the JAX package demodulates every input
    as 6 PRB)."""
    by_len = {OfdmConfig(nof_prb=p).sf_len: p for p in (6, 15, 25, 50, 75, 100)}
    nof_prb = by_len.get(sf_samples.shape[-1])
    if nof_prb is None:
        raise ValueError(f"{sf_samples.shape[-1]} samples are not one subframe of an LTE "
                         f"bandwidth ({sorted(by_len)})")
    grid_rx = ofdm.demodulate(OfdmConfig(nof_prb=nof_prb), sf_samples)
    if nof_prb != 6:
        mid = grid_rx.shape[-1] // 2
        grid_rx = grid_rx[..., mid - 36:mid + 36]
    cell = G.CellConfig(nof_prb=6, cell_id=cell_id, cfi=1)
    est = chest.estimate(chest.ChestConfig(cell=cell), grid_rx, 0)
    return pbch.decode(cell, grid_rx, est["h"], est["noise_var"])
