"""UE DL composite receiver: cell search → sync → demod → decode.

Port counterpart of ``srsran_4g_tpu/models/ue_dl.py`` (the reference's
`lib/src/phy/ue/{ue_sync.c,ue_cell_search.c,ue_dl.c}`): the FIND/TRACK loop
becomes a batched, feed-forward program — PSS matched filter over the
capture, CFO correction, subframe alignment by gather, OFDM demod, SSS/cell-id
resolution, then the PDSCH receiver of models/pdsch.py.  No step waits on
the host: the detected ids select among precomputed hypotheses by gather.
"""

from __future__ import annotations

import torch

from srsran_4g_tpu_torch.models import pdsch as pdsch_mod
from srsran_4g_tpu_torch.models import sync
from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig, _symbol_offsets, demodulate


def _take(samples: torch.Tensor, start: torch.Tensor, length: int) -> torch.Tensor:
    """samples[..., start + arange(length)] per row, indices clamped into the
    capture."""
    idx = start[..., None] + torch.arange(length, device=samples.device)
    return torch.gather(samples, -1, idx.clamp(0, samples.shape[-1] - 1))


def align_subframe(samples: torch.Tensor, pss_offset: torch.Tensor, cfg: OfdmConfig,
                   subframe_of_pss: int = 0) -> torch.Tensor:
    """Extract one aligned subframe given the detected PSS symbol start.

    PSS occupies the last symbol of slot 0, so the subframe starts at the PSS
    body start minus the offset of symbol 6's body.
    """
    del subframe_of_pss  # the PSS sits in the same symbol of subframes 0 and 5
    return _take(samples, pss_offset - int(_symbol_offsets(cfg)[6]), cfg.sf_len)


def cell_search(samples: torch.Tensor, nof_prb: int) -> dict:
    """Blind cell search over captures (B, n) of ≥ 1 subframe + sf_len samples.

    At 6 PRB, as in the JAX package, the CFO comes from the phase between
    the halves of the received PSS symbol (±1 subcarrier), and the whole
    capture is corrected before aligning.  Above 6 PRB the PSS symbol also
    carries PDSCH on the other subcarriers, which that estimate takes as
    part of the PSS (at 100 PRB it was off by up to 0.9 subcarrier, and the
    SSS then named the wrong cell); there the port aligns first, takes the
    CFO from the CP of the aligned subframe (±0.5 subcarrier; the
    reference's ue_sync tracks the CFO on the CP, cp.c) and corrects the
    subframe.  It also refines the timing there: the PSS occupies 62
    subcarriers, so its matched filter has a main lobe of ~N/62 samples and
    at 100 PRB the peak can land a sample off; the phase slope of the
    demodulated PSS (``sync.pss_timing_error``) gives the rest, and the
    subframe is aligned and demodulated again at the corrected offset.

    Returns dict(cell_id, n_id_2, n_id_1, phase, cfo, sf_samples, grid,
    pss_peak, offset): the JAX package's keys, and the PSS body start that
    the alignment used.
    """
    cfg = OfdmConfig(nof_prb=nof_prb)
    n = cfg.symbol_sz
    nsy = cfg.nsymb_slot
    mid = cfg.nre // 2

    found = sync.find_pss(samples, n)
    n_id_2, offset = found["n_id_2"], found["offset"]
    if nof_prb <= 6:
        cfo = sync.pss_cfo_estimate(_take(samples, offset, n), n_id_2, n)
        sf = align_subframe(sync.cfo_correct(samples, cfo, n), offset, cfg)
    else:
        sf = align_subframe(samples, offset, cfg)
        cfo = sync.cp_cfo_estimate(cfg, sf)
        coarse = demodulate(cfg, sync.cfo_correct(sf, cfo, n))
        err = sync.pss_timing_error(coarse[..., nsy - 1, mid - 31:mid + 31], n_id_2, n)
        offset = offset + torch.round(err).to(offset.dtype)
        sf = sync.cfo_correct(align_subframe(samples, offset, cfg), cfo, n)
    grid = demodulate(cfg, sf)

    sss_re = grid[..., nsy - 2, mid - 31:mid + 31]
    pss_re = grid[..., nsy - 1, mid - 31:mid + 31]
    # equalise the SSS by the channel seen on the PSS
    h_pss = pss_re * sync.pss_freq_refs(samples.device)[n_id_2].conj()
    sss_eq = sss_re * h_pss.conj() / torch.clamp(h_pss.abs() ** 2, min=1e-9)

    # sss_detect takes one n_id_2: run all three and select by gather
    outs = [sync.sss_detect(sss_eq, i) for i in range(3)]
    sel = n_id_2[..., None]
    n_id_1 = torch.gather(torch.stack([o["n_id_1"] for o in outs], -1), -1, sel)[..., 0]
    phase = torch.gather(torch.stack([o["phase"] for o in outs], -1), -1, sel)[..., 0]
    return dict(cell_id=3 * n_id_1 + n_id_2, n_id_2=n_id_2, n_id_1=n_id_1, phase=phase,
                cfo=cfo, sf_samples=sf, grid=grid, pss_peak=found["peak"],
                offset=offset)


def receive_pdsch_subframe(cfg: pdsch_mod.PdschConfig, samples: torch.Tensor,
                           n_iter: int = 5) -> dict:
    """Known-cell receive: OFDM demod + chest + PDSCH decode
    (srsran_ue_dl_decode_fft_estimate, ue_dl.c:349)."""
    grid = demodulate(OfdmConfig(nof_prb=cfg.cell.nof_prb), samples)
    return pdsch_mod.decode(cfg, grid, n_iter=n_iter)
