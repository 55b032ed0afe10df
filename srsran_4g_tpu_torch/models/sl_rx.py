"""Sidelink blind-search receiver: the counterpart of the reference's
`pssch_pscch_file_test.c` flow — OFDM demod, PSCCH blind search over the
resource pool, SCI unpack, then PSSCH decode at the SCI-indicated
allocation.

Port counterpart of ``srsran_4g_tpu/models/sl_rx.py``.  TM1/2 (36.213
§14.2.1.2): PSCCH PRB sweep over [prb_start, prb_end] on the pool's PSCCH
subframes, SCI format 0, PSSCH subframes gated by the time-resource pattern
with rv cycling 0,1,2,3.  TM3/4 (36.213 §14.1.1.4C): per-subchannel 2-PRB
PSCCH with a blind cyclic-shift search over {0,3,6,9}, SCI format 1,
adjacent PSSCH whose PRBs derive from the SCI RIV over subchannels.

Where the port differs in form (the events are the same):
- ``decode_capture`` demodulates every subframe of the capture in one
  gather and one FFT on the device before its loop (JAX: numpy, a symbol at
  a time, a subframe a loop pass).
- The PSCCH searches of all the subframes that carry one (TM3/4: every
  subframe; TM1/2: the pool's PSCCH subframes) run before the loop as one
  batch — every subframe × subchannel × cyclic shift (or × PRB) in one
  conv de-rate-match and one Viterbi (JAX: one Viterbi a subframe).  The
  search depends on nothing the loop changes, so each subframe's hypotheses
  are the ones JAX decodes, in JAX's order.  The per-subframe state machine
  (the TM1/2 SCI persisting across the period, ``allowed_pssch_sf_idx``,
  the subframe counters) and the PSSCH decodes stay in the loop, as JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from srsran_4g_tpu_torch.models import ra, ra_sl
from srsran_4g_tpu_torch.models import sidelink as SL
from srsran_4g_tpu_torch.models.pdsch import _on_device

# SL-SCH redundancy-version table (pssch.h:40 srsran_pssch_rv): the SCI
# retransmission index 0..3 maps to rate-matcher rv 0,2,3,1
PSSCH_RV = (0, 2, 3, 1)
CYCLIC_SHIFTS = (0, 3, 6, 9)


@dataclass
class SlPool:
    """Sidelink communication resource pool
    (`phy_common_sl.c:321` srsran_sl_comm_resource_pool_get_default_config).
    """
    nof_prb: int
    tm: int = 4
    period_length: int = 40
    prb_num: int = 0
    prb_start: int = 0
    prb_end: int = 0
    size_sub_channel: int = 10
    num_sub_channel: int = 5
    start_prb_sub_channel: int = 0
    pscch_sf_bitmap: np.ndarray = field(default_factory=lambda: np.zeros(0))
    pssch_sf_bitmap: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @classmethod
    def default(cls, nof_prb: int, tm: int = 4) -> "SlPool":
        p = cls(nof_prb=nof_prb, tm=tm)
        p.period_length = 160 if tm >= 3 else 40
        p.prb_num = math.ceil(nof_prb / 2)
        p.prb_start, p.prb_end = 0, nof_prb - 1
        p.pscch_sf_bitmap = np.zeros(p.period_length, np.int8)
        p.pscch_sf_bitmap[1:3] = 1
        p.pssch_sf_bitmap = np.zeros(p.period_length, np.int8)
        p.pssch_sf_bitmap[3:40] = 1
        if tm >= 3:
            if nof_prb == 6:
                p.size_sub_channel, p.num_sub_channel = 6, 1
            elif nof_prb in (15, 25, 75):
                p.size_sub_channel = 5
                p.num_sub_channel = nof_prb // 5
            elif nof_prb in (50, 100):
                p.size_sub_channel = 10
                p.num_sub_channel = nof_prb // 10
            else:
                raise ValueError(f"no default TM4 pool for {nof_prb} PRB")
        return p


def _batched_equalize(grid: torch.Tensor, dmrs: torch.Tensor, ks: torch.Tensor,
                      dmrs_syms, data_syms, noise_var: float) -> torch.Tensor:
    """LS at the DMRS symbols + linear time interpolation, batched over
    subframes and hypotheses.  grid (S, 14, nre); dmrs (H, D, m_sc); ks
    (H, m_sc) RE index per hypothesis → (S·H, len(data_syms), m_sc)
    equalized symbols (final guard symbol zeroed)."""
    s, h = grid.shape[0], ks.shape[0]
    g = grid[:, :, ks].permute(0, 2, 1, 3).reshape(s * h, 14, ks.shape[1])
    dm = dmrs.repeat(s, 1, 1)
    return SL._interp_equalize(g, dm, dmrs_syms, data_syms, noise_var)


def _ok_hyps(bits: np.ndarray, ok: np.ndarray, n: int) -> list[int]:
    """Indices of the CRC-passing hypotheses, all-zero payloads rejected (an
    empty resource yields zero LLRs whose all-zero decode trivially passes
    CRC; sci.c:107-116, 145-167)."""
    return [i for i in range(len(ok)) if ok[i] and bits[i, :n].any()]


def pscch34_search(grids: torch.Tensor, pool: SlPool, noise_var: float = 1e-2
                   ) -> list[list[dict]]:
    """TM3/4 PSCCH blind search of S subframes (S, 14, nre) over
    (subchannel × cyclic shift), all S·H hypotheses in one Viterbi → for
    each subframe, the list of dicts of its CRC-passing hypotheses."""
    dev = grids.device
    m_sc = SL.PSCCH34_NOF_PRB * 12
    hyp = [(s, cs) for s in range(pool.num_sub_channel) for cs in CYCLIC_SHIFTS]
    ks = torch.as_tensor(np.stack([np.arange(m_sc) + pool.size_sub_channel * s * 12
                                   for s, _ in hyp]), device=dev)
    dmrs = torch.as_tensor(np.stack([np.tile(SL._pscch34_dmrs(cs)[None], (4, 1))
                                     for _, cs in hyp]), device=dev)
    eq = _batched_equalize(grids, dmrs, ks, SL.SL34_DMRS_SYMS, SL.SL34_DATA_SYMS, noise_var)
    bits, ok = SL._viterbi_crc(SL.pscch34_llrs(eq, noise_var), SL.SCI1_LEN + SL.SCI_CRC_LEN)
    n_x = SL._crc_value(bits).cpu().numpy()
    bits, ok = bits.cpu().numpy(), ok.cpu().numpy()
    out = []
    for sf in range(grids.shape[0]):
        lo = sf * len(hyp)
        out.append([dict(sub_channel=hyp[i][0], cyclic_shift=hyp[i][1],
                         bits=bits[lo + i, :SL.SCI1_LEN], n_x_id=int(n_x[lo + i]))
                    for i in _ok_hyps(bits[lo:lo + len(hyp)], ok[lo:lo + len(hyp)],
                                      SL.SCI1_LEN)])
    return out


def pscch34_blind(grid: torch.Tensor, pool: SlPool, noise_var: float = 1e-2) -> list[dict]:
    """TM3/4 PSCCH blind search of one subframe grid (14, nre) over
    (subchannel × cyclic shift) as one batch → list of dicts for each
    CRC-passing hypothesis."""
    return pscch34_search(grid[None], pool, noise_var)[0]


def _pscch12_prbs(pool: SlPool) -> list[int]:
    """The TM1/2 PSCCH PRB sweep (36.213 §14.2.1.2 pool geometry, incl. the
    upper-half jump of `pssch_pscch_file_test.c:306-311`)."""
    prbs, p = [], pool.prb_start
    while p <= pool.prb_end:
        prbs.append(p)
        if (pool.prb_num * 2) <= (pool.prb_end - pool.prb_start + 1) and \
                p + 1 == pool.prb_start + pool.prb_num:
            p = pool.prb_end - pool.prb_num
        p += 1
    return prbs


def pscch12_search(grids: torch.Tensor, pool: SlPool, noise_var: float = 1e-2
                   ) -> list[list[dict]]:
    """TM1/2 PSCCH blind PRB sweep of S subframes, all S·H hypotheses in one
    Viterbi → for each subframe, the list of its CRC-passing hypotheses."""
    dev = grids.device
    prbs = _pscch12_prbs(pool)
    m_sc = 12
    e = len(SL.SL_DATA_SYMS) * m_sc * 2
    ks = torch.as_tensor(np.stack([np.arange(m_sc) + prb * 12 for prb in prbs]), device=dev)
    dmrs = torch.as_tensor(np.tile(SL._sl_dmrs(0, m_sc)[None], (len(prbs), 1, 1)), device=dev)
    eq = _batched_equalize(grids, dmrs, ks, SL.SL_DMRS_SYMS, SL.SL_DATA_SYMS, noise_var)
    llr = SL._sc_fdma_llrs(eq, "qpsk", noise_var, 2 * m_sc)
    llr = llr * SL._sign_t(SL.PSCCH_SCRAMBLING_SEED, e, dev)
    llr = llr[..., SL._perms_t(e, 2, False, dev)[1]]
    sci_len = SL.SciFormat0(riv=0).pack(pool.nof_prb).shape[-1]
    bits, ok = SL._viterbi_crc(llr, sci_len + SL.SCI_CRC_LEN)
    bits, ok = bits.cpu().numpy(), ok.cpu().numpy()
    out = []
    for sf in range(grids.shape[0]):
        lo = sf * len(prbs)
        out.append([dict(prb=prbs[i], bits=bits[lo + i, :sci_len])
                    for i in _ok_hyps(bits[lo:lo + len(prbs)], ok[lo:lo + len(prbs)],
                                      sci_len)])
    return out


def pscch12_blind(grid: torch.Tensor, pool: SlPool, noise_var: float = 1e-2) -> list[dict]:
    """TM1/2 PSCCH blind PRB sweep of one subframe grid (14, nre)."""
    return pscch12_search(grid[None], pool, noise_var)[0]


def decode_capture(samples, nof_prb: int, tm: int, symbol_sz: int,
                   pool: SlPool | None = None, first_sf_idx: int = 0,
                   file_offset: int = 0, max_subframes: int = 128,
                   noise_var: float = 1e-2,
                   device: torch.device | str | None = None) -> dict:
    """Run the full blind-decode loop over a raw IQ capture (L,).  A tensor
    keeps its device; other input goes to ``device`` (default CUDA).

    Returns dict(num_decoded_sci, num_decoded_tb, events) where events
    carries one entry per decoded SCI with its unpacked fields and the
    PSSCH outcome — the counters match `pssch_pscch_file_test.c:440`'s
    printed pass criteria."""
    samples = _on_device(samples, device)
    pool = pool or SlPool.default(nof_prb, tm)
    sf_len = symbol_sz * 15
    samples = samples[file_offset:]
    # a trailing partial subframe is zero-padded and still processed, like
    # the reference's short-read path (pssch_pscch_file_test.c:276-279)
    if samples.shape[0] % sf_len:
        samples = torch.cat([samples, samples.new_zeros(sf_len - samples.shape[0] % sf_len)])
    nsf = min(samples.shape[0] // sf_len, max_subframes)
    grids = SL.sl_subframe_grid(samples[:nsf * sf_len].reshape(nsf, sf_len), nof_prb,
                                symbol_sz)
    if tm in (1, 2):
        pscch_sfs = [sf for sf in range(nsf)
                     if pool.pscch_sf_bitmap[sf % pool.period_length]]
        found = dict(zip(pscch_sfs, pscch12_search(grids[pscch_sfs], pool, noise_var)
                         if pscch_sfs else []))
    else:
        found = dict(enumerate(pscch34_search(grids, pool, noise_var)))
    num_sci = num_tb = 0
    events = []
    current_sf_idx = first_sf_idx
    period_sf_idx = 0
    allowed_pssch_sf_idx = 0
    sci0_state = None  # TM1/2: last decoded SCI persists across the period
    for sf in range(nsf):
        grid = grids[sf:sf + 1]
        if tm in (1, 2):
            if pool.pscch_sf_bitmap[period_sf_idx % pool.period_length]:
                for h in found[sf]:
                    sci = SL.SciFormat0.unpack(h["bits"], pool.nof_prb)
                    if sci.mcs >= 29:  # sci.c:132 sanity check
                        continue
                    num_sci += 1
                    sci0_state = sci
                    events.append(dict(sf=sf, sci=sci, prb=h["prb"]))
            if pool.pssch_sf_bitmap[period_sf_idx % pool.period_length] \
                    and sci0_state is not None:
                sci = sci0_state
                if ra_sl.pssch_allowed_sf(current_sf_idx, sci.trp):
                    rv = allowed_pssch_sf_idx % 4
                    l_crb, prb0 = ra.riv_decode(nof_prb, sci.riv)
                    # TM1/2 n_X_ID is the SCI's 8-bit N_sa_id field
                    # (pssch_pscch_file_test.c:325 N_x_id = sci.N_sa_id)
                    mod = ra.ul_mcs_to_mod(sci.mcs)
                    tbs = ra.tbs_from_itbs(ra.ul_mcs_to_itbs(sci.mcs), l_crb)
                    cfg = SL.PsschConfig(
                        tbs=tbs, nof_prb_cell=nof_prb, prb_start=prb0, nof_prb=l_crb, mod=mod,
                        n_x_id=sci.group_dst_id, sf_idx=current_sf_idx, rv=PSSCH_RV[rv])
                    ok = bool(SL.pssch_decode(cfg, grid, noise_var)["crc_ok"][0])
                    num_tb += int(ok)
                    events.append(dict(sf=sf, pssch=True, crc_ok=ok, tbs=tbs, rv=rv))
                    allowed_pssch_sf_idx += 1
                current_sf_idx += 1
        else:
            for h in found[sf]:
                sci = SL.SciFormat1.unpack(h["bits"], pool.num_sub_channel)
                if sci.mcs >= 29:  # sci.c:165 sanity check
                    continue
                num_sci += 1
                ps, nprb = SL.pssch34_prbs(
                    h["sub_channel"], sci.riv, pool.size_sub_channel,
                    pool.num_sub_channel, pool.start_prb_sub_channel)
                rv_idx = 1 if sci.retransmission else 0
                out = SL.pssch34_decode(grid, ps, nprb, h["n_x_id"], sci.mcs,
                                        PSSCH_RV[rv_idx], current_sf_idx, noise_var)
                ok = bool(out["crc_ok"][0])
                num_tb += int(ok)
                events.append(dict(sf=sf, sci=sci, crc_ok=ok, tbs=int(out["tbs"]),
                                   mcs=sci.mcs, sub_channel=h["sub_channel"]))
            current_sf_idx = (current_sf_idx + 1) % 10
        period_sf_idx += 1
    return dict(num_decoded_sci=num_sci, num_decoded_tb=num_tb, events=events)
