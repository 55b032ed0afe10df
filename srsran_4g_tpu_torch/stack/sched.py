"""eNB MAC downlink scheduler with RR / proportional-fair policies.

Counterpart of the reference's `srsenb/src/stack/mac/sched*.cc`
(SURVEY.md §2.5): per-UE state (CQI → MCS, 8 HARQ processes, buffer
occupancy), a per-TTI PRB resource grid, pluggable time-domain policies
(round-robin `sched_time_rr.cc`, proportional-fair `sched_time_pf.cc`),
and the FAPI-like `get_dl_sched(tti)` contract the PHY pulls grants from
(srsenb mac.cc:639).

This is deliberately host-side Python: scheduling is branchy control-plane
logic, not a TPU kernel (SURVEY §7.11).  The produced grants carry the
exact (mcs, tbs, prb_mask, rv, harq_pid) tuples the TPU PDSCH pipeline
consumes, so a scheduler-driven multi-subframe simulation feeds the PHY
directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from srsran_4g_tpu_torch.models import ra

N_HARQ = 8
MAX_RETX = 4
# CQI (1..15) → max usable MCS, a simplified BLER-target mapping like the
# reference's dl_cqi → MCS selection with conservative backoff
_CQI_TO_MCS = [0, 0, 1, 3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27]
_RV_SEQ = [0, 2, 3, 1]


@dataclass
class HarqProc:
    active: bool = False
    tbs: int = 0
    mcs: int = 0
    prb_mask: tuple[int, ...] = ()
    n_retx: int = 0
    ndi: int = 0
    # second codeword (TM3/TM4 rank-2 dual-codeword transmissions)
    tbs2: int = 0
    mcs2: int = 0


@dataclass
class UeCtx:
    rnti: int
    cqi: int = 7
    buffer_bytes: int = 0
    harq: list[HarqProc] = field(default_factory=lambda: [HarqProc() for _ in range(N_HARQ)])
    # PF bookkeeping
    avg_rate: float = 1.0
    pending_retx: list[int] = field(default_factory=list)
    # transmission mode + UE-reported rank/precoder (sched_ue.cc:1015-1031
    # selects the DCI format from the configured TM; RI/PMI arrive on the
    # UE's periodic CSI report, reference srsran_pmi_select feedback)
    tm: int = 1
    ri: int = 1
    pmi: int = 1   # rank-2 codebook index (1..2, mimo._CODEBOOK_2TX_R2)

    def free_harq(self) -> int | None:
        for i, h in enumerate(self.harq):
            if not h.active:
                return i
        return None


@dataclass
class DlGrant:
    rnti: int
    harq_pid: int
    mcs: int
    tbs: int
    prb_mask: tuple[int, ...]
    rv: int
    ndi: int
    is_retx: bool
    # dual-codeword fields (set when the grant is a TM3/TM4 rank-2 spatial
    # multiplex; tbs2 None = single codeword)
    tbs2: int | None = None
    mcs2: int = 0
    rv2: int = 0
    tm: int = 1
    pmi: int = 1


@dataclass
class UlGrant:
    rnti: int
    harq_pid: int
    mcs: int
    tbs: int
    prb_start: int
    prb_len: int
    rv: int
    ndi: int
    is_retx: bool


class UlScheduler:
    """UL counterpart (sched_ue UL grants + ul_crc_info ARQ); the grant
    for TTI n is transmitted in n+4 (FDD_HARQ_DELAY)."""

    def __init__(self, nof_prb: int, policy: str = "rr",
                 edge_guard: int = 1) -> None:
        self.nof_prb = nof_prb
        self.policy = policy
        self.edge_guard = edge_guard  # PUCCH region PRBs at both band edges
        self.ues: dict[int, UeCtx] = {}

    def ue_cfg(self, rnti: int) -> None:
        self.ues[rnti] = UeCtx(rnti=rnti)

    def ue_rem(self, rnti: int) -> None:
        self.ues.pop(rnti, None)

    def ul_bsr(self, rnti: int, nof_bytes: int) -> None:
        if rnti in self.ues:
            self.ues[rnti].buffer_bytes = nof_bytes

    def ul_cqi_info(self, rnti: int, cqi: int) -> None:
        if rnti in self.ues:
            self.ues[rnti].cqi = max(1, min(15, cqi))

    def ul_crc_info(self, rnti: int, pid: int, ok: bool) -> None:
        """PUSCH decode result (mac.cc crc_info:308) -> UL ARQ."""
        ue = self.ues.get(rnti)
        if ue is None:
            return
        h = ue.harq[pid % N_HARQ]
        if ok:
            h.active = False
        else:
            h.n_retx += 1
            if h.n_retx >= MAX_RETX:
                h.active = False
            else:
                ue.pending_retx.append(pid % N_HARQ)

    def get_ul_sched(self, tti: int, k: int = 4) -> list[UlGrant]:
        """Grants signalled at `tti` for PUSCH at tti+k (FDD k=4; TDD
        passes the Table 8-2 delay).  UL HARQ is synchronous (36.213 §8):
        the process id is (tti+k) mod 8 on both sides, so a
        retransmission can only be granted when its process comes around
        again."""
        grants: list[UlGrant] = []
        pid = (tti + k) % N_HARQ
        # PUCCH guard PRBs at both band edges (sched_grid.cc)
        lo, hi = self.edge_guard, self.nof_prb - self.edge_guard
        for ue in self.ues.values():
            h = ue.harq[pid]
            # 1) synchronous retransmission of this TTI's process
            if pid in ue.pending_retx:
                n = max(1, len(h.prb_mask))
                if n > hi - lo:
                    continue
                ue.pending_retx.remove(pid)
                grants.append(UlGrant(
                    rnti=ue.rnti, harq_pid=pid, mcs=h.mcs, tbs=h.tbs,
                    prb_start=lo, prb_len=n, rv=_RV_SEQ[h.n_retx % 4],
                    ndi=h.ndi, is_retx=True))
                h.prb_mask = tuple(range(lo, lo + n))
                lo += n
                continue
            # 2) new transmission on a free process
            if h.active or ue.buffer_bytes <= 0 or lo >= hi:
                continue
            mcs = min(_CQI_TO_MCS[ue.cqi], 24)
            want = ue.buffer_bytes * 8 + 32
            n = hi - lo
            for nn in range(1, hi - lo + 1):
                if ra.tbs_from_itbs(ra.ul_mcs_to_itbs(mcs), nn) >= want:
                    n = nn
                    break
            tbs = ra.tbs_from_itbs(ra.ul_mcs_to_itbs(mcs), n)
            h.active, h.tbs, h.mcs = True, tbs, mcs
            h.prb_mask = tuple(range(lo, lo + n))
            h.n_retx, h.ndi = 0, h.ndi ^ 1
            grants.append(UlGrant(
                rnti=ue.rnti, harq_pid=pid, mcs=mcs, tbs=tbs,
                prb_start=lo, prb_len=n, rv=0, ndi=h.ndi, is_retx=False))
            lo += n
            ue.buffer_bytes = max(0, ue.buffer_bytes - tbs // 8)
        return grants


class DlScheduler:
    """Per-carrier DL scheduler (sched.cc + sched_grid.cc equivalents)."""

    def __init__(self, nof_prb: int, policy: str = "pf", pf_fairness: float = 0.05):
        self.nof_prb = nof_prb
        self.policy = policy
        self.pf_fairness = pf_fairness
        self.nof_ports = 1   # 2 when any TM>1 UE is configured (CRS cost)
        self.frame_type = "fdd"   # "tdd" changes the sync-RE reservations
        self.ues: dict[int, UeCtx] = {}

    # --- FAPI-like upper interface (mac.cc:639 etc.) ------------------------

    def ue_cfg(self, rnti: int) -> None:
        self.ues.setdefault(rnti, UeCtx(rnti=rnti))

    def ue_rem(self, rnti: int) -> None:
        self.ues.pop(rnti, None)

    def dl_rlc_buffer_state(self, rnti: int, nof_bytes: int) -> None:
        self.ues[rnti].buffer_bytes = nof_bytes

    def dl_cqi_info(self, rnti: int, cqi: int) -> None:
        self.ues[rnti].cqi = max(1, min(15, cqi))

    def set_tm(self, rnti: int, tm: int) -> None:
        """Configure the UE's transmission mode (enb.conf [enb] tm=N;
        sched_ue.cc set_cfg → DCI format selection)."""
        assert tm in (1, 2, 3, 4)
        self.ues[rnti].tm = tm
        if tm > 1:
            self.nof_ports = 2

    def dl_ri_info(self, rnti: int, ri: int) -> None:
        """UE-reported rank indicator (1 or 2)."""
        if rnti in self.ues:
            self.ues[rnti].ri = max(1, min(2, ri))

    def dl_pmi_info(self, rnti: int, pmi: int) -> None:
        """UE-reported rank-2 codebook index (1..2)."""
        if rnti in self.ues:
            self.ues[rnti].pmi = max(1, min(2, pmi))

    def dl_ack_info(self, rnti: int, harq_pid: int, ack: bool,
                    ack2: bool | None = None) -> None:
        """Per-process HARQ feedback; for a dual-codeword process the pair
        is retransmitted together when either codeword failed (the
        framework's unit-HARQ simplification of the reference's per-TB
        tracking — both rv fields advance in the retransmission DCI)."""
        h = self.ues[rnti].harq[harq_pid]
        if not h.active:
            return
        ok = ack and (ack2 is None or ack2)
        if ok or h.n_retx + 1 >= MAX_RETX:
            h.active = False
        else:
            h.n_retx += 1
            self.ues[rnti].pending_retx.append(harq_pid)

    # --- core allocation ----------------------------------------------------

    def _metric(self, ue: UeCtx) -> float:
        inst = ra.dl_tbs(_CQI_TO_MCS[ue.cqi], max(self.nof_prb // 2, 1))
        if self.policy == "rr":
            return 1.0
        return inst / max(ue.avg_rate, 1.0)

    def _sf_cap_bits(self, sf: int, prbs: tuple[int, ...], mcs: int) -> int:
        """Exact PDSCH bit capacity of this allocation in subframe `sf`
        (the reference's per-subframe ra_re_x_prb accounting,
        ra_dl.c:45-161: sync/PBCH REs in subframes 0/5 shrink it)."""
        from srsran_4g_tpu_torch.models import grid as G

        cell = G.CellConfig(
            nof_prb=self.nof_prb, cell_id=1,
            cfi=3 if self.nof_prb <= 10 else 2,
            nof_ports=self.nof_ports, frame_type=self.frame_type)
        qm = {"qpsk": 2, "16qam": 4, "64qam": 6}[ra.dl_mcs_to_mod(mcs)]
        return len(G.pdsch_re_indices(cell, sf, prbs)) * qm

    def _fit_mcs(self, sf: int, prbs: tuple[int, ...],
                 mcs: int) -> tuple[int, int]:
        """Largest MCS ≤ `mcs` whose TBS fits the subframe's actual RE
        capacity at code rate ≤ 0.93 (dl_metric.cc alloc_data TBS from
        per-sf nof_re)."""
        while mcs > 0:
            tbs = ra.dl_tbs(mcs, len(prbs))
            if tbs + 24 <= 0.93 * self._sf_cap_bits(sf, prbs, mcs):
                return mcs, tbs
            mcs -= 1
        return 0, ra.dl_tbs(0, len(prbs))

    def _alloc_rbgs(self, free_prbs: list[int], mcs: int,
                    want_bits: int) -> tuple[int, ...]:
        """Take the smallest run of fully-free RBGs whose dual-codeword
        capacity (2 layers × per-layer TBS) meets the buffer."""
        p = ra.rbg_size(self.nof_prb)
        n_rbg = -(-self.nof_prb // p)
        free = set(free_prbs)
        rbgs = [g for g in range(n_rbg)
                if all(q in free for q in
                       range(g * p, min((g + 1) * p, self.nof_prb)))]
        taken: list[int] = []
        for g in rbgs:
            taken.extend(range(g * p, min((g + 1) * p, self.nof_prb)))
            if 2 * ra.dl_tbs(mcs, len(taken)) >= want_bits:
                break
        return tuple(taken)

    def get_dl_sched(self, tti: int) -> list[DlGrant]:
        grants: list[DlGrant] = []
        free_prbs = list(range(self.nof_prb))

        sf = tti % 10
        # 1) retransmissions first (same PRB count, next rv); a retx
        # whose fixed TBS cannot fit this subframe (sync/PBCH REs in
        # 0/5) waits for the next opportunity
        for ue in self.ues.values():
            while ue.pending_retx and free_prbs:
                pid = ue.pending_retx.pop(0)
                h = ue.harq[pid]
                need = len(h.prb_mask)
                if need > len(free_prbs):
                    ue.pending_retx.insert(0, pid)
                    break
                if h.tbs + 24 > 0.93 * self._sf_cap_bits(
                        sf, tuple(free_prbs[:need]), h.mcs):
                    ue.pending_retx.insert(0, pid)
                    break
                if h.tbs2:
                    # dual-codeword retx rides a type-0 bitmap: whole RBGs
                    p = ra.rbg_size(self.nof_prb)
                    free = set(free_prbs)
                    prbs = []
                    for g0 in range(-(-self.nof_prb // p)):
                        blk = list(range(g0 * p,
                                         min((g0 + 1) * p, self.nof_prb)))
                        if all(q in free for q in blk):
                            prbs.extend(blk)
                        if len(prbs) >= need:
                            break
                    if len(prbs) != need:  # TBS is fixed by the PRB count
                        ue.pending_retx.insert(0, pid)
                        break
                    prbs = tuple(prbs)
                    free_prbs = [q for q in free_prbs if q not in set(prbs)]
                else:
                    prbs = tuple(free_prbs[:need])
                    free_prbs = free_prbs[need:]
                grants.append(DlGrant(
                    rnti=ue.rnti, harq_pid=pid, mcs=h.mcs, tbs=h.tbs,
                    prb_mask=prbs, rv=_RV_SEQ[h.n_retx % 4], ndi=h.ndi,
                    is_retx=True,
                    tbs2=h.tbs2 or None, mcs2=h.mcs2,
                    rv2=_RV_SEQ[h.n_retx % 4], tm=ue.tm, pmi=ue.pmi))
                h.prb_mask = prbs

        # 2) new transmissions by policy metric
        cand = [u for u in self.ues.values()
                if u.buffer_bytes > 0 and u.free_harq() is not None]
        if self.policy == "rr":
            cand.sort(key=lambda u: (tti + u.rnti) % max(len(self.ues), 1))
        else:
            cand.sort(key=self._metric, reverse=True)
        for ue in cand:
            if not free_prbs:
                break
            # TM3/TM4 with a rank-2 report: dual-codeword spatial multiplex
            # (sched_ue.cc:1015-1031 — TM3 → format 2A, TM4 → format 2);
            # each codeword maps to one layer, so per-codeword TBS is the
            # standard single-layer table (36.213 §7.1.7.2.1)
            dual = ue.tm in (3, 4) and ue.ri >= 2
            mcs = _CQI_TO_MCS[ue.cqi]
            want_bits = ue.buffer_bytes * 8 + 32
            if dual:
                # formats 2/2A carry a type-0 RBG bitmap, so dual-codeword
                # allocations take whole free RBGs (sched_grid.cc rbgmask)
                prbs = self._alloc_rbgs(free_prbs, mcs, want_bits)
                if not prbs:
                    continue
                free_prbs = [p for p in free_prbs if p not in set(prbs)]
            else:
                n_prb = len(free_prbs)
                # smallest PRB count meeting the buffer, capped at free
                for n in range(1, len(free_prbs) + 1):
                    if ra.dl_tbs(mcs, n) >= want_bits:
                        n_prb = n
                        break
                prbs = tuple(free_prbs[:n_prb])
                free_prbs = free_prbs[n_prb:]
            mcs, tbs = self._fit_mcs(sf, prbs, mcs)
            pid = ue.free_harq()
            h = ue.harq[pid]
            h.active, h.tbs, h.mcs, h.prb_mask = True, tbs, mcs, prbs
            h.n_retx, h.ndi = 0, h.ndi ^ 1
            h.tbs2, h.mcs2 = (tbs, mcs) if dual else (0, 0)
            grants.append(DlGrant(
                rnti=ue.rnti, harq_pid=pid, mcs=mcs, tbs=tbs, prb_mask=prbs,
                rv=0, ndi=h.ndi, is_retx=False,
                tbs2=tbs if dual else None, mcs2=mcs if dual else 0,
                rv2=0, tm=ue.tm, pmi=ue.pmi))
            served = tbs * (2 if dual else 1)
            ue.buffer_bytes = max(0, ue.buffer_bytes - served // 8)

        # PF average-rate update (scheduled or not)
        for ue in self.ues.values():
            served = sum(g.tbs + (g.tbs2 or 0) for g in grants
                         if g.rnti == ue.rnti and not g.is_retx)
            ue.avg_rate = (1 - self.pf_fairness) * ue.avg_rate + \
                self.pf_fairness * served
        return grants


class CaScheduler:
    """Carrier aggregation: one DlScheduler per component carrier
    (sched.cc per-carrier `sched_carrier`, SURVEY P3 per-carrier
    cc_workers; up to 5 LTE CCs).  The PCell is cc 0; SCells are
    activated per UE (36.321 SCell Activation CE).  Buffer state is
    shared: each carrier schedules against what the earlier carriers
    have not already drained this TTI."""

    def __init__(self, nof_prb_per_cc: list[int] | tuple[int, ...],
                 policy: str = "pf") -> None:
        assert 1 <= len(nof_prb_per_cc) <= 5
        self.cc = [DlScheduler(n, policy) for n in nof_prb_per_cc]
        self.active: dict[int, list[int]] = {}  # rnti -> active cc list
        self.buffer: dict[int, int] = {}

    def ue_cfg(self, rnti: int, scells: tuple[int, ...] = ()) -> None:
        self.active[rnti] = [0] + [c for c in scells if 0 < c < len(self.cc)]
        self.buffer.setdefault(rnti, 0)
        for c in self.active[rnti]:
            self.cc[c].ue_cfg(rnti)

    def scell_activate(self, rnti: int, cc_idx: int, on: bool = True) -> None:
        a = self.active[rnti]
        if on and cc_idx not in a and 0 < cc_idx < len(self.cc):
            a.append(cc_idx)
            self.cc[cc_idx].ue_cfg(rnti)
        if not on and cc_idx in a and cc_idx != 0:
            a.remove(cc_idx)
            self.cc[cc_idx].ue_rem(rnti)

    def ue_rem(self, rnti: int) -> None:
        for c in self.active.pop(rnti, []):
            self.cc[c].ue_rem(rnti)
        self.buffer.pop(rnti, None)

    def dl_rlc_buffer_state(self, rnti: int, nof_bytes: int) -> None:
        self.buffer[rnti] = nof_bytes

    def dl_cqi_info(self, rnti: int, cqi: int, cc_idx: int = 0) -> None:
        if rnti in self.cc[cc_idx].ues:
            self.cc[cc_idx].dl_cqi_info(rnti, cqi)

    def dl_ack_info(self, rnti: int, harq_pid: int, ack: bool,
                    cc_idx: int = 0) -> None:
        if rnti in self.cc[cc_idx].ues:
            self.cc[cc_idx].dl_ack_info(rnti, harq_pid, ack)

    def get_dl_sched(self, tti: int) -> list[list[DlGrant]]:
        """Per-cc grant lists; HARQ state is per (UE, cc) as in the
        reference (independent HARQ entities per carrier)."""
        remaining = dict(self.buffer)
        out: list[list[DlGrant]] = []
        for c, sched in enumerate(self.cc):
            for rnti, ccs in self.active.items():
                if c in ccs:
                    sched.dl_rlc_buffer_state(rnti, remaining.get(rnti, 0))
            grants = sched.get_dl_sched(tti)
            for g in grants:
                if not g.is_retx:
                    remaining[g.rnti] = max(
                        0, remaining.get(g.rnti, 0) - g.tbs // 8)
            out.append(grants)
        self.buffer = remaining
        return out
