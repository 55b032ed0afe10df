"""gNB NR MAC scheduler: BWP-based slot scheduling over parallel carriers.

Counterpart of `srsgnb/src/stack/mac/sched_nr*.cc` (~4.9 k LoC: BWP
grids, per-carrier `sched_nr_worker` slot workers with fine-grained
locking, validated by sched_nr_parallel_test.cc): per-slot PDSCH/PUSCH
grant generation with PF/RR policies, per-UE NR HARQ entities (16
processes), CORESET/PDCCH candidate allocation, and NR TBS via
models/ra_nr.

The reference parallelises slot workers with threads + locks (P8 in
SURVEY §2.7); here each carrier is an independent object and
`SchedNr.run_slot` iterates them — the host loop is microseconds per
slot, and the TPU-side PHY consumes the grants batched across carriers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from srsran_4g_tpu_torch.models import ra_nr

NOF_HARQ_NR = 16
_RV_SEQ = (0, 2, 3, 1)


@dataclass
class NrHarqProc:
    active: bool = False
    tbs: int = 0
    mcs: int = 0
    prbs: tuple[int, int] = (0, 0)   # (start, len)
    ndi: int = 0
    n_retx: int = 0


@dataclass
class NrUeCtx:
    rnti: int
    cqi: int = 15
    buffer_bytes: int = 0
    ul_buffer_bytes: int = 0
    avg_rate: float = 1.0
    harq: list[NrHarqProc] = field(
        default_factory=lambda: [NrHarqProc() for _ in range(NOF_HARQ_NR)])
    pending_retx: list[int] = field(default_factory=list)

    def free_harq(self) -> Optional[int]:
        for i, h in enumerate(self.harq):
            if not h.active:
                return i
        return None


@dataclass
class NrGrant:
    rnti: int
    harq_pid: int
    mcs: int
    tbs: int
    rb_start: int
    rb_len: int
    rv: int
    ndi: int
    is_retx: bool
    is_ul: bool = False


_CQI_TO_MCS = [0, 0, 1, 3, 5, 7, 9, 11, 13, 15, 18, 20, 22, 24, 26, 28]


@dataclass
class BwpConfig:
    nof_prb: int = 52
    coreset_cces: int = 8        # PDCCH capacity per slot


class CarrierSched:
    """One carrier's slot scheduler (sched_nr_worker equivalent)."""

    def __init__(self, bwp: BwpConfig, policy: str = "pf",
                 pf_fairness: float = 0.05) -> None:
        self.bwp = bwp
        self.policy = policy
        self.pf_fairness = pf_fairness
        self.ues: dict[int, NrUeCtx] = {}

    def ue_cfg(self, rnti: int) -> None:
        self.ues[rnti] = NrUeCtx(rnti=rnti)

    def ue_rem(self, rnti: int) -> None:
        self.ues.pop(rnti, None)

    def dl_buffer_state(self, rnti: int, nof_bytes: int) -> None:
        if rnti in self.ues:
            self.ues[rnti].buffer_bytes = nof_bytes

    def ul_bsr(self, rnti: int, nof_bytes: int) -> None:
        if rnti in self.ues:
            self.ues[rnti].ul_buffer_bytes = nof_bytes

    def cqi_info(self, rnti: int, cqi: int) -> None:
        if rnti in self.ues:
            self.ues[rnti].cqi = max(0, min(15, cqi))

    def ack_info(self, rnti: int, pid: int, ack: bool) -> None:
        ue = self.ues.get(rnti)
        if ue is None:
            return
        h = ue.harq[pid]
        if ack:
            h.active = False
        else:
            h.n_retx += 1
            if h.n_retx >= 4:
                h.active = False   # max retx -> drop
            else:
                ue.pending_retx.append(pid)

    def _metric(self, ue: NrUeCtx) -> float:
        inst = ra_nr.dl_tbs(_CQI_TO_MCS[ue.cqi], 10)
        return inst / max(ue.avg_rate, 1.0)

    def run_slot(self, slot: int) -> list[NrGrant]:
        grants: list[NrGrant] = []
        free = [0, self.bwp.nof_prb]   # contiguous allocator [next, end]
        cces_left = self.bwp.coreset_cces

        # 1) DL retransmissions
        for ue in self.ues.values():
            while ue.pending_retx and cces_left > 0:
                pid = ue.pending_retx.pop(0)
                h = ue.harq[pid]
                if h.prbs[1] > free[1] - free[0]:
                    ue.pending_retx.insert(0, pid)
                    break
                start = free[0]
                free[0] += h.prbs[1]
                h.prbs = (start, h.prbs[1])
                cces_left -= 1
                grants.append(NrGrant(
                    rnti=ue.rnti, harq_pid=pid, mcs=h.mcs, tbs=h.tbs,
                    rb_start=start, rb_len=h.prbs[1],
                    rv=_RV_SEQ[h.n_retx % 4], ndi=h.ndi, is_retx=True))

        # 2) new DL by policy
        cand = [u for u in self.ues.values()
                if u.buffer_bytes > 0 and u.free_harq() is not None]
        if self.policy == "rr":
            cand.sort(key=lambda u: (slot + u.rnti) % max(len(self.ues), 1))
        else:
            cand.sort(key=self._metric, reverse=True)
        for ue in cand:
            if free[0] >= free[1] or cces_left <= 0:
                break
            mcs = _CQI_TO_MCS[ue.cqi]
            want = ue.buffer_bytes * 8 + 32
            avail = free[1] - free[0]
            n = avail
            for k in range(1, avail + 1):
                if ra_nr.dl_tbs(mcs, k) >= want:
                    n = k
                    break
            tbs = ra_nr.dl_tbs(mcs, n)
            pid = ue.free_harq()
            h = ue.harq[pid]
            h.active, h.tbs, h.mcs = True, tbs, mcs
            h.prbs, h.n_retx, h.ndi = (free[0], n), 0, h.ndi ^ 1
            grants.append(NrGrant(
                rnti=ue.rnti, harq_pid=pid, mcs=mcs, tbs=tbs,
                rb_start=free[0], rb_len=n, rv=0, ndi=h.ndi,
                is_retx=False))
            free[0] += n
            cces_left -= 1
            ue.buffer_bytes = max(0, ue.buffer_bytes - tbs // 8)

        # 3) UL grants with leftover CCEs (round robin on BSR)
        for ue in self.ues.values():
            if cces_left <= 0:
                break
            if ue.ul_buffer_bytes > 0:
                mcs = _CQI_TO_MCS[ue.cqi]
                n = min(10, self.bwp.nof_prb)
                tbs = ra_nr.dl_tbs(mcs, n)
                grants.append(NrGrant(
                    rnti=ue.rnti, harq_pid=slot % NOF_HARQ_NR, mcs=mcs,
                    tbs=tbs, rb_start=0, rb_len=n, rv=0, ndi=1,
                    is_retx=False, is_ul=True))
                cces_left -= 1
                ue.ul_buffer_bytes = max(0, ue.ul_buffer_bytes - tbs // 8)

        # PF average update
        for ue in self.ues.values():
            served = sum(g.tbs for g in grants
                         if g.rnti == ue.rnti and not g.is_retx
                         and not g.is_ul)
            ue.avg_rate = ((1 - self.pf_fairness) * ue.avg_rate
                           + self.pf_fairness * served)
        return grants


class SchedNr:
    """Multi-carrier scheduler (sched_nr.cc top level)."""

    def __init__(self, nof_carriers: int = 1, bwp: BwpConfig | None = None,
                 policy: str = "pf") -> None:
        self.carriers = [CarrierSched(bwp or BwpConfig(), policy)
                         for _ in range(nof_carriers)]

    def ue_cfg(self, rnti: int, carriers: Optional[list[int]] = None) -> None:
        for i in carriers or range(len(self.carriers)):
            self.carriers[i].ue_cfg(rnti)

    def run_slot(self, slot: int) -> list[list[NrGrant]]:
        """All carriers scheduled for one slot (the reference runs these
        in parallel worker threads; here they are independent calls)."""
        return [c.run_slot(slot) for c in self.carriers]
