"""eNB MAC entity: RACH → RAR → scheduler-driven grant + PDU assembly.

Counterpart of the reference's `srsenb/src/stack/mac/mac.cc`: the FAPI-like
surface the PHY pulls from every TTI (`get_dl_sched` mac.cc:639,
`get_ul_sched`, `rach_detected` mac.cc:560, `crc_info` mac.cc:308,
`push_pdu` mac.cc:326) plus what the reference does per grant in
`ue::generate_pdu` (mac.cc:686): assemble the DL MAC PDU from pending
control elements and the per-UE RLC entities.

The entity owns per-RNTI RLC bearers and DL HARQ PDU buffers (for
retransmission without re-reading RLC), allocates C-RNTIs at RACH time,
carries contention resolution, and drives the DL/UL schedulers of
`stack/sched.py`.  Every produced item carries the packed DCI so the PHY
can transmit the grant over PDCCH — nothing is handed to the UE
out-of-band.

Msg3 convention: the RAR UL grant field packs (riv << 5) | mcs for the
cell bandwidth, a compact rendering of the reference's 20-bit RAR grant
(36.213 §6.2 / mac_pdu RAR subheader).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from srsran_4g_tpu_torch.models import dci as dci_mod, ra
from srsran_4g_tpu_torch.stack import mac_pdu, sched
from srsran_4g_tpu_torch.stack.rlc_am import RlcAm
from srsran_4g_tpu_torch.stack.rlc_um import RlcTm

MSG3_DELAY = 4      # RAR at n → msg3 PUSCH at n+4 (36.213 §6.1.1)
MSG3_PRB = 2
MSG3_PRB_START = 2  # clear of the PUCCH format-2 (PRB 0) and format-1 regions
MSG3_MCS = 2
RAR_PRB = 3
RAR_MCS = 0
SI_RNTI = 0xFFFF
SI_MCS = 2


def pack_rar_ul_grant(nof_prb: int, prb_start: int, prb_len: int,
                      mcs: int) -> int:
    """The real 20-bit 36.213 §6.2 RAR UL grant (srsran_dci_rar_pack,
    dci.c:55): hopping(1) | RBA/truncated-RIV(10) | trunc_mcs(4) |
    TPC(3) | UL-delay(1) | CSI-request(1)."""
    assert mcs < 16, "RAR grant carries a 4-bit truncated MCS"
    riv = ra.riv_encode(nof_prb, prb_len, prb_start) & 0x3FF
    return (0 << 19) | (riv << 9) | (mcs << 5) | (0b100 << 2) | 0


def unpack_rar_ul_grant(nof_prb: int, g: int) -> tuple[int, int, int, int]:
    """→ (prb_start, prb_len, mcs, tbs) (srsran_dci_rar_to_ul_dci,
    dci.c:68: RIV truncation per bandwidth)."""
    import math

    riv = (g >> 9) & 0x3FF
    mcs = (g >> 5) & 0xF
    if nof_prb <= 44:
        b = math.ceil(math.log2(nof_prb * (nof_prb + 1) / 2))
        riv &= (1 << (b + 1)) - 1
    l_crbs, rb_start = ra.riv_decode(nof_prb, riv)
    tbs = ra.tbs_from_itbs(ra.ul_mcs_to_itbs(mcs), l_crbs)
    return rb_start, l_crbs, mcs, tbs


@dataclass
class DlSchedItem:
    """One DL allocation the PHY must transmit this TTI."""

    grant: sched.DlGrant
    pdu: bytes                    # MAC PDU (grant.tbs // 8 bytes)
    dci: object                   # Dci1A, or Dci2/Dci2A for dual-codeword
    is_rar: bool = False          # rnti field is the RA-RNTI
    pdu2: Optional[bytes] = None  # second codeword (TM3/TM4 rank 2)


@dataclass
class UlSchedItem:
    grant: sched.UlGrant
    dci: Optional[dci_mod.Dci0]   # None for msg3 (granted via the RAR)
    is_msg3: bool = False


@dataclass
class _EnbUe:
    rnti: int
    rlc: dict[int, object] = field(default_factory=dict)
    pending_ces: list[tuple[int, bytes]] = field(default_factory=list)
    dl_pdu_buf: dict[int, bytes] = field(default_factory=dict)
    con_res_done: bool = False
    msg3_tti: Optional[int] = None


def _rlc_buffered_bytes(ent) -> int:
    q = getattr(ent, "sdu_q", None)
    n = sum(len(s) for s in q) if q else 0
    if getattr(ent, "retx_q", None):
        n += 64
    if n == 0 and ent.has_data():
        n = 64
    return n


class EnbMac:
    """The eNB MAC entity (mac.cc + per-UE RLC adapters)."""

    def __init__(self, nof_prb: int, dl_policy: str = "pf",
                 prb_quant: bool = False, first_rnti: int = 0x46,
                 tm: int = 1, si_dci_1c: bool = False) -> None:
        self.nof_prb = nof_prb
        self.tm = tm  # cell transmission mode (enb.conf.example:17-31 tm=N)
        # SI on DCI format 1C instead of 1A (the reference's compact
        # SI/RAR/paging format, ra_dl.c tbs_format1c_table + dci.c:346)
        self.si_dci_1c = si_dci_1c
        self.dl_sched = sched.DlScheduler(nof_prb, policy=dl_policy)
        self.ul_sched = sched.UlScheduler(nof_prb)
        self.prb_quant = prb_quant
        self.ues: dict[int, _EnbUe] = {}
        self.next_rnti = first_rnti
        # (preamble, temp_crnti, ra_rnti)
        self._pending_rar: list[tuple[int, int, int]] = []
        self._pending_msg3: list[tuple[int, sched.UlGrant]] = []  # (due_tti, g)
        # upper-layer callbacks (eNB RRC / user plane)
        self.rx_ccch: Callable[[int, bytes], int] = lambda rnti, pdu: rnti
        self.rx_dcch: Callable[[int, int, bytes], None] = lambda *_: None
        self.rx_drb: Callable[[int, int, bytes], None] = lambda *_: None
        self.metrics = {"rach": 0, "dl_tx": 0, "dl_retx": 0, "ul_crc_ok": 0,
                        "ul_crc_ko": 0, "si_tx": 0, "scell_tx": 0}
        # carrier aggregation: one extra DL scheduler per SCell
        # (sched.cc per-carrier sched_carrier; activation per 36.321 CE)
        self.scell_sched: Optional[sched.DlScheduler] = None
        self.scell_active: set[int] = set()   # rntis with the SCell on
        # BCCH-DL-SCH broadcast (sched_si): message i goes out in the TTI
        # where tti mod (period * n) == i * period + 1
        self.si_messages: list[bytes] = []
        self.si_period_ttis = 20
        self.si_offset = 1      # SI window subframe (TDD moves it to a D sf)
        # UL-grant delay hook: tti -> k (None = this subframe carries no
        # UL grants; TDD Table 8-2 via the air's ul_k)
        self.ul_k = lambda tti: 4

    def set_si(self, messages: list[bytes], period_ttis: int = 20) -> None:
        self.si_messages = list(messages)
        self.si_period_ttis = period_ttis

    def _si_item(self, tti: int) -> Optional[DlSchedItem]:
        n = len(self.si_messages)
        if n == 0 or tti % self.si_period_ttis != self.si_offset:
            return None
        i = (tti // self.si_period_ttis) % n
        payload = self.si_messages[i]
        want = (len(payload) + 1) * 8
        self.metrics["si_tx"] += 1
        if self.si_dci_1c:
            return self._si_item_1c(payload, want)
        n_prb = 1
        while ra.dl_tbs(SI_MCS, n_prb) < want:
            n_prb += 1
        tbs = ra.dl_tbs(SI_MCS, n_prb)
        grant = sched.DlGrant(rnti=SI_RNTI, harq_pid=0, mcs=SI_MCS, tbs=tbs,
                              prb_mask=tuple(range(n_prb)), rv=0, ndi=0,
                              is_retx=False)
        d = dci_mod.Dci1A(rb_start=0, l_crbs=n_prb, mcs=SI_MCS)
        return DlSchedItem(grant=grant, pdu=payload.ljust(tbs // 8, b"\0"),
                           dci=d, is_rar=True)

    def _si_item_1c(self, payload: bytes, want: int) -> DlSchedItem:
        """SI on DCI format 1C: the MCS field is a direct index into the
        36.213 Table 7.1.7.2.3-1 TBS table (QPSK), the RIV addresses
        N_RB_step-unit blocks (ra_dl.c:234-246, dci.c dci_format1Cs)."""
        i_tbs = 0
        while ra.TBS_FORMAT1C[i_tbs] < want:
            i_tbs += 1
        tbs = ra.TBS_FORMAT1C[i_tbs]
        step = ra.type2_n_rb_step(self.nof_prb)
        n_vrb = ra.type2_n_vrb_dl(self.nof_prb, True) // step
        # smallest step-unit count whose QPSK capacity carries the TBS
        # (conservative RE estimate: 10 data symbols x 12 SC x 2 bits)
        l_step = 1
        while l_step < n_vrb and (l_step * step) * 10 * 12 * 2 < tbs + 24:
            l_step += 1
        d = dci_mod.Dci1C(riv=ra.riv_encode(n_vrb, l_step, 0), mcs=i_tbs)
        prbs = dci_mod.dci1c_prbs(d, self.nof_prb)
        self.metrics["si_1c_tx"] = self.metrics.get("si_1c_tx", 0) + 1
        grant = sched.DlGrant(rnti=SI_RNTI, harq_pid=0, mcs=i_tbs, tbs=tbs,
                              prb_mask=prbs, rv=0, ndi=0, is_retx=False)
        return DlSchedItem(grant=grant, pdu=payload.ljust(tbs // 8, b"\0"),
                           dci=d, is_rar=True)

    # -- bearers -----------------------------------------------------------

    def add_bearer(self, rnti: int, lcid: int, mode: str = "am") -> None:
        ue = self.ues[rnti]
        ue.rlc[lcid] = RlcTm() if mode == "tm" else RlcAm()

    def write_dl_sdu(self, rnti: int, lcid: int, sdu: bytes) -> None:
        """RLC SDU from RRC/PDCP to be scheduled for DL."""
        ue = self.ues.get(rnti)
        if ue is None:
            return
        if lcid not in ue.rlc:
            self.add_bearer(rnti, lcid, "tm" if lcid == 0 else "am")
        ue.rlc[lcid].write_sdu(sdu)

    def _dl_buffer_bytes(self, ue: _EnbUe) -> int:
        n = sum(_rlc_buffered_bytes(e) for e in ue.rlc.values())
        n += sum(len(p) + 1 for _, p in ue.pending_ces)
        return n

    # -- RACH (mac.cc rach_detected:560) ------------------------------------

    def rach_detected(self, tti: int, preamble: int) -> int:
        """PRACH detection from the PHY; returns the allocated temp C-RNTI."""
        rnti = self.next_rnti
        self.next_rnti += 1
        ue = _EnbUe(rnti=rnti)
        ue.rlc[0] = RlcTm()
        self.ues[rnti] = ue
        self.dl_sched.ue_cfg(rnti)
        if self.tm != 1:
            self.dl_sched.set_tm(rnti, self.tm)
        self.ul_sched.ue_cfg(rnti)
        # RA-RNTI = 1 + t_id of the PRACH subframe (36.321 §5.1.4)
        self._pending_rar.append((preamble, rnti, 1 + tti % 10))
        self.metrics["rach"] += 1
        return rnti

    # -- PHY pull surface ----------------------------------------------------

    def get_dl_sched(self, tti: int) -> list[DlSchedItem]:
        items: list[DlSchedItem] = []
        # 0) BCCH-DL-SCH broadcast window (SI-RNTI, common search space)
        si = self._si_item(tti)
        if si is not None:
            return [si]
        # 1) RAR subframes take precedence (common search space, RA-RNTI);
        # the RAR can only go out where an UL grant delay exists (TDD:
        # Table 8-2 subframes), otherwise it waits for the next one
        if self._pending_rar and self.ul_k(tti) is not None:
            preamble, temp_crnti, ra_rnti = self._pending_rar.pop(0)
            ue = self.ues[temp_crnti]
            ue.msg3_tti = tti + self.ul_k(tti)
            ul_grant = pack_rar_ul_grant(
                self.nof_prb, MSG3_PRB_START, MSG3_PRB, MSG3_MCS)
            rar = mac_pdu.pack_rar([mac_pdu.RarGrant(
                rapid=preamble, ta=2, ul_grant=ul_grant,
                temp_crnti=temp_crnti)])
            msg3_tbs = ra.tbs_from_itbs(ra.ul_mcs_to_itbs(MSG3_MCS), MSG3_PRB)
            self._pending_msg3.append((ue.msg3_tti, sched.UlGrant(
                rnti=temp_crnti, harq_pid=ue.msg3_tti % 8, mcs=MSG3_MCS,
                tbs=msg3_tbs, prb_start=MSG3_PRB_START, prb_len=MSG3_PRB,
                rv=0, ndi=0, is_retx=False)))
            tbs = ra.dl_tbs(RAR_MCS, RAR_PRB)
            grant = sched.DlGrant(rnti=ra_rnti, harq_pid=0, mcs=RAR_MCS,
                                  tbs=tbs, prb_mask=tuple(range(RAR_PRB)),
                                  rv=0, ndi=0, is_retx=False)
            d = dci_mod.Dci1A(rb_start=0, l_crbs=RAR_PRB, mcs=RAR_MCS,
                              harq_pid=0, ndi=0, rv=0)
            items.append(DlSchedItem(grant=grant, pdu=rar.ljust(tbs // 8, b"\0"),
                                     dci=d, is_rar=True))
            return items

        # 2) regular scheduling
        for rnti, ue in self.ues.items():
            self.dl_sched.dl_rlc_buffer_state(rnti, self._dl_buffer_bytes(ue))
        for g in self.dl_sched.get_dl_sched(tti):
            ue = self.ues[g.rnti]
            if g.is_retx:
                pdu = ue.dl_pdu_buf.get((0, g.harq_pid, 0), bytes(g.tbs // 8))
                self.metrics["dl_retx"] += 1
            else:
                pdu = self._generate_pdu(ue, g.tbs // 8)
                ue.dl_pdu_buf[(0, g.harq_pid, 0)] = pdu
                self.metrics["dl_tx"] += 1
            if g.tbs2 is not None:
                # dual-codeword spatial multiplex: second MAC PDU + DCI
                # format 2 (TM4, pinfo = reported PMI) or 2A (TM3) —
                # sched_ue.cc:1015-1031 format-by-TM selection
                if g.is_retx:
                    pdu2 = ue.dl_pdu_buf.get((0, g.harq_pid, 1),
                                             bytes(g.tbs2 // 8))
                else:
                    pdu2 = self._generate_pdu(ue, g.tbs2 // 8)
                    ue.dl_pdu_buf[(0, g.harq_pid, 1)] = pdu2
                    self.metrics["dl_tx"] += 1
                bitmap = ra.prbs_to_rbg_bitmap(g.prb_mask, self.nof_prb)
                cls = dci_mod.Dci2 if g.tm == 4 else dci_mod.Dci2A
                d = cls(rbg_bitmap=bitmap, harq_pid=g.harq_pid,
                        mcs0=g.mcs, ndi0=g.ndi, rv0=g.rv,
                        mcs1=g.mcs2, ndi1=g.ndi, rv1=g.rv2,
                        pinfo=g.pmi if g.tm == 4 else 0)
                items.append(DlSchedItem(grant=g, pdu=pdu, dci=d, pdu2=pdu2))
                continue
            rb_start = min(g.prb_mask)
            d = dci_mod.Dci1A(rb_start=rb_start, l_crbs=len(g.prb_mask),
                              mcs=g.mcs, harq_pid=g.harq_pid, ndi=g.ndi,
                              rv=g.rv)
            items.append(DlSchedItem(grant=g, pdu=pdu, dci=d))
        return items

    def get_ul_sched(self, tti: int) -> list[UlSchedItem]:
        items: list[UlSchedItem] = []
        due = [m for m in self._pending_msg3 if m[0] <= tti]
        self._pending_msg3 = [m for m in self._pending_msg3 if m[0] > tti]
        for _, g in due:
            items.append(UlSchedItem(grant=g, dci=None, is_msg3=True))
        k = self.ul_k(tti)
        if k is None:
            return items
        for g in self.ul_sched.get_ul_sched(tti, k=k):
            d = dci_mod.Dci0(rb_start=g.prb_start, l_crbs=g.prb_len,
                             mcs=g.mcs, ndi=g.ndi)
            items.append(UlSchedItem(grant=g, dci=d))
        return items

    # -- PDU assembly (mac.cc ue::generate_pdu:686) --------------------------

    def _generate_pdu(self, ue: _EnbUe, nof_bytes: int) -> bytes:
        pdu = mac_pdu.MacPdu()
        budget = nof_bytes
        while ue.pending_ces and budget >= 7:
            lcid, payload = ue.pending_ces.pop(0)
            pdu.add_ce(lcid, payload)
            budget -= len(payload) + 1
        for lcid in sorted(ue.rlc):
            ent = ue.rlc[lcid]
            while ent.has_data() and budget > 3:
                sdu = ent.read_pdu(budget - 3)
                if not sdu:
                    break
                pdu.add_sdu(lcid, sdu)
                budget -= len(sdu) + 3
        return mac_pdu.pack(pdu, nof_bytes)

    # -- UL ingress (mac.cc crc_info:308 / push_pdu:326) ---------------------

    def crc_info(self, tti: int, rnti: int, pid: int, ok: bool) -> None:
        self.metrics["ul_crc_ok" if ok else "ul_crc_ko"] += 1
        self.ul_sched.ul_crc_info(rnti, pid, ok)

    def push_pdu(self, rnti: int, raw: bytes) -> None:
        ue = self.ues.get(rnti)
        if ue is None:
            return
        up = mac_pdu.unpack(raw, ul=True)
        for sub in up.subpdus:
            if not sub.is_sdu:
                if sub.lcid in (mac_pdu.LCID_SHORT_BSR, mac_pdu.LCID_TRUNC_BSR) \
                        and sub.payload:
                    idx = sub.payload[0] & 0x3F
                    from srsran_4g_tpu_torch.stack.ue_mac import BSR_TABLE
                    self.ul_sched.ul_bsr(rnti, BSR_TABLE[idx])
                elif sub.lcid == mac_pdu.LCID_LONG_BSR and len(sub.payload) >= 3:
                    v = int.from_bytes(sub.payload[:3], "big")
                    from srsran_4g_tpu_torch.stack.ue_mac import BSR_TABLE
                    total = sum(BSR_TABLE[(v >> s) & 0x3F]
                                for s in (18, 12, 6, 0))
                    self.ul_sched.ul_bsr(rnti, total)
                continue
            if sub.lcid == 0:
                if ue.con_res_done:
                    continue  # duplicate msg3 (HARQ retx of CCCH)
                ue.con_res_done = True
                ue.pending_ces.append(
                    (mac_pdu.LCID_CON_RES, sub.payload[:6].ljust(6, b"\0")))
                self.rx_ccch(rnti, sub.payload)
            elif sub.lcid in (1, 2):
                ent = ue.rlc.setdefault(sub.lcid, RlcAm())
                n0 = len(ent.delivered)
                ent.write_pdu(sub.payload)
                for sdu in ent.delivered[n0:]:
                    self.rx_dcch(rnti, sub.lcid, sdu)
            else:
                ent = ue.rlc.setdefault(sub.lcid, RlcAm())
                n0 = len(ent.delivered)
                ent.write_pdu(sub.payload)
                for sdu in ent.delivered[n0:]:
                    self.rx_drb(rnti, sub.lcid, sdu)

    # -- feedback ------------------------------------------------------------

    def dl_ack_info(self, rnti: int, pid: int, ack: bool,
                    cc: int = 0, ack2: bool | None = None) -> None:
        s = self.dl_sched if cc == 0 else self.scell_sched
        if s is None or rnti not in s.ues:
            return
        s.dl_ack_info(rnti, pid, ack, ack2=ack2)
        if ack and (ack2 is None or ack2):
            self.ues[rnti].dl_pdu_buf.pop((cc, pid, 0), None)
            self.ues[rnti].dl_pdu_buf.pop((cc, pid, 1), None)

    def dl_ri_info(self, rnti: int, ri: int) -> None:
        self.dl_sched.dl_ri_info(rnti, ri)

    def dl_pmi_info(self, rnti: int, pmi: int) -> None:
        self.dl_sched.dl_pmi_info(rnti, pmi)

    # -- carrier aggregation (CaScheduler semantics over the air) -----------

    def enable_scell(self, nof_prb: int) -> None:
        self.scell_sched = sched.DlScheduler(nof_prb, policy="pf")

    def scell_activate(self, rnti: int) -> None:
        """Queue the 36.321 §6.1.3.8 Activation CE and start scheduling
        the UE on the SCell."""
        if self.scell_sched is None or rnti in self.scell_active:
            return
        ue = self.ues[rnti]
        ue.pending_ces.append((mac_pdu.LCID_ACT_DEACT, bytes([0x02])))
        self.scell_sched.ue_cfg(rnti)
        self.scell_active.add(rnti)

    def get_dl_sched_scell(self, tti: int) -> list[DlSchedItem]:
        """SCell grants: data-only (no RAR/SI/CCCH), draining what the
        PCell left in the shared per-UE buffers this TTI (call AFTER
        get_dl_sched, CaScheduler shared-buffer semantics)."""
        items: list[DlSchedItem] = []
        if self.scell_sched is None:
            return items
        for rnti in self.scell_active:
            ue = self.ues.get(rnti)
            if ue is not None:
                self.scell_sched.dl_rlc_buffer_state(
                    rnti, self._dl_buffer_bytes(ue))
        for g in self.scell_sched.get_dl_sched(tti):
            ue = self.ues[g.rnti]
            if g.is_retx:
                pdu = ue.dl_pdu_buf.get((1, g.harq_pid, 0), bytes(g.tbs // 8))
                self.metrics["dl_retx"] += 1
            else:
                pdu = self._generate_pdu(ue, g.tbs // 8)
                ue.dl_pdu_buf[(1, g.harq_pid, 0)] = pdu
                self.metrics["scell_tx"] += 1
            d = dci_mod.Dci1A(rb_start=min(g.prb_mask),
                              l_crbs=len(g.prb_mask), mcs=g.mcs,
                              harq_pid=g.harq_pid, ndi=g.ndi, rv=g.rv)
            items.append(DlSchedItem(grant=g, pdu=pdu, dci=d))
        return items

    def dl_cqi_info(self, rnti: int, cqi: int) -> None:
        if rnti in self.dl_sched.ues:
            self.dl_sched.dl_cqi_info(rnti, cqi)

    def ul_bsr(self, rnti: int, nof_bytes: int) -> None:
        self.ul_sched.ul_bsr(rnti, nof_bytes)

    def tick(self, ms: int = 1) -> None:
        for ue in self.ues.values():
            for ent in ue.rlc.values():
                if hasattr(ent, "tick"):
                    ent.tick(ms)
