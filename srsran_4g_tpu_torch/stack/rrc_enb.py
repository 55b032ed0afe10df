"""eNB RRC: per-UE connection FSM, bearer setup, S1AP glue, SIB gen.

Counterpart of `srsenb/src/stack/rrc/` (rrc_ue.cc per-UE FSM,
rrc_bearer_cfg.cc bearer setup, rrc_cell_cfg.cc SIB generation) and the
S1AP client side of `srsenb/src/stack/s1ap/s1ap.cc` (InitialUEMessage,
NAS transport, InitialContextSetup handling).

`tx_rrc(rnti, lcid, pdu)` sends toward the UE (via RLC/MAC/PHY or a
test transport); `tx_s1ap(pdu)` sends toward the MME.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from . import rrc_msgs as R
from . import s1ap_msgs as S
from . import security
from .pdcp import PdcpConfig, PdcpEntity

SRB0_LCID = 0
SRB1_LCID = 1


@dataclass
class EnbCellConfig:
    nof_prb: int = 100
    pci: int = 1
    tac: int = 0x0001
    cell_id: int = 0x01
    mcc: int = 1
    mnc: int = 1
    enb_s1u_teid_base: int = 0x1000


class UeCtx:
    def __init__(self, rnti: int, enb_ue_s1ap_id: int) -> None:
        self.rnti = rnti
        self.enb_ue_s1ap_id = enb_ue_s1ap_id
        self.mme_ue_s1ap_id = 0
        self.state = "CONN_SETUP_SENT"
        self.srb1 = PdcpEntity(PdcpConfig(is_control=True, bearer_id=1))
        self.drbs: dict[int, PdcpEntity] = {}      # by lcid
        self.k_enb: bytes = b""
        self.k_rrc_int: Optional[bytes] = None
        self.k_rrc_enc: Optional[bytes] = None
        self.k_up_enc: Optional[bytes] = None
        self.pending_erabs: list[S.ErabToSetup] = []
        self.erab_teids: dict[int, int] = {}       # erab_id -> eNB DL teid
        self.spgw_teids: dict[int, int] = {}       # erab_id -> SPGW UL teid
        self.erab_by_lcid: dict[int, int] = {}     # lcid -> erab_id


class RrcEnb:
    def __init__(self, cell: EnbCellConfig | None = None,
                 tx_rrc: Callable[[int, int, bytes], None] | None = None,
                 tx_s1ap: Callable[[bytes], None] | None = None) -> None:
        self.cell = cell or EnbCellConfig()
        self.tx_rrc = tx_rrc or (lambda rnti, lcid, pdu: None)
        self.tx_s1ap = tx_s1ap or (lambda pdu: None)
        self.ues: dict[int, UeCtx] = {}            # by rnti
        self.by_enb_id: dict[int, UeCtx] = {}
        self.next_rnti = 0x46
        self.next_enb_ue_id = 1
        self.next_teid = self.cell.enb_s1u_teid_base
        self.neighbor_pcis: set[int] = set()
        # PCIs served by OTHER eNBs: S1 handover instead of intra-eNB
        self.s1_neighbors: dict[int, int] = {}     # pci -> global eNB id
        self.a3_offset_rsrp: int = 60  # report threshold index (36.133)
        self.pcch_tx = lambda pdu: None
        self.events: list[str] = []

    # -- system information (rrc_cell_cfg.cc) ------------------------------

    def gen_mib(self, sfn: int = 0) -> R.Mib:
        return R.Mib(dl_bandwidth=self.cell.nof_prb, sfn=sfn)

    def gen_sib1(self) -> R.Sib1:
        return R.Sib1(plmn_mcc=self.cell.mcc, plmn_mnc=self.cell.mnc,
                      tac=self.cell.tac, cell_id=self.cell.cell_id)

    def gen_sib2(self) -> R.Sib2:
        return R.Sib2()

    def s1_setup(self) -> None:
        self.tx_s1ap(S.pack_pdu(S.PROC_S1_SETUP, S.PDU_INITIATING,
                                S.S1SetupRequest(tac=self.cell.tac)))

    # -- UL RRC ------------------------------------------------------------

    def rx_ccch(self, tmp_rnti: int, pdu: bytes) -> int:
        """CCCH from a just-RACHed UE; returns the allocated C-RNTI."""
        msg = R.unpack_ul_ccch(pdu)
        if isinstance(msg, R.RrcConnectionRequest):
            # the MAC allocated the C-RNTI at RACH time (mac.cc
            # rach_detected); standalone use (tmp_rnti=0) self-allocates
            if tmp_rnti:
                rnti = tmp_rnti
                self.next_rnti = max(self.next_rnti, rnti + 1)
            else:
                rnti = self.next_rnti
                self.next_rnti += 1
            ue = UeCtx(rnti, self.next_enb_ue_id)
            self.next_enb_ue_id += 1
            self.ues[rnti] = ue
            self.by_enb_id[ue.enb_ue_s1ap_id] = ue
            self.events.append(f"conn_request rnti={rnti:#x}")
            self.tx_rrc(rnti, SRB0_LCID,
                        R.RrcConnectionSetup(rnti=rnti).pack())
            return rnti
        if isinstance(msg, R.RrcConnectionReestablishmentRequest):
            # 36.331 5.3.7: accept when the UE context (C-RNTI at this
            # cell) is known and security was activated; else reject
            old = self.ues.get(msg.c_rnti)
            self.events.append("reest_request")
            if old is not None and old.k_rrc_int is not None \
                    and msg.phys_cell_id == self.cell.pci:
                rnti = self.next_rnti
                self.next_rnti += 1
                self.ues[rnti] = old
                del self.ues[msg.c_rnti]
                old.rnti = rnti
                self.events.append(f"reest_accept {msg.c_rnti:#x}->"
                                   f"{rnti:#x}")
                self.tx_rrc(rnti, SRB0_LCID,
                            R.RrcConnectionReestablishment(rnti=rnti).pack())
                return rnti
            self.tx_rrc(tmp_rnti, SRB0_LCID,
                        R.RrcConnectionReestablishmentReject().pack())
            return 0
        return 0

    def rx_dcch(self, rnti: int, lcid: int, pdcp_pdu: bytes) -> None:
        ue = self.ues.get(rnti)
        if ue is None:
            return
        n0 = len(ue.srb1.delivered)
        ue.srb1.write_pdu(pdcp_pdu, direction=0)
        for sdu in ue.srb1.delivered[n0:]:
            self._handle_dcch(ue, sdu)

    def _tx_dcch(self, ue: UeCtx, rrc_pdu: bytes) -> None:
        self.tx_rrc(ue.rnti, SRB1_LCID, ue.srb1.write_sdu(rrc_pdu, direction=1))

    def _handle_dcch(self, ue: UeCtx, pdu: bytes) -> None:
        msg = R.unpack_ul_dcch(pdu)
        if isinstance(msg, R.RrcConnectionSetupComplete):
            ue.state = "CONNECTED"
            self.events.append("setup_complete")
            self.tx_s1ap(S.pack_pdu(
                S.PROC_INITIAL_UE_MESSAGE, S.PDU_INITIATING,
                S.InitialUeMessage(enb_ue_s1ap_id=ue.enb_ue_s1ap_id,
                                   nas_pdu=msg.nas_pdu,
                                   tac=self.cell.tac,
                                   cell_id=self.cell.cell_id)))
        elif isinstance(msg, R.UlInformationTransfer):
            self.tx_s1ap(S.pack_pdu(
                S.PROC_UPLINK_NAS_TRANSPORT, S.PDU_INITIATING,
                S.NasTransport(mme_ue_s1ap_id=ue.mme_ue_s1ap_id,
                               enb_ue_s1ap_id=ue.enb_ue_s1ap_id,
                               nas_pdu=msg.nas_pdu)))
        elif isinstance(msg, R.SecurityModeCompleteRrc):
            # ciphering active from the next message on both directions
            ue.srb1.cfg.cipher_key = ue.k_rrc_enc
            self.events.append("security_activated")
            self._setup_bearers(ue)
        elif isinstance(msg, R.RrcConnectionReconfigurationComplete):
            self.events.append("reconf_complete")
            if ue.state == "HO_IN":
                # UE arrived from the source cell (36.413 8.4.3)
                ue.state = "ACTIVE"
                self.events.append("ho_complete")
                self.tx_s1ap(S.pack_pdu(
                    S.PROC_HANDOVER_NOTIFY, S.PDU_INITIATING,
                    S.HandoverNotify(mme_ue_s1ap_id=ue.mme_ue_s1ap_id,
                                     enb_ue_s1ap_id=ue.enb_ue_s1ap_id,
                                     tac=self.cell.tac,
                                     cell_id=self.cell.cell_id)))
                return
            if ue.state == "RECONF_SENT":
                ue.state = "ACTIVE"
                erabs = [S.ErabSetupItem(erab_id=eid, gtp_teid=teid)
                         for eid, teid in ue.erab_teids.items()]
                self.tx_s1ap(S.pack_pdu(
                    S.PROC_INITIAL_CONTEXT_SETUP, S.PDU_SUCCESSFUL,
                    S.InitialContextSetupResponse(
                        mme_ue_s1ap_id=ue.mme_ue_s1ap_id,
                        enb_ue_s1ap_id=ue.enb_ue_s1ap_id, erabs=erabs)))
        elif isinstance(msg, R.MeasReport):
            self.events.append(f"meas_report pci={msg.pci}")
            self._handle_measurement(ue, msg)

    # -- S1AP (MME -> eNB) -------------------------------------------------

    def rx_s1ap(self, raw: bytes) -> None:
        try:
            proc, pdu_type, msg = S.unpack_pdu(raw)
        except (ValueError, IndexError):
            self.events.append("malformed_s1ap")
            return
        if proc == S.PROC_S1_SETUP and pdu_type == S.PDU_SUCCESSFUL:
            self.events.append("s1_setup_ok")
            return
        if proc == S.PROC_DOWNLINK_NAS_TRANSPORT:
            ue = self.by_enb_id.get(msg.enb_ue_s1ap_id)
            if ue:
                ue.mme_ue_s1ap_id = msg.mme_ue_s1ap_id
                self._tx_dcch(ue, R.DlInformationTransfer(
                    nas_pdu=msg.nas_pdu).pack())
            return
        if proc == S.PROC_INITIAL_CONTEXT_SETUP and \
                pdu_type == S.PDU_INITIATING:
            ue = self.by_enb_id.get(msg.enb_ue_s1ap_id)
            if ue is None:
                return
            ue.mme_ue_s1ap_id = msg.mme_ue_s1ap_id
            ue.k_enb = msg.security_key
            ue.pending_erabs = msg.erabs
            for e in msg.erabs:
                ue.spgw_teids[e.erab_id] = e.gtp_teid
            # RRC security mode first (rrc_ue.cc send_security_mode_command)
            ue.k_rrc_int = security.k_rrc_up(ue.k_enb, 2, "rrc_int")
            ue.k_rrc_enc = security.k_rrc_up(ue.k_enb, 2, "rrc_enc")
            ue.k_up_enc = security.k_rrc_up(ue.k_enb, 2, "up_enc")
            ue.srb1.cfg.integrity_key = ue.k_rrc_int
            self._tx_dcch(ue, R.SecurityModeCommandRrc(
                ciph_alg=2, integ_alg=2).pack())
            self.events.append("smc_sent")
            return
        if proc == S.PROC_PAGING:
            self.pcch_tx(self.page(msg.mtmsi))
            return
        if proc == S.PROC_UE_CONTEXT_RELEASE:
            ue = self.by_enb_id.get(msg.enb_ue_s1ap_id)
            if ue:
                if ue.state != "HO_OUT":  # moved UEs are gone already
                    self._tx_dcch(ue, R.RrcConnectionRelease().pack())
                self.ues.pop(ue.rnti, None)
                self.by_enb_id.pop(ue.enb_ue_s1ap_id, None)
            return
        if proc == S.PROC_HANDOVER_REQUEST and pdu_type == S.PDU_INITIATING:
            self._ho_request(msg)  # we are the target eNB
            return
        if proc == S.PROC_HANDOVER_REQUIRED and pdu_type == S.PDU_SUCCESSFUL:
            self._ho_command(msg)  # we are the source eNB
            return
        if proc == S.PROC_MME_STATUS_TRANSFER:
            self._mme_status_transfer(msg)
            return
        self.events.append(f"unhandled_s1ap:{proc}")

    def _setup_bearers(self, ue: UeCtx) -> None:
        """After security: RRCConnectionReconfiguration with the pending
        E-RABs as DRBs + piggybacked NAS (rrc_bearer_cfg.cc)."""
        drbs = []
        nas_pdu = b""
        for i, e in enumerate(ue.pending_erabs):
            drb_id = i + 1
            lcid = 3 + i
            drbs.append(R.DrbToAddMod(drb_id=drb_id, eps_bearer_id=e.erab_id,
                                      lcid=lcid, rlc_mode="am"))
            ue.drbs[lcid] = PdcpEntity(PdcpConfig(
                is_control=False, bearer_id=drb_id + 2,
                cipher_key=ue.k_up_enc))
            ue.erab_teids[e.erab_id] = self.next_teid
            ue.erab_by_lcid[lcid] = e.erab_id
            self.next_teid += 1
            if e.nas_pdu:
                nas_pdu = e.nas_pdu
        ue.state = "RECONF_SENT"
        self._tx_dcch(ue, R.RrcConnectionReconfiguration(
            drbs=drbs, nas_pdu=nas_pdu).pack())

    # -- mobility (rrc_mobility.cc) ----------------------------------------

    def _handle_measurement(self, ue: UeCtx, rep: "R.MeasReport") -> None:
        """A3-style decision: neighbor above serving + offset -> intra-eNB
        handover via reconfiguration-with-mobilityControlInfo, or S1
        handover when the PCI belongs to another eNB.  A B1 NR report
        triggers EN-DC SgNB addition instead (rrc_endc.cc)."""
        if rep.is_nr:
            self._start_endc(ue)
            return
        if rep.rsrp < self.a3_offset_rsrp or rep.pci == self.cell.pci:
            return
        if rep.pci in self.s1_neighbors:
            self._s1_ho_required(ue, rep.pci)
            return
        if rep.pci not in self.neighbor_pcis:
            return
        old_rnti = ue.rnti
        new_rnti = self.next_rnti
        self.next_rnti += 1
        self._tx_dcch(ue, R.RrcConnectionReconfiguration(
            mobility=R.MobilityControlInfo(
                target_pci=rep.pci, new_c_rnti=new_rnti)).pack())
        # re-key the context under the new C-RNTI (intra-eNB: same ctx)
        self.ues[new_rnti] = ue
        del self.ues[old_rnti]
        ue.rnti = new_rnti
        self.events.append(f"ho_cmd {old_rnti:#x}->{new_rnti:#x} "
                           f"pci={rep.pci}")

    # -- EN-DC (rrc_endc.cc) -------------------------------------------------

    def enable_endc(self, endc) -> None:
        """Attach an x2.EnbEndc controller (NSA mode)."""
        self.endc = endc

    def _start_endc(self, ue: UeCtx) -> None:
        """B1 NR report received: SgNB Addition over X2, then the LTE
        reconfiguration carrying nr-SecondaryCellGroup + sk-Counter."""
        endc = getattr(self, "endc", None)
        if endc is None or not ue.k_enb:
            return
        erab_id = next(iter(ue.erab_teids), 5)
        sk_counter = getattr(self, "_sk_counter", 0)
        self._sk_counter = sk_counter + 1
        s_kgnb = security.s_kgnb(ue.k_enb, sk_counter)
        res = endc.start_endc(rnti=ue.rnti, erab_id=erab_id,
                              spgw_teid=ue.spgw_teids.get(erab_id, 0),
                              s_kgnb=s_kgnb)
        ue.nr_gnb_teid = res["gnb_teid"]
        ue.nr_rnti = res["nr_rnti"]
        self._tx_dcch(ue, R.RrcConnectionReconfiguration(
            nr_scg=res["nr_config"], sk_counter=sk_counter).pack())
        self.events.append(f"endc_start rnti={ue.rnti:#x} "
                           f"nr_rnti={res['nr_rnti']:#x}")

    # -- S1 handover (rrc_mobility.cc s1_source_ho_st / s1ap.cc HO procs) ---

    def _s1_ho_required(self, ue: UeCtx, target_pci: int) -> None:
        """Source role: HandoverRequired with the AS-Config container
        (36.413 8.4.1, rrc_mobility.cc start_s1_tenb_ho)."""
        as_cfg = R.AsConfig(
            source_pci=self.cell.pci,
            drbs=[R.DrbToAddMod(drb_id=eid - 4 if eid >= 5 else eid,
                                eps_bearer_id=eid, lcid=lcid)
                  for lcid, eid in ue.erab_by_lcid.items()])
        ue.state = "HO_PREP"
        self.events.append(f"s1_ho_required pci={target_pci}")
        self.tx_s1ap(S.pack_pdu(
            S.PROC_HANDOVER_REQUIRED, S.PDU_INITIATING,
            S.HandoverRequired(mme_ue_s1ap_id=ue.mme_ue_s1ap_id,
                               enb_ue_s1ap_id=ue.enb_ue_s1ap_id,
                               target_enb_id=self.s1_neighbors[target_pci],
                               container=as_cfg.pack())))

    def _ho_command(self, msg: "S.HandoverCommand") -> None:
        """Source role: forward the target-built RRC handover command to
        the UE (transparently, ciphered with the SOURCE keys) and send
        the eNB Status Transfer with the DRB PDCP COUNTs."""
        ue = self.by_enb_id.get(msg.enb_ue_s1ap_id)
        if ue is None:
            return
        self._tx_dcch(ue, msg.container)
        bearers = [S.BearerStatus(erab_id=ue.erab_by_lcid[lcid],
                                  ul_count=ent.next_rx_count,
                                  dl_count=ent.tx_count)
                   for lcid, ent in ue.drbs.items()]
        ue.state = "HO_OUT"
        self.events.append("s1_ho_command_fwd")
        self.tx_s1ap(S.pack_pdu(
            S.PROC_ENB_STATUS_TRANSFER, S.PDU_INITIATING,
            S.StatusTransfer(mme_ue_s1ap_id=ue.mme_ue_s1ap_id,
                             enb_ue_s1ap_id=ue.enb_ue_s1ap_id,
                             bearers=bearers)))

    def _ho_request(self, msg: "S.HandoverRequest") -> None:
        """Target role: admit the UE, derive K_eNB* vertically from the
        MME's {NH, NCC}, rebuild the bearers from the AS-Config, and
        answer with the RRC handover command as the target→source
        container (36.413 8.4.2, rrc_mobility.cc handle_ho_req)."""
        as_cfg = R.AsConfig.unpack(msg.container)
        rnti = self.next_rnti
        self.next_rnti += 1
        ue = UeCtx(rnti, self.next_enb_ue_id)
        self.next_enb_ue_id += 1
        self.ues[rnti] = ue
        self.by_enb_id[ue.enb_ue_s1ap_id] = ue
        ue.mme_ue_s1ap_id = msg.mme_ue_s1ap_id
        ue.k_enb = security.k_enb_star(msg.security_key, self.cell.pci)
        ue.k_rrc_int = security.k_rrc_up(ue.k_enb, 2, "rrc_int")
        ue.k_rrc_enc = security.k_rrc_up(ue.k_enb, 2, "rrc_enc")
        ue.k_up_enc = security.k_rrc_up(ue.k_enb, 2, "up_enc")
        # fresh SRB1 under the new keys; the UE's ReconfigurationComplete
        # arrives here already integrity-protected + ciphered
        ue.srb1 = PdcpEntity(PdcpConfig(is_control=True, bearer_id=1,
                                        integrity_key=ue.k_rrc_int,
                                        cipher_key=ue.k_rrc_enc))
        admitted = []
        by_eps = {d.eps_bearer_id: d for d in as_cfg.drbs}
        for e in msg.erabs:
            drb = by_eps.get(e.erab_id)
            if drb is None:
                continue
            ue.drbs[drb.lcid] = PdcpEntity(PdcpConfig(
                is_control=False, bearer_id=drb.drb_id + 2,
                cipher_key=ue.k_up_enc))
            ue.erab_teids[e.erab_id] = self.next_teid
            ue.erab_by_lcid[drb.lcid] = e.erab_id
            ue.spgw_teids[e.erab_id] = e.gtp_teid
            admitted.append(S.ErabSetupItem(erab_id=e.erab_id,
                                            gtp_teid=self.next_teid))
            self.next_teid += 1
        ho_cmd = R.RrcConnectionReconfiguration(
            drbs=as_cfg.drbs,
            mobility=R.MobilityControlInfo(target_pci=self.cell.pci,
                                           new_c_rnti=rnti,
                                           ncc=msg.ncc)).pack()
        ue.state = "HO_IN"
        self.events.append("s1_ho_request_ack")
        self.tx_s1ap(S.pack_pdu(
            S.PROC_HANDOVER_REQUEST, S.PDU_SUCCESSFUL,
            S.HandoverRequestAcknowledge(
                mme_ue_s1ap_id=msg.mme_ue_s1ap_id,
                enb_ue_s1ap_id=ue.enb_ue_s1ap_id,
                erabs=admitted, container=ho_cmd)))

    def _mme_status_transfer(self, msg: "S.StatusTransfer") -> None:
        """Target role: continue the DRB PDCP COUNTs where the source
        left off (36.413 8.4.5)."""
        ue = self.by_enb_id.get(msg.enb_ue_s1ap_id)
        if ue is None:
            return
        lcid_by_erab = {eid: lcid for lcid, eid in ue.erab_by_lcid.items()}
        for b in msg.bearers:
            lcid = lcid_by_erab.get(b.erab_id)
            if lcid is not None:
                # our DL continues the source's DL; their UL is our RX
                ue.drbs[lcid].set_counts(tx_count=b.dl_count,
                                         rx_next=b.ul_count)
        self.events.append("s1_ho_counts_set")

    # -- paging (rrc_paging.cc) --------------------------------------------

    def page(self, mtmsi: int) -> bytes:
        """Build the PCCH payload for one paging record; the PHY layer
        broadcasts it on the paging occasions."""
        self.events.append(f"paging {mtmsi:#x}")
        return R.Paging(tmsis=[mtmsi]).pack()

    # -- user plane helpers ------------------------------------------------

    def drb_tx(self, rnti: int, lcid: int, sdu: bytes) -> bytes:
        """Cipher a DL user-plane SDU for the UE (returns PDCP PDU)."""
        return self.ues[rnti].drbs[lcid].write_sdu(sdu, direction=1)

    def drb_rx(self, rnti: int, lcid: int, pdu: bytes) -> list[bytes]:
        ent = self.ues[rnti].drbs[lcid]
        n0 = len(ent.delivered)
        ent.write_pdu(pdu, direction=0)
        return ent.delivered[n0:]
