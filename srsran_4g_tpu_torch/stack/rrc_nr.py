"""NR RRC (TS 38.331): SA connection entities on the 3GPP-exact codec.

Counterpart of the reference's generated RRC-NR codec (`lib/src/asn1/
rrc_nr.cc`, ~60 k LoC), `srsue/src/stack/rrc_nr/` and
`srsgnb/src/stack/rrc/rrc_nr.cc` (~4.5 k): RRCSetupRequest/RRCSetup/
RRCSetupComplete, SecurityModeCommand/Complete, RRCReconfiguration
with the full RadioBearerConfig DRB/SDAP/PDCP substructure, and UL/DL
InformationTransfer — driving the SA registration flow against
ngap.Amf, with PDCP-NR on SRB1 and SDAP/PDCP-NR on DRBs.

Every PDU on SRB0/SRB1 is 38.331 UPER via the declarative schemas in
`rrc_nr_uper.py` (the round-4 LTE treatment applied to the NR wire):
UL-CCCH/DL-CCCH/UL-DCCH/DL-DCCH message wrappers, proven byte-exact
through the reference's own compiled rrc_nr.cc in
tests/test_rrc_nr_wire_exact.py.  One deliberate container use: the
RRCSetup `masterCellGroup` OCTET STRING (opaque on the wire per ASN.1)
carries the framework's 2-byte C-RNTI assignment instead of a full
CellGroupConfig — in the reference the C-RNTI arrives via the MAC RA
procedure which this SA model folds into RRC setup.
"""

from __future__ import annotations

from typing import Callable, Optional

from . import ngap
from . import nas_5g as N5
from . import rrc_nr_uper as U
from . import security
from .pdcp_nr import PdcpNrConfig, PdcpNrEntity, sdap_pack, sdap_unpack

# 33.501: NEA2/NIA2 (AES) — the algorithm ids signalled in the AS SMC
# and fed to the key derivations
CIPH_ALG = 2
INT_ALG = 2


def _srb1_config() -> dict:
    return {"srb_identity": 1}


def _ies(msg_value: dict, key: str) -> dict:
    """critical_extensions → the IEs branch (asserting it is not
    criticalExtensionsFuture)."""
    name, v = msg_value["critical_extensions"]
    assert name == key, (name, key)
    return v


class RrcNrUe:
    """UE-side SA RRC (srsue rrc_nr + nas_5g glue)."""

    def __init__(self, nas: N5.Nas5gUe | None = None,
                 tx: Callable[[int, bytes], None] | None = None) -> None:
        self.nas = nas or N5.Nas5gUe()
        self.tx = tx or (lambda lcid, pdu: None)
        self.state = "IDLE"
        self.c_rnti = 0
        self.srb1: Optional[PdcpNrEntity] = None
        self.drbs: dict[int, PdcpNrEntity] = {}
        self.drb_qfi: dict[int, int] = {}
        self.events: list[str] = []

    def connect(self) -> None:
        self.state = "CONNECTING"
        pdu = U.pack_msg(U.UL_CCCH_MESSAGE, "rrc_setup_request", {
            "rrc_setup_request": {
                "ue_id": ("random_value", 0x123456789 & ((1 << 39) - 1)),
                "establishment_cause": 3,    # mo-Signalling
                "spare": 0}})
        self.tx(0, pdu)
        self.events.append("setup_request")

    def rx_ccch(self, pdu: bytes) -> None:
        name, v = U.unpack_msg(U.DL_CCCH_MESSAGE, pdu)
        assert name == "rrc_setup", name
        ies = _ies(v, "rrc_setup")
        # C-RNTI from the masterCellGroup container (see module docstring)
        self.c_rnti = int.from_bytes(ies["master_cell_group"][:2], "big")
        self.state = "CONNECTED"
        self.srb1 = PdcpNrEntity(PdcpNrConfig(is_srb=True, bearer_id=1))
        self.events.append("setup")
        nas_pdu = self.nas.start_registration()
        self._tx_dcch(U.pack_msg(U.UL_DCCH_MESSAGE, "rrc_setup_complete", {
            "rrc_transaction_id": v["rrc_transaction_id"],
            "critical_extensions": ("rrc_setup_complete", {
                "selected_plmn_identity": 1,
                "dedicated_nas_msg": nas_pdu})}))

    def _tx_dcch(self, rrc_pdu: bytes) -> None:
        self.tx(1, self.srb1.write_sdu(rrc_pdu, direction=0))

    def _tx_ul_info(self, nas_pdu: bytes) -> None:
        self._tx_dcch(U.pack_msg(
            U.UL_DCCH_MESSAGE, "ul_information_transfer",
            {"critical_extensions": ("ul_information_transfer",
                                     {"dedicated_nas_msg": nas_pdu})}))

    def rx_dcch(self, pdcp_pdu: bytes) -> None:
        n0 = len(self.srb1.delivered)
        self.srb1.write_pdu(pdcp_pdu, direction=1)
        for sdu in self.srb1.delivered[n0:]:
            self._handle(sdu)

    def _handle(self, pdu: bytes) -> None:
        name, v = U.unpack_msg(U.DL_DCCH_MESSAGE, pdu)
        if name == "security_mode_command":
            ies = _ies(v, "security_mode_command")
            alg = ies["security_config_smc"]["security_algorithm_config"]
            ciph = alg["ciphering_algorithm"]
            integ = alg.get("integrity_prot_algorithm", 0)
            # derive AS keys off K_gNB (38.331 5.3.4 + 33.501 A.8)
            k_gnb = security._kdf(self.nas.k_amf, 0x6E, b"\x00\x00\x00\x01")
            k_int = security.k_rrc_up(k_gnb, integ, "rrc_int")
            k_enc = security.k_rrc_up(k_gnb, ciph, "rrc_enc")
            self.k_up_enc = security.k_rrc_up(k_gnb, ciph, "up_enc")
            self.srb1.cfg.integrity_key = k_int
            self._tx_dcch(U.pack_msg(
                U.UL_DCCH_MESSAGE, "security_mode_complete",
                {"rrc_transaction_id": v["rrc_transaction_id"],
                 "critical_extensions": ("security_mode_complete", {})}))
            self.srb1.cfg.cipher_key = k_enc
            self.events.append("as_security")
        elif name == "rrc_reconfiguration":
            ies = _ies(v, "rrc_reconfiguration")
            rbc = ies.get("radio_bearer_config", {})
            for drb in rbc.get("drb_to_add_mod_list", []):
                lcid = drb["drb_identity"]
                qfi = 1
                assoc = drb.get("cn_association")
                if assoc is not None and assoc[0] == "sdap_config":
                    flows = assoc[1].get("mapped_qos_flows_to_add", [1])
                    qfi = flows[0] if flows else 1
                self.drbs[lcid] = PdcpNrEntity(PdcpNrConfig(
                    is_srb=False, sn_len=18, bearer_id=lcid,
                    cipher_key=getattr(self, "k_up_enc", None)))
                self.drb_qfi[lcid] = qfi
                self.events.append(f"drb{lcid}_up")
            nce = ies.get("non_critical_extension", {})
            for nas in nce.get("dedicated_nas_msg_list", []):
                for ul in self.nas.rx(nas):
                    self._tx_ul_info(ul)
            self._tx_dcch(U.pack_msg(
                U.UL_DCCH_MESSAGE, "rrc_reconfiguration_complete",
                {"rrc_transaction_id": v["rrc_transaction_id"],
                 "critical_extensions":
                     ("rrc_reconfiguration_complete", {})}))
        elif name == "dl_information_transfer":
            ies = _ies(v, "dl_information_transfer")
            nas = ies.get("dedicated_nas_msg", b"")
            for ul in self.nas.rx(nas):
                self._tx_ul_info(ul)

    # user plane (SDAP on top of PDCP-NR)
    def write_drb_sdu(self, lcid: int, ip_pkt: bytes) -> None:
        sdu = sdap_pack(ip_pkt, self.drb_qfi.get(lcid, 1))
        self.tx(lcid, self.drbs[lcid].write_sdu(sdu, direction=0))

    def rx_drb_pdu(self, lcid: int, pdu: bytes) -> list[bytes]:
        ent = self.drbs[lcid]
        n0 = len(ent.delivered)
        ent.write_pdu(pdu, direction=1)
        return [sdap_unpack(s)[0] for s in ent.delivered[n0:]]


class GnbUeCtx:
    def __init__(self, rnti: int, ran_ue_id: int) -> None:
        self.rnti = rnti
        self.ran_ue_id = ran_ue_id
        self.amf_ue_id = 0
        self.srb1 = PdcpNrEntity(PdcpNrConfig(is_srb=True, bearer_id=1))
        self.drbs: dict[int, PdcpNrEntity] = {}
        self.k_gnb = b""
        self.k_up_enc: Optional[bytes] = None
        self.pending_sessions: list = []
        self.state = "SETUP"
        self.n3_teids: dict[int, int] = {}


class RrcNrGnb:
    """gNB-side SA RRC + NGAP glue (srsgnb rrc_nr.cc / ngap.cc)."""

    def __init__(self, tx_rrc=None, tx_ngap=None) -> None:
        self.tx_rrc = tx_rrc or (lambda rnti, lcid, pdu: None)
        self.tx_ngap = tx_ngap or (lambda pdu: None)
        self.ues: dict[int, GnbUeCtx] = {}
        self.by_ran_id: dict[int, GnbUeCtx] = {}
        self.next_rnti = 0x4601
        self.next_ran_id = 1
        self.next_teid = 0x2000
        self.events: list[str] = []

    def ng_setup(self) -> None:
        self.tx_ngap(ngap.pack_pdu(ngap.PROC_NG_SETUP, ngap.PDU_INITIATING,
                                   ngap.NgSetupRequest()))

    def rx_ccch(self, pdu: bytes) -> int:
        name, _ = U.unpack_msg(U.UL_CCCH_MESSAGE, pdu)
        assert name == "rrc_setup_request", name
        rnti = self.next_rnti
        self.next_rnti += 1
        ue = GnbUeCtx(rnti, self.next_ran_id)
        self.next_ran_id += 1
        self.ues[rnti] = ue
        self.by_ran_id[ue.ran_ue_id] = ue
        self.events.append("setup_request")
        setup = U.pack_msg(U.DL_CCCH_MESSAGE, "rrc_setup", {
            "rrc_transaction_id": 0,
            "critical_extensions": ("rrc_setup", {
                "radio_bearer_config": {
                    "srb_to_add_mod_list": [_srb1_config()]},
                "master_cell_group": rnti.to_bytes(2, "big")})})
        self.tx_rrc(rnti, 0, setup)
        return rnti

    def _tx_dcch(self, ue: GnbUeCtx, pdu: bytes) -> None:
        self.tx_rrc(ue.rnti, 1, ue.srb1.write_sdu(pdu, direction=1))

    def _tx_dl_info(self, ue: GnbUeCtx, nas_pdu: bytes) -> None:
        self._tx_dcch(ue, U.pack_msg(
            U.DL_DCCH_MESSAGE, "dl_information_transfer",
            {"rrc_transaction_id": 0,
             "critical_extensions": ("dl_information_transfer",
                                     {"dedicated_nas_msg": nas_pdu})}))

    def rx_dcch(self, rnti: int, pdcp_pdu: bytes) -> None:
        ue = self.ues.get(rnti)
        if ue is None:
            return
        n0 = len(ue.srb1.delivered)
        ue.srb1.write_pdu(pdcp_pdu, direction=0)
        for sdu in ue.srb1.delivered[n0:]:
            self._handle(ue, sdu)

    def _handle(self, ue: GnbUeCtx, pdu: bytes) -> None:
        name, v = U.unpack_msg(U.UL_DCCH_MESSAGE, pdu)
        if name == "rrc_setup_complete":
            ies = _ies(v, "rrc_setup_complete")
            ue.state = "CONNECTED"
            self.tx_ngap(ngap.pack_pdu(
                ngap.PROC_INITIAL_UE_MESSAGE, ngap.PDU_INITIATING,
                ngap.NgInitialUeMessage(ran_ue_id=ue.ran_ue_id,
                                        nas_pdu=ies["dedicated_nas_msg"])))
        elif name == "security_mode_complete":
            ue.srb1.cfg.cipher_key = security.k_rrc_up(ue.k_gnb, CIPH_ALG,
                                                       "rrc_enc")
            self.events.append("as_security")
            nas = getattr(ue, "pending_nas", b"")
            if nas:
                ue.pending_nas = b""
                self._tx_dl_info(ue, nas)
            self._setup_drbs(ue)
        elif name == "rrc_reconfiguration_complete":
            self.events.append("reconf_complete")
            if ue.state == "RECONF":
                ue.state = "ACTIVE"
                self.tx_ngap(ngap.pack_pdu(
                    ngap.PROC_INITIAL_CTX_SETUP, ngap.PDU_SUCCESSFUL,
                    ngap.NgInitialCtxSetupResponse(
                        amf_ue_id=ue.amf_ue_id, ran_ue_id=ue.ran_ue_id,
                        gnb_teids=[(sid, teid) for sid, teid
                                   in ue.n3_teids.items()])))
        elif name == "ul_information_transfer":
            ies = _ies(v, "ul_information_transfer")
            self.tx_ngap(ngap.pack_pdu(
                ngap.PROC_UL_NAS_TRANSPORT, ngap.PDU_INITIATING,
                ngap.NgNasTransport(amf_ue_id=ue.amf_ue_id,
                                    ran_ue_id=ue.ran_ue_id,
                                    nas_pdu=ies.get("dedicated_nas_msg",
                                                    b""))))

    def rx_ngap(self, raw: bytes) -> None:
        try:
            proc, t, msg = ngap.unpack_pdu(raw)
        except (ValueError, IndexError):
            self.events.append("malformed_ngap")
            return
        if proc == ngap.PROC_NG_SETUP and t == ngap.PDU_SUCCESSFUL:
            self.events.append("ng_setup_ok")
            return
        if proc == ngap.PROC_DL_NAS_TRANSPORT:
            ue = self.by_ran_id.get(msg.ran_ue_id)
            if ue:
                ue.amf_ue_id = msg.amf_ue_id
                self._tx_dl_info(ue, msg.nas_pdu)
            return
        if proc == ngap.PROC_INITIAL_CTX_SETUP and t == ngap.PDU_INITIATING:
            ue = self.by_ran_id.get(msg.ran_ue_id)
            if ue is None:
                return
            ue.amf_ue_id = msg.amf_ue_id
            ue.k_gnb = msg.security_key
            ue.pending_sessions = list(msg.pdu_sessions)
            ue.srb1.cfg.integrity_key = security.k_rrc_up(ue.k_gnb, INT_ALG,
                                                          "rrc_int")
            ue.k_up_enc = security.k_rrc_up(ue.k_gnb, CIPH_ALG, "up_enc")
            # the ICS NAS PDU goes out as its own DLInformationTransfer
            # AFTER AS security activates — the AS SecurityModeCommand
            # carries no NAS container (38.331 §6.2.2), and an
            # integrity-protected PDCP PDU before the UE's key activation
            # would be dropped
            ue.pending_nas = msg.nas_pdu
            self._tx_dcch(ue, U.pack_msg(
                U.DL_DCCH_MESSAGE, "security_mode_command",
                {"rrc_transaction_id": 0,
                 "critical_extensions": ("security_mode_command", {
                     "security_config_smc": {
                         "security_algorithm_config": {
                             "ciphering_algorithm": CIPH_ALG,
                             "integrity_prot_algorithm": INT_ALG}}})}))
            self.events.append("smc_sent")
            return

    def _setup_drbs(self, ue: GnbUeCtx) -> None:
        drb_list = []
        nas_list = []
        for i, (sid, teid, nas) in enumerate(ue.pending_sessions):
            lcid = 4 + i
            drb_list.append({
                "cn_association": ("sdap_config", {
                    "pdu_session": sid,
                    "sdap_hdr_dl": 1,       # absent
                    "sdap_hdr_ul": 1,
                    "default_drb": True,
                    "mapped_qos_flows_to_add": [1]}),
                "drb_identity": lcid,
                "pdcp_config": {
                    "drb": {"pdcp_sn_size_ul": 1, "pdcp_sn_size_dl": 1,
                            "header_compression": ("not_used", None)},
                    "t_reordering": 0}})
            ue.drbs[lcid] = PdcpNrEntity(PdcpNrConfig(
                is_srb=False, sn_len=18, bearer_id=lcid,
                cipher_key=ue.k_up_enc))
            ue.n3_teids[sid] = self.next_teid
            self.next_teid += 1
            if nas:
                nas_list.append(nas)
        ue.state = "RECONF"
        ies = {"radio_bearer_config": {"drb_to_add_mod_list": drb_list}}
        if nas_list:
            ies["non_critical_extension"] = {
                "dedicated_nas_msg_list": nas_list}
        self._tx_dcch(ue, U.pack_msg(
            U.DL_DCCH_MESSAGE, "rrc_reconfiguration",
            {"rrc_transaction_id": 1,
             "critical_extensions": ("rrc_reconfiguration", ies)}))

    def drb_tx(self, rnti: int, lcid: int, ip_pkt: bytes) -> bytes:
        ue = self.ues[rnti]
        return ue.drbs[lcid].write_sdu(sdap_pack(ip_pkt, 1), direction=1)

    def drb_rx(self, rnti: int, lcid: int, pdu: bytes) -> list[bytes]:
        ent = self.ues[rnti].drbs[lcid]
        n0 = len(ent.delivered)
        ent.write_pdu(pdu, direction=0)
        return [sdap_unpack(s)[0] for s in ent.delivered[n0:]]
