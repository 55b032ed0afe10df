"""EPC core network: MME (EMM/S1AP), HSS (AKA vectors), SPGW (sessions).

Counterpart of `srsepc/` (~9 k LoC): `srsepc/src/mme/nas.cc` (per-UE EMM
state machine: attach, AKA authentication, security mode, ESM default
bearer, detach), `srsepc/src/hss/hss.cc` (user DB + Milenage vector
generation with SQN resync), `srsepc/src/spgw/` (GTP-C session state,
TEID/IP allocation, S1-U <-> SGi forwarding).

Transport-agnostic: the MME consumes/produces S1AP PDUs (s1ap_msgs);
tools/run_lte.py wires it to the eNB in-process or over the native TCP
bridge (the reference uses SCTP — replaced per SURVEY.md §2.8).
"""

from __future__ import annotations

import ipaddress
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

from . import nas_msgs as M
from . import s1ap_msgs as S
from . import security

# ---------------------------------------------------------------------------
# HSS


@dataclass
class Subscriber:
    imsi: str
    k: bytes
    opc: bytes
    sqn: int = 0


class Hss:
    """AKA vector generation (hss.cc:280-318 Milenage path) with a CSV
    user DB compatible in spirit with user_db.csv."""

    def __init__(self) -> None:
        self.db: dict[str, Subscriber] = {}

    def add_subscriber(self, imsi: str, k: bytes, opc: bytes) -> None:
        self.db[imsi] = Subscriber(imsi=imsi, k=k, opc=opc)

    def load_csv(self, path: str) -> None:
        """name,auth,imsi,key,op_type,op/opc,... (user_db.csv format)."""
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(",")
                imsi, key = parts[2], bytes.fromhex(parts[3])
                op_val = bytes.fromhex(parts[5])
                opc = op_val if parts[4] == "opc" else \
                    security.opc_from_op(key, op_val)
                self.db[imsi] = Subscriber(imsi=imsi, k=key, opc=opc)

    def save_csv(self, path: str) -> None:
        """Persist SQN state on shutdown (hss.cc:205-223)."""
        with open(path, "w") as f:
            for s in self.db.values():
                f.write(f"ue,mil,{s.imsi},{s.k.hex()},opc,{s.opc.hex()},"
                        f"{s.sqn:012x}\n")

    def get_auth_vector(self, imsi: str, plmn: bytes
                        ) -> Optional[tuple[bytes, bytes, bytes, bytes]]:
        """Returns (rand, autn, xres, k_asme) or None if unknown IMSI."""
        sub = self.db.get(imsi)
        if sub is None:
            return None
        sub.sqn += 32  # increment like the reference's SQN management
        rand = os.urandom(16)
        sqn = sub.sqn.to_bytes(6, "big")
        amf = b"\x80\x00"
        mac_a, xres, ck, ik, ak = security.milenage(
            sub.k, sub.opc, rand, sqn, amf)
        sqn_xor_ak = bytes(a ^ b for a, b in zip(sqn, ak))
        autn = sqn_xor_ak + amf + mac_a
        k_asme = security.k_asme(ck, ik, plmn, sqn_xor_ak)
        return rand, autn, xres, k_asme

    def resync_sqn(self, imsi: str, auts: bytes) -> None:
        """SQN resynchronisation from AUTS (hss.cc resync path).
        AUTS carries SQNms^AK*; our soft-USIM uses plain AK."""
        sub = self.db.get(imsi)
        if sub is None:
            return
        sub.sqn += 0x10000  # jump ahead (simplified resync)


# ---------------------------------------------------------------------------
# SPGW


@dataclass
class SpgwSession:
    imsi: str
    ue_ip: bytes
    spgw_teid: int           # UL TEID (eNB -> SPGW)
    enb_teid: int = 0        # DL TEID (SPGW -> eNB)
    erab_id: int = 5


class Spgw:
    """Session/bearer management + user-plane forwarding decision
    (spgw.cc:102-155, gtpc.cc)."""

    def __init__(self, ip_pool: str = "172.16.0.0/24") -> None:
        self.sessions: dict[str, SpgwSession] = {}
        self.by_teid: dict[int, SpgwSession] = {}
        self.by_ip: dict[bytes, SpgwSession] = {}
        self.pool = list(ipaddress.ip_network(ip_pool).hosts())[1:]
        self.next_teid = 1
        self.sgi_tx: Optional[Callable[[bytes], None]] = None   # to internet
        self.s1u_tx: Optional[Callable[[int, bytes], None]] = None  # to eNB

    def create_session(self, imsi: str) -> SpgwSession:
        """GTP-C CreateSessionRequest handling: alloc TEID + UE IP."""
        ip = self.pool.pop(0).packed
        s = SpgwSession(imsi=imsi, ue_ip=ip, spgw_teid=self.next_teid)
        self.next_teid += 1
        self.sessions[imsi] = s
        self.by_teid[s.spgw_teid] = s
        self.by_ip[ip] = s
        return s

    def modify_bearer(self, imsi: str, enb_teid: int) -> None:
        """ModifyBearerRequest: learn the eNB's DL TEID."""
        if imsi in self.sessions:
            self.sessions[imsi].enb_teid = enb_teid

    def delete_session(self, imsi: str) -> None:
        s = self.sessions.pop(imsi, None)
        if s:
            self.by_teid.pop(s.spgw_teid, None)
            self.by_ip.pop(s.ue_ip, None)

    # user plane ------------------------------------------------------------

    def rx_s1u(self, teid: int, payload: bytes) -> None:
        """UL GTP-U from eNB -> SGi."""
        if teid in self.by_teid and self.sgi_tx:
            self.sgi_tx(payload)

    def rx_sgi(self, ip_pkt: bytes) -> None:
        """DL IP packet -> look up dest IP -> GTP-U to eNB."""
        if len(ip_pkt) < 20:
            return
        dst = ip_pkt[16:20]
        s = self.by_ip.get(dst)
        if s and s.enb_teid and self.s1u_tx:
            self.s1u_tx(s.enb_teid, ip_pkt)


# ---------------------------------------------------------------------------
# MME


@dataclass
class UeEmmCtx:
    imsi: str = ""
    mme_ue_s1ap_id: int = 0
    enb_ue_s1ap_id: int = 0
    state: str = "ATTACH_REQ"     # -> AUTH -> SMC -> CTX_SETUP -> ATTACHED
    xres: bytes = b""
    k_asme: bytes = b""
    k_nas_int: bytes = b""
    k_nas_enc: bytes = b""
    dl_count: int = 0
    ul_count: int = 0
    eea: int = 2
    eia: int = 2
    esm_pending: bytes = b""
    session: Optional[SpgwSession] = None
    mtmsi: int = 0
    ecm_state: str = "CONNECTED"  # ECM-CONNECTED / IDLE
    nh: bytes = b""               # next-hop key of the {NH, NCC} pair
    ncc: int = 0
    enb_id: int = 0               # serving eNB (multi-eNB S1 routing)
    ho_source_enb: int = 0
    ho_source_enb_ue: int = 0
    ho_target_enb: int = 0
    ho_target_enb_ue: int = 0
    ho_target_teid: int = 0
    dedicated_bearers: set = field(default_factory=set)


class Mme:
    """Per-UE EMM handling driven by S1AP PDUs (mme/nas.cc attach FSM).

    `rx_s1ap(pdu_bytes) -> [reply_pdu_bytes]`; user plane handled by
    the embedded SPGW.
    """

    def __init__(self, hss: Hss | None = None, spgw: Spgw | None = None,
                 plmn: bytes = b"\x00\xf1\x10") -> None:
        self.hss = hss or Hss()
        self.spgw = spgw or Spgw()
        self.plmn = plmn
        self.ues: dict[int, UeEmmCtx] = {}     # by mme_ue_s1ap_id
        self.next_mme_id = 1
        self.next_mtmsi = 0x12340000
        self.events: list[str] = []
        # PDUs addressed to a *different* eNB than the caller of rx_s1ap
        # (S1 handover fan-out); a multi-eNB harness drains (enb_id, pdu)
        self.outbox: list[tuple[int, bytes]] = []

    # NAS security helpers --------------------------------------------------

    def _protect(self, ue: UeEmmCtx, plain: bytes, ciphered: bool = True,
                 new_ctx: bool = False) -> bytes:
        if not ue.k_nas_int:
            return plain
        hdr = (M.SEC_INTEGRITY_CIPHERED if ciphered else M.SEC_INTEGRITY)
        if new_ctx:
            hdr = (M.SEC_INTEGRITY_CIPHERED_NEW_CTX if ciphered
                   else M.SEC_INTEGRITY_NEW_CTX)
        out = M.pack_protected(plain, ue.k_nas_int,
                               ue.k_nas_enc if ciphered else None,
                               ue.dl_count, M.NAS_DIR_DL, hdr)
        ue.dl_count += 1
        return out

    def _unprotect(self, ue: UeEmmCtx, pdu: bytes) -> Optional[bytes]:
        if not ue.k_nas_int or (pdu[0] >> 4) == M.SEC_NONE:
            return pdu
        sec_hdr = pdu[0] >> 4
        ciphered = sec_hdr in (M.SEC_INTEGRITY_CIPHERED,
                               M.SEC_INTEGRITY_CIPHERED_NEW_CTX)
        plain, ok, count = M.unpack_protected(
            pdu, ue.k_nas_int, ue.k_nas_enc if ciphered else None,
            ue.ul_count, M.NAS_DIR_UL)
        if not ok:
            self.events.append("ul_integrity_failure")
            return None
        ue.ul_count = count + 1
        return plain

    # S1AP surface ----------------------------------------------------------

    def rx_s1ap(self, raw: bytes, enb_id: int = 0) -> list[bytes]:
        try:
            proc, pdu_type, msg = S.unpack_pdu(raw)
        except (ValueError, IndexError):
            self.events.append("malformed_s1ap")
            return []
        if proc == S.PROC_HANDOVER_REQUIRED and pdu_type == S.PDU_INITIATING:
            return self._ho_required(msg, enb_id)
        if proc == S.PROC_HANDOVER_REQUEST and pdu_type == S.PDU_SUCCESSFUL:
            return self._ho_request_ack(msg, enb_id)
        if proc == S.PROC_ENB_STATUS_TRANSFER:
            return self._enb_status_transfer(msg)
        if proc == S.PROC_HANDOVER_NOTIFY:
            return self._ho_notify(msg)
        if proc == S.PROC_S1_SETUP and pdu_type == S.PDU_INITIATING:
            self.events.append("s1_setup")
            return [S.pack_pdu(S.PROC_S1_SETUP, S.PDU_SUCCESSFUL,
                               S.S1SetupResponse())]
        if proc == S.PROC_INITIAL_UE_MESSAGE:
            return self._initial_ue(msg)
        if proc == S.PROC_UPLINK_NAS_TRANSPORT:
            return self._ul_nas(msg)
        if proc == S.PROC_INITIAL_CONTEXT_SETUP and \
                pdu_type == S.PDU_SUCCESSFUL:
            return self._ctx_setup_rsp(msg)
        if proc == S.PROC_UE_CONTEXT_RELEASE:
            # ECM connection released; the EMM context and EPS session
            # survive (the UE goes idle and returns via service request)
            ue = self.ues.get(msg.mme_ue_s1ap_id)
            if ue:
                if ue.state == "DETACHED":
                    self.spgw.delete_session(ue.imsi)
                    del self.ues[msg.mme_ue_s1ap_id]
                else:
                    ue.ecm_state = "IDLE"
                    self.events.append("ecm_idle")
            return []
        self.events.append(f"unhandled_s1ap:{proc}")
        return []

    def _dl_nas(self, ue: UeEmmCtx, nas_pdu: bytes) -> bytes:
        return S.pack_pdu(
            S.PROC_DOWNLINK_NAS_TRANSPORT, S.PDU_INITIATING,
            S.NasTransport(mme_ue_s1ap_id=ue.mme_ue_s1ap_id,
                           enb_ue_s1ap_id=ue.enb_ue_s1ap_id,
                           nas_pdu=nas_pdu))

    def _find_by_mtmsi(self, mtmsi: int) -> Optional[UeEmmCtx]:
        for ue in self.ues.values():
            if ue.mtmsi == mtmsi:
                return ue
        return None

    def _initial_ue(self, msg: S.InitialUeMessage) -> list[bytes]:
        # short-format service request (ECM-IDLE -> CONNECTED,
        # mme/nas.cc handle_service_request)
        if M.is_service_request(msg.nas_pdu):
            ue = self._find_by_mtmsi(msg.mtmsi)
            if ue is None or ue.state != "ATTACHED":
                self.events.append("service_reject")
                return [S.pack_pdu(
                    S.PROC_DOWNLINK_NAS_TRANSPORT, S.PDU_INITIATING,
                    S.NasTransport(enb_ue_s1ap_id=msg.enb_ue_s1ap_id,
                                   nas_pdu=M.ServiceReject().pack()))]
            ok, count = M.check_service_request(
                msg.nas_pdu, ue.k_nas_int, ue.ul_count)
            if not ok:
                self.events.append("service_request_mac_fail")
                return [self._dl_nas(ue, M.ServiceReject().pack())]
            ue.ul_count = count + 1
            ue.enb_ue_s1ap_id = msg.enb_ue_s1ap_id
            ue.ecm_state = "CONNECTED"
            self.events.append("service_request")
            k_enb = security.k_enb(ue.k_asme, count)
            ue.nh, ue.ncc = k_enb, 0
            ics = S.InitialContextSetupRequest(
                mme_ue_s1ap_id=ue.mme_ue_s1ap_id,
                enb_ue_s1ap_id=msg.enb_ue_s1ap_id,
                security_key=k_enb,
                erabs=[S.ErabToSetup(
                    erab_id=5, qci=9,
                    gtp_teid=ue.session.spgw_teid if ue.session else 0)])
            return [S.pack_pdu(S.PROC_INITIAL_CONTEXT_SETUP,
                               S.PDU_INITIATING, ics)]
        # protected TAU request as the initial NAS message (idle TAU)
        if msg.mtmsi and (msg.nas_pdu[0] >> 4) != 0:
            ue = self._find_by_mtmsi(msg.mtmsi)
            if ue is not None:
                ue.enb_ue_s1ap_id = msg.enb_ue_s1ap_id
                ue.ecm_state = "CONNECTED"
                plain = self._unprotect(ue, msg.nas_pdu)
                if plain is not None:
                    try:
                        nas = M.parse(plain)
                    except (ValueError, AssertionError, IndexError):
                        nas = None
                    if isinstance(nas, M.TrackingAreaUpdateRequest):
                        return self._tau_accept(ue)
            self.events.append("initial_tau_fail")
            return []
        try:
            nas = M.parse(msg.nas_pdu)
        except (ValueError, AssertionError, IndexError):
            self.events.append("malformed_initial_nas")
            return []
        if not isinstance(nas, M.AttachRequest):
            self.events.append("unexpected_initial_nas")
            return []
        ue = UeEmmCtx(imsi=nas.imsi, mme_ue_s1ap_id=self.next_mme_id,
                      enb_ue_s1ap_id=msg.enb_ue_s1ap_id,
                      esm_pending=nas.esm_msg)
        self.next_mme_id += 1
        self.ues[ue.mme_ue_s1ap_id] = ue
        vec = self.hss.get_auth_vector(nas.imsi, self.plmn)
        if vec is None:
            self.events.append("unknown_imsi")
            return []  # attach reject path
        rand, autn, xres, k_asme = vec
        ue.xres, ue.k_asme, ue.state = xres, k_asme, "AUTH"
        self.events.append("auth_request")
        req = M.AuthenticationRequest(rand=rand, autn=autn).pack()
        return [self._dl_nas(ue, req)]

    def _ul_nas(self, msg: S.NasTransport) -> list[bytes]:
        ue = self.ues.get(msg.mme_ue_s1ap_id)
        if ue is None:
            return []
        plain = self._unprotect(ue, msg.nas_pdu)
        if plain is None:
            return []
        try:
            nas = M.parse(plain)
        except (ValueError, AssertionError, IndexError):
            self.events.append("malformed_ul_nas")
            return []

        if isinstance(nas, M.AuthenticationResponse) and ue.state == "AUTH":
            if nas.res != ue.xres:
                self.events.append("auth_reject")
                return []
            ue.state = "SMC"
            ue.k_nas_int = security.k_nas(ue.k_asme, ue.eia, integrity=True)
            ue.k_nas_enc = security.k_nas(ue.k_asme, ue.eea, integrity=False)
            smc = M.SecurityModeCommand(eea=ue.eea, eia=ue.eia).pack()
            self.events.append("smc")
            # SMC is integrity-only with new ctx (24.301 4.4.5)
            return [self._dl_nas(ue, self._protect(
                ue, smc, ciphered=False, new_ctx=True))]

        if isinstance(nas, M.AuthenticationFailure):
            if nas.cause == 21:  # synch failure
                self.hss.resync_sqn(ue.imsi, nas.auts)
                vec = self.hss.get_auth_vector(ue.imsi, self.plmn)
                if vec:
                    rand, autn, xres, k_asme = vec
                    ue.xres, ue.k_asme = xres, k_asme
                    self.events.append("auth_resync")
                    req = M.AuthenticationRequest(rand=rand, autn=autn).pack()
                    return [self._dl_nas(ue, req)]
            self.events.append("auth_failure")
            return []

        if isinstance(nas, M.SecurityModeComplete) and ue.state == "SMC":
            ue.state = "CTX_SETUP"
            # GTP-C CreateSession towards SPGW (mme_gtpc.cc)
            sess = self.spgw.create_session(ue.imsi)
            ue.session = sess
            esm = M.ActivateDefaultEpsBearerRequest(
                eps_bearer_id=5, ip_addr=sess.ue_ip)
            accept = M.AttachAccept(esm_msg=esm.pack(),
                                    guti_mtmsi=self.next_mtmsi)
            ue.mtmsi = self.next_mtmsi
            self.next_mtmsi += 1
            k_enb = security.k_enb(ue.k_asme, ue.ul_count)
            ue.nh, ue.ncc = k_enb, 0
            self.events.append("initial_ctx_setup")
            ics = S.InitialContextSetupRequest(
                mme_ue_s1ap_id=ue.mme_ue_s1ap_id,
                enb_ue_s1ap_id=ue.enb_ue_s1ap_id,
                security_key=k_enb,
                erabs=[S.ErabToSetup(
                    erab_id=5, qci=9, gtp_teid=sess.spgw_teid,
                    nas_pdu=self._protect(ue, accept.pack()))])
            return [S.pack_pdu(S.PROC_INITIAL_CONTEXT_SETUP,
                               S.PDU_INITIATING, ics)]

        if isinstance(nas, M.AttachComplete):
            ue.state = "ATTACHED"
            self.events.append("attach_complete")
            return []

        if isinstance(nas, M.DetachRequest):
            self.spgw.delete_session(ue.imsi)
            ue.state = "DETACHED"
            self.events.append("detach")
            return []

        if isinstance(nas, M.TrackingAreaUpdateRequest):
            return self._tau_accept(ue)

        if isinstance(nas, M.TrackingAreaUpdateComplete):
            self.events.append("tau_complete")
            return []

        if isinstance(nas, M.ActivateDedicatedEpsBearerAccept):
            ue.dedicated_bearers.add(nas.eps_bearer_id)
            self.events.append(f"dedicated_bearer_accept:{nas.eps_bearer_id}")
            return []

        self.events.append(f"unhandled_nas:{type(nas).__name__}")
        return []

    def activate_dedicated_bearer(self, imsi: str, ebi: int = 6,
                                  qci: int = 1,
                                  filters: list | None = None) -> list[bytes]:
        """Network-initiated dedicated bearer with a TFT (the reference MME
        has the ESM machinery in `srsepc/src/mme/nas.cc`; the UE side is
        `tft_packet_filter.cc`).  Returns the S1AP DL NAS transport PDU."""
        from . import tft as tft_mod

        ue = next((u for u in self.ues.values() if u.imsi == imsi), None)
        if ue is None or ue.state != "ATTACHED":
            self.events.append("dedicated_bearer_no_ue")
            return []
        tft_bytes = tft_mod.pack_tft(filters or [])
        esm = M.ActivateDedicatedEpsBearerRequest(
            eps_bearer_id=ebi, linked_ebi=5, qci=qci, tft=tft_bytes).pack()
        self.events.append(f"dedicated_bearer_req:{ebi}")
        return [self._dl_nas(ue, self._protect(ue, esm))]

    def _tau_accept(self, ue: UeEmmCtx) -> list[bytes]:
        """TAU accept with a fresh GUTI (mme/nas.cc
        handle_tracking_area_update_request)."""
        ue.mtmsi = self.next_mtmsi
        self.next_mtmsi += 1
        self.events.append("tau_accept")
        acc = M.TrackingAreaUpdateAccept(guti_mtmsi=ue.mtmsi).pack()
        return [self._dl_nas(ue, self._protect(ue, acc))]


    # --- S1 handover relay (mme s1ap handover procedures) -------------------

    def _ho_required(self, msg: S.HandoverRequired, enb_id: int) -> list[bytes]:
        ue = self.ues.get(msg.mme_ue_s1ap_id)
        if ue is None or ue.state != "ATTACHED":
            self.events.append("ho_required_unknown_ue")
            return []
        ue.ho_source_enb = enb_id
        ue.ho_source_enb_ue = msg.enb_ue_s1ap_id
        ue.ho_target_enb = msg.target_enb_id
        erabs = []
        if ue.session:
            erabs.append(S.ErabToSetup(erab_id=5, qci=9,
                                       gtp_teid=ue.session.spgw_teid))
        # fresh {NH, NCC} pair for the target's vertical K_eNB* derivation
        # (33.401 7.2.8.4; mme s1ap handover_request security context)
        ue.nh = security.nh(ue.k_asme, ue.nh)
        ue.ncc += 1
        req = S.HandoverRequest(mme_ue_s1ap_id=ue.mme_ue_s1ap_id,
                                security_key=ue.nh, ncc=ue.ncc,
                                erabs=erabs, container=msg.container)
        self.events.append("ho_request")
        self.outbox.append((msg.target_enb_id, S.pack_pdu(
            S.PROC_HANDOVER_REQUEST, S.PDU_INITIATING, req)))
        return []

    def _ho_request_ack(self, msg: S.HandoverRequestAcknowledge,
                        enb_id: int) -> list[bytes]:
        ue = self.ues.get(msg.mme_ue_s1ap_id)
        if ue is None:
            return []
        ue.ho_target_enb_ue = msg.enb_ue_s1ap_id
        if msg.erabs:
            ue.ho_target_teid = msg.erabs[0].gtp_teid
        cmd = S.HandoverCommand(mme_ue_s1ap_id=ue.mme_ue_s1ap_id,
                                enb_ue_s1ap_id=ue.ho_source_enb_ue,
                                container=msg.container)
        self.events.append("ho_command")
        self.outbox.append((ue.ho_source_enb, S.pack_pdu(
            S.PROC_HANDOVER_REQUIRED, S.PDU_SUCCESSFUL, cmd)))
        return []

    def _enb_status_transfer(self, msg: S.StatusTransfer) -> list[bytes]:
        ue = self.ues.get(msg.mme_ue_s1ap_id)
        if ue is None:
            return []
        fwd = S.StatusTransfer(mme_ue_s1ap_id=ue.mme_ue_s1ap_id,
                               enb_ue_s1ap_id=ue.ho_target_enb_ue,
                               bearers=msg.bearers)
        self.events.append("mme_status_transfer")
        self.outbox.append((ue.ho_target_enb, S.pack_pdu(
            S.PROC_MME_STATUS_TRANSFER, S.PDU_INITIATING, fwd)))
        return []

    def _ho_notify(self, msg: S.HandoverNotify) -> list[bytes]:
        ue = self.ues.get(msg.mme_ue_s1ap_id)
        if ue is None:
            return []
        # path switch: SPGW now sends DL towards the target eNB
        if ue.session and ue.ho_target_teid:
            self.spgw.modify_bearer(ue.imsi, ue.ho_target_teid)
        self.events.append("path_switch")
        # release the source eNB context
        self.outbox.append((ue.ho_source_enb, S.pack_pdu(
            S.PROC_UE_CONTEXT_RELEASE, S.PDU_INITIATING,
            S.UeContextRelease(mme_ue_s1ap_id=ue.mme_ue_s1ap_id,
                               enb_ue_s1ap_id=ue.ho_source_enb_ue,
                               cause=2))))
        ue.enb_id = ue.ho_target_enb
        ue.enb_ue_s1ap_id = msg.enb_ue_s1ap_id
        ue.ho_source_enb = ue.ho_source_enb_ue = 0
        return []

    def _ctx_setup_rsp(self, msg: S.InitialContextSetupResponse) -> list[bytes]:
        ue = self.ues.get(msg.mme_ue_s1ap_id)
        if ue and msg.erabs and ue.session:
            # ModifyBearer: learn eNB DL TEID (mme_gtpc.cc -> spgw)
            self.spgw.modify_bearer(ue.imsi, msg.erabs[0].gtp_teid)
            self.events.append("modify_bearer")
        return []

    def attached_ues(self) -> list[str]:
        return [u.imsi for u in self.ues.values() if u.state == "ATTACHED"]

    def page_ue(self, imsi: str) -> list[bytes]:
        """DL data for an idle UE -> S1AP Paging to the eNB(s)
        (mme s1ap_paging.cc)."""
        for mme_id, ue in self.ues.items():
            if ue.imsi == imsi:
                self.events.append(f"paging {imsi}")
                return [S.pack_pdu(S.PROC_PAGING, S.PDU_INITIATING,
                                   S.S1Paging(ue_index=mme_id % 1024,
                                              mtmsi=ue.mtmsi))]
        return []
