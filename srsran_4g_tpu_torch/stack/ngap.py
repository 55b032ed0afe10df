"""NGAP message codecs (TS 38.413 subset) + 5GC (AMF/SMF/UPF).

Counterpart of the reference's generated NGAP codec (`lib/src/asn1/
ngap.cc`, ~51 k LoC), the gNB client `srsgnb/src/stack/ngap/ngap.cc`,
and — since the reference ships no 5G core — the minimal AMF needed to
drive the SA registration flow end-to-end (the reference's E2E runs NSA
against srsepc; SA termination here mirrors the MME design in epc.py).

Framing matches s1ap_msgs: [proc 1B][type 1B][len 2B][ies].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from . import nas_5g as N5
from . import security
from .asn1 import BitReader, BitWriter, pack_varlen_bytes, unpack_varlen_bytes
from .epc import Hss, Spgw

PROC_NG_SETUP = 21
PROC_INITIAL_UE_MESSAGE = 15
PROC_DL_NAS_TRANSPORT = 4
PROC_UL_NAS_TRANSPORT = 46
PROC_INITIAL_CTX_SETUP = 14
PROC_PDU_SESSION_SETUP = 29
PROC_UE_CTX_RELEASE = 41

PDU_INITIATING = 0
PDU_SUCCESSFUL = 1


@dataclass
class NgSetupRequest:
    global_gnb_id: int = 0x19B
    gnb_name: str = "srsgnb-tpu"
    tac: int = 0x000001
    plmn: int = 0x00F110

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.global_gnb_id, 32)
        w.put(self.tac, 24)
        w.put(self.plmn, 24)
        pack_varlen_bytes(w, self.gnb_name.encode())
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "NgSetupRequest":
        r = BitReader(d)
        return cls(global_gnb_id=r.get(32), tac=r.get(24), plmn=r.get(24),
                   gnb_name=unpack_varlen_bytes(r).decode())


@dataclass
class NgSetupResponse:
    amf_name: str = "srsamf-tpu"
    served_guami: int = 0x0001
    capacity: int = 255

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.served_guami, 24)
        w.put(self.capacity, 8)
        pack_varlen_bytes(w, self.amf_name.encode())
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "NgSetupResponse":
        r = BitReader(d)
        return cls(served_guami=r.get(24), capacity=r.get(8),
                   amf_name=unpack_varlen_bytes(r).decode())


@dataclass
class NgInitialUeMessage:
    ran_ue_id: int = 0
    nas_pdu: bytes = b""
    tac: int = 1

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.ran_ue_id, 32)
        w.put(self.tac, 24)
        pack_varlen_bytes(w, self.nas_pdu)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "NgInitialUeMessage":
        r = BitReader(d)
        return cls(ran_ue_id=r.get(32), tac=r.get(24),
                   nas_pdu=unpack_varlen_bytes(r))


@dataclass
class NgNasTransport:
    amf_ue_id: int = 0
    ran_ue_id: int = 0
    nas_pdu: bytes = b""

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.amf_ue_id, 40)
        w.put(self.ran_ue_id, 32)
        pack_varlen_bytes(w, self.nas_pdu)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "NgNasTransport":
        r = BitReader(d)
        return cls(amf_ue_id=r.get(40), ran_ue_id=r.get(32),
                   nas_pdu=unpack_varlen_bytes(r))


@dataclass
class NgInitialCtxSetup:
    amf_ue_id: int = 0
    ran_ue_id: int = 0
    security_key: bytes = b"\x00" * 32   # K_gNB
    nas_pdu: bytes = b""
    pdu_sessions: list[tuple[int, int, bytes]] = field(default_factory=list)
    # (session_id, upf_teid, nas)

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.amf_ue_id, 40)
        w.put(self.ran_ue_id, 32)
        w.put_bytes(self.security_key)
        pack_varlen_bytes(w, self.nas_pdu)
        w.put(len(self.pdu_sessions), 4)
        for sid, teid, nas in self.pdu_sessions:
            w.put(sid, 8)
            w.put(teid, 32)
            pack_varlen_bytes(w, nas)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "NgInitialCtxSetup":
        r = BitReader(d)
        out = cls(amf_ue_id=r.get(40), ran_ue_id=r.get(32),
                  security_key=r.get_bytes(32),
                  nas_pdu=unpack_varlen_bytes(r))
        for _ in range(r.get(4)):
            out.pdu_sessions.append(
                (r.get(8), r.get(32), unpack_varlen_bytes(r)))
        return out


@dataclass
class NgInitialCtxSetupResponse:
    amf_ue_id: int = 0
    ran_ue_id: int = 0
    gnb_teids: list[tuple[int, int]] = field(default_factory=list)

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.amf_ue_id, 40)
        w.put(self.ran_ue_id, 32)
        w.put(len(self.gnb_teids), 4)
        for sid, teid in self.gnb_teids:
            w.put(sid, 8)
            w.put(teid, 32)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "NgInitialCtxSetupResponse":
        r = BitReader(d)
        out = cls(amf_ue_id=r.get(40), ran_ue_id=r.get(32))
        for _ in range(r.get(4)):
            out.gnb_teids.append((r.get(8), r.get(32)))
        return out


_CODECS = {
    (PROC_NG_SETUP, PDU_INITIATING): NgSetupRequest,
    (PROC_NG_SETUP, PDU_SUCCESSFUL): NgSetupResponse,
    (PROC_INITIAL_UE_MESSAGE, PDU_INITIATING): NgInitialUeMessage,
    (PROC_DL_NAS_TRANSPORT, PDU_INITIATING): NgNasTransport,
    (PROC_UL_NAS_TRANSPORT, PDU_INITIATING): NgNasTransport,
    (PROC_INITIAL_CTX_SETUP, PDU_INITIATING): NgInitialCtxSetup,
    (PROC_INITIAL_CTX_SETUP, PDU_SUCCESSFUL): NgInitialCtxSetupResponse,
}


def pack_pdu(proc: int, pdu_type: int, msg) -> bytes:
    ies = msg.pack_ies()
    return bytes([proc, pdu_type]) + len(ies).to_bytes(2, "big") + ies


def unpack_pdu(data: bytes):
    proc, t = data[0], data[1]
    n = int.from_bytes(data[2:4], "big")
    cls = _CODECS.get((proc, t))
    if cls is None or len(data[4:4 + n]) != n:
        raise ValueError(f"bad NGAP (proc={proc}, type={t})")
    return proc, t, cls.unpack_ies(data[4:4 + n])


# --------------------------------------------------------------------------
# AMF (+ embedded SMF/UPF session handling via the shared Spgw model)


@dataclass
class UeRegCtx:
    suci: str = ""
    amf_ue_id: int = 0
    ran_ue_id: int = 0
    state: str = "REG_REQ"
    xres_star: bytes = b""
    k_amf: bytes = b""
    session: object = None
    # NAS security context (activated when the SMC goes out)
    k_nas_int: bytes = b""
    k_nas_enc: bytes = b""
    ul_count: int = 0
    dl_count: int = 0


class Amf:
    """5G core: registration FSM per UE, driven by NGAP PDUs."""

    def __init__(self, hss: Hss | None = None, upf: Spgw | None = None,
                 plmn: bytes = b"\x00\xf1\x10") -> None:
        self.hss = hss or Hss()
        self.upf = upf or Spgw(ip_pool="172.17.0.0/24")
        self.plmn = plmn
        self.ues: dict[int, UeRegCtx] = {}
        self.next_id = 1
        self.events: list[str] = []

    def rx_ngap(self, raw: bytes) -> list[bytes]:
        try:
            proc, t, msg = unpack_pdu(raw)
        except (ValueError, IndexError):
            self.events.append("malformed_ngap")
            return []
        if proc == PROC_NG_SETUP and t == PDU_INITIATING:
            self.events.append("ng_setup")
            return [pack_pdu(PROC_NG_SETUP, PDU_SUCCESSFUL,
                             NgSetupResponse())]
        if proc == PROC_INITIAL_UE_MESSAGE:
            return self._initial_ue(msg)
        if proc == PROC_UL_NAS_TRANSPORT:
            return self._ul_nas(msg)
        if proc == PROC_INITIAL_CTX_SETUP and t == PDU_SUCCESSFUL:
            ue = self.ues.get(msg.amf_ue_id)
            if ue and msg.gnb_teids and ue.session:
                self.upf.modify_bearer(ue.suci, msg.gnb_teids[0][1])
                self.events.append("n3_tunnel_up")
            return []
        self.events.append(f"unhandled:{proc}")
        return []

    def _dl(self, ue: UeRegCtx, nas: bytes, protected: bool = True) -> bytes:
        if protected and ue.k_nas_int:
            nas = N5.protect(nas, ue.k_nas_int, ue.k_nas_enc,
                             ue.dl_count, 1)
            ue.dl_count += 1
        return pack_pdu(PROC_DL_NAS_TRANSPORT, PDU_INITIATING,
                        NgNasTransport(amf_ue_id=ue.amf_ue_id,
                                       ran_ue_id=ue.ran_ue_id, nas_pdu=nas))

    def _initial_ue(self, msg: NgInitialUeMessage) -> list[bytes]:
        try:
            nas = N5.parse(msg.nas_pdu)
        except (ValueError, AssertionError, IndexError):
            self.events.append("malformed_nas")
            return []
        if not isinstance(nas, N5.RegistrationRequest):
            return []
        ue = UeRegCtx(suci=nas.suci, amf_ue_id=self.next_id,
                      ran_ue_id=msg.ran_ue_id)
        self.next_id += 1
        self.ues[ue.amf_ue_id] = ue
        vec = self.hss.get_auth_vector(nas.suci, self.plmn)
        if vec is None:
            self.events.append("unknown_suci")
            return []
        rand, autn, xres, k_asme = vec
        ue.k_amf = k_asme
        ue.xres_star = security._kdf(k_asme, 0x6B, xres)[:16]
        ue.state = "AUTH"
        self.events.append("auth_request")
        return [self._dl(ue, N5.AuthRequest5g(rand=rand, autn=autn).pack())]

    def _ul_nas(self, msg: NgNasTransport) -> list[bytes]:
        ue = self.ues.get(msg.amf_ue_id)
        if ue is None:
            return []
        pdu = msg.nas_pdu
        if len(pdu) > 1 and pdu[0] == N5.PD_5GMM and (pdu[1] & 0x0F) != 0:
            if not ue.k_nas_int:
                self.events.append("protected_before_smc")
                return []
            pdu, ok, cnt = N5.unprotect(pdu, ue.k_nas_int, ue.k_nas_enc,
                                        ue.ul_count, 0)
            if not ok:
                self.events.append("nas_integrity_fail")
                return []
            ue.ul_count = cnt + 1
        try:
            nas = N5.parse(pdu)
        except (ValueError, AssertionError, IndexError):
            self.events.append("malformed_nas")
            return []
        if isinstance(nas, N5.AuthResponse5g) and ue.state == "AUTH":
            if nas.res_star != ue.xres_star:
                self.events.append("auth_reject")
                return []
            ue.state = "SMC"
            self.events.append("smc")
            # activate the NAS security context the moment the SMC goes
            # out (the SMC itself travels plain; 24.501 integrity-protects
            # it with the new context — the framework's envelope starts
            # one message later, mirrored by the UE)
            ue.k_nas_int = security.k_nas(ue.k_amf, 2, integrity=True)
            ue.k_nas_enc = security.k_nas(ue.k_amf, 2, integrity=False)
            return [self._dl(ue, N5.SecModeCommand5g().pack(),
                             protected=False)]
        if isinstance(nas, N5.SecModeComplete5g) and ue.state == "SMC":
            ue.state = "CTX"
            return []  # wait for the PDU session request
        if isinstance(nas, N5.PduSessionEstRequest):
            sess = self.upf.create_session(ue.suci)
            ue.session = sess
            accept = N5.PduSessionEstAccept(
                session_id=nas.session_id, ip_addr=sess.ue_ip).pack()
            reg_acc = N5.RegistrationAccept(guti_5g=0x5F000000
                                            + ue.amf_ue_id).pack()
            if ue.k_nas_int:
                # the ICS-carried NAS travels protected too, in delivery
                # order (the gNB forwards reg_acc first, then the 5GSM
                # accept inside the RRCReconfiguration)
                reg_acc = N5.protect(reg_acc, ue.k_nas_int, ue.k_nas_enc,
                                     ue.dl_count, 1)
                ue.dl_count += 1
                accept = N5.protect(accept, ue.k_nas_int, ue.k_nas_enc,
                                    ue.dl_count, 1)
                ue.dl_count += 1
            k_gnb = security._kdf(ue.k_amf, 0x6E, b"\x00\x00\x00\x01")
            self.events.append("initial_ctx_setup")
            ics = NgInitialCtxSetup(
                amf_ue_id=ue.amf_ue_id, ran_ue_id=ue.ran_ue_id,
                security_key=k_gnb, nas_pdu=reg_acc,
                pdu_sessions=[(nas.session_id, sess.spgw_teid, accept)])
            return [pack_pdu(PROC_INITIAL_CTX_SETUP, PDU_INITIATING, ics)]
        if isinstance(nas, N5.RegistrationComplete):
            ue.state = "REGISTERED"
            self.events.append("registration_complete")
            return []
        self.events.append(f"unhandled_nas:{type(nas).__name__}")
        return []

    def registered_ues(self) -> list[str]:
        return [u.suci for u in self.ues.values() if u.state == "REGISTERED"]
