"""S1AP message codecs (TS 36.413 subset) on the PER-style bit runtime.

Counterpart of the reference's generated S1AP codec
(`lib/src/asn1/s1ap.cc`, ~67 k LoC generated): typed PDUs with
pack()/unpack() for the procedures driven by the E2E attach flow —
S1 Setup, Initial UE Message, UL/DL NAS Transport, Initial Context
Setup, UE Context Release — as used by `srsenb/src/stack/s1ap/s1ap.cc`
and `srsepc/src/mme/s1ap.cc`.

Each PDU is framed as [procedure-code 1B][pdu-type 1B][length 2B][ies]
so it can ride any stream transport (the reference uses SCTP; this
framework's transport layer uses the native TCP bridge or in-process
queues — see stack/s1ap.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .asn1 import BitReader, BitWriter, pack_varlen_bytes, unpack_varlen_bytes

# procedure codes (36.413 9.3.7)
PROC_S1_SETUP = 17
PROC_INITIAL_UE_MESSAGE = 12
PROC_DOWNLINK_NAS_TRANSPORT = 11
PROC_UPLINK_NAS_TRANSPORT = 13
PROC_INITIAL_CONTEXT_SETUP = 9
PROC_UE_CONTEXT_RELEASE = 23
PROC_ERAB_SETUP = 5
PROC_PAGING = 10
PROC_HANDOVER_REQUIRED = 0
PROC_HANDOVER_REQUEST = 1

PDU_INITIATING = 0
PDU_SUCCESSFUL = 1
PDU_UNSUCCESSFUL = 2


@dataclass
class S1SetupRequest:
    global_enb_id: int = 0x19B
    enb_name: str = "srsenb-tpu"
    tac: int = 0x0001
    plmn: int = 0x00F110

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.global_enb_id, 28)
        w.put(self.tac, 16)
        w.put(self.plmn, 24)
        pack_varlen_bytes(w, self.enb_name.encode())
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "S1SetupRequest":
        r = BitReader(d)
        gid = r.get(28)
        tac = r.get(16)
        plmn = r.get(24)
        name = unpack_varlen_bytes(r).decode()
        return cls(global_enb_id=gid, enb_name=name, tac=tac, plmn=plmn)


@dataclass
class S1SetupResponse:
    mme_name: str = "srsmme-tpu"
    mme_group: int = 0x0001
    mme_code: int = 0x1A
    rel_capacity: int = 255

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.mme_group, 16)
        w.put(self.mme_code, 8)
        w.put(self.rel_capacity, 8)
        pack_varlen_bytes(w, self.mme_name.encode())
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "S1SetupResponse":
        r = BitReader(d)
        grp = r.get(16)
        code = r.get(8)
        cap = r.get(8)
        name = unpack_varlen_bytes(r).decode()
        return cls(mme_name=name, mme_group=grp, mme_code=code,
                   rel_capacity=cap)


@dataclass
class InitialUeMessage:
    enb_ue_s1ap_id: int = 0
    nas_pdu: bytes = b""
    tac: int = 0x0001
    cell_id: int = 0x01
    rrc_cause: int = 3  # mo-Data
    mtmsi: int = 0      # optional S-TMSI (0 = absent) for service request

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.enb_ue_s1ap_id, 24)
        w.put(self.tac, 16)
        w.put(self.cell_id, 28)
        w.put(self.rrc_cause, 3)
        w.put(1 if self.mtmsi else 0, 1)
        if self.mtmsi:
            w.put(self.mtmsi, 32)
        pack_varlen_bytes(w, self.nas_pdu)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "InitialUeMessage":
        r = BitReader(d)
        eid = r.get(24)
        tac = r.get(16)
        cid = r.get(28)
        cause = r.get(3)
        mtmsi = r.get(32) if r.get(1) else 0
        nas = unpack_varlen_bytes(r)
        return cls(enb_ue_s1ap_id=eid, nas_pdu=nas, tac=tac, cell_id=cid,
                   mtmsi=mtmsi,
                   rrc_cause=cause)


@dataclass
class NasTransport:
    """UL or DL NAS transport (direction given by the procedure code)."""
    mme_ue_s1ap_id: int = 0
    enb_ue_s1ap_id: int = 0
    nas_pdu: bytes = b""

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.mme_ue_s1ap_id, 32)
        w.put(self.enb_ue_s1ap_id, 24)
        pack_varlen_bytes(w, self.nas_pdu)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "NasTransport":
        r = BitReader(d)
        mid = r.get(32)
        eid = r.get(24)
        nas = unpack_varlen_bytes(r)
        return cls(mme_ue_s1ap_id=mid, enb_ue_s1ap_id=eid, nas_pdu=nas)


@dataclass
class ErabToSetup:
    erab_id: int = 5
    qci: int = 9
    gtp_teid: int = 0
    transport_addr: bytes = b"\x7f\x00\x01\x01"  # SPGW S1-U IPv4
    nas_pdu: bytes = b""


@dataclass
class InitialContextSetupRequest:
    mme_ue_s1ap_id: int = 0
    enb_ue_s1ap_id: int = 0
    ue_ambr_dl: int = 100_000_000
    ue_ambr_ul: int = 50_000_000
    erabs: list[ErabToSetup] = field(default_factory=list)
    security_key: bytes = b"\x00" * 32  # K_eNB
    encryption_algs: int = 0xE0  # bitmask EEA0-2
    integrity_algs: int = 0xE0

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.mme_ue_s1ap_id, 32)
        w.put(self.enb_ue_s1ap_id, 24)
        w.put(self.ue_ambr_dl, 40)
        w.put(self.ue_ambr_ul, 40)
        w.put(self.encryption_algs, 16)
        w.put(self.integrity_algs, 16)
        w.put_bytes(self.security_key)
        w.put(len(self.erabs), 4)
        for e in self.erabs:
            w.put(e.erab_id, 4)
            w.put(e.qci, 8)
            w.put(e.gtp_teid, 32)
            pack_varlen_bytes(w, e.transport_addr)
            pack_varlen_bytes(w, e.nas_pdu)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "InitialContextSetupRequest":
        r = BitReader(d)
        out = cls(mme_ue_s1ap_id=r.get(32), enb_ue_s1ap_id=r.get(24),
                  ue_ambr_dl=r.get(40), ue_ambr_ul=r.get(40),
                  encryption_algs=r.get(16), integrity_algs=r.get(16),
                  security_key=r.get_bytes(32))
        n = r.get(4)
        for _ in range(n):
            out.erabs.append(ErabToSetup(
                erab_id=r.get(4), qci=r.get(8), gtp_teid=r.get(32),
                transport_addr=unpack_varlen_bytes(r),
                nas_pdu=unpack_varlen_bytes(r)))
        return out


@dataclass
class ErabSetupItem:
    erab_id: int = 5
    gtp_teid: int = 0
    transport_addr: bytes = b"\x7f\x00\x01\x02"  # eNB S1-U IPv4


@dataclass
class InitialContextSetupResponse:
    mme_ue_s1ap_id: int = 0
    enb_ue_s1ap_id: int = 0
    erabs: list[ErabSetupItem] = field(default_factory=list)

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.mme_ue_s1ap_id, 32)
        w.put(self.enb_ue_s1ap_id, 24)
        w.put(len(self.erabs), 4)
        for e in self.erabs:
            w.put(e.erab_id, 4)
            w.put(e.gtp_teid, 32)
            pack_varlen_bytes(w, e.transport_addr)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "InitialContextSetupResponse":
        r = BitReader(d)
        out = cls(mme_ue_s1ap_id=r.get(32), enb_ue_s1ap_id=r.get(24))
        for _ in range(r.get(4)):
            out.erabs.append(ErabSetupItem(
                erab_id=r.get(4), gtp_teid=r.get(32),
                transport_addr=unpack_varlen_bytes(r)))
        return out


@dataclass
class S1Paging:
    """MME -> eNB paging (36.413 8.5): UE identity index + S-TMSI."""
    ue_index: int = 0
    mtmsi: int = 0
    tac: int = 0x0001

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.ue_index, 10)
        w.put(self.mtmsi, 32)
        w.put(self.tac, 16)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "S1Paging":
        r = BitReader(d)
        return cls(ue_index=r.get(10), mtmsi=r.get(32), tac=r.get(16))


@dataclass
class UeContextRelease:
    mme_ue_s1ap_id: int = 0
    enb_ue_s1ap_id: int = 0
    cause: int = 0

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.mme_ue_s1ap_id, 32)
        w.put(self.enb_ue_s1ap_id, 24)
        w.put(self.cause, 8)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "UeContextRelease":
        r = BitReader(d)
        return cls(mme_ue_s1ap_id=r.get(32), enb_ue_s1ap_id=r.get(24),
                   cause=r.get(8))


# --- S1 handover (36.413 8.4, srsenb rrc_mobility.cc S1 path) ----------------

PROC_ENB_STATUS_TRANSFER = 24
PROC_MME_STATUS_TRANSFER = 25
PROC_HANDOVER_NOTIFY = 2


@dataclass
class HandoverRequired:
    """Source eNB → MME: target + source-to-target transparent container
    (the RRC/AS context the target needs)."""
    mme_ue_s1ap_id: int = 0
    enb_ue_s1ap_id: int = 0
    target_enb_id: int = 0
    cause: int = 0  # handover-desirable-for-radio-reasons
    container: bytes = b""

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.mme_ue_s1ap_id, 32)
        w.put(self.enb_ue_s1ap_id, 24)
        w.put(self.target_enb_id, 28)
        w.put(self.cause, 8)
        pack_varlen_bytes(w, self.container)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "HandoverRequired":
        r = BitReader(d)
        return cls(mme_ue_s1ap_id=r.get(32), enb_ue_s1ap_id=r.get(24),
                   target_enb_id=r.get(28), cause=r.get(8),
                   container=unpack_varlen_bytes(r))


@dataclass
class HandoverRequest:
    """MME → target eNB: E-RABs to set up + fresh security key +
    the source's transparent container."""
    mme_ue_s1ap_id: int = 0
    security_key: bytes = b"\x00" * 32  # NH (vertical derivation, 33.401)
    ncc: int = 0
    erabs: list[ErabToSetup] = field(default_factory=list)
    container: bytes = b""

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.mme_ue_s1ap_id, 32)
        w.put_bytes(self.security_key)
        w.put(self.ncc, 3)
        w.put(len(self.erabs), 4)
        for e in self.erabs:
            w.put(e.erab_id, 4)
            w.put(e.qci, 8)
            w.put(e.gtp_teid, 32)
        pack_varlen_bytes(w, self.container)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "HandoverRequest":
        r = BitReader(d)
        out = cls(mme_ue_s1ap_id=r.get(32), security_key=r.get_bytes(32),
                  ncc=r.get(3))
        for _ in range(r.get(4)):
            out.erabs.append(ErabToSetup(erab_id=r.get(4), qci=r.get(8),
                                         gtp_teid=r.get(32)))
        out.container = unpack_varlen_bytes(r)
        return out


@dataclass
class HandoverRequestAcknowledge:
    """Target eNB → MME: admitted E-RABs (target DL TEIDs) + the
    target-to-source container (the RRC handover command)."""
    mme_ue_s1ap_id: int = 0
    enb_ue_s1ap_id: int = 0  # target's UE id
    erabs: list[ErabSetupItem] = field(default_factory=list)
    container: bytes = b""

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.mme_ue_s1ap_id, 32)
        w.put(self.enb_ue_s1ap_id, 24)
        w.put(len(self.erabs), 4)
        for e in self.erabs:
            w.put(e.erab_id, 4)
            w.put(e.gtp_teid, 32)
        pack_varlen_bytes(w, self.container)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "HandoverRequestAcknowledge":
        r = BitReader(d)
        out = cls(mme_ue_s1ap_id=r.get(32), enb_ue_s1ap_id=r.get(24))
        for _ in range(r.get(4)):
            out.erabs.append(ErabSetupItem(erab_id=r.get(4),
                                           gtp_teid=r.get(32)))
        out.container = unpack_varlen_bytes(r)
        return out


@dataclass
class HandoverCommand:
    """MME → source eNB: the target's RRC container to forward to the UE."""
    mme_ue_s1ap_id: int = 0
    enb_ue_s1ap_id: int = 0  # source's UE id
    container: bytes = b""

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.mme_ue_s1ap_id, 32)
        w.put(self.enb_ue_s1ap_id, 24)
        pack_varlen_bytes(w, self.container)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "HandoverCommand":
        r = BitReader(d)
        return cls(mme_ue_s1ap_id=r.get(32), enb_ue_s1ap_id=r.get(24),
                   container=unpack_varlen_bytes(r))


@dataclass
class BearerStatus:
    erab_id: int = 5
    ul_count: int = 0  # PDCP COUNT expected next from the UE
    dl_count: int = 0  # PDCP COUNT to use next towards the UE


@dataclass
class StatusTransfer:
    """eNB Status Transfer (source→MME) / MME Status Transfer (MME→target):
    per-bearer PDCP COUNT continuation (36.413 8.4.4/8.4.5)."""
    mme_ue_s1ap_id: int = 0
    enb_ue_s1ap_id: int = 0
    bearers: list[BearerStatus] = field(default_factory=list)

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.mme_ue_s1ap_id, 32)
        w.put(self.enb_ue_s1ap_id, 24)
        w.put(len(self.bearers), 4)
        for b in self.bearers:
            w.put(b.erab_id, 4)
            w.put(b.ul_count, 32)
            w.put(b.dl_count, 32)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "StatusTransfer":
        r = BitReader(d)
        out = cls(mme_ue_s1ap_id=r.get(32), enb_ue_s1ap_id=r.get(24))
        for _ in range(r.get(4)):
            out.bearers.append(BearerStatus(
                erab_id=r.get(4), ul_count=r.get(32), dl_count=r.get(32)))
        return out


@dataclass
class HandoverNotify:
    """Target eNB → MME: the UE has arrived; triggers the path switch."""
    mme_ue_s1ap_id: int = 0
    enb_ue_s1ap_id: int = 0  # target's UE id
    tac: int = 0x0001
    cell_id: int = 0x01

    def pack_ies(self) -> bytes:
        w = BitWriter()
        w.put(self.mme_ue_s1ap_id, 32)
        w.put(self.enb_ue_s1ap_id, 24)
        w.put(self.tac, 16)
        w.put(self.cell_id, 28)
        return w.to_bytes()

    @classmethod
    def unpack_ies(cls, d: bytes) -> "HandoverNotify":
        r = BitReader(d)
        return cls(mme_ue_s1ap_id=r.get(32), enb_ue_s1ap_id=r.get(24),
                   tac=r.get(16), cell_id=r.get(28))


# --------------------------------------------------------------------------
# PDU framing: 3GPP-exact aligned-PER S1AP-PDUs (36.413 §9.1; the
# container + IE layouts are byte-exact against the reference's
# committed golden vectors — tests/test_s1ap_golden.py).  The legacy
# [proc][type][len] framing used through round 2 is gone.

from . import s1ap_ies as _IE
from .s1ap_per import S1apPdu as _Pdu
from .s1ap_per import CRIT_IGNORE as _CI, CRIT_REJECT as _CR


def _ues_from(cls, ies):
    return _IE.nas_transport_from(cls, ies)


_TO_IES = {
    (PROC_S1_SETUP, PDU_INITIATING): _IE.s1_setup_request_ies,
    (PROC_S1_SETUP, PDU_SUCCESSFUL): _IE.s1_setup_response_ies,
    (PROC_INITIAL_UE_MESSAGE, PDU_INITIATING): _IE.initial_ue_message_ies,
    (PROC_DOWNLINK_NAS_TRANSPORT, PDU_INITIATING): _IE.nas_transport_ies,
    (PROC_UPLINK_NAS_TRANSPORT, PDU_INITIATING): _IE.nas_transport_ies,
    (PROC_INITIAL_CONTEXT_SETUP, PDU_INITIATING):
        _IE.initial_ctxt_setup_request_ies,
    (PROC_INITIAL_CONTEXT_SETUP, PDU_SUCCESSFUL):
        _IE.initial_ctxt_setup_response_ies,
    (PROC_UE_CONTEXT_RELEASE, PDU_INITIATING): _IE.ue_ctxt_release_ies,
    (PROC_PAGING, PDU_INITIATING): _IE.paging_ies,
    (PROC_HANDOVER_REQUIRED, PDU_INITIATING): _IE.handover_required_ies,
    (PROC_HANDOVER_REQUIRED, PDU_SUCCESSFUL): _IE.handover_command_ies,
    (PROC_HANDOVER_REQUEST, PDU_INITIATING): _IE.handover_request_ies,
    (PROC_HANDOVER_REQUEST, PDU_SUCCESSFUL): _IE.handover_request_ack_ies,
    (PROC_ENB_STATUS_TRANSFER, PDU_INITIATING): _IE.status_transfer_ies,
    (PROC_MME_STATUS_TRANSFER, PDU_INITIATING): _IE.status_transfer_ies,
    (PROC_HANDOVER_NOTIFY, PDU_INITIATING): _IE.handover_notify_ies,
}

_FROM_IES = {
    (PROC_S1_SETUP, PDU_INITIATING):
        lambda ies: _IE.s1_setup_request_from(S1SetupRequest, ies),
    (PROC_S1_SETUP, PDU_SUCCESSFUL):
        lambda ies: _IE.s1_setup_response_from(S1SetupResponse, ies),
    (PROC_INITIAL_UE_MESSAGE, PDU_INITIATING):
        lambda ies: _IE.initial_ue_message_from(InitialUeMessage, ies),
    (PROC_DOWNLINK_NAS_TRANSPORT, PDU_INITIATING):
        lambda ies: _IE.nas_transport_from(NasTransport, ies),
    (PROC_UPLINK_NAS_TRANSPORT, PDU_INITIATING):
        lambda ies: _IE.nas_transport_from(NasTransport, ies),
    (PROC_INITIAL_CONTEXT_SETUP, PDU_INITIATING):
        lambda ies: _IE.initial_ctxt_setup_request_from(
            InitialContextSetupRequest, ErabToSetup, ies),
    (PROC_INITIAL_CONTEXT_SETUP, PDU_SUCCESSFUL):
        lambda ies: _IE.initial_ctxt_setup_response_from(
            InitialContextSetupResponse, ErabSetupItem, ies),
    (PROC_UE_CONTEXT_RELEASE, PDU_INITIATING):
        lambda ies: _IE.ue_ctxt_release_from(UeContextRelease, ies),
    (PROC_PAGING, PDU_INITIATING):
        lambda ies: _IE.paging_from(S1Paging, ies),
    (PROC_HANDOVER_REQUIRED, PDU_INITIATING):
        lambda ies: _IE.handover_required_from(HandoverRequired, ies),
    (PROC_HANDOVER_REQUIRED, PDU_SUCCESSFUL):
        lambda ies: _IE.handover_command_from(HandoverCommand, ies),
    (PROC_HANDOVER_REQUEST, PDU_INITIATING):
        lambda ies: _IE.handover_request_from(
            HandoverRequest, ErabToSetup, ies),
    (PROC_HANDOVER_REQUEST, PDU_SUCCESSFUL):
        lambda ies: _IE.handover_request_ack_from(
            HandoverRequestAcknowledge, ErabSetupItem, ies),
    (PROC_ENB_STATUS_TRANSFER, PDU_INITIATING):
        lambda ies: _IE.status_transfer_from(StatusTransfer, BearerStatus,
                                             ies),
    (PROC_MME_STATUS_TRANSFER, PDU_INITIATING):
        lambda ies: _IE.status_transfer_from(StatusTransfer, BearerStatus,
                                             ies),
    (PROC_HANDOVER_NOTIFY, PDU_INITIATING):
        lambda ies: _IE.handover_notify_from(HandoverNotify, ies),
}


def pack_pdu(proc: int, pdu_type: int, msg) -> bytes:
    to_ies = _TO_IES.get((proc, pdu_type))
    if to_ies is None:
        raise ValueError(f"unknown S1AP (proc={proc}, type={pdu_type})")
    crit = _CR if pdu_type == PDU_INITIATING else _CR
    return _Pdu(pdu_type=pdu_type, proc_code=proc, crit=crit,
                ies=to_ies(msg)).pack()


def unpack_pdu(data: bytes) -> tuple[int, int, object]:
    pdu = _Pdu.unpack(data)
    from_ies = _FROM_IES.get((pdu.proc_code, pdu.pdu_type))
    if from_ies is None:
        raise ValueError(
            f"unknown S1AP (proc={pdu.proc_code}, type={pdu.pdu_type})")
    return pdu.proc_code, pdu.pdu_type, from_ies(pdu.ies)
