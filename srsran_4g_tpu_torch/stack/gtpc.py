"""GTP-C v2 codec (TS 29.274 subset): S11 session management.

Counterpart of the reference's GTP-C handling (`srsepc/src/spgw/gtpc.cc`,
`srsepc/src/mme/mme_gtpc.cc`, header codec in `lib/include/srsran/asn1/
gtpc*.h`): Create Session Request/Response, Modify Bearer
Request/Response, Delete Session Request/Response with the IEs the
attach flow needs (IMSI, F-TEID, PAA, bearer context).

In-process MME<->SPGW calls in epc.py use these the moment the two run
as separate processes (tools/run_lte.py --split-epc style deployments).
"""

from __future__ import annotations

from dataclasses import dataclass

MSG_CREATE_SESSION_REQ = 32
MSG_CREATE_SESSION_RSP = 33
MSG_MODIFY_BEARER_REQ = 34
MSG_MODIFY_BEARER_RSP = 35
MSG_DELETE_SESSION_REQ = 36
MSG_DELETE_SESSION_RSP = 37


def _hdr(msg_type: int, teid: int, seq: int, length: int) -> bytes:
    """GTPv2-C header with TEID (29.274 5.1): flags 0x48."""
    return bytes([0x48, msg_type]) + (length + 8).to_bytes(2, "big") \
        + teid.to_bytes(4, "big") + seq.to_bytes(3, "big") + b"\x00"


def _parse_hdr(raw: bytes) -> tuple[int, int, int, bytes]:
    if raw[0] != 0x48:
        raise ValueError("bad GTP-C flags")
    msg_type = raw[1]
    length = int.from_bytes(raw[2:4], "big")
    teid = int.from_bytes(raw[4:8], "big")
    seq = int.from_bytes(raw[8:11], "big")
    return msg_type, teid, seq, raw[12:4 + length]


def _ie(ie_type: int, payload: bytes) -> bytes:
    return bytes([ie_type]) + len(payload).to_bytes(2, "big") + b"\x00" \
        + payload


def _parse_ies(body: bytes) -> dict[int, bytes]:
    out = {}
    pos = 0
    while pos + 4 <= len(body):
        t = body[pos]
        n = int.from_bytes(body[pos + 1:pos + 3], "big")
        out[t] = body[pos + 4:pos + 4 + n]
        pos += 4 + n
    return out


IE_IMSI = 1
IE_CAUSE = 2
IE_PAA = 79       # PDN address allocation
IE_FTEID = 87
IE_EBI = 73


@dataclass
class CreateSessionRequest:
    imsi: str
    sender_teid: int = 0
    ebi: int = 5
    seq: int = 0

    def pack(self) -> bytes:
        body = _ie(IE_IMSI, self.imsi.encode()) \
            + _ie(IE_FTEID, self.sender_teid.to_bytes(4, "big")) \
            + _ie(IE_EBI, bytes([self.ebi]))
        return _hdr(MSG_CREATE_SESSION_REQ, 0, self.seq, len(body)) + body


@dataclass
class CreateSessionResponse:
    cause: int = 16  # accepted
    spgw_teid: int = 0
    ue_ip: bytes = b"\x00\x00\x00\x00"
    ebi: int = 5
    seq: int = 0

    def pack(self) -> bytes:
        body = _ie(IE_CAUSE, bytes([self.cause])) \
            + _ie(IE_FTEID, self.spgw_teid.to_bytes(4, "big")) \
            + _ie(IE_PAA, b"\x01" + self.ue_ip) \
            + _ie(IE_EBI, bytes([self.ebi]))
        return _hdr(MSG_CREATE_SESSION_RSP, 0, self.seq, len(body)) + body


@dataclass
class ModifyBearerRequest:
    spgw_teid: int = 0
    enb_teid: int = 0
    ebi: int = 5
    seq: int = 0

    def pack(self) -> bytes:
        body = _ie(IE_FTEID, self.enb_teid.to_bytes(4, "big")) \
            + _ie(IE_EBI, bytes([self.ebi]))
        return _hdr(MSG_MODIFY_BEARER_REQ, self.spgw_teid, self.seq,
                    len(body)) + body


@dataclass
class DeleteSessionRequest:
    spgw_teid: int = 0
    ebi: int = 5
    seq: int = 0

    def pack(self) -> bytes:
        body = _ie(IE_EBI, bytes([self.ebi]))
        return _hdr(MSG_DELETE_SESSION_REQ, self.spgw_teid, self.seq,
                    len(body)) + body


def unpack(raw: bytes):
    msg_type, teid, seq, body = _parse_hdr(raw)
    ies = _parse_ies(body)
    if msg_type == MSG_CREATE_SESSION_REQ:
        return CreateSessionRequest(
            imsi=ies[IE_IMSI].decode(),
            sender_teid=int.from_bytes(ies.get(IE_FTEID, b"\0" * 4), "big"),
            ebi=ies.get(IE_EBI, b"\x05")[0], seq=seq)
    if msg_type == MSG_CREATE_SESSION_RSP:
        return CreateSessionResponse(
            cause=ies[IE_CAUSE][0],
            spgw_teid=int.from_bytes(ies[IE_FTEID], "big"),
            ue_ip=ies[IE_PAA][1:5], ebi=ies.get(IE_EBI, b"\x05")[0],
            seq=seq)
    if msg_type == MSG_MODIFY_BEARER_REQ:
        return ModifyBearerRequest(
            spgw_teid=teid,
            enb_teid=int.from_bytes(ies[IE_FTEID], "big"),
            ebi=ies.get(IE_EBI, b"\x05")[0], seq=seq)
    if msg_type == MSG_DELETE_SESSION_REQ:
        return DeleteSessionRequest(spgw_teid=teid,
                                    ebi=ies.get(IE_EBI, b"\x05")[0], seq=seq)
    raise ValueError(f"unknown GTP-C msg {msg_type}")
