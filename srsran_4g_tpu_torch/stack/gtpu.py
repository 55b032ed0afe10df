"""GTP-U header pack/unpack + tunnel manager, TS 29.281.

Counterpart of the reference's `lib/src/gtpu/gtpu.cc` (header codec) and the
eNB-side `gtpu_tunnel_manager` (srsenb/hdr/stack/upper/gtpu.h:50-91):
per-bearer TEID maps with the buffering/forwarding states used during
handover.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from enum import Enum

GTPU_MSG_ECHO_REQUEST = 1
GTPU_MSG_ECHO_RESPONSE = 2
GTPU_MSG_ERROR_INDICATION = 26
GTPU_MSG_END_MARKER = 254
GTPU_MSG_DATA_PDU = 255


@dataclass
class GtpuHeader:
    teid: int
    msg_type: int = GTPU_MSG_DATA_PDU
    seq: int | None = None


def pack(h: GtpuHeader, payload: bytes) -> bytes:
    flags = 0x30  # version 1, PT=1
    ext = b""
    if h.seq is not None:
        flags |= 0x02
        ext = struct.pack(">HBB", h.seq, 0, 0)
    return struct.pack(">BBHI", flags, h.msg_type, len(payload) + len(ext),
                       h.teid) + ext + payload


def unpack(raw: bytes) -> tuple[GtpuHeader, bytes]:
    flags, msg_type, length, teid = struct.unpack(">BBHI", raw[:8])
    assert (flags >> 5) == 1, "not GTPv1"
    pos = 8
    seq = None
    if flags & 0x07:  # any of S/E/PN present → 4 more bytes
        seq_v, _, _ = struct.unpack(">HBB", raw[8:12])
        if flags & 0x02:
            seq = seq_v
        pos = 12
    return GtpuHeader(teid=teid, msg_type=msg_type, seq=seq), raw[pos:pos + length - (pos - 8)]


class TunnelState(Enum):
    NORMAL = 0
    BUFFERING = 1  # HO: hold SDUs until the target is ready
    FORWARD_TO = 2  # HO: forward to another tunnel


@dataclass
class Tunnel:
    teid_in: int
    teid_out: int
    rnti: int
    bearer_id: int
    state: TunnelState = TunnelState.NORMAL
    forward_teid: int | None = None
    buffer: list[bytes] = field(default_factory=list)


class TunnelManager:
    """TEID allocation + per-bearer state (gtpu_tunnel_manager)."""

    def __init__(self):
        self._next_teid = 1
        self.by_teid: dict[int, Tunnel] = {}
        self.by_bearer: dict[tuple[int, int], Tunnel] = {}

    def add_tunnel(self, rnti: int, bearer_id: int, teid_out: int) -> Tunnel:
        t = Tunnel(teid_in=self._next_teid, teid_out=teid_out, rnti=rnti,
                   bearer_id=bearer_id)
        self._next_teid += 1
        self.by_teid[t.teid_in] = t
        self.by_bearer[(rnti, bearer_id)] = t
        return t

    def rem_tunnel(self, teid_in: int) -> None:
        t = self.by_teid.pop(teid_in, None)
        if t:
            self.by_bearer.pop((t.rnti, t.bearer_id), None)

    def set_buffering(self, teid_in: int) -> None:
        self.by_teid[teid_in].state = TunnelState.BUFFERING

    def set_forwarding(self, teid_in: int, forward_teid: int) -> list[bytes]:
        """Switch to forwarding (HO target ready); returns buffered SDUs."""
        t = self.by_teid[teid_in]
        t.state = TunnelState.FORWARD_TO
        t.forward_teid = forward_teid
        out, t.buffer = t.buffer, []
        return out

    def handle_rx(self, teid_in: int, sdu: bytes) -> tuple[str, int | None, bytes | None]:
        """→ ('deliver'|'buffered'|'forward'|'drop', forward_teid, sdu)."""
        t = self.by_teid.get(teid_in)
        if t is None:
            return "drop", None, None
        if t.state == TunnelState.BUFFERING:
            t.buffer.append(sdu)
            return "buffered", None, None
        if t.state == TunnelState.FORWARD_TO:
            return "forward", t.forward_teid, sdu
        return "deliver", None, sdu
