"""Traffic Flow Template packet filters (TS 24.008 §10.5.6.12).

Counterpart of the reference's `srsue/src/stack/upper/tft_packet_filter.cc`
(component codec + per-component AND matching, `match()` at :194) and
`srsue/hdr/stack/upper/tft_packet_filter.h` (component type/flag constants).
The UE GW uses these to steer uplink IP packets onto dedicated EPS bearers:
filters are evaluated in ascending `eval_precedence` order, first match
wins, no match falls back to the default bearer.

IPv4 components are implemented (our user-plane loop is IPv4); IPv6
components parse but never match, mirroring how the reference only matches
the version the packet actually carries.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

# component type identifiers (24.008 Table 10.5.162; tft_packet_filter.h:46-58)
IPV4_REMOTE_ADDR_TYPE = 0x10
IPV4_LOCAL_ADDR_TYPE = 0x11
IPV6_REMOTE_ADDR_TYPE = 0x20
PROTOCOL_ID_TYPE = 0x30
SINGLE_LOCAL_PORT_TYPE = 0x40
LOCAL_PORT_RANGE_TYPE = 0x41
SINGLE_REMOTE_PORT_TYPE = 0x50
REMOTE_PORT_RANGE_TYPE = 0x51
SECURITY_PARAMETER_INDEX_TYPE = 0x60
TYPE_OF_SERVICE_TYPE = 0x70
FLOW_LABEL_TYPE = 0x80

UDP_PROTOCOL = 0x11
TCP_PROTOCOL = 0x06

# filter direction (24.008: bits 5-6 of the packet filter identifier octet)
DIR_DOWNLINK = 1
DIR_UPLINK = 2
DIR_BIDIRECTIONAL = 3


@dataclass
class TftFilter:
    """One packet filter of a TFT, with its matching state.

    `components` holds (type, value) pairs in wire order so pack/parse
    round-trips exactly; the typed fields below are the decoded view the
    matcher uses (reference struct tft_packet_filter_t).
    """

    filter_id: int = 0                   # 1..15 within the bearer
    eval_precedence: int = 0             # lower evaluates first
    direction: int = DIR_BIDIRECTIONAL
    eps_bearer_id: int = 0
    components: list[tuple[int, bytes]] = field(default_factory=list)

    # decoded component view
    ipv4_remote: tuple[bytes, bytes] | None = None   # (addr, mask)
    ipv4_local: tuple[bytes, bytes] | None = None
    protocol_id: int | None = None
    single_local_port: int | None = None
    local_port_range: tuple[int, int] | None = None
    single_remote_port: int | None = None
    remote_port_range: tuple[int, int] | None = None
    tos: tuple[int, int] | None = None               # (value, mask)

    # ---- component construction helpers -------------------------------
    def add_ipv4_remote(self, addr: str, mask: str = "255.255.255.255"):
        a, m = _ip4(addr), _ip4(mask)
        self.components.append((IPV4_REMOTE_ADDR_TYPE, a + m))
        self.ipv4_remote = (a, m)
        return self

    def add_ipv4_local(self, addr: str, mask: str = "255.255.255.255"):
        a, m = _ip4(addr), _ip4(mask)
        self.components.append((IPV4_LOCAL_ADDR_TYPE, a + m))
        self.ipv4_local = (a, m)
        return self

    def add_protocol(self, proto: int):
        self.components.append((PROTOCOL_ID_TYPE, bytes([proto])))
        self.protocol_id = proto
        return self

    def add_single_remote_port(self, port: int):
        self.components.append((SINGLE_REMOTE_PORT_TYPE, struct.pack("!H", port)))
        self.single_remote_port = port
        return self

    def add_single_local_port(self, port: int):
        self.components.append((SINGLE_LOCAL_PORT_TYPE, struct.pack("!H", port)))
        self.single_local_port = port
        return self

    def add_remote_port_range(self, lo: int, hi: int):
        self.components.append((REMOTE_PORT_RANGE_TYPE, struct.pack("!HH", lo, hi)))
        self.remote_port_range = (lo, hi)
        return self

    def add_local_port_range(self, lo: int, hi: int):
        self.components.append((LOCAL_PORT_RANGE_TYPE, struct.pack("!HH", lo, hi)))
        self.local_port_range = (lo, hi)
        return self

    def add_tos(self, value: int, mask: int = 0xFF):
        self.components.append((TYPE_OF_SERVICE_TYPE, bytes([value, mask])))
        self.tos = (value, mask)
        return self

    # ---- wire format (24.008 10.5.6.12 packet filter list entry) ------
    def pack(self) -> bytes:
        body = b"".join(bytes([t]) + v for t, v in self.components)
        hdr = bytes([(self.direction << 4) | (self.filter_id & 0x0F),
                     self.eval_precedence, len(body)])
        return hdr + body

    @classmethod
    def parse(cls, data: bytes, eps_bearer_id: int = 0) -> tuple["TftFilter", bytes]:
        f = cls(filter_id=data[0] & 0x0F, direction=(data[0] >> 4) & 0x3,
                eval_precedence=data[1], eps_bearer_id=eps_bearer_id)
        n = data[2]
        body, rest = data[3:3 + n], data[3 + n:]
        i = 0
        while i < len(body):
            t = body[i]
            i += 1
            size = {IPV4_REMOTE_ADDR_TYPE: 8, IPV4_LOCAL_ADDR_TYPE: 8,
                    IPV6_REMOTE_ADDR_TYPE: 32, PROTOCOL_ID_TYPE: 1,
                    SINGLE_LOCAL_PORT_TYPE: 2, SINGLE_REMOTE_PORT_TYPE: 2,
                    LOCAL_PORT_RANGE_TYPE: 4, REMOTE_PORT_RANGE_TYPE: 4,
                    SECURITY_PARAMETER_INDEX_TYPE: 4,
                    TYPE_OF_SERVICE_TYPE: 2, FLOW_LABEL_TYPE: 3}.get(t)
            if size is None:
                raise ValueError(f"unknown TFT component type 0x{t:02x}")
            v = body[i:i + size]
            i += size
            f.components.append((t, v))
            if t == IPV4_REMOTE_ADDR_TYPE:
                f.ipv4_remote = (v[:4], v[4:])
            elif t == IPV4_LOCAL_ADDR_TYPE:
                f.ipv4_local = (v[:4], v[4:])
            elif t == PROTOCOL_ID_TYPE:
                f.protocol_id = v[0]
            elif t == SINGLE_LOCAL_PORT_TYPE:
                f.single_local_port = struct.unpack("!H", v)[0]
            elif t == SINGLE_REMOTE_PORT_TYPE:
                f.single_remote_port = struct.unpack("!H", v)[0]
            elif t == LOCAL_PORT_RANGE_TYPE:
                f.local_port_range = struct.unpack("!HH", v)
            elif t == REMOTE_PORT_RANGE_TYPE:
                f.remote_port_range = struct.unpack("!HH", v)
            elif t == TYPE_OF_SERVICE_TYPE:
                f.tos = (v[0], v[1])
        return f, rest

    # ---- matching (tft_packet_filter.cc:194-400) -----------------------
    def match(self, pkt: bytes) -> bool:
        """AND of all active components against an uplink IPv4 packet.

        Like the reference's `match()`, the packet is implied OUTGOING:
        local = source, remote = destination.
        """
        if not self.components:
            return False
        if len(pkt) < 20 or pkt[0] >> 4 != 4:
            return False
        ihl = (pkt[0] & 0xF) * 4
        src, dst, proto, tos = pkt[12:16], pkt[16:20], pkt[9], pkt[1]
        if self.ipv4_local is not None:
            a, m = self.ipv4_local
            if _masked(src, m) != _masked(a, m):
                return False
        if self.ipv4_remote is not None:
            a, m = self.ipv4_remote
            if _masked(dst, m) != _masked(a, m):
                return False
        if self.protocol_id is not None and proto != self.protocol_id:
            return False
        if self.tos is not None and (tos & self.tos[1]) != (self.tos[0] & self.tos[1]):
            return False
        needs_ports = (self.single_local_port is not None
                       or self.single_remote_port is not None
                       or self.local_port_range is not None
                       or self.remote_port_range is not None)
        if needs_ports:
            # ports exist only for UDP/TCP (tft_packet_filter.cc:317-380)
            if proto not in (UDP_PROTOCOL, TCP_PROTOCOL) or len(pkt) < ihl + 4:
                return False
            sport, dport = struct.unpack("!HH", pkt[ihl:ihl + 4])
            if self.single_local_port is not None and sport != self.single_local_port:
                return False
            if self.single_remote_port is not None and dport != self.single_remote_port:
                return False
            if self.local_port_range is not None and not (
                    self.local_port_range[0] <= sport <= self.local_port_range[1]):
                return False
            if self.remote_port_range is not None and not (
                    self.remote_port_range[0] <= dport <= self.remote_port_range[1]):
                return False
        return True


def pack_tft(filters: list[TftFilter], opcode: int = 1) -> bytes:
    """TFT IE value: opcode (1=create new TFT) + packet filter list."""
    out = bytes([(opcode << 5) | (len(filters) & 0x0F)])
    return out + b"".join(f.pack() for f in filters)


def parse_tft(data: bytes, eps_bearer_id: int = 0) -> list[TftFilter]:
    n = data[0] & 0x0F
    rest = data[1:]
    out = []
    for _ in range(n):
        f, rest = TftFilter.parse(rest, eps_bearer_id)
        out.append(f)
    return out


class TftMatcher:
    """Routes uplink packets to EPS bearers (gw.cc apply_traffic_flow_template).

    Filters across all dedicated bearers are evaluated in ascending
    eval_precedence; the first match selects its bearer, otherwise the
    default bearer carries the packet.
    """

    def __init__(self, default_bearer_id: int = 5) -> None:
        self.default_bearer_id = default_bearer_id
        self._filters: list[TftFilter] = []

    def apply_tft(self, eps_bearer_id: int, filters: list[TftFilter]) -> None:
        for f in filters:
            f.eps_bearer_id = eps_bearer_id
        self._filters.extend(filters)
        self._filters.sort(key=lambda f: f.eval_precedence)

    def remove_bearer(self, eps_bearer_id: int) -> None:
        self._filters = [f for f in self._filters
                         if f.eps_bearer_id != eps_bearer_id]

    def lookup(self, pkt: bytes) -> int:
        for f in self._filters:
            if f.direction in (DIR_UPLINK, DIR_BIDIRECTIONAL) and f.match(pkt):
                return f.eps_bearer_id
        return self.default_bearer_id


def _ip4(s: str) -> bytes:
    return bytes(int(p) for p in s.split("."))


def _masked(addr: bytes, mask: bytes) -> bytes:
    return bytes(a & m for a, m in zip(addr, mask))
