"""NR RLC: UM and AM entities with SO-based segmentation (TS 38.322).

Counterpart of the reference's `lib/src/rlc/rlc_um_nr.cc` and
`rlc_am_nr.cc`: unlike LTE RLC (LI-based concatenation), NR RLC
carries at most ONE SDU (or SDU segment) per PDU, with a segment
offset (SO) field on non-first segments; AM adds ARQ with a STATUS PDU
listing NACK_SN(+SO ranges) and t-PollRetransmit/t-Reassembly/
t-StatusProhibit timers.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

# Segmentation info (SI) field: 00 full, 01 first, 10 last, 11 middle
SI_FULL, SI_FIRST, SI_LAST, SI_MID = 0, 1, 2, 3


# --------------------------------------------------------------------------
# UM (38.322 6.2.2.3: UMD PDU with 6- or 12-bit SN)


@dataclass
class UmdNrPdu:
    si: int
    sn: int = 0           # absent for SI_FULL
    so: int = 0           # present for last/middle
    data: bytes = b""


def pack_umd_nr(p: UmdNrPdu, sn_len: int = 6) -> bytes:
    if p.si == SI_FULL:
        return bytes([p.si << 6]) + p.data
    if sn_len == 6:
        hdr = bytes([(p.si << 6) | (p.sn & 0x3F)])
    else:
        hdr = bytes([(p.si << 6) | ((p.sn >> 8) & 0xF), p.sn & 0xFF])
    if p.si in (SI_LAST, SI_MID):
        hdr += p.so.to_bytes(2, "big")
    return hdr + p.data


def unpack_umd_nr(raw: bytes, sn_len: int = 6) -> UmdNrPdu:
    si = raw[0] >> 6
    if si == SI_FULL:
        return UmdNrPdu(si=si, data=raw[1:])
    if sn_len == 6:
        sn, pos = raw[0] & 0x3F, 1
    else:
        sn, pos = ((raw[0] & 0xF) << 8) | raw[1], 2
    so = 0
    if si in (SI_LAST, SI_MID):
        so = int.from_bytes(raw[pos:pos + 2], "big")
        pos += 2
    return UmdNrPdu(si=si, sn=sn, so=so, data=raw[pos:])


class RlcUmNr:
    """Bidirectional UM entity (TX segmentation + RX reassembly)."""

    def __init__(self, sn_len: int = 6, t_reassembly_ms: int = 35) -> None:
        self.sn_len = sn_len
        self.sn_mod = 1 << sn_len
        self.t_reassembly_ms = t_reassembly_ms
        # TX
        self.sdu_q: deque[bytes] = deque()
        self.tx_next = 0
        self._partial: Optional[bytes] = None
        self._partial_so = 0
        # RX
        self.rx_segs: dict[int, dict[int, bytes]] = {}
        self.rx_has_last: dict[int, int] = {}   # sn -> total length
        self.t_reass = -1
        self.delivered: list[bytes] = []

    # TX ------------------------------------------------------------------

    def write_sdu(self, sdu: bytes) -> None:
        self.sdu_q.append(sdu)

    def has_data(self) -> bool:
        return bool(self.sdu_q or self._partial is not None)

    def read_pdu(self, nof_bytes: int) -> Optional[bytes]:
        hdr_max = (1 if self.sn_len == 6 else 2) + 2
        if nof_bytes <= hdr_max:
            return None
        if self._partial is not None:
            seg = self._partial[:nof_bytes - hdr_max]
            rest = self._partial[len(seg):]
            si = SI_LAST if not rest else SI_MID
            pdu = pack_umd_nr(UmdNrPdu(si=si, sn=self.tx_next,
                                       so=self._partial_so, data=seg),
                              self.sn_len)
            self._partial_so += len(seg)
            if rest:
                self._partial = rest
            else:
                self._partial = None
                self.tx_next = (self.tx_next + 1) % self.sn_mod
            return pdu
        if not self.sdu_q:
            return None
        sdu = self.sdu_q.popleft()
        if len(sdu) + 1 <= nof_bytes:
            return pack_umd_nr(UmdNrPdu(si=SI_FULL, data=sdu), self.sn_len)
        seg = sdu[:nof_bytes - hdr_max]
        self._partial = sdu[len(seg):]
        self._partial_so = len(seg)
        return pack_umd_nr(UmdNrPdu(si=SI_FIRST, sn=self.tx_next, data=seg),
                           self.sn_len)

    # RX ------------------------------------------------------------------

    def write_pdu(self, raw: bytes) -> None:
        p = unpack_umd_nr(raw, self.sn_len)
        if p.si == SI_FULL:
            self.delivered.append(p.data)
            return
        segs = self.rx_segs.setdefault(p.sn, {})
        so = p.so if p.si in (SI_MID, SI_LAST) else 0
        segs[so] = p.data
        if p.si == SI_LAST:
            self.rx_has_last[p.sn] = so + len(p.data)
        if self.t_reass < 0:
            self.t_reass = self.t_reassembly_ms
        self._try_reassemble(p.sn)

    def _try_reassemble(self, sn: int) -> None:
        if sn not in self.rx_has_last:
            return
        total = self.rx_has_last[sn]
        segs = self.rx_segs.get(sn, {})
        buf = bytearray(total)
        covered = 0
        for so in sorted(segs):
            d = segs[so]
            buf[so:so + len(d)] = d
            covered += len(d)
        if covered >= total:
            self.delivered.append(bytes(buf))
            del self.rx_segs[sn]
            del self.rx_has_last[sn]
            self.t_reass = -1

    def tick(self, ms: int = 1) -> None:
        if self.t_reass > 0:
            self.t_reass -= ms
            if self.t_reass <= 0:
                # discard incomplete SDUs (38.322 5.2.2.2.4)
                self.rx_segs.clear()
                self.rx_has_last.clear()
                self.t_reass = -1


# --------------------------------------------------------------------------
# AM (38.322 6.2.2.4: AMD PDU, 12- or 18-bit SN; STATUS 6.2.2.5)


@dataclass
class AmdNrPdu:
    sn: int
    si: int = SI_FULL
    so: int = 0
    poll: bool = False
    data: bytes = b""


def pack_amd_nr(p: AmdNrPdu, sn_len: int = 12) -> bytes:
    b0 = 0x80 | ((1 if p.poll else 0) << 6) | (p.si << 4)
    if sn_len == 12:
        hdr = bytes([b0 | ((p.sn >> 8) & 0xF), p.sn & 0xFF])
    else:
        hdr = bytes([b0 | ((p.sn >> 16) & 0x3),
                     (p.sn >> 8) & 0xFF, p.sn & 0xFF])
    if p.si in (SI_LAST, SI_MID):
        hdr += p.so.to_bytes(2, "big")
    return hdr + p.data


def unpack_amd_nr(raw: bytes, sn_len: int = 12) -> AmdNrPdu:
    b0 = raw[0]
    poll = bool(b0 & 0x40)
    si = (b0 >> 4) & 0x3
    if sn_len == 12:
        sn, pos = ((b0 & 0xF) << 8) | raw[1], 2
    else:
        sn, pos = ((b0 & 0x3) << 16) | (raw[1] << 8) | raw[2], 3
    so = 0
    if si in (SI_LAST, SI_MID):
        so = int.from_bytes(raw[pos:pos + 2], "big")
        pos += 2
    return AmdNrPdu(sn=sn, si=si, so=so, poll=poll, data=raw[pos:])


def pack_status_nr(ack_sn: int, nacks: list[int], sn_len: int = 12) -> bytes:
    """Control PDU: [0|CPT=0][ACK_SN][E1][NACK_SN...]."""
    out = bytearray([0x00])
    out += ack_sn.to_bytes(3, "big")
    out.append(len(nacks))
    for sn in nacks:
        out += sn.to_bytes(3, "big")
    return bytes(out)


def unpack_status_nr(raw: bytes) -> tuple[int, list[int]]:
    ack = int.from_bytes(raw[1:4], "big")
    n = raw[4]
    nacks = [int.from_bytes(raw[5 + 3 * i:8 + 3 * i], "big")
             for i in range(n)]
    return ack, nacks


class RlcAmNr:
    """Bidirectional AM entity with ARQ (window, poll, status, retx)."""

    def __init__(self, sn_len: int = 12, max_retx: int = 8,
                 t_poll_retx_ms: int = 45, t_reassembly_ms: int = 35,
                 t_status_prohibit_ms: int = 0) -> None:
        self.sn_len = sn_len
        self.sn_mod = 1 << sn_len
        self.window = self.sn_mod // 2
        self.max_retx = max_retx
        self.t_poll_retx_ms = t_poll_retx_ms
        self.t_reassembly_ms = t_reassembly_ms
        self.t_status_prohibit_ms = t_status_prohibit_ms
        # TX
        self.sdu_q: deque[bytes] = deque()
        self.tx_next = 0
        self.tx_next_ack = 0
        self.tx_window: dict[int, bytes] = {}
        self.retx_q: deque[int] = deque()
        self.retx_count: dict[int, int] = {}
        self.pdu_since_poll = 0
        self.t_poll = -1
        self.max_retx_reached = False
        # RX
        self.rx_next = 0
        self.rx_window: dict[int, bytes] = {}
        self.status_due = False
        self.t_status = -1
        self.delivered: list[bytes] = []

    # TX ------------------------------------------------------------------

    def write_sdu(self, sdu: bytes) -> None:
        self.sdu_q.append(sdu)

    def has_data(self) -> bool:
        return bool(self.sdu_q or self.retx_q or self.status_due)

    def _window_full(self) -> bool:
        return ((self.tx_next - self.tx_next_ack) % self.sn_mod) \
            >= self.window

    def read_pdu(self, nof_bytes: int) -> Optional[bytes]:
        if self.status_due and self.t_status < 0:
            status = pack_status_nr(self.rx_next, self._missing(),
                                    self.sn_len)
            if len(status) <= nof_bytes:
                self.status_due = False
                if self.t_status_prohibit_ms:
                    self.t_status = self.t_status_prohibit_ms
                return status
        if self.retx_q:
            sn = self.retx_q.popleft()
            if sn in self.tx_window:
                self.retx_count[sn] = self.retx_count.get(sn, 0) + 1
                if self.retx_count[sn] > self.max_retx:
                    self.max_retx_reached = True  # -> RLF upstairs
                    return None
                data = self.tx_window[sn]
                pdu = pack_amd_nr(AmdNrPdu(sn=sn, poll=True, data=data),
                                  self.sn_len)
                if len(pdu) <= nof_bytes:
                    self.t_poll = self.t_poll_retx_ms
                    return pdu
                self.retx_q.appendleft(sn)
                return None
        if not self.sdu_q or self._window_full():
            return None
        hdr = 2 if self.sn_len == 12 else 3
        if len(self.sdu_q[0]) + hdr > nof_bytes:
            return None  # (no re-segmentation of new SDUs in this build)
        sdu = self.sdu_q.popleft()
        sn = self.tx_next
        self.tx_next = (self.tx_next + 1) % self.sn_mod
        self.tx_window[sn] = sdu
        self.pdu_since_poll += 1
        poll = self.pdu_since_poll >= 4 or not self.sdu_q
        if poll:
            self.pdu_since_poll = 0
            self.t_poll = self.t_poll_retx_ms
        return pack_amd_nr(AmdNrPdu(sn=sn, poll=poll, data=sdu),
                           self.sn_len)

    # RX ------------------------------------------------------------------

    def _missing(self) -> list[int]:
        if not self.rx_window:
            return []
        hi = max((sn - self.rx_next) % self.sn_mod
                 for sn in self.rx_window)
        return [(self.rx_next + d) % self.sn_mod for d in range(hi)
                if (self.rx_next + d) % self.sn_mod not in self.rx_window]

    def write_pdu(self, raw: bytes) -> None:
        if not raw:
            return
        if not (raw[0] & 0x80):  # control
            ack, nacks = unpack_status_nr(raw)
            # advance tx_next_ack, drop acked from window
            while self.tx_next_ack != ack:
                if self.tx_next_ack in nacks:
                    break
                self.tx_window.pop(self.tx_next_ack, None)
                self.tx_next_ack = (self.tx_next_ack + 1) % self.sn_mod
            for sn in nacks:
                if sn in self.tx_window and sn not in self.retx_q:
                    self.retx_q.append(sn)
            if not self.tx_window:
                self.t_poll = -1
            return
        p = unpack_amd_nr(raw, self.sn_len)
        if p.poll:
            self.status_due = True
        dist = (p.sn - self.rx_next) % self.sn_mod
        if dist >= self.window or p.sn in self.rx_window:
            return
        self.rx_window[p.sn] = p.data
        while self.rx_next in self.rx_window:
            self.delivered.append(self.rx_window.pop(self.rx_next))
            self.rx_next = (self.rx_next + 1) % self.sn_mod

    def tick(self, ms: int = 1) -> None:
        if self.t_poll > 0:
            self.t_poll -= ms
            if self.t_poll <= 0 and self.tx_window:
                oldest = self.tx_next_ack
                if oldest in self.tx_window and oldest not in self.retx_q:
                    self.retx_q.append(oldest)
        if self.t_status > 0:
            self.t_status -= ms
