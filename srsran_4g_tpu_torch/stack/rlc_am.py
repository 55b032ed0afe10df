"""RLC AM entity, TS 36.322 §5.2.

Counterpart of the reference's `lib/src/rlc/rlc_am_lte.cc` (SURVEY.md §2.3):
AMD PDUs (D/C, RF, P, FI, E, 10-bit SN), SDU segmentation/concatenation,
ARQ with STATUS PDUs (ACK_SN + NACK list), the poll machinery (pollPDU /
pollByte / t-PollRetransmit), t-Reordering driven status triggering,
t-StatusProhibit, and **re-segmentation**: a retransmitted PDU that no
longer fits the grant is split into AMD PDU segments (RF=1 headers with
LSF + 15-bit SO, §6.2.1.5), each carrying the FI/LI structure of the
SDU fields it contains; the receiver reassembles segments by SO and
reconstructs the original PDU's field boundaries exactly.

Driven by explicit `tick()` calls (1 ms).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

SN_MOD = 1024
WINDOW = 512


# --- PDU codecs ---------------------------------------------------------------


@dataclass
class AmdPdu:
    sn: int
    fi_first: bool
    fi_last: bool
    poll: bool
    lis: list[int]
    data: bytes


def pack_amd(p: AmdPdu) -> bytes:
    b0 = 0x80  # D/C = data, RF = 0 (a retransmitted full PDU is identical)
    if p.poll:
        b0 |= 0x20
    fi = (0 if p.fi_first else 2) | (0 if p.fi_last else 1)
    b0 |= fi << 3
    if p.lis:
        b0 |= 0x04  # E
    # layout: D/C RF P FI FI E SN[9:8] | SN[7:0]
    hdr = bytes([b0 | (p.sn >> 8), p.sn & 0xFF])
    return hdr + (_pack_li_ext(p.lis) if p.lis else b"") + p.data


def unpack_amd(raw: bytes) -> AmdPdu:
    b0 = raw[0]
    assert b0 & 0x80, "not an AMD PDU"
    assert not (b0 & 0x40), "AMD PDU segment — use unpack_amd_segment"
    poll = bool(b0 & 0x20)
    fi = (b0 >> 3) & 0x3
    e = bool(b0 & 0x04)
    sn = ((b0 & 0x3) << 8) | raw[1]
    pos = 2
    lis: list[int] = []
    if e:
        lis, pos = _unpack_li_ext(raw, pos)
    return AmdPdu(sn=sn, fi_first=not (fi & 2), fi_last=not (fi & 1),
                  poll=poll, lis=lis, data=bytes(raw[pos:]))


@dataclass
class AmdSegment:
    """AMD PDU segment (RF=1): a byte range [so, so+len(data)) of the
    original PDU's data field, with the FI/LIs of the fields it holds."""
    sn: int
    so: int
    lsf: bool       # last segment flag
    fi_first: bool  # first byte of this segment starts an SDU
    fi_last: bool   # last byte of this segment ends an SDU
    poll: bool
    lis: list[int]
    data: bytes


def _pack_li_ext(lis: list[int]) -> bytes:
    ext = bytearray()
    nibble = None
    for i, li in enumerate(lis):
        e_next = 1 if i < len(lis) - 1 else 0
        v = (e_next << 11) | li
        if nibble is None:
            ext.append(v >> 4)
            nibble = v & 0xF
        else:
            ext.append((nibble << 4) | (v >> 8))
            ext.append(v & 0xFF)
            nibble = None
    if nibble is not None:
        ext.append(nibble << 4)
    return bytes(ext)


def _unpack_li_ext(raw: bytes, pos: int) -> tuple[list[int], int]:
    lis: list[int] = []
    nibble = None
    while True:
        if nibble is None:
            v = (raw[pos] << 4) | (raw[pos + 1] >> 4)
            nibble = True
            pos += 1
        else:
            v = ((raw[pos] & 0xF) << 8) | raw[pos + 1]
            nibble = None
            pos += 2
        lis.append(v & 0x7FF)
        if not (v >> 11):
            break
    if nibble:
        pos += 1
    return lis, pos


def pack_amd_segment(s: AmdSegment) -> bytes:
    """RF=1 header: D/C RF P FI FI E SN(10) | LSF SO(15) (+ LI ext)."""
    b0 = 0x80 | 0x40  # D/C = data, RF = segment
    if s.poll:
        b0 |= 0x20
    fi = (0 if s.fi_first else 2) | (0 if s.fi_last else 1)
    b0 |= fi << 3
    if s.lis:
        b0 |= 0x04
    hdr = bytes([b0 | (s.sn >> 8), s.sn & 0xFF,
                 ((1 if s.lsf else 0) << 7) | (s.so >> 8), s.so & 0xFF])
    return hdr + (_pack_li_ext(s.lis) if s.lis else b"") + s.data


def unpack_amd_segment(raw: bytes) -> AmdSegment:
    b0 = raw[0]
    assert (b0 & 0xC0) == 0xC0, "not an AMD PDU segment"
    poll = bool(b0 & 0x20)
    fi = (b0 >> 3) & 0x3
    e = bool(b0 & 0x04)
    sn = ((b0 & 0x3) << 8) | raw[1]
    lsf = bool(raw[2] & 0x80)
    so = ((raw[2] & 0x7F) << 8) | raw[3]
    pos = 4
    lis: list[int] = []
    if e:
        lis, pos = _unpack_li_ext(raw, pos)
    return AmdSegment(sn=sn, so=so, lsf=lsf, fi_first=not (fi & 2),
                      fi_last=not (fi & 1), poll=poll, lis=lis,
                      data=bytes(raw[pos:]))


def pack_status(ack_sn: int, nacks: list[int]) -> bytes:
    """STATUS PDU: D/C=0, CPT=0, ACK_SN(10), then E1/NACK_SN(10) list."""
    bits: list[int] = [0, 0, 0, 0]  # D/C=0, CPT=000
    bits += [(ack_sn >> (9 - i)) & 1 for i in range(10)]
    for n in nacks:
        bits.append(1)  # E1: a NACK follows
        bits += [(n >> (9 - i)) & 1 for i in range(10)]
        bits.append(0)  # E2: no segment offsets
    bits.append(0)  # E1 = 0: end
    while len(bits) % 8:
        bits.append(0)
    out = bytearray()
    for i in range(0, len(bits), 8):
        out.append(int("".join(map(str, bits[i:i + 8])), 2))
    return bytes(out)


def unpack_status(raw: bytes) -> tuple[int, list[int]]:
    bits = []
    for byte in raw:
        bits += [(byte >> (7 - i)) & 1 for i in range(8)]
    assert bits[0] == 0, "not a STATUS PDU"
    pos = 4
    ack_sn = int("".join(map(str, bits[pos:pos + 10])), 2)
    pos += 10
    nacks = []
    while pos < len(bits) and bits[pos] == 1:
        pos += 1
        nacks.append(int("".join(map(str, bits[pos:pos + 10])), 2))
        pos += 10
        e2 = bits[pos]
        pos += 1
        assert e2 == 0, "segment NACKs not supported"
    return ack_sn, nacks


# --- entity -------------------------------------------------------------------


@dataclass
class AmConfig:
    t_poll_retx_ms: int = 45
    poll_pdu: int = 4
    poll_byte: int = 3000
    t_reordering_ms: int = 35
    t_status_prohibit_ms: int = 0
    max_retx: int = 8


def _lt(a: int, b: int, base: int) -> bool:
    return ((a - base) % SN_MOD) < ((b - base) % SN_MOD)


def _bounds_to_lis(bounds: list[int], total: int) -> list[int]:
    """Field boundaries (offsets, exclusive of 0/total) → LI lengths of
    all fields but the last."""
    lis = []
    prev = 0
    for b in bounds:
        lis.append(b - prev)
        prev = b
    return lis


class RlcAm:
    """Bidirectional AM entity (TX + RX sides)."""

    def __init__(self, cfg: AmConfig | None = None):
        self.cfg = cfg or AmConfig()
        # TX state
        self.sdu_q: deque[bytes] = deque()
        self._partial: bytes | None = None
        self.vt_s = 0  # next SN to assign
        self.vt_a = 0  # oldest unacked SN
        self.tx_window: dict[int, AmdPdu] = {}
        self.retx_q: deque[int] = deque()
        self.retx_so: dict[int, int] = {}  # resegmentation progress per SN
        self.retx_count: dict[int, int] = {}
        self.pdu_without_poll = 0
        self.byte_without_poll = 0
        self.t_poll = -1
        self.max_retx_reached = False
        # RX state
        self.rx_window: dict[int, AmdPdu] = {}
        self.vr_r = 0  # next expected in-sequence SN
        self.vr_h = 0  # highest received + 1
        self.t_reord = -1
        self.status_due = False
        self.t_status_prohibit = -1
        self.delivered: list[bytes] = []
        self._sdu_acc: bytes | None = None
        self.rx_segs: dict[int, dict[int, AmdSegment]] = {}

    # --- TX side -----------------------------------------------------------

    def write_sdu(self, sdu: bytes) -> None:
        self.sdu_q.append(sdu)

    def has_data(self) -> bool:
        return bool(self.sdu_q or self._partial is not None or self.retx_q
                    or self.status_due)

    def _window_full(self) -> bool:
        return ((self.vt_s - self.vt_a) % SN_MOD) >= WINDOW

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        """Build the next PDU: STATUS first, then retx, then new data."""
        if self.status_due and self.t_status_prohibit < 0:
            status = pack_status(self.vr_r, self._nack_list())
            if len(status) <= nof_bytes:
                self.status_due = False
                if self.cfg.t_status_prohibit_ms:
                    self.t_status_prohibit = self.cfg.t_status_prohibit_ms
                return status
        if self.retx_q:
            sn = self.retx_q[0]
            pdu = self.tx_window.get(sn)
            if pdu is None:
                self.retx_q.popleft()
                return self.read_pdu(nof_bytes)
            so = self.retx_so.get(sn, 0)
            raw = pack_amd(AmdPdu(**{**pdu.__dict__, "poll": True}))
            if so == 0 and len(raw) <= nof_bytes:
                self._retx_done(sn)
                return raw
            return self._resegment(sn, pdu, so, nof_bytes)
        if (self.sdu_q or self._partial is not None) and not self._window_full() \
                and nof_bytes >= 4:
            fields: list[bytes] = []
            fi_first = self._partial is None
            space = nof_bytes - 2
            fi_last = True
            while space > 0:
                if self._partial is None and space <= 2 and fields:
                    break
                cur = self._partial if self._partial is not None else (
                    self.sdu_q.popleft() if self.sdu_q else None)
                self._partial = None
                if cur is None:
                    break
                if len(cur) > space:
                    fields.append(cur[:space])
                    self._partial = cur[space:]
                    fi_last = False
                    space = 0
                else:
                    fields.append(cur)
                    space -= len(cur)
                    if self.sdu_q or self._partial is not None:
                        space -= 2
            if not fields:
                return None
            data = b"".join(fields)
            self.pdu_without_poll += 1
            self.byte_without_poll += len(data)
            poll = (
                self.pdu_without_poll >= self.cfg.poll_pdu
                or self.byte_without_poll >= self.cfg.poll_byte
                or (not self.sdu_q and self._partial is None)
            )
            if poll:
                self.pdu_without_poll = 0
                self.byte_without_poll = 0
                self.t_poll = self.cfg.t_poll_retx_ms
            pdu = AmdPdu(sn=self.vt_s, fi_first=fi_first, fi_last=fi_last,
                         poll=poll, lis=[len(f) for f in fields[:-1]],
                         data=data)
            self.tx_window[self.vt_s] = pdu
            self.vt_s = (self.vt_s + 1) % SN_MOD
            return pack_amd(pdu)
        return None

    def _retx_done(self, sn: int) -> None:
        self.retx_q.popleft()
        self.retx_so.pop(sn, None)
        self.retx_count[sn] = self.retx_count.get(sn, 0) + 1
        if self.retx_count[sn] >= self.cfg.max_retx:
            self.max_retx_reached = True
        self.t_poll = self.cfg.t_poll_retx_ms

    def _resegment(self, sn: int, pdu: AmdPdu, so: int,
                   nof_bytes: int) -> bytes | None:
        """Emit the next AMD PDU segment of `pdu` fitting `nof_bytes`
        (rlc_am_lte.cc build_retx_pdu resegmentation, TS 36.322 §5.2.1)."""
        total = len(pdu.data)
        # original SDU-field boundaries inside the data field
        bounds = []
        acc = 0
        for li in pdu.lis:
            acc += li
            bounds.append(acc)
        chunk = min(total - so, nof_bytes - 4)
        while chunk > 0:
            seg_lis_b = [b - so for b in bounds if so < b < so + chunk]
            hdr_len = 4 + (len(_pack_li_ext(
                _bounds_to_lis(seg_lis_b, chunk))) if seg_lis_b else 0)
            if hdr_len + chunk <= nof_bytes:
                break
            chunk -= (hdr_len + chunk) - nof_bytes
        if chunk <= 0:
            return None
        end = so + chunk
        lsf = end == total
        seg = AmdSegment(
            sn=sn, so=so, lsf=lsf,
            fi_first=pdu.fi_first if so == 0 else (so in bounds),
            fi_last=pdu.fi_last if lsf else (end in bounds),
            poll=lsf,
            lis=_bounds_to_lis([b - so for b in bounds if so < b < end],
                               chunk),
            data=pdu.data[so:end],
        )
        if lsf:
            self._retx_done(sn)
        else:
            self.retx_so[sn] = end
        return pack_amd_segment(seg)

    def handle_status(self, raw: bytes) -> None:
        ack_sn, nacks = unpack_status(raw)
        for sn in nacks:
            if sn in self.tx_window and sn not in self.retx_q:
                self.retx_q.append(sn)
        # everything below ack_sn and not nacked is acknowledged
        sn = self.vt_a
        while sn != ack_sn:
            if sn not in nacks:
                self.tx_window.pop(sn, None)
                self.retx_count.pop(sn, None)
            sn = (sn + 1) % SN_MOD
        # advance vt_a to the first still-outstanding SN
        sn = self.vt_a
        while sn != ack_sn and sn not in self.tx_window:
            sn = (sn + 1) % SN_MOD
        self.vt_a = sn
        if not self.tx_window:
            self.t_poll = -1

    # --- RX side -----------------------------------------------------------

    def _nack_list(self) -> list[int]:
        out = []
        sn = self.vr_r
        while sn != self.vr_h:
            if sn not in self.rx_window and _lt(sn, self.vr_h, self.vr_r):
                out.append(sn)
            sn = (sn + 1) % SN_MOD
        return out

    def write_pdu(self, raw: bytes) -> None:
        if not raw:
            return
        if not (raw[0] & 0x80):  # control PDU → TX side
            self.handle_status(raw)
            return
        if raw[0] & 0x40:  # AMD PDU segment (RF = 1)
            pdu = self._handle_segment(unpack_amd_segment(raw))
            if pdu is None:
                return
        else:
            pdu = unpack_amd(raw)
        sn = pdu.sn
        if pdu.poll:
            self.status_due = True
        inside = ((sn - self.vr_r) % SN_MOD) < WINDOW
        if not inside or sn in self.rx_window:
            return  # duplicate / stale
        self.rx_window[sn] = pdu
        if _lt(self.vr_h, (sn + 1) % SN_MOD, self.vr_r) or self.vr_h == sn:
            self.vr_h = (sn + 1) % SN_MOD
        # in-order delivery
        while self.vr_r in self.rx_window:
            self._reassemble(self.rx_window.pop(self.vr_r))
            self.vr_r = (self.vr_r + 1) % SN_MOD
        if self.vr_r != self.vr_h and self.t_reord < 0:
            self.t_reord = self.cfg.t_reordering_ms

    def _handle_segment(self, seg: AmdSegment) -> AmdPdu | None:
        """Collect AMD PDU segments; once [0, total) is covered and LSF
        seen, reconstruct the original PDU (data + exact FI/LI structure)."""
        sn = seg.sn
        if ((sn - self.vr_r) % SN_MOD) >= WINDOW or sn in self.rx_window:
            return None  # stale / already have the full PDU
        if seg.poll:
            self.status_due = True
        segs = self.rx_segs.setdefault(sn, {})
        segs[seg.so] = seg
        # contiguity check from 0, LSF on the final piece
        pos = 0
        chain: list[AmdSegment] = []
        while pos in segs:
            s = segs[pos]
            chain.append(s)
            pos += len(s.data)
            if s.lsf:
                break
        if not chain or not chain[-1].lsf:
            return None
        total = pos
        data = b"".join(s.data for s in chain)
        bounds: set[int] = set()
        for s in chain:
            acc = s.so
            for li in s.lis:
                acc += li
                bounds.add(acc)
            # segment-edge boundaries: an SDU ending exactly at the edge
            if s.fi_last and s.so + len(s.data) < total:
                bounds.add(s.so + len(s.data))
            if s.fi_first and s.so > 0:
                bounds.add(s.so)
        del self.rx_segs[sn]
        return AmdPdu(sn=sn, fi_first=chain[0].fi_first,
                      fi_last=chain[-1].fi_last, poll=False,
                      lis=_bounds_to_lis(sorted(bounds), total), data=data)

    def _reassemble(self, pdu: AmdPdu) -> None:
        fields = []
        pos = 0
        for li in pdu.lis:
            fields.append(pdu.data[pos:pos + li])
            pos += li
        fields.append(pdu.data[pos:])
        for i, f in enumerate(fields):
            starts = (i > 0) or pdu.fi_first
            ends = (i < len(fields) - 1) or pdu.fi_last
            if starts:
                self._sdu_acc = b""
            if self._sdu_acc is None:
                continue
            self._sdu_acc += f
            if ends:
                self.delivered.append(self._sdu_acc)
                self._sdu_acc = None

    # --- timers --------------------------------------------------------------

    def tick(self, ms: int = 1) -> None:
        if self.t_poll > 0:
            self.t_poll -= ms
            if self.t_poll <= 0 and self.tx_window:
                # t-PollRetransmit expiry: retransmit the oldest outstanding
                if self.vt_a in self.tx_window and self.vt_a not in self.retx_q:
                    self.retx_q.append(self.vt_a)
                self.t_poll = -1
        if self.t_reord > 0:
            self.t_reord -= ms
            if self.t_reord <= 0:
                self.status_due = True
                self.t_reord = self.cfg.t_reordering_ms if \
                    self.vr_r != self.vr_h else -1
        if self.t_status_prohibit > 0:
            self.t_status_prohibit -= ms
            if self.t_status_prohibit <= 0:
                self.t_status_prohibit = -1
