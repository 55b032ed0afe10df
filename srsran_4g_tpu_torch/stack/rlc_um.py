"""RLC TM and UM entities, TS 36.322.

Counterpart of the reference's `lib/src/rlc/{rlc_tm.cc,rlc_um_lte.cc}`:
UM transmit (SDU segmentation/concatenation, FI/LI headers, 10-bit SN) and
receive (reordering window, t-Reordering gap skip, reassembly), plus the
trivial TM passthrough.  Host-side control/user-plane code; PDUs ride the
PHY transport blocks.

Timer model: the entity is driven by explicit `tick()` calls (1 ms = 1
TTI), like the reference's timer wheel.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

SN_MOD = 1024  # 10-bit SN
WINDOW = 512


@dataclass
class UmdPdu:
    sn: int
    fi_first: bool  # first byte of data is the start of an SDU
    fi_last: bool  # last byte of data is the end of an SDU
    lis: list[int]  # length indicators for all but the last data field
    data: bytes


def pack_umd(pdu: UmdPdu) -> bytes:
    fi = (0 if pdu.fi_first else 2) | (0 if pdu.fi_last else 1)
    e = 1 if pdu.lis else 0
    hdr = bytes([(fi << 3) | (e << 2) | (pdu.sn >> 8), pdu.sn & 0xFF])
    # LI extension: 11-bit E/LI pairs, 1.5 bytes each
    ext = bytearray()
    nibble = None
    for i, li in enumerate(pdu.lis):
        e_next = 1 if i < len(pdu.lis) - 1 else 0
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
    return hdr + bytes(ext) + pdu.data


def unpack_umd(raw: bytes) -> UmdPdu:
    fi = (raw[0] >> 3) & 0x3
    e = (raw[0] >> 2) & 0x1
    sn = ((raw[0] & 0x3) << 8) | raw[1]
    pos = 2
    lis = []
    if e:
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
    return UmdPdu(sn=sn, fi_first=not (fi & 2), fi_last=not (fi & 1),
                  lis=lis, data=bytes(raw[pos:]))


class RlcTm:
    """Transparent mode: pass-through queue (rlc_tm.cc)."""

    def __init__(self):
        self.q: deque[bytes] = deque()

    def write_sdu(self, sdu: bytes) -> None:
        self.q.append(sdu)

    def has_data(self) -> bool:
        return bool(self.q)

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        if self.q and len(self.q[0]) <= nof_bytes:
            return self.q.popleft()
        return None


class RlcUmTx:
    def __init__(self):
        self.sdu_q: deque[bytes] = deque()
        self.vt_us = 0
        self._partial: bytes | None = None  # remainder of a segmented SDU

    def write_sdu(self, sdu: bytes) -> None:
        self.sdu_q.append(sdu)

    def has_data(self) -> bool:
        return bool(self.sdu_q) or self._partial is not None

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        """Build one UMD PDU of at most nof_bytes (header incl.)."""
        if not self.has_data() or nof_bytes < 3:
            return None
        fields: list[bytes] = []
        fi_first = self._partial is None
        # rough header budget: 2 fixed + 1.5 per extra field
        def budget() -> int:
            return 2 + (3 * max(len(fields) - 0, 0) + 1) // 2

        space = nof_bytes - 2
        fi_last = True
        while space > 0:
            if self._partial is None and space <= 2 and fields:
                break  # not worth starting a new SDU for <= 2 bytes
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
                # account extra LI header room for a further field
                if self.sdu_q or self._partial is not None:
                    space -= 2
        if not fields:
            return None
        pdu = UmdPdu(
            sn=self.vt_us, fi_first=fi_first, fi_last=fi_last,
            lis=[len(f) for f in fields[:-1]], data=b"".join(fields),
        )
        self.vt_us = (self.vt_us + 1) % SN_MOD
        out = pack_umd(pdu)
        assert len(out) <= nof_bytes, (len(out), nof_bytes)
        return out


class RlcUmRx:
    def __init__(self, t_reordering_ms: int = 35):
        self.t_reordering = t_reordering_ms
        self.buf: dict[int, UmdPdu] = {}
        self.vr_ur = 0  # earliest SN still considered for reordering
        self.vr_uh = 0  # highest received SN + 1
        self.timer = -1  # -1 = stopped
        self.delivered: list[bytes] = []
        self._sdu_acc: bytes | None = None

    @staticmethod
    def _lt(a: int, b: int, base: int) -> bool:
        return ((a - base) % SN_MOD) < ((b - base) % SN_MOD)

    def write_pdu(self, raw: bytes) -> None:
        pdu = unpack_umd(raw)
        sn = pdu.sn
        base = (self.vr_uh - WINDOW) % SN_MOD
        if sn in self.buf:  # duplicate
            return
        # below the reassembly window → stale duplicate
        diff = (self.vr_uh - sn) % SN_MOD
        if 0 < diff <= WINDOW and self._lt(sn, self.vr_ur, base):
            return
        self.buf[sn] = pdu
        if self._lt(self.vr_uh, (sn + 1) % SN_MOD, base) or self.vr_uh == sn:
            self.vr_uh = (sn + 1) % SN_MOD
        self._try_deliver()
        if self.timer < 0 and self.vr_ur != self.vr_uh:
            self.timer = self.t_reordering

    def tick(self, ms: int = 1) -> None:
        if self.timer < 0:
            return
        self.timer -= ms
        if self.timer <= 0:
            # skip the gap: advance VR(UR) to the next received SN
            sn = self.vr_ur
            for _ in range(SN_MOD):
                sn = (sn + 1) % SN_MOD
                if sn in self.buf or sn == self.vr_uh:
                    break
            self.vr_ur = sn
            self._sdu_acc = None  # incomplete SDU across the gap is lost
            self._try_deliver()
            self.timer = self.t_reordering if self.vr_ur != self.vr_uh else -1

    def _try_deliver(self) -> None:
        while self.vr_ur in self.buf:
            pdu = self.buf.pop(self.vr_ur)
            self._reassemble(pdu)
            self.vr_ur = (self.vr_ur + 1) % SN_MOD
        if self.vr_ur == self.vr_uh:
            self.timer = -1

    def _reassemble(self, pdu: UmdPdu) -> None:
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
                continue  # continuation of a lost SDU head
            self._sdu_acc += f
            if ends:
                self.delivered.append(self._sdu_acc)
                self._sdu_acc = None
