"""LTE MAC PDU packing/unpacking, TS 36.321 §6.

Counterpart of the reference's `lib/src/mac/pdu.cc` /
`lib/include/srsran/mac/pdu.h` (sch_pdu, rar_pdu): MAC subheaders
(R/F2/E/LCID + F/L), control elements, SDU multiplexing, padding rules, and
the Random Access Response PDU.  Host-side control-plane code — the
transport blocks it produces/consumes are the bit payloads of the TPU
PHY pipeline (models/sch.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# DL-SCH control-element LCIDs (TS 36.321 Table 6.2.1-1)
LCID_CCCH = 0
LCID_ACT_DEACT = 0x1B
LCID_CON_RES = 0x1C
LCID_TA_CMD = 0x1D
LCID_DRX_CMD = 0x1E
LCID_PADDING = 0x1F
# UL-SCH CE LCIDs (Table 6.2.1-2)
LCID_PHR = 0x1A
LCID_CRNTI = 0x1B
LCID_TRUNC_BSR = 0x1C
LCID_SHORT_BSR = 0x1D
LCID_LONG_BSR = 0x1E

_CE_SIZES_DL = {LCID_ACT_DEACT: 1, LCID_CON_RES: 6, LCID_TA_CMD: 1,
                LCID_DRX_CMD: 0}
_CE_SIZES_UL = {LCID_PHR: 1, LCID_CRNTI: 2, LCID_TRUNC_BSR: 1,
                LCID_SHORT_BSR: 1, LCID_LONG_BSR: 3}


@dataclass
class MacSubPdu:
    lcid: int
    payload: bytes = b""
    is_sdu: bool = True


@dataclass
class MacPdu:
    subpdus: list[MacSubPdu] = field(default_factory=list)

    def add_sdu(self, lcid: int, payload: bytes) -> None:
        assert 0 <= lcid <= 10
        self.subpdus.append(MacSubPdu(lcid, payload, is_sdu=True))

    def add_ce(self, lcid: int, payload: bytes = b"") -> None:
        self.subpdus.append(MacSubPdu(lcid, payload, is_sdu=False))


def pack(pdu: MacPdu, pdu_len: int, ul: bool = False) -> bytes:
    """Pack into exactly pdu_len bytes (padding rules per §6.1.2:
    1-2 spare bytes → padding subheader(s) at the start; more → a padding
    subheader at the end consuming the remainder)."""
    # CEs first in DL (and UL except padding); order preserved otherwise
    subs = [s for s in pdu.subpdus if not s.is_sdu] + \
           [s for s in pdu.subpdus if s.is_sdu]

    def build(pre_pad: int, end_pad: bool) -> bytes:
        headers: list[bytes] = [bytes([LCID_PADDING])] * pre_pad
        payloads: list[bytes] = []
        for i, s in enumerate(subs):
            last_sub = (i == len(subs) - 1) and not end_pad
            if s.is_sdu and not last_sub:
                n = len(s.payload)
                if n < 128:
                    headers.append(bytes([s.lcid, n]))
                else:
                    headers.append(
                        bytes([s.lcid, 0x80 | (n >> 8), n & 0xFF]))
            else:
                headers.append(bytes([s.lcid]))
            payloads.append(s.payload)
        if end_pad:
            headers.append(bytes([LCID_PADDING]))
        # E bit on every subheader except the last
        fixed = [
            bytes([(h[0] | 0x20) if i < len(headers) - 1 else (h[0] & 0x1F)])
            + h[1:]
            for i, h in enumerate(headers)
        ]
        return b"".join(fixed) + b"".join(payloads)

    base = build(0, False)
    pad = pdu_len - len(base)
    assert pad >= 0, f"PDU overflow: need {len(base)}, have {pdu_len}"
    if pad == 0:
        out = base
    elif pad <= 2:
        out = build(pad, False)
    else:
        out = build(0, True)
    out = out + b"\x00" * (pdu_len - len(out))
    assert len(out) == pdu_len, (len(out), pdu_len)
    return out


def unpack(data: bytes, ul: bool = False) -> MacPdu:
    ce_sizes = _CE_SIZES_UL if ul else _CE_SIZES_DL
    pdu = MacPdu()
    pos = 0
    entries: list[tuple[int, int | None]] = []  # (lcid, length or None=rest)
    while True:
        b0 = data[pos]
        pos += 1
        ext = bool(b0 & 0x20)
        lcid = b0 & 0x1F
        if lcid <= 10 and ext:  # SDU with length field
            f = data[pos]
            if f & 0x80:
                length = ((f & 0x7F) << 8) | data[pos + 1]
                pos += 2
            else:
                length = f
                pos += 1
            entries.append((lcid, length))
        elif lcid <= 10:
            entries.append((lcid, None))  # last SDU: rest of PDU
        else:
            entries.append((lcid, ce_sizes.get(lcid, 0)))
        if not ext:
            break
    for lcid, length in entries:
        if lcid == LCID_PADDING:
            continue
        if length is None:
            payload = data[pos:]
            pos = len(data)
        else:
            payload = data[pos:pos + length]
            pos += length
        pdu.subpdus.append(MacSubPdu(lcid, bytes(payload), is_sdu=lcid <= 10))
    return pdu


# --- Random Access Response (TS 36.321 §6.1.5) -------------------------------


@dataclass
class RarGrant:
    rapid: int
    ta: int  # timing advance command (11 bits)
    ul_grant: int  # 20 bits
    temp_crnti: int


def pack_rar(grants: list[RarGrant], backoff: int | None = None,
             pdu_len: int | None = None) -> bytes:
    raw = []
    if backoff is not None:
        raw.append(backoff & 0x0F)  # T=0: backoff indicator
    for g in grants:
        raw.append(0x40 | g.rapid)  # T=1: RAPID
    headers = [
        bytes([(0x80 if i < len(raw) - 1 else 0) | b]) for i, b in enumerate(raw)
    ]
    body = b""
    for g in grants:
        v = (g.ta << 36) | (g.ul_grant << 16) | g.temp_crnti
        body += v.to_bytes(6, "big")
    out = b"".join(headers) + body
    if pdu_len is not None:
        out = out + b"\x00" * (pdu_len - len(out))
    return out


def unpack_rar(data: bytes) -> tuple[int | None, list[RarGrant]]:
    pos = 0
    backoff = None
    rapids = []
    while True:
        b0 = data[pos]
        pos += 1
        if b0 & 0x40:  # T=1: RAPID
            rapids.append(b0 & 0x3F)
        else:
            backoff = b0 & 0x0F
        if not (b0 & 0x80):
            break
    grants = []
    for rapid in rapids:
        v = int.from_bytes(data[pos:pos + 6], "big")
        pos += 6
        grants.append(RarGrant(
            rapid=rapid, ta=(v >> 36) & 0x7FF, ul_grant=(v >> 16) & 0xFFFFF,
            temp_crnti=v & 0xFFFF,
        ))
    return backoff, grants
