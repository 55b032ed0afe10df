"""NR MAC PDU packing/unpacking (TS 38.321 §6.1).

Counterpart of the reference's NR MAC PDU lib (`lib/src/mac/
mac_sch_pdu_nr.cc`, `mac_rar_pdu_nr.cc`): subPDUs with R|F|LCID(6) +
8/16-bit L field, MAC CEs, DL padding subheader, and the RAR subPDU
(E|T|RAPID + 7-byte payload: TA, UL grant, TC-RNTI).

Unlike LTE (header block first, payloads after), NR subPDU headers are
inline with their payloads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

LCID_CCCH = 0
LCID_PADDING = 63
LCID_CON_RES = 62       # DL: UE Contention Resolution Identity CE
LCID_TA_CMD = 61        # DL: Timing Advance Command CE
LCID_C_RNTI = 58        # UL: C-RNTI CE
LCID_SHORT_BSR = 61     # UL
LCID_LONG_BSR = 62      # UL

_CE_SIZES_DL = {LCID_CON_RES: 6, LCID_TA_CMD: 1}
_CE_SIZES_UL = {LCID_C_RNTI: 2, LCID_SHORT_BSR: 1, LCID_LONG_BSR: 3}


@dataclass
class NrSubPdu:
    lcid: int
    payload: bytes = b""
    is_sdu: bool = True


@dataclass
class NrMacPdu:
    subpdus: list[NrSubPdu] = field(default_factory=list)

    def add_sdu(self, lcid: int, payload: bytes) -> None:
        assert 0 <= lcid <= 32
        self.subpdus.append(NrSubPdu(lcid, payload, is_sdu=True))

    def add_ce(self, lcid: int, payload: bytes = b"") -> None:
        self.subpdus.append(NrSubPdu(lcid, payload, is_sdu=False))


def pack(pdu: NrMacPdu, pdu_len: int, ul: bool = False) -> bytes:
    out = bytearray()
    for s in pdu.subpdus:
        if s.is_sdu:
            n = len(s.payload)
            if n < 256:
                out += bytes([s.lcid & 0x3F, n])           # F=0, 8-bit L
            else:
                out += bytes([0x40 | (s.lcid & 0x3F),
                              n >> 8, n & 0xFF])           # F=1, 16-bit L
        else:
            out += bytes([s.lcid & 0x3F])                  # fixed-size CE
        out += s.payload
    if len(out) > pdu_len:
        raise ValueError(f"PDU overflow: {len(out)} > {pdu_len}")
    if len(out) < pdu_len:
        out += bytes([LCID_PADDING])
        out += b"\x00" * (pdu_len - len(out))
    return bytes(out)


def unpack(data: bytes, ul: bool = False) -> NrMacPdu:
    ce_sizes = _CE_SIZES_UL if ul else _CE_SIZES_DL
    pdu = NrMacPdu()
    pos = 0
    while pos < len(data):
        b0 = data[pos]
        lcid = b0 & 0x3F
        f = bool(b0 & 0x40)
        pos += 1
        if lcid == LCID_PADDING:
            break
        if lcid <= 32:  # SDU with L field
            if f:
                n = (data[pos] << 8) | data[pos + 1]
                pos += 2
            else:
                n = data[pos]
                pos += 1
            pdu.subpdus.append(NrSubPdu(lcid, bytes(data[pos:pos + n]),
                                        is_sdu=True))
            pos += n
        else:           # fixed-size CE
            n = ce_sizes.get(lcid, 0)
            pdu.subpdus.append(NrSubPdu(lcid, bytes(data[pos:pos + n]),
                                        is_sdu=False))
            pos += n
    return pdu


# --------------------------------------------------------------------------
# RAR (38.321 6.1.5 / 6.2.3)


@dataclass
class NrRarGrant:
    rapid: int
    ta: int = 0            # 12 bits
    ul_grant: int = 0      # 27 bits
    tc_rnti: int = 0


def pack_rar(grants: list[NrRarGrant]) -> bytes:
    out = bytearray()
    for i, g in enumerate(grants):
        e = 0x80 if i < len(grants) - 1 else 0
        out.append(e | 0x40 | (g.rapid & 0x3F))     # E|T=1|RAPID
        v = (g.ta << 43) | (g.ul_grant << 16) | g.tc_rnti
        out += v.to_bytes(7, "big")
    return bytes(out)


def unpack_rar(data: bytes) -> list[NrRarGrant]:
    out = []
    pos = 0
    while pos < len(data):
        b0 = data[pos]
        pos += 1
        if not (b0 & 0x40):   # T=0: backoff subheader, skip payload-less
            if not (b0 & 0x80):
                break
            continue
        v = int.from_bytes(data[pos:pos + 7], "big")
        pos += 7
        out.append(NrRarGrant(rapid=b0 & 0x3F, ta=(v >> 43) & 0xFFF,
                              ul_grant=(v >> 16) & 0x7FFFFFF,
                              tc_rnti=v & 0xFFFF))
        if not (b0 & 0x80):
            break
    return out
