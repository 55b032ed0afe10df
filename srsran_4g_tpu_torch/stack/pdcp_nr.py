"""NR PDCP entity (TS 38.323) + SDAP (TS 37.324).

Counterpart of `lib/src/pdcp/pdcp_entity_nr.cc` and
`srsue/src/stack/upper/sdap.cc`: 12/18-bit SN data PDUs with COUNT
reconstruction (RX_DELIV window), optional integrity on DRBs (a 38.323
difference from LTE), ciphering, in-order delivery with t-Reordering,
and the 1-byte SDAP header (QFI, RDI/RQI) on the data plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import security


@dataclass
class PdcpNrConfig:
    is_srb: bool = False
    sn_len: int = 12            # 12 or 18 (SRB always 12)
    bearer_id: int = 1
    cipher_key: Optional[bytes] = None
    integrity_key: Optional[bytes] = None
    integrity_on_drb: bool = False
    t_reordering_ms: int = 100


class PdcpNrEntity:
    def __init__(self, cfg: PdcpNrConfig) -> None:
        self.cfg = cfg
        self.sn_mod = 1 << cfg.sn_len
        self.tx_next = 0
        self.rx_deliv = 0           # COUNT of first not-delivered
        self.rx_next = 0
        self.reorder: dict[int, bytes] = {}
        self.t_reord = -1
        self.delivered: list[bytes] = []
        self.integrity_failures = 0

    def _hdr(self, sn: int) -> bytes:
        if self.cfg.sn_len == 12:
            return bytes([0x80 | ((sn >> 8) & 0xF), sn & 0xFF])
        return bytes([0x80 | ((sn >> 16) & 0x3), (sn >> 8) & 0xFF,
                      sn & 0xFF])

    def _use_integrity(self) -> bool:
        return self.cfg.integrity_key is not None and \
            (self.cfg.is_srb or self.cfg.integrity_on_drb)

    def write_sdu(self, sdu: bytes, direction: int = 0) -> bytes:
        count = self.tx_next
        self.tx_next += 1
        sn = count % self.sn_mod
        hdr = self._hdr(sn)
        mac = b""
        if self._use_integrity():
            mac = security.eia2(self.cfg.integrity_key, count,
                                self.cfg.bearer_id - 1, direction,
                                hdr + sdu)[:4]
        body = sdu + mac
        if self.cfg.cipher_key:
            body = security.eea2(self.cfg.cipher_key, count,
                                 self.cfg.bearer_id - 1, direction, body)
        return hdr + body

    def write_pdu(self, pdu: bytes, direction: int = 1) -> None:
        if self.cfg.sn_len == 12:
            sn = ((pdu[0] & 0xF) << 8) | pdu[1]
            body = pdu[2:]
            hdr = pdu[:2]
        else:
            sn = ((pdu[0] & 0x3) << 16) | (pdu[1] << 8) | pdu[2]
            body = pdu[3:]
            hdr = pdu[:3]
        # COUNT reconstruction around RX_DELIV (38.323 5.2.2.1)
        base = self.rx_deliv
        hfn = base // self.sn_mod
        cand = hfn * self.sn_mod + sn
        if cand < base - self.sn_mod // 2:
            cand += self.sn_mod
        elif cand >= base + self.sn_mod // 2:
            cand -= self.sn_mod
        count = max(cand, 0)
        if self.cfg.cipher_key:
            body = security.eea2(self.cfg.cipher_key, count,
                                 self.cfg.bearer_id - 1, direction, body)
        if self._use_integrity():
            sdu, mac = body[:-4], body[-4:]
            exp = security.eia2(self.cfg.integrity_key, count,
                                self.cfg.bearer_id - 1, direction,
                                hdr + sdu)[:4]
            if mac != exp:
                self.integrity_failures += 1
                return
        else:
            sdu = body
        if count < self.rx_deliv or count in self.reorder:
            return  # duplicate/stale
        self.reorder[count] = sdu
        self.rx_next = max(self.rx_next, count + 1)
        while self.rx_deliv in self.reorder:
            self.delivered.append(self.reorder.pop(self.rx_deliv))
            self.rx_deliv += 1
        if self.reorder and self.t_reord < 0:
            self.t_reord = self.cfg.t_reordering_ms

    def tick(self, ms: int = 1) -> None:
        if self.t_reord > 0:
            self.t_reord -= ms
            if self.t_reord <= 0:
                # flush: deliver all held, advance RX_DELIV (5.2.2.2)
                for c in sorted(self.reorder):
                    self.delivered.append(self.reorder.pop(c))
                self.rx_deliv = self.rx_next
                self.t_reord = -1


# --------------------------------------------------------------------------
# SDAP (37.324): 1-byte DL/UL data header with QFI


def sdap_pack(sdu: bytes, qfi: int, rdi: bool = False,
              rqi: bool = False) -> bytes:
    return bytes([((1 if rdi else 0) << 7) | ((1 if rqi else 0) << 6)
                  | (qfi & 0x3F)]) + sdu


def sdap_unpack(pdu: bytes) -> tuple[bytes, int, bool, bool]:
    b0 = pdu[0]
    return pdu[1:], b0 & 0x3F, bool(b0 & 0x80), bool(b0 & 0x40)
