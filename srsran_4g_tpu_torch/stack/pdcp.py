"""PDCP entity (LTE), TS 36.323.

Counterpart of the reference's `lib/src/pdcp/pdcp_entity_lte.cc`: data-plane
(DRB, 12-bit SN) and control-plane (SRB, 5-bit SN) PDU formats, COUNT
maintenance with hyper-frame numbers, ciphering and
integrity hooks with 33.401 algorithm-id dispatch (EEA0-3/EIA1-3), duplicate/reorder handling for RLC UM
delivery, per-SDU discard timers (pdcp_entity_lte.h:91), and status
reports (pdcp_entity_lte.h:145, TS 36.323 §5.3.1): FMS + received-SN
bitmap control PDUs exchanged at re-establishment of AM DRBs, with the
TX side discarding acknowledged SDUs on reception.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from srsran_4g_tpu_torch.stack import security

SN_LEN_SRB = 5
SN_LEN_DRB = 12


@dataclass
class PdcpConfig:
    is_control: bool = False  # SRB (5-bit SN + MAC-I) vs DRB (12-bit SN)
    bearer_id: int = 1
    discard_timer_ms: int = 0  # 0 = off
    cipher_key: bytes | None = None
    integrity_key: bytes | None = None
    cipher_algo: int = 2     # 33.401 EEA id: 0=null, 1=SNOW3G, 2=AES, 3=ZUC
    integrity_algo: int = 2  # EIA id: 1=SNOW3G, 2=AES, 3=ZUC


class PdcpEntity:
    def __init__(self, cfg: PdcpConfig):
        self.cfg = cfg
        self.sn_len = SN_LEN_SRB if cfg.is_control else SN_LEN_DRB
        self.sn_mod = 1 << self.sn_len
        self.tx_count = 0
        self.rx_hfn = 0
        self.next_rx_sn = 0
        self.delivered: list[bytes] = []
        self.integrity_failures = 0
        self._discard: dict[int, int] = {}  # count -> remaining ms
        self._rx_counts: set[int] = set()   # received counts >= _rx_base
        self._rx_base = 0                   # all counts below are received

    @property
    def next_rx_count(self) -> int:
        """Next in-sequence COUNT expected from the peer (= FMS count)."""
        return self._rx_base

    def set_counts(self, tx_count: int, rx_next: int) -> None:
        """Continue COUNTs across handover (36.323 §5.2 re-establishment
        for AM DRBs; fed by the S1AP eNB/MME Status Transfer)."""
        self.tx_count = tx_count
        self._rx_base = rx_next
        self._rx_counts.clear()
        self.rx_hfn = rx_next // self.sn_mod
        self.next_rx_sn = rx_next % self.sn_mod

    # --- TX ---------------------------------------------------------------

    def _header(self, sn: int) -> bytes:
        if self.cfg.is_control:
            return bytes([sn & 0x1F])
        return bytes([0x80 | (sn >> 8), sn & 0xFF])  # D/C=1 data

    def write_sdu(self, sdu: bytes, direction: int = 0) -> bytes:
        count = self.tx_count
        sn = count % self.sn_mod
        self.tx_count += 1
        payload = sdu
        mac = b""
        if self.cfg.is_control and self.cfg.integrity_key:
            mac = security.integrity(self.cfg.integrity_algo,
                                     self.cfg.integrity_key, count,
                                     self.cfg.bearer_id - 1, direction,
                                     self._header(sn) + sdu)
        if self.cfg.cipher_key:
            payload = security.cipher(self.cfg.cipher_algo,
                                      self.cfg.cipher_key, count,
                                      self.cfg.bearer_id - 1, direction,
                                      sdu + mac)
        else:
            payload = sdu + mac
        if self.cfg.discard_timer_ms:
            self._discard[count] = self.cfg.discard_timer_ms
        return self._header(sn) + payload

    # --- RX ---------------------------------------------------------------

    def write_pdu(self, pdu: bytes, direction: int = 1) -> None:
        if self.cfg.is_control:
            sn = pdu[0] & 0x1F
            body = pdu[1:]
        else:
            sn = ((pdu[0] & 0x0F) << 8) | pdu[1]
            body = pdu[2:]
        # COUNT reconstruction with HFN window (36.323 §5.1.2.1.2)
        if sn < self.next_rx_sn - self.sn_mod // 2:
            hfn = self.rx_hfn + 1
        elif sn > self.next_rx_sn + self.sn_mod // 2:
            hfn = self.rx_hfn - 1
        else:
            hfn = self.rx_hfn
        count = hfn * self.sn_mod + sn

        if self.cfg.cipher_key:
            body = security.cipher(self.cfg.cipher_algo,
                                   self.cfg.cipher_key, count,
                                   self.cfg.bearer_id - 1, direction, body)
        if self.cfg.is_control and self.cfg.integrity_key:
            sdu, mac = body[:-4], body[-4:]
            expect = security.integrity(self.cfg.integrity_algo,
                                        self.cfg.integrity_key, count,
                                        self.cfg.bearer_id - 1, direction,
                                        pdu[:1] + sdu)
            if mac != expect:
                self.integrity_failures += 1
                return
        else:
            sdu = body
        if sn >= self.next_rx_sn or hfn > self.rx_hfn:
            self.next_rx_sn = (sn + 1) % self.sn_mod
            if sn + 1 >= self.sn_mod:
                self.rx_hfn = hfn + 1
            else:
                self.rx_hfn = hfn
        if count >= self._rx_base:
            self._rx_counts.add(count)
            while self._rx_base in self._rx_counts:
                self._rx_counts.discard(self._rx_base)
                self._rx_base += 1
        self.delivered.append(sdu)

    # --- status report (TS 36.323 §5.3.1 / §6.2.6) --------------------------

    def status_report(self) -> bytes:
        """Control PDU: D/C=0, type=0, FMS (first missing SN, 12 bit) +
        bitmap of received SNs after FMS (bit 1 = received)."""
        fms_count = self._rx_base
        fms = fms_count % self.sn_mod
        top = max(self._rx_counts, default=fms_count)
        nbits = max(0, top - fms_count)
        bits = [1 if (fms_count + 1 + i) in self._rx_counts else 0
                for i in range(nbits)]
        out = bytearray([fms >> 8, fms & 0xFF])  # D/C=0, type=000
        for i in range(0, len(bits), 8):
            byte = 0
            for j, b in enumerate(bits[i:i + 8]):
                byte |= b << (7 - j)
            out.append(byte)
        return bytes(out)

    def handle_status_report(self, pdu: bytes) -> list[int]:
        """TX side: discard acknowledged SDUs (cancel discard timers).
        Returns the acknowledged COUNT offsets relative to FMS semantics:
        counts < FMS plus bitmap-1 positions."""
        assert not (pdu[0] & 0x80) and ((pdu[0] >> 4) & 0x7) == 0
        fms = ((pdu[0] & 0x0F) << 8) | pdu[1]
        # reconstruct the FMS count against our TX counter window
        hfn = (self.tx_count // self.sn_mod)
        cand = [h * self.sn_mod + fms for h in (hfn - 1, hfn, hfn + 1)
                if h >= 0]
        fms_count = min(cand, key=lambda c: abs(c - self.tx_count))
        acked = [c for c in list(self._discard) if c < fms_count]
        pos = 0
        for byte_i in range(2, len(pdu)):
            for j in range(8):
                if (pdu[byte_i] >> (7 - j)) & 1:
                    acked.append(fms_count + 1 + pos)
                pos += 1
        for c in acked:
            self._discard.pop(c, None)
        return sorted(set(acked))

    # --- timers -----------------------------------------------------------

    def tick(self, ms: int = 1) -> list[int]:
        """Advance discard timers; returns COUNTs discarded this tick."""
        dead = []
        for count in list(self._discard):
            self._discard[count] -= ms
            if self._discard[count] <= 0:
                dead.append(count)
                del self._discard[count]
        return dead
