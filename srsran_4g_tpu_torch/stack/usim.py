"""Soft USIM: Milenage AKA + key hierarchy.

Counterpart of `srsue/src/stack/upper/usim.cc` (soft USIM with
Milenage/XOR AKA, AUTN verification, K_ASME derivation).  PCSC
hardware SIMs are excluded (hardware interface).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import security


@dataclass
class UsimConfig:
    imsi: str = "001010123456789"
    imei: str = "353490069873319"
    k: bytes = bytes.fromhex("00112233445566778899aabbccddeeff")
    opc: bytes = bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d")
    mcc: int = 1
    mnc: int = 1


class Usim:
    def __init__(self, cfg: UsimConfig | None = None) -> None:
        self.cfg = cfg or UsimConfig()
        self.sqn_he = 0
        self.k_asme: bytes | None = None

    @property
    def imsi(self) -> str:
        return self.cfg.imsi

    def plmn_bytes(self) -> bytes:
        """MCC/MNC as the 3-byte BCD PLMN used in KDF S1 input."""
        mcc, mnc = self.cfg.mcc, self.cfg.mnc
        d = [mcc // 100, (mcc // 10) % 10, mcc % 10,
             0xF, (mnc // 10) % 10, mnc % 10]
        return bytes([(d[1] << 4) | d[0], (d[3] << 4) | d[2],
                      (d[5] << 4) | d[4]])

    def generate_authentication_response(
            self, rand: bytes, autn: bytes) -> tuple[str, bytes]:
        """AKA per 33.102: verify AUTN (MAC + SQN freshness); returns
        ("ok", RES) | ("mac_failure", b"") | ("synch_failure", AUTS)."""
        mac_a, res, ck, ik, ak = security.milenage(
            self.cfg.k, self.cfg.opc, rand, b"\x00" * 6, b"\x80\x00")
        sqn_xor_ak = autn[:6]
        amf = autn[6:8]
        mac_rx = autn[8:16]
        sqn = bytes(a ^ b for a, b in zip(sqn_xor_ak, ak))
        # recompute MAC with the real SQN/AMF
        mac_a, res, ck, ik, ak = security.milenage(
            self.cfg.k, self.cfg.opc, rand, sqn, amf)
        if mac_a != mac_rx:
            return "mac_failure", b""
        sqn_i = int.from_bytes(sqn, "big")
        if sqn_i <= self.sqn_he:
            # synch failure: AUTS = SQNms^AK* || MAC-S (simplified MAC-S)
            auts = bytes(a ^ b for a, b in zip(
                self.sqn_he.to_bytes(6, "big"), ak)) + mac_a
            return "synch_failure", auts
        self.sqn_he = sqn_i
        self.k_asme = security.k_asme(ck, ik, self.plmn_bytes(), sqn_xor_ak)
        return "ok", res

    def get_k_asme(self) -> bytes:
        assert self.k_asme is not None, "run AKA first"
        return self.k_asme
