"""MBMS-GW: M1-U GTP-U multicast user plane for eMBMS.

Counterpart of the reference's `srsepc/src/mbms-gw/` (~0.5 k LoC:
`mbms-gw.cc` + `main.cc`): IP packets arriving on the SGi-mb tunnel
interface are filtered by multicast group, encapsulated in GTP-U with
the configured M1-U TEID, and sent toward the eNB's M1-U endpoint
(reference default: multicast 239.255.0.1:2152, TEID 1).

The eNB side (`EnbMbms`, reference `srsenb` MCH/MBSFN path) receives
M1-U GTP-U, strips the header, and schedules the MTCH SDUs into MCH MAC
PDUs transmitted on PMCH MBSFN subframes (`models/pmch.py`).  The UE
side unpacks the MCH PDU back into multicast IP packets.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from srsran_4g_tpu_torch.stack import gtpu, mac_pdu

M1U_TEID = 1                      # reference mbms-gw default
MTCH_LCID = 1                     # MTCH logical channel on the MCH
MCCH_LCID = 0


def _ip_dst(pkt: bytes) -> bytes:
    """Destination address of an IPv4 packet (bytes 16:20)."""
    return pkt[16:20] if len(pkt) >= 20 else b""


def _is_multicast(addr: bytes) -> bool:
    return len(addr) == 4 and 224 <= addr[0] <= 239


@dataclass
class MbmsService:
    """One MBMS bearer service (mbms-gw.cc service config)."""

    group: bytes                  # multicast group the SGi-mb side joins
    teid: int = M1U_TEID
    lcid: int = MTCH_LCID


class MbmsGw:
    """SGi-mb → GTP-U M1-U encapsulation (mbms-gw.cc run loop)."""

    def __init__(self) -> None:
        self.services: list[MbmsService] = []
        self.m1u_tx: Callable[[bytes], None] = lambda pdu: None
        self.metrics = {"sgi_rx": 0, "m1u_tx": 0, "dropped": 0}

    def add_service(self, group: str, teid: int = M1U_TEID,
                    lcid: int = MTCH_LCID) -> MbmsService:
        svc = MbmsService(group=bytes(int(x) for x in group.split(".")),
                          teid=teid, lcid=lcid)
        self.services.append(svc)
        return svc

    def rx_sgi_mb(self, ip_pkt: bytes) -> None:
        """One IP packet from the SGi-mb tunnel (spgw SGi side or a
        content source); forwarded iff its destination is a joined
        multicast group."""
        self.metrics["sgi_rx"] += 1
        dst = _ip_dst(ip_pkt)
        for svc in self.services:
            if dst == svc.group and _is_multicast(dst):
                self.m1u_tx(gtpu.pack(gtpu.GtpuHeader(teid=svc.teid),
                                      ip_pkt))
                self.metrics["m1u_tx"] += 1
                return
        self.metrics["dropped"] += 1


class EnbMbms:
    """eNB M1-U termination + MCH scheduling onto PMCH subframes."""

    def __init__(self, pdu_bytes: int) -> None:
        self.pdu_bytes = pdu_bytes
        self.queues: dict[int, list[bytes]] = {}   # teid -> pending SDUs
        self.teid_lcid: dict[int, int] = {M1U_TEID: MTCH_LCID}
        self.metrics = {"m1u_rx": 0, "mch_tx": 0}

    def rx_m1u(self, raw: bytes) -> None:
        h, payload = gtpu.unpack(raw)
        self.metrics["m1u_rx"] += 1
        self.queues.setdefault(h.teid, []).append(payload)

    def has_data(self) -> bool:
        return any(q for q in self.queues.values())

    def get_mch_pdu(self) -> Optional[bytes]:
        """Assemble one MCH MAC PDU for the next MBSFN subframe
        (the reference's MCH scheduling inside the MBSFN sf allocation)."""
        pdu = mac_pdu.MacPdu()
        budget = self.pdu_bytes
        for teid, q in self.queues.items():
            lcid = self.teid_lcid.get(teid, MTCH_LCID)
            while q and budget > len(q[0]) + 3:
                sdu = q.pop(0)
                pdu.add_sdu(lcid, sdu)
                budget -= len(sdu) + 3
        if not pdu.subpdus:
            return None
        self.metrics["mch_tx"] += 1
        return mac_pdu.pack(pdu, self.pdu_bytes)


def ue_mch_rx(raw: bytes) -> list[tuple[int, bytes]]:
    """UE-side MCH PDU unpack → [(lcid, multicast IP packet)]."""
    up = mac_pdu.unpack(raw)
    return [(s.lcid, s.payload) for s in up.subpdus if s.is_sdu]
