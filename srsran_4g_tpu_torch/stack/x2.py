"""X2 adapter + EN-DC (NSA) setup: eNB <-> gNB SgNB addition.

Counterpart of the reference's in-process `x2_adapter` (`srsenb/src/
enb.cc:86`) and the EN-DC procedure (`srsenb/src/stack/rrc/rrc_endc.cc`):
the LTE eNB anchors the control plane and adds an NR secondary cell
group over X2 — SgNB Addition Request (UE capabilities + E-RAB to
offload) / Addition Request Acknowledge (NR RRC config blob + N3/S1-U
TEID), then the LTE RRCConnectionReconfiguration carries the
nr-SecondaryCellGroup to the UE.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from .asn1 import BitReader, BitWriter, pack_varlen_bytes, unpack_varlen_bytes


@dataclass
class SgnbAdditionRequest:
    enb_ue_x2_id: int = 0
    erab_id: int = 5
    spgw_teid: int = 0
    s_kgnb: bytes = b""  # 33.401 E.2.4: MeNB-derived S-KgNB in the request

    def pack(self) -> bytes:
        w = BitWriter()
        w.put(self.enb_ue_x2_id, 16)
        w.put(self.erab_id, 4)
        w.put(self.spgw_teid, 32)
        pack_varlen_bytes(w, self.s_kgnb)
        return w.to_bytes()

    @classmethod
    def unpack(cls, d: bytes) -> "SgnbAdditionRequest":
        r = BitReader(d)
        return cls(enb_ue_x2_id=r.get(16), erab_id=r.get(4),
                   spgw_teid=r.get(32), s_kgnb=unpack_varlen_bytes(r))


@dataclass
class SgnbAdditionAck:
    enb_ue_x2_id: int = 0
    gnb_ue_x2_id: int = 0
    nr_rnti: int = 0
    gnb_teid: int = 0
    nr_config: bytes = b""   # nr-SecondaryCellGroup blob for the UE

    def pack(self) -> bytes:
        w = BitWriter()
        w.put(self.enb_ue_x2_id, 16)
        w.put(self.gnb_ue_x2_id, 16)
        w.put(self.nr_rnti, 16)
        w.put(self.gnb_teid, 32)
        pack_varlen_bytes(w, self.nr_config)
        return w.to_bytes()

    @classmethod
    def unpack(cls, d: bytes) -> "SgnbAdditionAck":
        r = BitReader(d)
        return cls(enb_ue_x2_id=r.get(16), gnb_ue_x2_id=r.get(16),
                   nr_rnti=r.get(16), gnb_teid=r.get(32),
                   nr_config=unpack_varlen_bytes(r))


class GnbEndcTerm:
    """gNB-side EN-DC termination: allocates the NR leg on request."""

    def __init__(self) -> None:
        self.next_rnti = 0x4601
        self.next_x2_id = 1
        self.next_teid = 0x3000
        self.ues: dict[int, dict] = {}
        self.events: list[str] = []

    def sgnb_addition(self, req: SgnbAdditionRequest) -> SgnbAdditionAck:
        rnti = self.next_rnti
        self.next_rnti += 1
        x2_id = self.next_x2_id
        self.next_x2_id += 1
        teid = self.next_teid
        self.next_teid += 1
        self.ues[x2_id] = dict(nr_rnti=rnti, erab_id=req.erab_id,
                               spgw_teid=req.spgw_teid, state="ADDED",
                               s_kgnb=req.s_kgnb)
        if req.s_kgnb:
            # SCG bearer PDCP-NR terminates at the gNB under K_UPenc
            # derived from S-KgNB (33.501-style, shared KDF family)
            from srsran_4g_tpu_torch.stack import security
            from srsran_4g_tpu_torch.stack.pdcp_nr import PdcpNrConfig, PdcpNrEntity
            k_up = security.k_rrc_up(req.s_kgnb, 2, "up_enc")
            self.ues[x2_id]["pdcp"] = PdcpNrEntity(PdcpNrConfig(
                bearer_id=req.erab_id, sn_len=18, cipher_key=k_up))
        self.events.append(f"sgnb_add x2={x2_id} rnti={rnti:#x}")
        # the NR config blob the UE's RRC-NR applies (opaque to LTE RRC)
        w = BitWriter()
        w.put(rnti, 16)
        w.put(4, 5)   # NR DRB lcid
        cfg = w.to_bytes()
        return SgnbAdditionAck(enb_ue_x2_id=req.enb_ue_x2_id,
                               gnb_ue_x2_id=x2_id, nr_rnti=rnti,
                               gnb_teid=teid, nr_config=cfg)

    def sgnb_release(self, x2_id: int) -> None:
        if x2_id in self.ues:
            self.ues[x2_id]["state"] = "RELEASED"
            self.events.append(f"sgnb_release x2={x2_id}")


class X2Adapter:
    """In-process X2: routes eNB requests to the gNB term (enb.cc:86)."""

    def __init__(self, gnb: GnbEndcTerm | None = None) -> None:
        self.gnb = gnb or GnbEndcTerm()
        self.events: list[str] = []

    def sgnb_addition_request(self, raw: bytes) -> bytes:
        req = SgnbAdditionRequest.unpack(raw)
        ack = self.gnb.sgnb_addition(req)
        self.events.append("addition_routed")
        return ack.pack()


class EnbEndc:
    """eNB-side EN-DC controller (rrc_endc.cc): starts SgNB addition for
    NR-capable UEs and produces the reconfiguration payload."""

    def __init__(self, x2: X2Adapter) -> None:
        self.x2 = x2
        self.next_x2_id = 1
        self.ues: dict[int, dict] = {}   # by enb_ue_x2_id
        self.events: list[str] = []

    def start_endc(self, rnti: int, erab_id: int, spgw_teid: int,
                   s_kgnb: bytes = b"") -> dict:
        """Returns {'nr_config': blob, 'gnb_teid': teid, 'nr_rnti': rnti}
        for the LTE reconfiguration toward the UE + the S1-U switch."""
        x2_id = self.next_x2_id
        self.next_x2_id += 1
        req = SgnbAdditionRequest(enb_ue_x2_id=x2_id, erab_id=erab_id,
                                  spgw_teid=spgw_teid, s_kgnb=s_kgnb)
        ack = SgnbAdditionAck.unpack(self.x2.sgnb_addition_request(req.pack()))
        self.ues[x2_id] = dict(rnti=rnti, gnb_x2_id=ack.gnb_ue_x2_id,
                               nr_rnti=ack.nr_rnti, state="ENDC_ACTIVE")
        self.events.append(f"endc_active rnti={rnti:#x} "
                           f"nr_rnti={ack.nr_rnti:#x}")
        return dict(nr_config=ack.nr_config, gnb_teid=ack.gnb_teid,
                    nr_rnti=ack.nr_rnti)
