"""UE RRC: connection establishment, security, reconfiguration, RLF.

Counterpart of `srsue/src/stack/rrc/rrc.cc` + the 13 proc_t procedures
(`srsue/hdr/stack/rrc/rrc_procedures.h:38-342`): connection request /
setup / reconfiguration, security mode, UL/DL information transfer,
connection release, radio-link-failure handling (N310/N311 counters +
T310/T311 timers, `rrc.cc:147,488-496`) with an RLF-injection hook
(`rrc.cc:44,215` simulate_rlf), and reestablishment.

Bearer plumbing: SRB0 rides CCCH (no PDCP); SRB1/SRB2 and DRBs are
PDCP entities keyed after the security mode command (keys derived
from K_eNB per 33.401).  `tx(lcid, pdu)` sends toward RLC/MAC.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from . import rrc_msgs as R
from . import security
from .nas_ue import NasUe
from .pdcp import PdcpConfig, PdcpEntity

RRC_IDLE = "IDLE"
RRC_CONNECTING = "CONNECTING"
RRC_CONNECTED = "CONNECTED"
RRC_REESTABLISHING = "REESTABLISHING"

SRB0_LCID = 0
SRB1_LCID = 1
SRB2_LCID = 2


@dataclass
class RlfConfig:
    n310: int = 1
    n311: int = 1
    t310_ms: int = 1000
    t311_ms: int = 1000


class RrcUe:
    def __init__(self, nas: NasUe | None = None,
                 tx: Callable[[int, bytes], None] | None = None,
                 rlf_cfg: RlfConfig | None = None,
                 phys_cell_id: int = 1) -> None:
        self.nas = nas or NasUe()
        self.tx = tx or (lambda lcid, pdu: None)
        self.state = RRC_IDLE
        self.c_rnti = 0
        self.phys_cell_id = phys_cell_id
        self.pdcp: dict[int, PdcpEntity] = {}
        self.drb_lcids: list[int] = []
        self.drb_pdcp: dict[int, PdcpEntity] = {}   # by lcid
        self.k_rrc_int: Optional[bytes] = None
        self.k_rrc_enc: Optional[bytes] = None
        self.k_up_enc: Optional[bytes] = None
        self.nh: Optional[bytes] = None  # {NH, NCC} pair (33.401 7.2.8)
        self.ncc = 0
        # RLF machinery
        self.rlf = rlf_cfg or RlfConfig()
        self.n310_count = 0
        self.n311_count = 0
        self.t310 = -1  # -1 = stopped
        self.t311 = -1
        self.t300 = -1
        self.t300_ms = 1000
        self.simulate_rlf = False  # console-style injection hook
        self.events: list[str] = []
        # idle-mode procedures (SI acquisition, cell selection/reselection)
        from .rrc_idle import IdleProcs
        from .rrc_meas import MeasEngine
        self.idle = IdleProcs()
        self.meas = MeasEngine()

    # -- connection establishment (connection_request_proc) ----------------

    def connect(self, cause: int = 4) -> None:  # mo-Data (36.331 enum)
        """Send RRCConnectionRequest on SRB0/CCCH; starts T300.

        When the UE camps on a cell (idle.serving_pci set), system
        information must have been acquired first (si_acquire_proc runs
        before connection_request_proc, rrc_procedures.h:181)."""
        if self.idle.serving_pci is not None and not self.idle.si_acquired():
            self.events.append("conn_request_blocked_no_si")
            return
        self.state = RRC_CONNECTING
        self.t300 = 0
        msg = R.RrcConnectionRequest(ue_identity=0xDEADBEEF42 & ((1 << 40) - 1),
                                     establishment_cause=cause)
        self.events.append("conn_request")
        self.tx(SRB0_LCID, msg.pack())

    # -- inbound -----------------------------------------------------------

    def rx_ccch(self, pdu: bytes) -> None:
        msg = R.unpack_dl_ccch(pdu)
        if isinstance(msg, R.RrcConnectionReestablishment):
            # 36.331 5.3.7.5: back to CONNECTED with the existing keys;
            # SRB1 PDCP is re-established (COUNTs continue in this model).
            # The new C-RNTI is NOT in the message — the MAC provided it
            # at the reestablishment RACH (temp C-RNTI promotion).
            self.c_rnti = msg.rnti or self.c_rnti
            self.state = RRC_CONNECTED
            self.t311 = -1
            self.n310_count = 0
            self.events.append("reestablished")
            return
        if isinstance(msg, R.RrcConnectionReestablishmentReject):
            self.state = RRC_IDLE
            self.t311 = -1
            self.events.append("reest_reject_to_idle")
            return
        if isinstance(msg, R.RrcConnectionSetup):
            # C-RNTI comes from the MAC RAR (36.321), not the message
            self.c_rnti = msg.rnti or self.c_rnti
            self.t300 = -1
            self.state = RRC_CONNECTED
            self.pdcp[SRB1_LCID] = PdcpEntity(
                PdcpConfig(is_control=True, bearer_id=SRB1_LCID))
            self.events.append("conn_setup")
            nas_pdu = self.nas.start_attach()
            rsp = R.RrcConnectionSetupComplete(nas_pdu=nas_pdu)
            self._tx_dcch(SRB1_LCID, rsp.pack())
        elif isinstance(msg, R.RrcConnectionReject):
            self.t300 = -1
            self.state = RRC_IDLE
            self.events.append("conn_reject")

    def rx_dcch(self, lcid: int, pdcp_pdu: bytes) -> None:
        ent = self.pdcp.get(lcid)
        if ent is None:
            return
        n0 = len(ent.delivered)
        ent.write_pdu(pdcp_pdu, direction=1)
        for sdu in ent.delivered[n0:]:
            self._handle_dcch(sdu)

    def _tx_dcch(self, lcid: int, rrc_pdu: bytes) -> None:
        ent = self.pdcp[lcid]
        self.tx(lcid, ent.write_sdu(rrc_pdu, direction=0))

    def _handle_dcch(self, pdu: bytes) -> None:
        msg = R.unpack_dl_dcch(pdu)
        if isinstance(msg, R.SecurityModeCommandRrc):
            k_enb = self.nas.get_k_enb()
            self.k_rrc_int = security.k_rrc_up(k_enb, msg.integ_alg, "rrc_int")
            self.k_rrc_enc = security.k_rrc_up(k_enb, msg.ciph_alg, "rrc_enc")
            self.k_up_enc = security.k_rrc_up(k_enb, msg.ciph_alg, "up_enc")
            # SecurityModeComplete goes integrity-protected only; ciphering
            # starts after this message (36.331 5.3.4.3)
            rsp = R.SecurityModeCompleteRrc()
            srb1 = self.pdcp[SRB1_LCID]
            srb1.cfg.integrity_key = self.k_rrc_int
            self._tx_dcch(SRB1_LCID, rsp.pack())
            srb1.cfg.cipher_key = self.k_rrc_enc
            self.events.append("security_activated")
        elif isinstance(msg, R.RrcConnectionReconfiguration):
            rekeyed = False
            if msg.mobility is not None:
                # handover command (36.331 5.3.5.4): retune to the target
                # cell, apply the new C-RNTI, T304 guards the RA there
                self.phys_cell_id = msg.mobility.target_pci
                self.c_rnti = msg.mobility.new_c_rnti
                if msg.mobility.ncc > self.ncc:
                    self._vertical_rekey(msg.mobility.ncc,
                                         msg.mobility.target_pci)
                    rekeyed = True
                self.events.append(
                    f"ho_to_pci{msg.mobility.target_pci}")
            for drb in msg.drbs:
                old = self.drb_pdcp.get(drb.lcid)
                ent = PdcpEntity(PdcpConfig(
                    is_control=False, bearer_id=drb.drb_id + 2,
                    cipher_key=self.k_up_enc))
                if rekeyed and old is not None:
                    # handover: COUNTs continue under the new key
                    ent.set_counts(old.tx_count, old.next_rx_count)
                else:
                    self.events.append(f"drb{drb.drb_id}_setup")
                if drb.lcid not in self.drb_lcids:
                    self.drb_lcids.append(drb.lcid)
                self.drb_pdcp[drb.lcid] = ent
            if msg.nr_scg:
                self._apply_nr_scg(msg.nr_scg, msg.sk_counter)
            if msg.nas_pdu:
                for ul in self.nas.rx(msg.nas_pdu):
                    self.send_ul_info_transfer(ul)
            self._tx_dcch(SRB1_LCID,
                          R.RrcConnectionReconfigurationComplete().pack())
        elif isinstance(msg, R.DlInformationTransfer):
            for ul in self.nas.rx(msg.nas_pdu):
                self.send_ul_info_transfer(ul)
        elif isinstance(msg, R.RrcConnectionRelease):
            self.state = RRC_IDLE
            self.events.append("released")

    def _apply_nr_scg(self, blob: bytes, sk_counter: int) -> None:
        """EN-DC secondary cell group (36.331 5.3.5.3 + rrc_nr
        RRCReconfiguration applied by the NSA UE): derive S-KgNB from the
        current K_eNB and the sk-Counter (33.401 A.15), bring up the SCG
        DRB's PDCP-NR under the NR user-plane key."""
        from srsran_4g_tpu_torch.stack.asn1 import BitReader
        from srsran_4g_tpu_torch.stack.pdcp_nr import PdcpNrConfig, PdcpNrEntity
        r = BitReader(blob)
        self.nr_rnti = r.get(16)
        self.nr_lcid = r.get(5)
        s_kgnb = security.s_kgnb(self.nas.get_k_enb(), sk_counter)
        k_up = security.k_rrc_up(s_kgnb, 2, "up_enc")
        self.scg_pdcp = PdcpNrEntity(PdcpNrConfig(
            bearer_id=5, sn_len=18, cipher_key=k_up))
        self.events.append(f"endc_scg nr_rnti={self.nr_rnti:#x}")

    def write_scg_sdu(self, sdu: bytes) -> bytes:
        """Cipher one IP packet onto the NR leg (SCG bearer)."""
        return self.scg_pdcp.write_sdu(sdu, direction=0)

    def rx_scg_pdu(self, pdu: bytes) -> list[bytes]:
        n0 = len(self.scg_pdcp.delivered)
        self.scg_pdcp.write_pdu(pdu, direction=1)
        return self.scg_pdcp.delivered[n0:]

    def _vertical_rekey(self, ncc: int, target_pci: int) -> None:
        """S1 handover key change (33.401 7.2.8.4): step the NH chain up
        to the commanded NCC, bind K_eNB* to the target cell, re-derive
        the AS keys, and restart SRB1 PDCP under them — the
        ReconfigurationComplete goes to the TARGET with the new keys."""
        k_asme = self.nas.usim.get_k_asme()
        nh = self.nh if self.nh is not None else self.nas.get_k_enb()
        for _ in range(ncc - self.ncc):
            nh = security.nh(k_asme, nh)
        self.nh, self.ncc = nh, ncc
        k_enb = security.k_enb_star(nh, target_pci)
        self.k_rrc_int = security.k_rrc_up(k_enb, 2, "rrc_int")
        self.k_rrc_enc = security.k_rrc_up(k_enb, 2, "rrc_enc")
        self.k_up_enc = security.k_rrc_up(k_enb, 2, "up_enc")
        self.pdcp[SRB1_LCID] = PdcpEntity(PdcpConfig(
            is_control=True, bearer_id=SRB1_LCID,
            integrity_key=self.k_rrc_int, cipher_key=self.k_rrc_enc))
        self.events.append(f"rekey ncc={ncc}")

    def rx_pcch(self, pdu: bytes) -> bool:
        """Paging reception (36.331 5.3.2): True if we were paged."""
        page = R.Paging.unpack(pdu)
        if self.nas.guti_mtmsi and self.nas.guti_mtmsi in page.tmsis:
            self.events.append("paged")
            return True
        if page.system_info_modification:
            self.events.append("si_modification")
            self.idle.si_modification()
        return False

    def rx_bcch(self, payload: bytes, pci: int | None = None) -> None:
        """BCCH-DL-SCH system information for the (serving) cell."""
        pci = self.phys_cell_id if pci is None else pci
        self.idle.rx_bcch_dlsch(pci, payload)

    def meas_tick(self, serving_dbm: float, neighbours: dict[int, float],
                  dt_ms: int = 1) -> list[dict]:
        """Run the A1–A5 engine; fire MeasurementReports on triggers."""
        fired = self.meas.tick(serving_dbm, neighbours, dt_ms)
        if self.state == RRC_CONNECTED:
            for rep in fired:
                pci = rep["pci"] if rep["pci"] >= 0 else self.phys_cell_id
                rsrp = rep["rsrp_dbm"] if rep["rsrp_dbm"] is not None \
                    else rep["serving_dbm"]
                self.send_meas_report(rsrp, -10.0, pci)
        return fired

    def send_ul_info_transfer(self, nas_pdu: bytes) -> None:
        self._tx_dcch(SRB1_LCID, R.UlInformationTransfer(nas_pdu=nas_pdu).pack())

    def send_meas_report(self, rsrp_dbm: float, rsrq_db: float,
                         pci: int, is_nr: bool = False) -> None:
        """A3-style measurement report (rrc_meas.cc value mapping);
        is_nr marks a B1 inter-RAT NR report (EN-DC trigger)."""
        rsrp_idx = max(0, min(97, int(rsrp_dbm + 141)))
        rsrq_idx = max(0, min(34, int(2 * (rsrq_db + 20))))
        self._tx_dcch(SRB1_LCID, R.MeasReport(
            rsrp=rsrp_idx, rsrq=rsrq_idx, pci=pci, is_nr=is_nr).pack())

    # -- user plane --------------------------------------------------------

    def write_drb_sdu(self, lcid: int, sdu: bytes) -> None:
        ent = self.drb_pdcp[lcid]
        self.tx(lcid, ent.write_sdu(sdu, direction=0))

    def rx_drb_pdu(self, lcid: int, pdu: bytes) -> list[bytes]:
        ent = self.drb_pdcp[lcid]
        n0 = len(ent.delivered)
        ent.write_pdu(pdu, direction=1)
        return ent.delivered[n0:]

    # -- radio link failure (rrc.cc:488-496) -------------------------------

    def out_of_sync(self) -> None:
        """PHY indicates out-of-sync; N310 consecutive -> start T310."""
        if self.state != RRC_CONNECTED:
            return
        self.n310_count += 1
        if self.n310_count >= self.rlf.n310 and self.t310 < 0:
            self.t310 = 0
            self.events.append("t310_start")

    def in_sync(self) -> None:
        if self.t310 >= 0:
            self.n311_count += 1
            if self.n311_count >= self.rlf.n311:
                self.t310 = -1
                self.n310_count = 0
                self.n311_count = 0
                self.events.append("t310_stop")

    def tick(self, ms: int = 1) -> None:
        if self.simulate_rlf:
            self.simulate_rlf = False
            self.events.append("rlf_injected")
            self._radio_link_failure()
        if self.t300 >= 0:
            self.t300 += ms
            if self.t300 > self.t300_ms:
                self.t300 = -1
                self.state = RRC_IDLE
                self.events.append("t300_expiry")
        if self.t310 >= 0:
            self.t310 += ms
            if self.t310 > self.rlf.t310_ms:
                self.t310 = -1
                self._radio_link_failure()
        if self.t311 >= 0:
            self.t311 += ms
            if self.t311 > self.rlf.t311_ms:
                self.t311 = -1
                self.state = RRC_IDLE
                self.events.append("t311_expiry_to_idle")

    def _radio_link_failure(self) -> None:
        """T310 expiry -> connection reestablishment (36.331 5.3.7)."""
        self.events.append("rlf")
        self.state = RRC_REESTABLISHING
        self.t311 = 0
        req = R.RrcConnectionReestablishmentRequest(
            c_rnti=self.c_rnti, phys_cell_id=self.phys_cell_id, cause=2)
        self.tx(SRB0_LCID, req.pack())
