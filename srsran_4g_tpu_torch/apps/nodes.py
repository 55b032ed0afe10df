"""Deployable node objects: UE / eNB stacks driven one TTI at a time.

The reference's deployable unit is three long-running processes
(`srsue/src/main.cc:724`, `srsenb/src/enb.cc:74`, `srsepc/src/main.cc:384`)
wired by config files and connected over ZMQ IQ streams + SCTP/UDP.  This
module holds the transport-agnostic node logic shared by BOTH deployment
shapes of this framework:

  * single-process TTI-stepped simulation (`tools/run_lte.py`) — the
    in-process analog of the reference E2E, where eNB TX samples feed the
    UE directly and S1AP PDUs are function calls;
  * three OS processes (`apps/srsue.py`, `apps/srsenb.py`,
    `apps/srsepc.py`) — IQ over the native TCP bridge
    (`native/runtime.cc` rt_bridge, sample count = clock, the reference's
    `rf_zmq_imp.c` model), S1AP over TCP with the 3GPP-exact aligned-PER
    encodings (`stack/s1ap_per.py`), GTP-U over UDP.

`UeNode` is the UE's MAC/RRC/NAS/RLC composite; `UePhy` drives one UE's
over-the-air acquisition FSM (srsue sync.cc:684-709) + per-TTI DL blind
decode / UL composition; `EnbNode` is the eNB MAC scheduler + RRC + PHY
subframe assembly/decode (srsenb txrx.cc:89-241 + mac.cc:639 contract).

Port counterpart of ``srsran_4g_tpu/apps/nodes.py``: the same node logic
over the port's ``runtime/lte_air.LteAirPhy``, whose samples, grids and
HARQ soft buffers stay on its device (the TDD acquisition buffer is joined
there with ``torch.cat``).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch


class UeNode:
    """One UE: MAC + RRC/NAS + RLC bearers + PUCCH resources."""

    def __init__(self, idx: int, air, stats: dict, log,
                 tm: int = 1) -> None:
        from srsran_4g_tpu_torch.stack.nas_ue import NasUe
        from srsran_4g_tpu_torch.stack.rlc_am import RlcAm
        from srsran_4g_tpu_torch.stack.rlc_um import RlcTm
        from srsran_4g_tpu_torch.stack.rrc_ue import RrcUe
        from srsran_4g_tpu_torch.stack.ue_mac import LogicalChannel, UeMac
        from srsran_4g_tpu_torch.stack.usim import Usim, UsimConfig

        self.idx = idx
        self.air = air
        self.stats = stats
        self.log = log
        base = UsimConfig()
        imsi = str(int(base.imsi) + idx).zfill(len(base.imsi))
        self.ucfg = replace(base, imsi=imsi)
        self.nas = NasUe(Usim(self.ucfg))
        self.mac = UeMac(contention_id=bytes([0x42] * 5 + [0x40 + idx]))
        import random
        self.mac.ra.rng = random.Random(1000 + idx)  # per-UE preamble draw
        self.rlc = {0: RlcTm(), 1: RlcAm(), 3: RlcAm()}
        self.rrc = RrcUe(nas=self.nas)
        self.rrc.tx = lambda lcid, pdu: self.rlc[lcid].write_sdu(pdu)
        self.crnti = 0
        self.ra_rnti = 0
        # over-the-air acquisition state (srsue sync.cc FSM analog):
        # search (PSS/SSS) -> mib (PBCH) -> camped
        self.sync_state = "search"
        self.acq_pci = -1
        self.sf_off = 0          # tti of the last detected subframe 0
        self.acq_sfn = -1
        self.phich_watch: list[tuple[int, int, int]] = []  # (tti, grp, seq)
        self.last_pusch: dict[int, tuple] = {}   # pid -> (cfg, pdu, rv)
        self.dl_softbufs: dict = {}     # HARQ chase-combining buffers
        from srsran_4g_tpu_torch.stack.ue_mac import DlHarqEntity
        self.scell_harq = DlHarqEntity()   # per-carrier DL HARQ entity
        self.prach_sent = False
        self.last_snr = 0.0
        # 2x2 MIMO: configured TM + last CSI selection (RI/PMI) reported
        # on the periodic PUCCH occasion (precoding.c pmi_select feedback)
        self.tm = tm
        self.last_ri = 1
        self.last_pmi = 1
        self.si_1c = False   # monitor the format-1C length on SI-RNTI
        self.cqi_sent: list[int] = []
        self.pending_ack: list[tuple[int, int, int]] = []   # (tti, n_pucch, bit)
        self.pending_pusch: list[tuple[int, object, bytes]] = []  # (tti, cfg, pdu)
        self.sr_count = 0
        n_cce = air.cch.n_cce
        self.n_pucch_sr = n_cce + 2 + idx
        self.n_pucch_2 = idx

        self.mac.demux.add_rlc(0, self.rrc.rx_ccch)
        for lc in (1, 3):
            self.mac.demux.add_rlc(lc, self._mk_sink(lc))
        for lcid, prio in ((0, 0), (1, 1), (3, 3)):
            self.mac.mux.setup_lcid(self._mk_chan(lcid, prio, LogicalChannel))

    def _mk_sink(self, lc):
        def sink(p):
            ent = self.rlc[lc]
            ent.write_pdu(p)
            q = getattr(ent, "delivered", None)
            if q is None:
                q = getattr(ent, "rx_sdus", [])
            sdus, q[:] = list(q), []
            for sdu in sdus:
                if lc in (1, 2):
                    self.rrc.rx_dcch(lc, sdu)
                else:
                    for ip_pkt in self.rrc.rx_drb_pdu(lc, sdu):
                        self.stats["dl_ping_rx"] += 1
                        self.rrc.write_drb_sdu(lc, b"echo:" + ip_pkt[-8:])
        return sink

    def _mk_chan(self, lcid, prio, LogicalChannel):
        ent = self.rlc[lcid]
        return LogicalChannel(
            lcid=lcid, priority=prio,
            has_data=lambda e=ent: (200 if e.has_data() else 0),
            read_pdu=lambda n, e=ent: e.read_pdu(n))

    def has_ul_data(self) -> bool:
        return any(c.has_data() > 0 for c in self.mac.mux.channels)

    def tick(self) -> None:
        self.mac.tick(1)
        self.rrc.tick(1)
        for ent in self.rlc.values():
            if hasattr(ent, "tick"):
                ent.tick(1)

    # -- DL reception ------------------------------------------------------

    def handle_rar(self, tti: int, pdu: bytes) -> None:
        from srsran_4g_tpu_torch.stack import mac_pdu
        from srsran_4g_tpu_torch.stack.enb_mac import (MSG3_DELAY,
                                                 unpack_rar_ul_grant)

        backoff, grants = mac_pdu.unpack_rar(pdu)
        for g in grants:
            if self.mac.ra.rar_received(g, backoff):
                self.crnti = g.temp_crnti
                # 36.321 temp C-RNTI promotion: RRC learns the identity
                # from MAC — ConnectionSetup does not carry it (36.331)
                self.rrc.c_rnti = g.temp_crnti
                st, ln, mcs, tbs = unpack_rar_ul_grant(
                    self.air.cell.nof_prb, g.ul_grant)
                # FDD: n+4; TDD: the Table 8-2 delay of the RAR subframe
                k = self.air.ul_k(tti) if hasattr(self.air, "ul_k") \
                    else MSG3_DELAY
                k = k if k is not None else MSG3_DELAY
                self._queue_pusch(tti + k, st, ln, mcs, tbs,
                                  pid=(tti + k) % 8, ndi=False,
                                  is_rar=True)

    def _queue_pusch(self, due: int, prb_start: int, prb_len: int, mcs: int,
                     tbs: int, pid: int, ndi: bool, is_rar: bool) -> None:
        from srsran_4g_tpu_torch.runtime.lte_air import _ul_cfg
        from srsran_4g_tpu_torch.stack.ue_mac import UlMacGrant

        g = UlMacGrant(rnti=self.crnti, pid=pid, tbs=tbs // 8, ndi=ndi,
                       is_rar=is_rar)
        out = self.mac.new_grant_ul(g)
        if out["pdu"]:
            if is_rar:
                # 36.321 §5.1.5: the contention-resolution identity is the
                # first 48 bits of the transmitted msg3 CCCH SDU
                from srsran_4g_tpu_torch.stack import mac_pdu
                up = mac_pdu.unpack(out["pdu"], ul=True)
                for sub in up.subpdus:
                    if sub.is_sdu and sub.lcid == 0:
                        self.mac.ra.ue_contention_id = \
                            sub.payload[:6].ljust(6, b"\0")
                        break
            cfg = _ul_cfg(self.air.cell, self.crnti, prb_start, prb_len,
                          mcs, sf=due % 10)
            self.pending_pusch.append((due, cfg, out["pdu"]))
            self.last_pusch[pid] = (cfg, out["pdu"], 0)
            from srsran_4g_tpu_torch.models.phich import phich_alloc
            grp, seq = phich_alloc(self.air.cell.nof_prb, prb_start)
            kp = (self.air.phich_k(due) if hasattr(self.air, "phich_k")
                  else 4)
            self.phich_watch.append((due + kp, grp, seq))

    def handle_dl_dci(self, tti: int, d, cce_start: int,
                      pdu: bytes | None, cc: int = 0) -> None:
        from srsran_4g_tpu_torch.stack.ue_mac import DlMacGrant

        tbs_bytes = len(pdu) if pdu else 0
        g = DlMacGrant(rnti=self.crnti, pid=d.harq_pid,
                       tbs=tbs_bytes, ndi=bool(d.ndi), tti=tti)
        if cc == 0:
            self.mac.new_grant_dl(g)
        else:
            self.scell_harq.new_grant(g)
        ok = pdu is not None
        if ok:
            if cc == 0:
                self.mac.tb_decoded(g, pdu)
            elif self.scell_harq.tb_decoded(g.pid, True):
                # one MAC entity, many carriers: SCell TBs feed the same
                # demux (36.321: HARQ entity per serving cell, common demux)
                self.mac.demux.push_pdu(pdu)
                self.mac.metrics["dl_ok"] += 1
        else:
            self.stats["pdsch_ko"] += 1
        # HARQ-ACK on the PCell PUCCH: n_pucch = first CCE (+ an offset
        # region for the SCell, the framework's channel-selection analog)
        n_pucch = cce_start if cc == 0 else self.air.cch.n_cce + 4 + cce_start
        ka = self.air.ack_k(tti) if hasattr(self.air, "ack_k") else 4
        self.pending_ack.append((tti + ka, n_pucch, 0 if ok else 1, cc,
                                 d.harq_pid))

    def handle_dl_dci_dual(self, tti: int, d, cce_start: int,
                           pdu: bytes | None, pdu2: bytes | None) -> None:
        """Format 2/2A dual-codeword grant: codeword 0 drives the MAC HARQ
        entity, codeword 1 feeds the same demux directly (36.321: one
        HARQ process carries both TBs of a spatial-multiplex grant), and
        both ACK bits ride consecutive PUCCH format-1 resources
        (cce_start, cce_start+1 — the framework's rendering of 36.213
        §10.1 channel selection)."""
        from srsran_4g_tpu_torch.stack.ue_mac import DlMacGrant

        g = DlMacGrant(rnti=self.crnti, pid=d.harq_pid,
                       tbs=len(pdu) if pdu else 0, ndi=bool(d.ndi0), tti=tti)
        self.mac.new_grant_dl(g)
        if pdu is not None:
            self.mac.tb_decoded(g, pdu)
        else:
            self.stats["pdsch_ko"] += 1
        if pdu2 is not None:
            self.mac.demux.push_pdu(pdu2)
            self.mac.metrics["dl_ok"] += 1
        else:
            self.stats["pdsch_ko"] += 1
        self.stats["pdsch_rank2"] = self.stats.get("pdsch_rank2", 0) + 1
        ka = self.air.ack_k(tti) if hasattr(self.air, "ack_k") else 4
        self.pending_ack.append((tti + ka, cce_start,
                                 0 if pdu is not None else 1, 0, d.harq_pid))
        self.pending_ack.append((tti + ka, cce_start + 1,
                                 0 if pdu2 is not None else 1, 0,
                                 d.harq_pid))

    def handle_ul_dci(self, tti: int, d) -> None:
        from srsran_4g_tpu_torch.models import ra

        tbs = ra.tbs_from_itbs(ra.ul_mcs_to_itbs(d.mcs), d.l_crbs)
        k = self.air.ul_k(tti) if hasattr(self.air, "ul_k") else 4
        k = k if k is not None else 4
        self._queue_pusch(tti + k, d.rb_start, d.l_crbs, d.mcs, tbs,
                          pid=(tti + k) % 8, ndi=bool(d.ndi), is_rar=False)

    # -- UL composition ------------------------------------------------------

    def ul_grid(self, tti: int, cqi_due: bool):
        if getattr(self.air, "frame_type", "fdd") == "tdd" \
                and self.air.sf_kind(tti) != "U":
            return None
        pusch = None
        due = [p for p in self.pending_pusch if p[0] <= tti]
        self.pending_pusch = [p for p in self.pending_pusch if p[0] > tti]
        if due:
            _, cfg, pdu = due[0]
            if cfg.subframe != tti % 10:     # slipped past its due TTI
                cfg = replace(cfg, subframe=tti % 10)
            pusch = (cfg, pdu)
            self.stats["pusch_tx"] += 1
        acks = [a for a in self.pending_ack if a[0] <= tti]
        self.pending_ack = [a for a in self.pending_ack if a[0] > tti]
        ack = None
        ack2 = None
        if acks:
            _, n_pucch, bit = acks[0][:3]
            ack = (n_pucch, bit)
            if len(acks) > 1:                 # second carrier's ACK
                ack2 = (acks[1][1], acks[1][2])
        sr = None
        if (pusch is None and self.mac.ra.is_complete()
                and self.has_ul_data() and not self.pending_pusch):
            sr = self.n_pucch_sr
            self.sr_count += 1
        cqi = None
        csi = None
        if cqi_due and self.mac.ra.is_complete() and self.last_snr > 0:
            from srsran_4g_tpu_torch.models.cqi import cqi_from_snr

            val = int(cqi_from_snr(self.last_snr))
            self.cqi_sent.append(val)
            if getattr(self.air, "nof_rx", 1) == 2:
                # 2x2 air: the periodic report carries CQI+RI+PMI
                csi = (self.n_pucch_2, self.crnti, val,
                       self.last_ri, self.last_pmi)
            else:
                cqi = (self.n_pucch_2, self.crnti, val)
        if pusch is None and ack is None and sr is None and cqi is None \
                and csi is None:
            return None
        sf = tti % 10
        g = self.air.ue_ul_tx(pusch, ack=ack, sr=sr, cqi=cqi, csi=csi, sf=sf)
        if ack2 is not None:
            g2 = self.air.ue_ul_tx(None, ack=ack2, sf=sf)
            g = g2 if g is None else g + g2
        return g


class UePhy:
    """Per-TTI DL receive path for one UE: OTA acquisition FSM then
    PHICH + blind PDCCH decode + PDSCH/RAR/SI routing (run() step 4 of
    the single-process driver; srsue sync.cc + cc_worker.cc analog)."""

    def __init__(self, ue: UeNode, air, air_s=None) -> None:
        self.ue = ue
        self.air = air
        self.air_s = air_s
        # TDD acquisition needs the PREVIOUS subframe too: the SSS sits
        # in the last symbol of sf 0/5 while the PSS is in the special
        # subframe that follows (36.211 §6.11; sync.c frame-type detect)
        self.prev_dl = None
        self.prev_tti = -9

    def rx_dl(self, tti: int, dl_samples) -> None:
        from srsran_4g_tpu_torch.stack.enb_mac import SI_RNTI
        from srsran_4g_tpu_torch.stack.rrc_msgs import Mib

        ue, air, stats, log = self.ue, self.air, self.ue.stats, self.ue.log
        if ue.sync_state == "search":
            if getattr(air, "frame_type", "fdd") == "tdd":
                prev, self.prev_dl = self.prev_dl, dl_samples
                prev_t, self.prev_tti = self.prev_tti, tti
                if prev is None or prev_t != tti - 1:
                    return
                buf = torch.cat([prev, dl_samples], dim=-1)
                found = air.ue_cell_search_tdd(buf)
                if found["found"]:
                    ue.acq_pci = found["cell_id"]
                    # buffer start (tti-1) is sf 0 (phase 0) or sf 5
                    ue.sf_off = (tti - 1 - 5 * found["phase"]) % 10
                    ue.sync_state = "mib"
                    log(f"tti {tti}: ue{ue.idx} SYNC(TDD) pci="
                        f"{ue.acq_pci} phase={found['phase']}")
                return
            found = air.ue_cell_search(dl_samples)
            if found["found"]:
                ue.acq_pci = found["cell_id"]
                # PSS marks sf 0 (phase 0) or sf 5 (phase 1)
                ue.sf_off = (tti - 5 * found["phase"]) % 10
                ue.sync_state = "mib"
                log(f"tti {tti}: ue{ue.idx} SYNC pci="
                    f"{ue.acq_pci} phase={found['phase']}")
            return
        ue_sf = (tti - ue.sf_off) % 10
        if ue.sync_state == "mib":
            if ue_sf != 0:
                return
            r = air.ue_mib_rx(dl_samples, ue.acq_pci)
            if r is not None:
                m = Mib.unpack(np.packbits(
                    r["mib"].astype(np.uint8)).tobytes())
                assert m.dl_bandwidth == air.cell.nof_prb
                ue.acq_sfn = m.sfn + r["block"]
                ue.sync_state = "camped"
                log(f"tti {tti}: ue{ue.idx} MIB ok bw="
                    f"{m.dl_bandwidth} sfn={ue.acq_sfn}")
            return
        pci = ue.acq_pci
        # PHICH for PUSCHs sent 4 TTIs ago (cc_worker decode_phich)
        ph_due = [w for w in ue.phich_watch if w[0] == tti]
        ue.phich_watch = [w for w in ue.phich_watch if w[0] > tti]
        for _, grp, seq in ph_due:
            if air.ue_phich_rx(dl_samples, grp, seq, sf=ue_sf):
                stats["phich_ack"] += 1
            else:
                stats["phich_nack"] += 1
        watch = []
        if not ue.rrc.idle.si_acquired(pci):
            watch.append(SI_RNTI)
        if ue.mac.ra.state == ue.mac.ra.MSG3_SENT or ue.crnti:
            watch.append(ue.crnti)
        if ue.mac.ra.state == ue.mac.ra.RAR_WAIT:
            watch.append(ue.ra_rnti)
        # TM3/TM4 UEs also search the TM-specific format on the C-RNTI
        # (ue_dl.c:543-548 searches 0/1A + the configured format)
        fmt = {3: "2A", 4: "2"}.get(ue.tm)
        for rnti in [r for r in watch if r]:
            rx = air.ue_dl_rx_multi(
                dl_samples, rnti, sf=ue_sf,
                harq_bufs=(ue.dl_softbufs if rnti == ue.crnti else None),
                mimo_fmt=(fmt if rnti == ue.crnti else None),
                common_1c=(ue.si_1c and rnti == SI_RNTI))
            ue.last_snr = rx["snr_db"]
            if "ri" in rx:
                ue.last_ri, ue.last_pmi = rx["ri"], max(1, rx["pmi"])
            for hit in rx["hits"]:
                if rnti == SI_RNTI and hit.get("pdu") is not None:
                    ue.rrc.rx_bcch(hit["pdu"], pci)
                    ue.rrc.idle.report_cell(pci, -100.0 + rx["snr_db"])
                elif rnti == ue.ra_rnti and hit.get("pdu") is not None:
                    ue.handle_rar(tti, hit["pdu"])
                elif "ul_dci" in hit:
                    ue.handle_ul_dci(tti, hit["ul_dci"])
                elif "dci2" in hit and rnti == ue.crnti:
                    ue.handle_dl_dci_dual(tti, hit["dci2"],
                                          hit["cce_start"],
                                          hit.get("pdu"), hit.get("pdu2"))
                elif rnti == ue.crnti:
                    ue.handle_dl_dci(tti, hit["dci"], hit["cce_start"],
                                     hit.get("pdu"))

    def rx_dl_scell(self, tti: int, scell_samples) -> None:
        ue = self.ue
        if 1 not in ue.mac.demux.active_scells or not ue.crnti:
            return
        rx = self.air_s.ue_dl_rx_multi(scell_samples, ue.crnti, sf=tti % 10)
        for hit in rx["hits"]:
            if "dci" in hit:
                ue.handle_dl_dci(tti, hit["dci"], hit["cce_start"],
                                 hit.get("pdu"), cc=1)

    # -- RA trigger (cell selection + PRACH decision) ----------------------

    def prach_due(self, tti: int) -> int | None:
        """Cell (re)selection gating + the one-PRACH-per-UE occasion rule;
        returns the chosen preamble index when this TTI is the UE's RA
        occasion (rrc_procedures.h connection_request gating)."""
        ue = self.ue
        idle = ue.rrc.idle
        pci = ue.acq_pci          # known only after OTA acquisition
        if (not ue.prach_sent and pci >= 0 and idle.si_acquired(pci)
                and idle.serving_pci is None):
            idle.select_cell()
        if getattr(ue.air, "frame_type", "fdd") == "tdd":
            # RA occasions cycle over this configuration's UL subframes
            from srsran_4g_tpu_torch.models import tdd as tdd_mod
            uls = [s for s in range(10)
                   if tdd_mod.sf_type(ue.air.ul_dl_config, s) == "U"]
            occasion = uls[ue.idx % len(uls)]
        else:
            occasion = (2 * ue.idx + 2) % 10
        if (not ue.prach_sent and pci >= 0 and idle.serving_pci == pci
                and tti % 10 == occasion):
            ue.rrc.connect()
            idx = ue.mac.ra.start(ue.mac.contention_id)
            ue.prach_sent = True
            ue.ra_rnti = 1 + tti % 10
            return idx
        return None


class EnbNode:
    """eNB MAC scheduler + RRC + per-TTI PHY assembly/decode.

    Transport callbacks: `tx_s1ap(pdu)` sends an aligned-PER S1AP PDU
    toward the MME; `s1u_tx(teid, pkt)` sends an UL user-plane packet
    toward the SPGW.  `rx_s1ap(pdu)` / `rx_s1u(teid, pkt)` are the
    inbound counterparts.
    """

    def __init__(self, air, stats: dict, log, air_s=None,
                 tx_s1ap=None, s1u_tx=None, tm: int = 1) -> None:
        from srsran_4g_tpu_torch.stack.enb_mac import EnbMac
        from srsran_4g_tpu_torch.stack.rrc_enb import EnbCellConfig, RrcEnb

        nof_prb = air.cell.nof_prb
        self.air = air
        self.air_s = air_s
        self.stats = stats
        self.log = log
        self.tm = tm
        self.mac = EnbMac(nof_prb=nof_prb, tm=tm)
        if getattr(air, "frame_type", "fdd") == "tdd":
            # SI window moves to a DL subframe; UL grants follow Table 8-2
            self.mac.si_offset = 0
            self.mac.ul_k = air.ul_k
            self.mac.dl_sched.frame_type = "tdd"
        self.mac.ul_sched.edge_guard = 2  # PUCCH format-2 + format-1 regions
        if air_s is not None:
            self.mac.enable_scell(nof_prb)
        self.rrc = RrcEnb(cell=EnbCellConfig(nof_prb=nof_prb))
        # BCCH broadcast: MIB + SIB1 + SIB2 over SI-RNTI PDSCH (sched_si)
        self.mac.set_si([
            bytes([0]) + self.rrc.gen_mib().pack(),
            bytes([1]) + self.rrc.gen_sib1().pack(),
            bytes([2]) + self.rrc.gen_sib2().pack(),
        ])
        self.rrc.tx_rrc = self.mac.write_dl_sdu
        self.rrc.tx_s1ap = tx_s1ap or (lambda pdu: None)
        self.s1u_tx = s1u_tx or (lambda teid, pkt: None)
        self.mac.rx_ccch = self.rrc.rx_ccch
        self.mac.rx_dcch = self.rrc.rx_dcch
        self.mac.rx_drb = self._rx_drb
        # eNB-side PUCCH expectations
        self.ack_watch: list[tuple] = []   # (tti, rnti, pid, n_pucch, cc)
        self.pusch_watch: list[tuple] = []  # (tti, grant, cfg)
        self.phich_pending: list[tuple] = []  # (tti, grp, seq, ack)
        # PUCCH resources per attached UE, assigned in attach order —
        # the deterministic mirror of UeNode's n_pucch_sr/n_pucch_2
        self.pucch_res: dict[int, tuple[int, int]] = {}  # rnti → (sr, cqi)

    # -- user plane ---------------------------------------------------------

    def _rx_drb(self, rnti: int, lcid: int, sdu: bytes) -> None:
        for pkt in self.rrc.drb_rx(rnti, lcid, sdu):
            ue_ctx = self.rrc.ues.get(rnti)
            if ue_ctx is None:
                continue
            erab = ue_ctx.erab_by_lcid.get(lcid)
            teid = ue_ctx.spgw_teids.get(erab)
            if teid is not None:
                self.s1u_tx(teid, pkt)

    def rx_s1u(self, teid: int, pkt: bytes) -> None:
        """DL user-plane ingress: SPGW TEID → (rnti, lcid) → PDCP."""
        for rnti, ue_ctx in self.rrc.ues.items():
            for erab, t in ue_ctx.erab_teids.items():
                if t == teid:
                    lcids = [lc for lc, e in ue_ctx.erab_by_lcid.items()
                             if e == erab]
                    lcid = lcids[0] if lcids else 3
                    self.mac.write_dl_sdu(rnti, lcid,
                                          self.rrc.drb_tx(rnti, lcid, pkt))
                    return

    def rx_s1ap(self, pdu: bytes) -> None:
        self.rrc.rx_s1ap(pdu)

    def tick(self) -> None:
        self.mac.tick(1)

    # -- RACH ---------------------------------------------------------------

    def rach_detected(self, tti: int, preamble: int) -> None:
        self.stats["prach"] += 1
        rnti = self.mac.rach_detected(tti, preamble)
        # PUCCH SR/CQI resources are assigned with the C-RNTI (attach
        # order), the eNB-side mirror of UeNode's deterministic derivation
        self.register_pucch(rnti)
        self.log(f"tti {tti}: PRACH idx={preamble}")

    # -- DL: schedule + assemble one subframe ------------------------------

    def step_dl(self, tti: int):
        """Run the scheduler and assemble this TTI's DL subframe; returns
        (samples, scell_samples_or_None)."""
        from srsran_4g_tpu_torch.models import dci as dci_mod
        from srsran_4g_tpu_torch.runtime.lte_air import _ul_cfg, dci_to_pdsch_cfg

        air, stats, nof_prb = self.air, self.stats, self.air.cell.nof_prb
        sf = tti % 10
        kind = air.sf_kind(tti) if hasattr(air, "sf_kind") else "D"
        if kind == "U":
            # TDD: the eNB receives only — but msg3 grants whose due TTI
            # is THIS uplink subframe must still arm the PUSCH watch
            # (get_ul_sched returns only msg3 items when ul_k is None)
            for it in self.mac.get_ul_sched(tti):
                if it.is_msg3:
                    g = it.grant
                    cfg = _ul_cfg(air.cell, g.rnti, g.prb_start,
                                  g.prb_len, g.mcs, rv=g.rv, sf=sf)
                    self.pusch_watch.append((tti, g, cfg))
            return None, None
        # special subframes carry control (DwPTS) but no PDSCH here
        dl_items = self.mac.get_dl_sched(tti) if kind == "D" else []
        ul_items = self.mac.get_ul_sched(tti)
        used_cces: set[int] = set()
        tx_list = []
        for it in dl_items:
            if it.pdu2 is not None:
                # dual-codeword TM3/TM4 grant: DCI format 2 (TM4) / 2A
                # (TM3), both ACK bits watched on consecutive PUCCH
                # format-1 resources (channel-selection rendering)
                from srsran_4g_tpu_torch.runtime.lte_air import \
                    dci_to_pdsch_mimo_cfg

                is_f2 = isinstance(it.dci, dci_mod.Dci2) and \
                    not isinstance(it.dci, dci_mod.Dci2A)
                bits = (dci_mod.pack_2(it.dci, nof_prb) if is_f2
                        else dci_mod.pack_2a(it.dci, nof_prb))
                alloc = air.cch.alloc(it.grant.rnti, used_cces, sf=sf)
                if alloc is None:
                    continue
                l_agg, cce_start = alloc
                if l_agg == 1:
                    # reserve the neighbour CCE: its implicit PUCCH
                    # resource carries this grant's second ACK bit
                    used_cces.add(cce_start + 1)
                cfg = dci_to_pdsch_mimo_cfg(air.cell, it.grant.rnti,
                                            it.dci, sf, 4 if is_f2 else 3)
                tx_list.append((cfg, (it.pdu, it.pdu2), bits,
                                it.grant.rnti, l_agg, cce_start))
                stats["pdsch_tx"] += 2
                stats["dci_tx"] += 1
                stats["pdsch_tx_rank2"] = stats.get("pdsch_tx_rank2", 0) + 1
                ka = air.ack_k(tti)
                self.ack_watch.append((tti + ka, it.grant.rnti,
                                       it.grant.harq_pid, cce_start, 0, 0))
                self.ack_watch.append((tti + ka, it.grant.rnti,
                                       it.grant.harq_pid, cce_start + 1,
                                       0, 1))
                continue
            if isinstance(it.dci, dci_mod.Dci1C):
                # compact SI/RAR/paging assignment (ra_dl.c format 1C:
                # QPSK, TBS straight from Table 7.1.7.2.3-1)
                bits = dci_mod.pack_1c(it.dci, nof_prb)
                alloc = air.cch.alloc(it.grant.rnti, used_cces, min_l=4,
                                      sf=sf)
                if alloc is None:
                    continue
                l_agg, cce_start = alloc
                from srsran_4g_tpu_torch.models import pdsch as pdsch_mod
                cfg = pdsch_mod.PdschConfig(
                    cell=air.cell, rnti=it.grant.rnti, subframe=sf,
                    mod="qpsk", tbs=it.grant.tbs,
                    prb_alloc=dci_mod.dci1c_prbs(it.dci, nof_prb))
                tx_list.append((cfg, it.pdu, bits, it.grant.rnti, l_agg,
                                cce_start))
                stats["pdsch_tx"] += 1
                stats["dci_tx"] += 1
                continue
            bits = dci_mod.pack_1a(it.dci, nof_prb)
            alloc = air.cch.alloc(it.grant.rnti, used_cces,
                                  min_l=4 if it.is_rar else 1, sf=sf)
            if alloc is None:
                continue
            l_agg, cce_start = alloc
            cfg = dci_to_pdsch_cfg(air.cell, it.grant.rnti, it.dci, sf)
            tx_list.append((cfg, it.pdu, bits, it.grant.rnti, l_agg,
                            cce_start))
            stats["pdsch_tx"] += 1
            stats["dci_tx"] += 1
            if not it.is_rar:
                self.ack_watch.append((tti + air.ack_k(tti), it.grant.rnti,
                                       it.grant.harq_pid, cce_start, 0, 0))
        ku = air.ul_k(tti) if hasattr(air, "ul_k") else 4
        for it in ul_items:
            g = it.grant
            if it.is_msg3:
                cfg = _ul_cfg(air.cell, g.rnti, g.prb_start, g.prb_len,
                              g.mcs, rv=g.rv, sf=sf)
                self.pusch_watch.append((tti, g, cfg))
                continue
            cfg = _ul_cfg(air.cell, g.rnti, g.prb_start, g.prb_len, g.mcs,
                          rv=g.rv, sf=(tti + (ku or 4)) % 10)
            bits = dci_mod.pack_0(it.dci, nof_prb)
            alloc = air.cch.alloc(g.rnti, used_cces, sf=sf)
            if alloc is None:
                continue
            l_agg, cce_start = alloc
            tx_list.append((None, None, bits, g.rnti, l_agg, cce_start))
            stats["dci_tx"] += 1
            self.pusch_watch.append((tti + (ku or 4), g, cfg))

        # DL over the air: the eNB transmits EVERY subframe (CRS +
        # PCFICH always; PSS/SSS at sf 0/5, PBCH at sf 0, PHICH for
        # pending UL HARQ feedback) so UEs can acquire and track OTA
        due_ph = [p for p in self.phich_pending if p[0] == tti]
        self.phich_pending = [p for p in self.phich_pending if p[0] != tti]
        mib = None
        if sf == 0:
            sfn = tti // 10
            mib_bytes = self.rrc.gen_mib(sfn).pack()
            mib = (np.unpackbits(np.frombuffer(mib_bytes, np.uint8))[:24]
                   .astype(np.int8), sfn % 4)
        dl_samples = air.enb_dl_tx(tx_list, sf=sf,
                                   phich=[p[1:] for p in due_ph], mib=mib,
                                   tti=tti)

        # SCell DL (data-only; CaScheduler shared-buffer draining)
        scell_samples = None
        if self.air_s is not None:
            s_items = self.mac.get_dl_sched_scell(tti)
            s_tx = []
            s_used: set[int] = set()
            for it in s_items:
                bits = dci_mod.pack_1a(it.dci, nof_prb)
                alloc = self.air_s.cch.alloc(it.grant.rnti, s_used, sf=sf)
                if alloc is None:
                    continue
                l_agg, cce_start = alloc
                cfg = dci_to_pdsch_cfg(self.air_s.cell, it.grant.rnti,
                                       it.dci, sf)
                s_tx.append((cfg, it.pdu, bits, it.grant.rnti, l_agg,
                             cce_start))
                stats["pdsch_tx"] += 1
                stats["dci_tx"] += 1
                self.ack_watch.append((tti + 4, it.grant.rnti,
                                       it.grant.harq_pid,
                                       air.cch.n_cce + 4 + cce_start, 1, 0))
            if s_tx:
                scell_samples = self.air_s.enb_dl_tx(s_tx, sf=sf)
        return dl_samples, scell_samples

    # -- UL: decode one subframe of samples --------------------------------

    def need_ul(self) -> bool:
        return bool(self.pusch_watch or self.ack_watch or self.pucch_res)

    def register_pucch(self, rnti: int) -> None:
        """Assign the UE's PUCCH SR/CQI resources at attach, mirroring
        UeNode's deterministic n_pucch_sr/n_pucch_2 derivation."""
        if rnti not in self.pucch_res:
            idx = len(self.pucch_res)
            self.pucch_res[rnti] = (self.air.cch.n_cce + 2 + idx, idx)

    def rx_ul(self, tti: int, ul_samples, pucch_scan: bool = True) -> None:
        from srsran_4g_tpu_torch.models.phich import phich_alloc

        air, stats, sf = self.air, self.stats, tti % 10
        ul_grid = air.enb_ul_grid(ul_samples)
        # PUSCH; each decode also produces a PHICH ACK/NACK on the
        # DL 4 TTIs later (phich.c; srsenb cc_worker encode_phich)
        due = [w for w in self.pusch_watch if w[0] <= tti]
        self.pusch_watch = [w for w in self.pusch_watch if w[0] > tti]
        for _, g, cfg in due:
            if cfg.subframe != sf:
                cfg = replace(cfg, subframe=sf)
            pdu = air.enb_pusch_rx(ul_grid, cfg)
            self.mac.crc_info(tti, g.rnti, g.harq_pid, pdu is not None)
            grp, seq = phich_alloc(air.cell.nof_prb, g.prb_start)
            kp = air.phich_k(tti) if hasattr(air, "phich_k") else 4
            self.phich_pending.append((tti + kp, grp, seq,
                                       1 if pdu is not None else 0))
            if pdu is None:
                stats["pusch_ko"] += 1
            else:
                self.mac.push_pdu(g.rnti, pdu)
        # HARQ-ACK: dual-codeword grants watch two consecutive resources;
        # their bits pair into ONE per-process feedback to the scheduler
        acks = [w for w in self.ack_watch if w[0] <= tti]
        self.ack_watch = [w for w in self.ack_watch if w[0] > tti]
        pair: dict[tuple, dict[int, bool]] = {}
        for _, rnti, pid, n_pucch, cc, cw in acks:
            r = air.enb_pucch_ack_rx(ul_grid, n_pucch, sf=sf)
            pair.setdefault((rnti, pid, cc), {})[cw] = bool(r)
        for (rnti, pid, cc), bits in pair.items():
            self.mac.dl_ack_info(rnti, pid, bits.get(0, False), cc=cc,
                                 ack2=bits.get(1))
        # SR + CQI on the attached UEs' assigned PUCCH resources.  On a
        # PRACH-detected subframe the preamble occupies the PUCCH region
        # (a 6-PRB cell's preamble spans the whole band), so the caller
        # disables the blind scan there to avoid false SR detections.
        if not pucch_scan:
            return
        cqi_due = (air.cqi_due(tti) if hasattr(air, "cqi_due")
                   else (tti % 20) == 5)
        for rnti, (n_sr, n_2) in self.pucch_res.items():
            if air.enb_sr_rx(ul_grid, n_sr, sf=sf):
                self.mac.ul_bsr(rnti, 128)
            if cqi_due:
                if getattr(air, "nof_rx", 1) == 2:
                    # 2x2 air: the periodic report carries CQI+RI+PMI —
                    # RI drives rank adaptation, PMI the TM4 precoder
                    cqi, ri, pmi = air.enb_csi_rx(ul_grid, n_2, rnti,
                                                  sf=sf)
                    self.mac.dl_ri_info(rnti, ri)
                    self.mac.dl_pmi_info(rnti, max(1, pmi))
                else:
                    cqi = air.enb_cqi_rx(ul_grid, n_2, rnti, sf=sf)
                self.mac.dl_cqi_info(rnti, cqi)
                if self.air_s is not None and cqi >= 13:
                    # good-CQI trigger: activate the SCell (36.321 CE)
                    self.mac.scell_activate(rnti)
                    self.mac.scell_sched.dl_cqi_info(rnti, cqi)
