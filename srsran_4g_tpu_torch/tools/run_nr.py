"""NR SA full-system E2E: UE <-> gNB over the NR PHY + 5G core.

Port counterpart of the JAX package's ``tools/run_nr.py`` (the SA
counterpart of tools/run_lte.py): slot by slot over the port's NR PHY on
one device —

  SSB broadcast -> UE SSB time-search (PCI + MIB via polar PBCH) ->
  random access at a real FR1 RACH occasion (38.211 Table 6.3.3.2-3,
  format-0 ZC preamble through the PRACH engine) -> RAR on PDSCH
  addressed by DCI 1_0 at the RA-RNTI -> msg3 -> contention-resolution
  CE -> RRCSetup + 5G-AKA registration + NAS/AS security + PDU session
  over PDSCH-NR / PUSCH-NR transport blocks (LDPC, type-1 DMRS chest).

EVERY grant travels over the air as in the reference
(`srsue/src/phy/nr/cc_worker.cc` + `mac_nr.cc`): the gNB encodes DCI 1_0 /
0_0 onto a CORESET symbol (polar PDCCH-NR, ``models/pdcch_nr``), the UE
blind-decodes its search space each DL slot, and the UE side is the
reusable ``stack/ue_mac_nr`` MAC entity (proc_ra_nr, 16-process HARQ, NR
BSR); DL HARQ-ACKs ride PUCCH-NR format 1.

The same ``run(...)`` (with ``nof_prb`` and ``device`` keywords), CLI, stats
and pass criteria as the JAX tool: SSB found with correct PCI + MIB CRC,
exactly one PRACH detection, registration completes, 0 unrecovered
PDSCH/PUSCH KO, 0% ping loss.  Where the JAX air jits one function per
config, the port runs the model functions eagerly; their per-config tables
(RE maps, DMRS, scrambling sequences, search candidates) are cached on the
device by the models.  The air's noise comes from one ``torch.Generator``
on the device seeded with ``seed``, so its draws differ from JAX's PRNG;
the PRACH noise is numpy's, as in JAX.  There is no CPU fallback:
``device="cpu"`` asks for the CPU.

Usage: python -m srsran_4g_tpu_torch.tools.run_nr [--slots 260] [--pings 5]
           [--snr 20] [--nof-prb 24] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.channel.awgn import awgn, snr_to_noise_var
from srsran_4g_tpu_torch.models import dci_nr, grid_nr, pdcch_nr, pdsch_nr, pucch_nr, pusch_nr, ra_nr

RA_RNTI = 0x0010
DL_SLOT, UL_SLOT = 2, 7       # fixed PHY slot indices (scrambling/DMRS)


class NrAirPhy:
    """NR slot transport on one device: CORESET + PDSCH/PUSCH grids,
    PUCCH-NR HARQ-ACKs, AWGN from one generator."""

    PUCCH_SYMS = (10, 11, 12, 13)

    def __init__(self, snr_db: float, seed: int = 5, nof_prb: int = 24,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.car = grid_nr.NrCarrierConfig(nof_prb=nof_prb, pci=123)
        self.coreset = pdcch_nr.CoresetConfig(nof_prb=nof_prb, pci=123,
                                              slot=DL_SLOT, start_sym=0)
        self.nv = float(snr_to_noise_var(snr_db, device=self.device))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.dci_len = dci_nr.DciNr10(n_rb=nof_prb).nof_bits
        self.pucch1 = pucch_nr.PucchNrF1Config(pci=self.car.pci, nof_symb=4)
        self._pucch_syms = torch.as_tensor(self.PUCCH_SYMS, device=self.device)

    def awgn(self, x: torch.Tensor, noise_var: float | None = None) -> torch.Tensor:
        return awgn(x, self.nv if noise_var is None else noise_var, generator=self.gen)

    def _bits(self, pdu: bytes, nbits: int) -> torch.Tensor:
        b = np.unpackbits(np.frombuffer(pdu, np.uint8))[:nbits]
        return torch.as_tensor(np.pad(b, (0, nbits - len(b))).astype(np.int8)[None],
                               device=self.device)

    def _zeros(self) -> torch.Tensor:
        return torch.zeros((1, 14, self.car.nre), dtype=torch.complex64, device=self.device)

    def dci_to_cfg(self, rnti: int, d, slot: int, ul: bool = False):
        qm = ra_nr.mcs_to_qm_r(d.mcs)[0]
        mod = {2: "qpsk", 4: "16qam", 6: "64qam", 8: "256qam"}[qm]
        cls = pusch_nr.PuschNrConfig if ul else pdsch_nr.PdschNrConfig
        return cls(carrier=self.car, rnti=rnti, slot=slot, mod=mod,
                   tbs=ra_nr.dl_tbs(d.mcs, d.l_rbs), rb_start=d.rb_start,
                   nof_rb=d.l_rbs)

    # -- gNB DL slot ----------------------------------------------------------

    def gnb_dl_tx(self, items: list) -> torch.Tensor:
        """items: (cfg|None, pdu, dci_bits, rnti, agg, start_cce) → noisy
        slot grid (1, 14, nre)."""
        grid = self._zeros()
        for cfg, pdu, _, _, _, _ in items:
            if cfg is not None:
                grid = grid + pdsch_nr.encode(cfg, self._bits(pdu, cfg.tbs))
        for _, _, dci_bits, rnti, agg, start_cce in items:
            grid[:, 0, :] += pdcch_nr.encode(self.coreset, dci_bits, rnti, aggregation=agg,
                                             start_cce=start_cce, device=self.device)[0]
        return self.awgn(grid)

    # -- UE DL slot -------------------------------------------------------------

    def ue_dl_rx(self, grid: torch.Tensor, rnti: int) -> dict | None:
        """Blind decode the CORESET for `rnti`; decode PDSCH on a DL hit.

        Returns None or dict(dci | ul_dci, pdu|None)."""
        out = pdcch_nr.blind_decode(self.coreset, grid[:, 0, :], rnti=rnti,
                                    dci_len=self.dci_len)
        if not bool(out["found"][0]):
            return None
        bits = out["bits"][0].cpu().numpy()
        byts = np.packbits(bits).tobytes()
        if bits[0] == 0:
            return dict(ul_dci=dci_nr.DciNr00.unpack(byts, self.car.nof_prb))
        d = dci_nr.DciNr10.unpack(byts, self.car.nof_prb)
        r = pdsch_nr.decode(self.dci_to_cfg(rnti, d, DL_SLOT), grid, n_iter=10)
        pdu = (np.packbits(r["bits"][0].cpu().numpy().astype(np.uint8)).tobytes()
               if bool(r["crc_ok"][0]) else None)
        return dict(dci=d, pdu=pdu)

    # -- UL slot ------------------------------------------------------------------

    def ue_ul_tx(self, cfg, pdu: bytes) -> torch.Tensor:
        return self.awgn(pusch_nr.encode(cfg, self._bits(pdu, cfg.tbs)))

    def ue_pucch_ack_tx(self, grid: torch.Tensor | None, ack_bit: int) -> torch.Tensor:
        """Place a PUCCH-NR format-1 HARQ-ACK on PRB 0 of the UL slot
        (38.211 6.3.2.4; PRB 0 is reserved from PUSCH allocations)."""
        sym = pucch_nr.f1_encode(self.pucch1, torch.tensor([[ack_bit]], dtype=torch.int8,
                                                            device=self.device))
        if grid is None:
            grid = self.awgn(self._zeros())
        grid = grid.clone()
        grid[:, self._pucch_syms, 0:12] += sym
        return grid

    def gnb_pucch_ack_rx(self, grid: torch.Tensor) -> bool | None:
        """→ True ACK / False NACK / None DTX (metric threshold)."""
        out = pucch_nr.f1_decode(self.pucch1, grid[:, self._pucch_syms, 0:12])
        z = complex(out["symbol"][0])
        if abs(z) < 10 * self.nv:
            return None
        return int(out["bits"][0, 0]) == 0

    def gnb_ul_rx(self, grid: torch.Tensor, cfg) -> bytes | None:
        r = pusch_nr.decode(cfg, grid, n_iter=10)
        if not bool(r["crc_ok"][0]):
            return None
        return np.packbits(r["bits"][0].cpu().numpy().astype(np.uint8)).tobytes()


def run(n_slots: int, n_pings: int, snr_db: float, nof_prb: int = 24,
        verbose: bool = False, device: torch.device | str | None = None):
    from srsran_4g_tpu_torch.models import prach as prach_mod
    from srsran_4g_tpu_torch.models import ssb as ssb_mod
    from srsran_4g_tpu_torch.models import ue_sync_nr
    from srsran_4g_tpu_torch.stack import mac_pdu_nr as MAC
    from srsran_4g_tpu_torch.stack.epc import Hss
    from srsran_4g_tpu_torch.stack.nas_5g import Nas5gUe
    from srsran_4g_tpu_torch.stack.ngap import Amf
    from srsran_4g_tpu_torch.stack.rlc_nr import RlcAmNr
    from srsran_4g_tpu_torch.stack.rrc_nr import RrcNrGnb, RrcNrUe
    from srsran_4g_tpu_torch.stack.ue_mac_nr import (DlGrantNr, LogicalChannelNr,
                                                     UeMacNr, UlGrantNr)
    from srsran_4g_tpu_torch.stack.usim import Usim, UsimConfig

    air = NrAirPhy(snr_db, nof_prb=nof_prb, device=device)
    dev = air.device
    car = air.car
    log = (lambda *a: print(*a, flush=True)) if verbose else (lambda *a: None)
    stats = {"ssb_found": 0, "pdsch_ko": 0, "pusch_ko": 0, "dci_tx": 0,
             "dl_ping_rx": 0, "ul_ping_rx": 0}

    # ----- 5GC + gNB + UE
    ucfg = UsimConfig()
    hss = Hss()
    hss.add_subscriber(ucfg.imsi, ucfg.k, ucfg.opc)
    amf = Amf(hss=hss)
    gnb = RrcNrGnb()
    ue = RrcNrUe(nas=Nas5gUe(Usim(ucfg)))
    ue_mac = UeMacNr(contention_id=b"\x51\x51\x51\x51\x51\x51")

    gnb_rlc = {0: [], 1: RlcAmNr()}
    ue_rlc = {0: [], 1: RlcAmNr()}

    gnb.tx_rrc = lambda rnti, lcid, pdu: (
        gnb_rlc[0].append(pdu) if lcid == 0 else gnb_rlc[1].write_sdu(pdu))
    gnb.tx_ngap = lambda pdu: [gnb.rx_ngap(r) for r in amf.rx_ngap(pdu)]
    ue.tx = lambda lcid, pdu: (
        ue_rlc[0].append(pdu) if lcid == 0 else ue_rlc[1].write_sdu(pdu))

    # UE MAC wiring: demux sinks + mux channels
    def ue_dcch_sink(p: bytes) -> None:
        ue_rlc[1].write_pdu(p)
        while ue_rlc[1].delivered:
            ue.rx_dcch(ue_rlc[1].delivered.pop(0))

    ue_mac.demux.add_rlc(0, ue.rx_ccch)
    ue_mac.demux.add_rlc(1, ue_dcch_sink)
    ue_mac.mux.setup_lcid(LogicalChannelNr(
        lcid=0, priority=0, has_data=lambda: len(ue_rlc[0]),
        read_pdu=lambda n: ue_rlc[0].pop(0) if ue_rlc[0] else None))
    ue_mac.mux.setup_lcid(LogicalChannelNr(
        lcid=1, priority=1,
        has_data=lambda: 200 if ue_rlc[1].has_data() else 0,
        read_pdu=lambda n: ue_rlc[1].read_pdu(n)))
    ue_mac.bsr.buffer_fn = lambda: (len(gnb_rlc) and sum(
        len(p) for p in ue_rlc[0]) + (200 if ue_rlc[1].has_data() else 0))


    # ----- phase 1: SSB search (sync_sa.cc cell_search)
    rng = np.random.default_rng(0)
    mib_payload = rng.integers(0, 2, 32).astype(np.int8)
    cfg_ssb = ssb_mod.SsbConfig(pci=car.pci)
    grid = ssb_mod.assemble(cfg_ssb, mib_payload[None], device=dev)
    t = ue_sync_nr.ssb_to_samples(grid)
    delay = 400
    stream = torch.cat([torch.zeros((1, delay), dtype=torch.complex64, device=dev), t,
                        torch.zeros((1, 200), dtype=torch.complex64, device=dev)], dim=-1)
    sig = float(t.abs().square().mean())
    capture = air.awgn(stream, air.nv * sig)
    us = ue_sync_nr.UeSyncNr()
    found = us.process(capture)
    if not found["in_sync"] or found["pci"] != car.pci:
        return False, stats, ue, amf
    mib = us.decode_mib(found["ssb_grid"])
    if not bool(mib["crc_ok"].all()):
        return False, stats, ue, amf
    stats["ssb_found"] = 1
    log(f"SSB: pci={found['pci']} offset={found['offset']} MIB ok")

    # ----- phase 1.5: PRACH at a real FR1 RACH occasion (proc_ra_nr)
    prach_cfg_idx = 7
    ra_tti = 0
    while not prach_mod.prach_nr_tti_opportunity(prach_cfg_idx, ra_tti,
                                                 paired=False):
        ra_tti += 1
    ra_cfg = prach_mod.PrachConfig(symbol_sz=512, root_seq_index=1,
                                   is_nr=True)
    preamble_idx = ue_mac.ra.start(ue_mac.contention_id)
    ptx = prach_mod.generate(ra_cfg, preamble_idx, device="cpu").numpy()
    sig_p = float(np.mean(np.abs(ptx) ** 2))
    nvar = sig_p * 10.0 ** (-snr_db / 10.0)
    pnoise = (rng.normal(size=ptx.shape) + 1j * rng.normal(size=ptx.shape))
    prx = (ptx + np.sqrt(nvar / 2.0) * pnoise).astype(np.complex64)
    pout = prach_mod.detect(ra_cfg, torch.as_tensor(prx[None], device=dev), threshold=0.5)
    pdet = pout["detected"][0].cpu().numpy()
    stats["prach_detected"] = int(pdet.sum())
    if stats["prach_detected"] != 1 or not pdet[preamble_idx]:
        return False, stats, ue, amf
    log(f"tti {ra_tti}: PRACH preamble {preamble_idx} detected")

    # ----- phase 2: slot loop; all grants via PDCCH-NR DCIs
    gnb.ng_setup()
    ue.connect()   # queues RRCSetupRequest on CCCH

    crnti = 0x4601
    gnb_pending_rar = [preamble_idx]
    gnb_conres: list[bytes] = []
    gnb_msg3_wait = False
    ue_pending_pusch: list[tuple] = []   # (cfg, pdu)
    gnb_pusch_watch: list[tuple] = []    # (grant-tbs cfg, pid)
    ue_pending_ack: list[int] = []       # ack bits for the next UL slot
    gnb_ack_watch: list[tuple] = []      # (pid, pdu, ndi) awaiting HARQ-ACK
    gnb_retx_q: list[tuple] = []         # (pid, pdu, ndi) NACKed DL PDUs
    stats["ack_rx"] = 0
    stats["dl_retx"] = 0
    ue_last_bsr = 0
    pings_sent = 0
    reg_slot = None
    dl_ndi = {}
    ul_ndi = False
    MCS = 7

    def gnb_dl_pdu(budget: int) -> bytes | None:
        pdu = MAC.NrMacPdu()
        left = budget
        while gnb_conres and left >= 7:
            pdu.add_ce(MAC.LCID_CON_RES, gnb_conres.pop(0))
            left -= 7
        while gnb_rlc[0] and left > len(gnb_rlc[0][0]) + 2:
            sdu = gnb_rlc[0].pop(0)
            pdu.add_sdu(0, sdu)
            left -= len(sdu) + 2
        while gnb_rlc[1].has_data() and left > 6:
            rp = gnb_rlc[1].read_pdu(left - 3)
            if not rp:
                break
            pdu.add_sdu(1, rp)
            left -= len(rp) + 3
        if not pdu.subpdus:
            return None
        return MAC.pack(pdu, budget)

    def l_rbs_for(nof_bytes: int) -> int:
        for n in range(1, car.nof_prb + 1):
            if ra_nr.dl_tbs(MCS, n) >= nof_bytes * 8 + 32:
                return n
        return car.nof_prb

    for slot in range(n_slots):
        gnb_rlc[1].tick(1)
        ue_rlc[1].tick(1)
        retry = ue_mac.tick(1)
        if retry is not None:
            # RA retry would send another preamble; the pass criterion is
            # exactly one PRACH, so count and bail
            stats["prach_detected"] += 1
            break

        # ---- gNB DL slot: RAR / data + DCIs
        items = []
        if gnb_pending_rar:
            rapid = gnb_pending_rar.pop(0)
            msg3_tbs = ra_nr.dl_tbs(MCS, 4)
            rar = MAC.pack_rar([MAC.NrRarGrant(
                rapid=rapid, ta=2,
                ul_grant=(dci_nr.riv_encode(car.nof_prb, 1, 4) << 5) | MCS,
                tc_rnti=crnti)])
            n_rb = l_rbs_for(len(rar))
            d = dci_nr.DciNr10(n_rb=car.nof_prb, rb_start=0, l_rbs=n_rb,
                               mcs=MCS, ndi=0, harq_pid=0)
            cfg = air.dci_to_cfg(RA_RNTI, d, DL_SLOT)
            items.append((cfg, rar.ljust(cfg.tbs // 8, b"\0"),
                          np.unpackbits(np.frombuffer(d.pack(), np.uint8))
                          [:air.dci_len].astype(np.int8), RA_RNTI, 2, 0))
            gnb_msg3_wait = True
            gnb_pusch_watch.append(
                (air.dci_to_cfg(crnti, dci_nr.DciNr00(
                    n_rb=car.nof_prb, rb_start=1, l_rbs=4, mcs=MCS),
                    UL_SLOT, ul=True), 0))
        elif gnb_retx_q:
            pid, pdu_b, ndi_b = gnb_retx_q.pop(0)
            n_rb = l_rbs_for(len(pdu_b))
            d = dci_nr.DciNr10(n_rb=car.nof_prb, rb_start=0, l_rbs=n_rb,
                               mcs=MCS, ndi=int(ndi_b), harq_pid=pid, rv=2)
            cfg = air.dci_to_cfg(crnti, d, DL_SLOT)
            items.append((cfg, pdu_b.ljust(cfg.tbs // 8, b"\0")[:cfg.tbs // 8],
                          np.unpackbits(np.frombuffer(d.pack(), np.uint8))
                          [:air.dci_len].astype(np.int8), crnti, 2, 0))
            gnb_ack_watch.append((pid, pdu_b, ndi_b))
        else:
            dl_bytes = (sum(len(p) + 8 for p in gnb_rlc[0])
                        + (220 if gnb_rlc[1].has_data() else 0)
                        + (7 if gnb_conres else 0))
            if dl_bytes:
                n_rb = l_rbs_for(dl_bytes)
                pid = slot % 16
                ndi = not dl_ndi.get(pid, False)
                dl_ndi[pid] = ndi
                d = dci_nr.DciNr10(n_rb=car.nof_prb, rb_start=0, l_rbs=n_rb,
                                   mcs=MCS, ndi=int(ndi), harq_pid=pid)
                cfg = air.dci_to_cfg(crnti, d, DL_SLOT)
                pdu = gnb_dl_pdu(cfg.tbs // 8)
                if pdu is not None:
                    items.append((cfg, pdu,
                                  np.unpackbits(np.frombuffer(
                                      d.pack(), np.uint8))[:air.dci_len]
                                  .astype(np.int8), crnti, 2, 0))
                    gnb_ack_watch.append((pid, pdu, ndi))
            # UL grant while the UE reports data; one DCI per slot to the
            # C-RNTI (the fallback search space carries one decode)
            if ue_last_bsr > 0 and not gnb_msg3_wait and not items:
                pid = (slot + 1) % 16
                ul_ndi = not ul_ndi
                d0 = dci_nr.DciNr00(
                    n_rb=car.nof_prb, rb_start=1,
                    l_rbs=min(l_rbs_for(ue_last_bsr), car.nof_prb - 1),
                    mcs=MCS, ndi=int(ul_ndi), harq_pid=pid,
                    target_bits=air.dci_len)
                items.append((None, None,
                              np.unpackbits(np.frombuffer(
                                  d0.pack(), np.uint8))[:air.dci_len]
                              .astype(np.int8), crnti, 2, 2))
                gnb_pusch_watch.append(
                    (air.dci_to_cfg(crnti, d0, UL_SLOT, ul=True), pid))
                ue_last_bsr = 0

        if items:
            stats["dci_tx"] += len(items)
            grid = air.gnb_dl_tx(items)
            # UE side: watch RA-RNTI during the RAR window, C-RNTI after
            watch = []
            if ue_mac.ra.state == ue_mac.ra.RAR_WAIT:
                watch.append(RA_RNTI)
            if ue_mac.ra.temp_crnti or ue_mac.ra.is_complete():
                watch.append(crnti)
            for rnti in watch:
                rx = air.ue_dl_rx(grid, rnti)
                if rx is None:
                    continue
                if "ul_dci" in rx:
                    d0 = rx["ul_dci"]
                    cfg = air.dci_to_cfg(crnti, d0, UL_SLOT, ul=True)
                    out = ue_mac.new_grant_ul(UlGrantNr(
                        rnti=crnti, pid=d0.harq_pid, tbs=cfg.tbs // 8,
                        ndi=bool(d0.ndi)))
                    if out["pdu"]:
                        ue_pending_pusch.append((cfg, out["pdu"]))
                    continue
                d, pdu = rx["dci"], rx.get("pdu")
                if rnti == RA_RNTI:
                    if pdu is None:
                        continue
                    for g_rar in MAC.unpack_rar(pdu):
                        if ue_mac.ra.rar_received(g_rar):
                            st, ln = dci_nr.riv_decode(
                                car.nof_prb, g_rar.ul_grant >> 5)
                            mcs3 = g_rar.ul_grant & 0x1F
                            cfg3 = air.dci_to_cfg(crnti, dci_nr.DciNr00(
                                n_rb=car.nof_prb, rb_start=st, l_rbs=ln,
                                mcs=mcs3), UL_SLOT, ul=True)
                            out = ue_mac.new_grant_ul(UlGrantNr(
                                rnti=crnti, pid=0, tbs=cfg3.tbs // 8,
                                ndi=True, is_msg3=True))
                            if out["pdu"]:
                                ue_pending_pusch.append((cfg3, out["pdu"]))
                    continue
                g = DlGrantNr(rnti=crnti, pid=d.harq_pid,
                              tbs=ra_nr.dl_tbs(d.mcs, d.l_rbs) // 8,
                              ndi=bool(d.ndi), rv=d.rv)
                new_tx = ue_mac.new_grant_dl(g)
                if pdu is None:
                    stats["pdsch_ko"] += 1
                elif new_tx:
                    ue_mac.tb_decoded(g, pdu)
                ue_pending_ack.append(0 if pdu is not None else 1)

        # ---- UE UL slot
        if ue_pending_pusch or ue_pending_ack:
            grid = None
            if ue_pending_pusch:
                cfg, pdu = ue_pending_pusch.pop(0)
                grid = air.ue_ul_tx(cfg, pdu)
            if ue_pending_ack:
                grid = air.ue_pucch_ack_tx(grid, ue_pending_ack.pop(0))
            # gNB: HARQ-ACK first (retx on NACK/DTX), then PUSCH
            if gnb_ack_watch:
                r = air.gnb_pucch_ack_rx(grid)
                pid, pdu_b, ndi_b = gnb_ack_watch.pop(0)
                if r is True:
                    stats["ack_rx"] += 1
                else:
                    # NACK or DTX: retransmit the buffered PDU with the
                    # SAME pid/ndi (dl_harq_nr: un-toggled NDI = retx)
                    stats["dl_retx"] += 1
                    gnb_retx_q.append((pid, pdu_b, ndi_b))
            watch = [w for w in gnb_pusch_watch]
            gnb_pusch_watch = []
            got = False
            for wcfg, pid in watch:
                rx = air.gnb_ul_rx(grid, wcfg)
                if rx is None:
                    continue
                got = True
                up = MAC.unpack(rx, ul=True)
                for sub in up.subpdus:
                    if not sub.is_sdu:
                        if sub.lcid == MAC.LCID_SHORT_BSR and sub.payload:
                            from srsran_4g_tpu_torch.stack.ue_mac_nr import _BSR_NR
                            ue_last_bsr = _BSR_NR[sub.payload[0] & 0x1F]
                        continue
                    if sub.lcid == 0:
                        if gnb_msg3_wait:
                            gnb_msg3_wait = False
                            gnb_conres.append(sub.payload[:6].ljust(6, b"\0"))
                        gnb.rx_ccch(sub.payload)
                    else:
                        gnb_rlc[1].write_pdu(sub.payload)
                        while gnb_rlc[1].delivered:
                            gnb.rx_dcch(gnb.next_rnti - 1,
                                        gnb_rlc[1].delivered.pop(0))
            if watch and not got:
                stats["pusch_ko"] += 1
        # standing small UL grant while attach signalling flows: the UE
        # signals pending data via BSR; bootstrap with one poll per 4 slots
        if (ue_mac.ra.is_complete() and ue_mac.has_ul_data()
                and ue_last_bsr == 0):
            ue_last_bsr = 128

        # ---- registration milestone + ping train over the DRB
        if ue.nas.state == "REGISTERED" and reg_slot is None:
            reg_slot = slot
            ip = ue.nas.ip_addr and ".".join(str(b) for b in ue.nas.ip_addr)
            log(f"slot {slot}: REGISTERED ip={ip}")
        if reg_slot is not None and pings_sent < n_pings \
                and slot > reg_slot + 2 and slot % 8 == 0 and 4 in ue.drbs:
            sent = []
            old_tx = ue.tx
            ue.tx = lambda l, p: sent.append((l, p))
            ue.write_drb_sdu(4, f"ping{pings_sent:04d}".encode())
            ue.tx = old_tx
            l, pdu = sent[-1]
            for pkt in gnb.drb_rx(ue.c_rnti, l, pdu):
                stats["ul_ping_rx"] += 1
                dl_pdu = gnb.drb_tx(ue.c_rnti, l, b"echo:" + pkt)
                for back in ue.rx_drb_pdu(l, dl_pdu):
                    stats["dl_ping_rx"] += 1
            pings_sent += 1

    ok = (stats["ssb_found"] == 1
          and stats.get("prach_detected") == 1
          and stats["ack_rx"] >= 1          # HARQ-ACKs rode PUCCH-NR
          and ue_mac.ra.is_complete()
          and ue.nas.state == "REGISTERED"
          and amf.registered_ues() == [ucfg.imsi]
          and stats["pdsch_ko"] == 0 and stats["pusch_ko"] == 0
          and stats["dl_ping_rx"] == n_pings
          and stats["ul_ping_rx"] == n_pings)
    return ok, stats, ue, amf


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=260)
    ap.add_argument("--pings", type=int, default=5)
    ap.add_argument("--snr", type=float, default=20.0)
    ap.add_argument("--nof-prb", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-v", action="store_true")
    args = ap.parse_args()
    ok, stats, ue, amf = run(args.slots, args.pings, args.snr, nof_prb=args.nof_prb,
                             verbose=args.v, device=args.device)
    ip = ue.nas.ip_addr and ".".join(str(b) for b in ue.nas.ip_addr)
    print(f"registered={ue.nas.state == 'REGISTERED'} ip={ip} stats={stats}")
    print("NR SA E2E RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
