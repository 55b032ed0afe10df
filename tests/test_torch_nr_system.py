"""Port parity: the NR SA system path — ``tools/run_nr`` and the 5G stack
it runs (``stack/{mac_pdu_nr,rlc_nr,nas_5gs_codec,nas_5g,ngap,rrc_nr_uper,
rrc_nr,sched_nr,ue_mac_nr}``, copies of the JAX package's files).

- The port's ``run_nr.run(80, 2, 20.0)`` on the CPU at 24 PRB, held to every
  criterion of tests/test_run_nr.py (the air's noise comes from a torch
  generator, so the run is held to the criteria, not to JAX's samples).
- The scenarios of tests/test_nr_stack.py (SA registration with 5G-AKA and
  security, the SDAP/PDCP-NR user plane, an unknown SUCI) run through both
  packages' stacks with ``os.urandom`` patched alike: every RRC, NGAP and
  DRB PDU byte-identical, in the same order, and the same end states.
- Two scenarios of tests/test_ue_mac_nr.py (contention resolution by the
  msg3 prefix; UL HARQ retransmission, the BSR CE and a new transmission)
  through both packages' ``UeMacNr``: every MAC PDU identical.
"""

import importlib
import os
import random

import pytest
import torch

from srsran_4g_tpu_torch.stack.usim import UsimConfig
from srsran_4g_tpu_torch.tools import run_nr

torch.set_num_threads(2)

PACKAGES = ("srsran_4g_tpu", "srsran_4g_tpu_torch")


def _stack(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.stack.{name}")


@pytest.fixture
def seeded_urandom(monkeypatch):
    """os.urandom from a seeded generator; ``reset()`` restarts its stream,
    so each package's run draws the same bytes."""
    state = {}

    def reset():
        state["rng"] = random.Random(7)

    def urandom(n):
        return bytes(state["rng"].getrandbits(8) for _ in range(n))

    reset()
    monkeypatch.setattr(os, "urandom", urandom)
    return reset


def test_run_nr_port_on_cpu_meets_the_criteria():
    ok, stats, ue, amf = run_nr.run(n_slots=80, n_pings=2, snr_db=20.0, device="cpu")
    assert stats["ssb_found"] == 1
    assert stats["prach_detected"] == 1   # exactly one preamble, no false alarms
    assert ue.nas.state == "REGISTERED"
    assert stats["pdsch_ko"] == 0 and stats["pusch_ko"] == 0
    assert stats["dl_ping_rx"] == 2 and stats["ul_ping_rx"] == 2
    assert stats["ack_rx"] >= 1      # DL HARQ-ACKs carried on PUCCH-NR F1
    assert amf.registered_ues() == [UsimConfig().imsi]
    assert ok


def _sa_network(pkg: str, log: list):
    """tests/test_nr_stack.py::_sa_network in one package, every PDU put on
    ``log`` as it is sent."""
    usim, epc, nas_5g = _stack(pkg, "usim"), _stack(pkg, "epc"), _stack(pkg, "nas_5g")
    ngap, rrc_nr = _stack(pkg, "ngap"), _stack(pkg, "rrc_nr")
    cfg = usim.UsimConfig()
    hss = epc.Hss()
    hss.add_subscriber(cfg.imsi, cfg.k, cfg.opc)
    amf = ngap.Amf(hss=hss)
    gnb = rrc_nr.RrcNrGnb()
    ue = rrc_nr.RrcNrUe(nas=nas_5g.Nas5gUe(usim.Usim(cfg)))
    q = {"u2g": [], "g2u": [], "g2a": [], "a2g": []}
    ue.tx = lambda lc, p: (log.append(("u2g", lc, p)), q["u2g"].append((lc, p)))
    gnb.tx_rrc = lambda r, lc, p: (log.append(("g2u", r, lc, p)), q["g2u"].append((r, lc, p)))
    gnb.tx_ngap = lambda p: (log.append(("g2a", p)), q["g2a"].append(p))

    def pump():
        for _ in range(60):
            if not any(q.values()):
                return
            while q["u2g"]:
                lc, p = q["u2g"].pop(0)
                if lc == 0:
                    gnb.rx_ccch(p)
                else:
                    gnb.rx_dcch(gnb.next_rnti - 1, p)
            while q["g2u"]:
                r, lc, p = q["g2u"].pop(0)
                if lc == 0:
                    ue.rx_ccch(p)
                else:
                    ue.rx_dcch(p)
            while q["g2a"]:
                for r in amf.rx_ngap(q["g2a"].pop(0)):
                    log.append(("a2g", r))
                    q["a2g"].append(r)
            while q["a2g"]:
                gnb.rx_ngap(q["a2g"].pop(0))

    return ue, gnb, amf, cfg, pump


def _registered(pkg: str):
    log: list = []
    ue, gnb, amf, cfg, pump = _sa_network(pkg, log)
    gnb.ng_setup()
    ue.connect()
    pump()
    return ue, gnb, amf, cfg, log


def test_sa_registration_flow_same_pdus(seeded_urandom):
    runs = {}
    for pkg in PACKAGES:
        seeded_urandom()
        ue, gnb, amf, cfg, log = _registered(pkg)
        assert ue.nas.state == "REGISTERED" and amf.registered_ues() == [cfg.imsi]
        assert "as_security" in ue.events and "as_security" in gnb.events
        assert "n3_tunnel_up" in amf.events
        runs[pkg] = (log, ue.nas.ip_addr, ue.events, gnb.events, amf.events)
    j, t = runs.values()
    assert len(t[0]) > 10 and t == j


def test_sa_user_plane_sdap_pdcp_same_pdus(seeded_urandom):
    runs = {}
    for pkg in PACKAGES:
        seeded_urandom()
        ue, gnb, _, _, _ = _registered(pkg)
        sent = []
        ue.tx = lambda lc, p: sent.append((lc, p))
        ue.write_drb_sdu(4, b"nr-uplink-ip")
        lc, pdu = sent[-1]
        assert b"nr-uplink-ip" not in pdu  # ciphered
        assert gnb.drb_rx(ue.c_rnti, lc, pdu) == [b"nr-uplink-ip"]
        dl = gnb.drb_tx(ue.c_rnti, 4, b"nr-downlink-ip")
        assert ue.rx_drb_pdu(4, dl) == [b"nr-downlink-ip"]
        runs[pkg] = (sent, dl)
    assert runs["srsran_4g_tpu"] == runs["srsran_4g_tpu_torch"]


def test_sa_unknown_imsi_same_outcome():
    out = {}
    for pkg in PACKAGES:
        ng, n5 = _stack(pkg, "ngap"), _stack(pkg, "nas_5g")
        amf = ng.Amf(hss=_stack(pkg, "epc").Hss())
        req = ng.pack_pdu(ng.PROC_INITIAL_UE_MESSAGE, ng.PDU_INITIATING,
                          ng.NgInitialUeMessage(ran_ue_id=1, nas_pdu=n5.RegistrationRequest(
                              suci="999990000000001").pack()))
        out[pkg] = (req, amf.rx_ngap(req), list(amf.events))
        assert out[pkg][1] == [] and "unknown_suci" in amf.events
    assert out["srsran_4g_tpu"] == out["srsran_4g_tpu_torch"]


def _mac(pkg: str, queue: list):
    m = _stack(pkg, "ue_mac_nr")
    mac = m.UeMacNr(contention_id=b"\x51" * 6, rng_seed=3)
    mac.mux.setup_lcid(m.LogicalChannelNr(
        lcid=0, priority=0, has_data=lambda: len(queue),
        read_pdu=lambda n: queue.pop(0) if queue else None))
    return m, mac


def test_ue_mac_nr_contention_resolution_same_pdus():
    runs = {}
    for pkg in PACKAGES:
        m, mac = _mac(pkg, [b"RRCSetupRequest-bytes"])
        pdu = _stack(pkg, "mac_pdu_nr")
        idx = mac.ra.start(mac.contention_id)
        assert mac.ra.rar_received(pdu.NrRarGrant(rapid=idx, tc_rnti=0x4601))
        out = mac.new_grant_ul(m.UlGrantNr(rnti=0x4601, pid=0, tbs=40, ndi=True, is_msg3=True))
        assert out["new_tx"] and mac.ra.ue_contention_id == b"RRCSet"
        dl = pdu.NrMacPdu()
        dl.add_ce(pdu.LCID_CON_RES, b"RRCSet")
        g = m.DlGrantNr(rnti=0x4601, pid=1, tbs=32, ndi=True)
        mac.new_grant_dl(g)
        raw = pdu.pack(dl, 32)
        mac.tb_decoded(g, raw)
        assert mac.ra.is_complete() and mac.ra.crnti == 0x4601
        runs[pkg] = (idx, out["pdu"], raw, mac.ra.crnti)
    assert runs["srsran_4g_tpu"] == runs["srsran_4g_tpu_torch"]


def test_ue_mac_nr_ul_harq_and_bsr_same_pdus():
    runs = {}
    for pkg in PACKAGES:
        m, mac = _mac(pkg, [b"first", b"second"])
        mac.bsr.buffer_fn = lambda: 300
        out1 = mac.new_grant_ul(m.UlGrantNr(rnti=0x4601, pid=2, tbs=24, ndi=True))
        out2 = mac.new_grant_ul(m.UlGrantNr(rnti=0x4601, pid=2, tbs=24, ndi=True, rv=2))
        out3 = mac.new_grant_ul(m.UlGrantNr(rnti=0x4601, pid=2, tbs=24, ndi=False))
        assert out1["new_tx"] and not out2["new_tx"] and out3["new_tx"]
        assert out2["pdu"] == out1["pdu"] != out3["pdu"] and mac.metrics["ul_retx"] == 1
        pdu = _stack(pkg, "mac_pdu_nr")
        ces = [s.payload for s in pdu.unpack(out1["pdu"], ul=True).subpdus
               if not s.is_sdu and s.lcid == pdu.LCID_SHORT_BSR]
        assert ces and (ces[0][0] & 0x1F) == m.bsr_index_nr(300)
        runs[pkg] = ([o["pdu"] for o in (out1, out2, out3)], ces, dict(mac.metrics))
    assert runs["srsran_4g_tpu"] == runs["srsran_4g_tpu_torch"]
