"""Port parity: the protocol stack that the system paths run — the 34
JAX-free ``stack/`` modules the port copies (nine of them the NR stack's),
and ``stack/security``, the one it rewrites (AES-128, CTR and CMAC in plain
Python instead of the ``cryptography`` package).

- Each copied module's source equals its JAX-package file once the import
  paths ``srsran_4g_tpu.`` are rewritten to ``srsran_4g_tpu_torch.``.
- ``security`` against the JAX package's ``cryptography``-backed functions on
  seeded random keys and messages (identical bytes), and against published
  vectors typed in as constants: FIPS-197 Appendix C.1 (AES-128), RFC 4493
  §4 (AES-CMAC), TS 35.208 test set 1 (Milenage, via TS 35.207's OP), TS
  33.401 Annex C.1 test set 1 (128-EEA2) and C.2 test set 5 (128-EIA2).
- The control-plane exchange of ``tests/test_attach.py::test_full_attach_flow``
  (RRC connection, S1 setup, AKA, NAS and RRC security mode, bearer setup,
  attach complete) then a ciphered DRB packet each way, run in both packages
  with ``os.urandom`` patched alike: every RRC, NAS-carrying and S1AP PDU
  byte-identical, in the same order.
"""

import dataclasses
import importlib
import os
import random
import re
from pathlib import Path

import pytest

from srsran_4g_tpu.stack import security as j_sec
from srsran_4g_tpu_torch.stack import security as t_sec

REPO = Path(__file__).resolve().parents[1]
COPIED = ("snow3g_zuc", "asn1", "aper", "rrc_uper", "rrc_msgs", "s1ap_per", "s1ap_ies",
          "s1ap_msgs", "nas_msgs", "tft", "usim", "pdcp", "pdcp_nr", "rlc_um", "rlc_am",
          "mac_pdu", "sched", "enb_mac", "ue_mac", "nas_ue", "rrc_idle", "rrc_meas", "rrc_ue",
          "rrc_enb", "epc", "mac_pdu_nr", "rlc_nr", "nas_5gs_codec", "nas_5g", "ngap",
          "rrc_nr_uper", "rrc_nr", "sched_nr", "ue_mac_nr")


def h(s: str) -> bytes:
    return bytes.fromhex(s)


@pytest.mark.parametrize("name", COPIED)
def test_copied_module_equals_jax_source(name):
    jax_src = (REPO / "srsran_4g_tpu" / "stack" / f"{name}.py").read_text()
    port_src = (REPO / "srsran_4g_tpu_torch" / "stack" / f"{name}.py").read_text()
    assert port_src == re.sub(r"\bsrsran_4g_tpu\.", "srsran_4g_tpu_torch.", jax_src)
    mod = importlib.import_module(f"srsran_4g_tpu_torch.stack.{name}")
    assert mod.__file__.endswith(f"srsran_4g_tpu_torch/stack/{name}.py")


def test_security_published_vectors():
    # FIPS-197 Appendix C.1
    assert t_sec._aes_block(h("000102030405060708090a0b0c0d0e0f"),
                            h("00112233445566778899aabbccddeeff")) == \
        h("69c4e0d86a7b0430d8cdb78070b4c55a")
    # RFC 4493 §4, examples 1 and 2
    k = h("2b7e151628aed2a6abf7158809cf4f3c")
    assert t_sec._aes_cmac(k, b"") == h("bb1d6929e95937287fa37d129b756746")
    assert t_sec._aes_cmac(k, h("6bc1bee22e409f96e93d7e117393172a")) == \
        h("070a16b46b4d4144f79bdd9dd04a287c")
    # TS 35.208 test set 1
    k = h("465b5ce8b199b49faa5f0a2ee238a6bc")
    opc = t_sec.opc_from_op(k, h("cdc202d5123e20f62b6d676ac72cb318"))
    assert opc == h("cd63cb71954a9f4e48a5994e37a02baf")
    assert t_sec.milenage(k, opc, h("23553cbe9637a89d218ae64dae47bf35"), h("ff9bb4d0b607"),
                          h("b9b9")) == (
        h("4a9ffac354dfafb3"), h("a54211d5e3ba50bf"), h("b40ba9a3c58b2a05bbf0d987b21bf8cb"),
        h("f769bcd751044604127672711c6d3441"), h("aa689c648370"))
    # TS 33.401 C.1 128-EEA2 test set 1
    key = h("d3c5d592327fb11c4035c6680af8c6d1")
    plain = h("981ba6824c1bfb1ab485472029b71d808ce33e2cc3c0b5fc1f3de8a6dc66b1f0")
    ct = h("e9fed8a63d155304d71df20bf3e82214b20ed7dad2f233dc3c22d7bdeeed8e78")
    assert t_sec.eea2(key, 0x398A59B4, 0x15, 1, plain) == ct
    assert t_sec.cipher(2, key, 0x398A59B4, 0x15, 1, ct) == plain
    # TS 33.401 C.2 128-EIA2 test set 5
    msg = h("35c68716633c66fb750c266865d53c11ea05b1e9fa49c8398d48e1efa5909d39"
            "47902837f5ae96d5a05bc8d61ca8dbef1b13a4b4abfe4fb1006045b674bb5472"
            "9304c382be53a5af05556176f6eaa2ef1d05e4b083181ee674cda5a485f74d7a")
    key = h("83fd23a244a74cf358da3019f1722635")
    assert t_sec.eia2(key, 0x36AF6144, 0x0F, 1, msg) == h("e657e182")
    assert t_sec.integrity(2, key, 0x36AF6144, 0x0F, 1, msg) == h("e657e182")


def test_security_matches_jax_on_random_inputs():
    rng = random.Random(20)

    def rb(n):
        return bytes(rng.getrandbits(8) for _ in range(n))

    for n in (0, 1, 5, 15, 16, 17, 31, 32, 33, 48, 100, 257, 1500):
        key, data = rb(16), rb(n)
        count, bearer, direction = rng.getrandbits(32), rng.getrandbits(5), rng.getrandbits(1)
        for alg in (0, 1, 2, 3):
            assert t_sec.cipher(alg, key, count, bearer, direction, data) == \
                j_sec.cipher(alg, key, count, bearer, direction, data), (alg, n)
        for alg in (1, 2, 3):
            assert t_sec.integrity(alg, key, count, bearer, direction, data) == \
                j_sec.integrity(alg, key, count, bearer, direction, data), (alg, n)
    for _ in range(8):
        k, op, rand, sqn, amf = rb(16), rb(16), rb(16), rb(6), rb(2)
        opc = t_sec.opc_from_op(k, op)
        assert opc == j_sec.opc_from_op(k, op)
        assert t_sec.milenage(k, opc, rand, sqn, amf) == j_sec.milenage(k, opc, rand, sqn, amf)
    ck, ik, plmn, sqn_ak = rb(16), rb(16), rb(3), rb(6)
    ka = t_sec.k_asme(ck, ik, plmn, sqn_ak)
    assert ka == j_sec.k_asme(ck, ik, plmn, sqn_ak)
    ke = t_sec.k_enb(ka, 7)
    assert ke == j_sec.k_enb(ka, 7)
    for which in ("rrc_enc", "rrc_int", "up_enc", "up_int"):
        assert t_sec.k_rrc_up(ke, 2, which) == j_sec.k_rrc_up(ke, 2, which)
    with pytest.raises(ValueError):
        t_sec._aes_block(bytes(15), bytes(16))


def _attach_exchange(pkg: str) -> tuple[list, dict]:
    """test_attach's lossless in-process wiring of UE, eNB and EPC from
    package ``pkg``, run through attach and one ciphered DRB packet each
    way; returns every PDU in the order sent and the end state."""
    R = importlib.import_module(f"{pkg}.stack.rrc_enb")
    U = importlib.import_module(f"{pkg}.stack.rrc_ue")
    N = importlib.import_module(f"{pkg}.stack.nas_ue")
    E = importlib.import_module(f"{pkg}.stack.epc")
    S = importlib.import_module(f"{pkg}.stack.usim")
    cfg = S.UsimConfig()
    hss = E.Hss()
    hss.add_subscriber(cfg.imsi, cfg.k, cfg.opc)
    mme = E.Mme(hss=hss)
    enb = R.RrcEnb(cell=R.EnbCellConfig())
    ue = U.RrcUe(nas=N.NasUe(S.Usim(cfg)))
    log: list = []
    q_ue2enb, q_enb2ue, q_enb2mme, q_mme2enb = [], [], [], []

    def rec(kind, q):
        return lambda *a: (log.append((kind,) + a), q.append(a if len(a) > 1 else a[0]))

    ue.tx = rec("ul_rrc", q_ue2enb)
    enb.tx_rrc = rec("dl_rrc", q_enb2ue)
    enb.tx_s1ap = rec("s1ap_ul", q_enb2mme)

    def pump():
        for _ in range(50):
            if not (q_ue2enb or q_enb2ue or q_enb2mme or q_mme2enb):
                return
            while q_ue2enb:
                lcid, pdu = q_ue2enb.pop(0)
                if lcid == 0:
                    enb.rx_ccch(0, pdu)
                else:
                    enb.rx_dcch(enb.next_rnti - 1, lcid, pdu)
            while q_enb2ue:
                rnti, lcid, pdu = q_enb2ue.pop(0)
                if lcid == 0:
                    ue.c_rnti = rnti or ue.c_rnti
                    ue.rx_ccch(pdu)
                else:
                    ue.rx_dcch(lcid, pdu)
            while q_enb2mme:
                for rsp in mme.rx_s1ap(q_enb2mme.pop(0)):
                    log.append(("s1ap_dl", rsp))
                    q_mme2enb.append(rsp)
            while q_mme2enb:
                enb.rx_s1ap(q_mme2enb.pop(0))

    enb.s1_setup()
    ue.connect()
    pump()
    sent: list = []
    ue.tx = lambda lcid, pdu: sent.append((lcid, pdu))
    ue.write_drb_sdu(3, b"ping-payload-1234")
    log.append(("ul_drb",) + sent[-1])
    up = enb.drb_rx(ue.c_rnti, 3, sent[-1][1])
    dl = enb.drb_tx(ue.c_rnti, 3, b"pong-payload-5678")
    log.append(("dl_drb", dl))
    state = dict(ue_state=ue.state, registered=ue.nas.is_registered(), ip=ue.nas.ip_addr,
                 attached=mme.attached_ues(), k_enb=enb.ues[ue.c_rnti].k_enb,
                 ue_k_enb=ue.nas.get_k_enb(), drbs=ue.drb_lcids, up=up,
                 down=ue.rx_drb_pdu(3, dl),
                 session=dataclasses.astuple(mme.spgw.sessions[cfg.imsi]))
    return log, state


def test_attach_exchange_matches_jax(monkeypatch):
    """Every PDU of the attach and a ciphered DRB round trip, in both
    packages with the same ``os.urandom`` stream (the EPC's RAND)."""
    runs = []
    for pkg in ("srsran_4g_tpu", "srsran_4g_tpu_torch"):
        rng = random.Random(33)
        monkeypatch.setattr(os, "urandom", lambda n, rng=rng: rng.randbytes(n))
        runs.append(_attach_exchange(pkg))
    (j_log, j_state), (t_log, t_state) = runs
    assert [e[0] for e in t_log] == [e[0] for e in j_log]
    kinds = {e[0] for e in j_log}
    assert {"ul_rrc", "dl_rrc", "s1ap_ul", "s1ap_dl", "ul_drb", "dl_drb"} <= kinds
    assert len(j_log) > 20
    for i, (a, b) in enumerate(zip(t_log, j_log)):
        assert a == b, (i, a[0])
    assert t_state == j_state
    assert t_state["registered"] and t_state["ue_state"] == "CONNECTED"
    assert t_state["k_enb"] == t_state["ue_k_enb"]
    assert t_state["up"] == [b"ping-payload-1234"]
    assert t_state["down"] == [b"pong-payload-5678"]
