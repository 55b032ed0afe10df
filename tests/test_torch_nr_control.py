"""Port parity: the NR control channels — ``models/ssb``, ``ue_sync_nr``,
``pdcch_nr`` and ``pucch_nr`` — against the JAX package on the same numpy
inputs, at the shapes of tests/test_nr_phy.py, test_nr_control.py and
test_nr_sa_sync_csi.py.

Noise is a numpy array added to the same transmitted signal on both sides;
the JAX side runs under ``jax.jit`` with the fast-compile options, but for
the ``UeSyncNr`` FSM (a host loop, run eagerly).  Tolerances: bits, CRC
flags, payloads, PCI, NID1/NID2, offsets, aggregation levels and sequences
identical; grids and LLRs within rtol 1e-4 / atol 1e-3; correlation
metrics within atol 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_4g_tpu.models import dci_nr as j_dci
from srsran_4g_tpu.models import pdcch_nr as j_pdcch
from srsran_4g_tpu.models import pucch_nr as j_pucch
from srsran_4g_tpu.models import ssb as j_ssb
from srsran_4g_tpu.models import ue_sync_nr as j_sync
from srsran_4g_tpu_torch import convert
from srsran_4g_tpu_torch.models import pdcch_nr, pucch_nr, ssb, ue_sync_nr

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-3)
CPU = torch.device("cpu")


FAST = dict(xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
            xla_cpu_parallel_codegen_split_count=1)


def _jit(fn, *args, **kw):
    """fn with its leading and keyword arguments fixed, under jax.jit,
    compiled for speed of compiling."""
    return jax.jit(functools.partial(fn, *args, **kw), compiler_options=FAST)


# the JAX encoder turns its payload into a constant with numpy, so every
# argument is static (eagerly, each call would compile op by op: ~4 CPU-s)
J_PDCCH_ENCODE = jax.jit(j_pdcch.encode, static_argnums=(0, 1, 2, 3, 4), compiler_options=FAST)


def _noise(rng, shape, nv):
    return (np.sqrt(nv / 2) * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_ssb_sequences_and_noise_only_search():
    for nid2 in range(3):
        np.testing.assert_array_equal(ssb.pss_sequence(nid2), j_ssb.pss_sequence(nid2))
    for nid1, nid2 in ((0, 0), (1, 0), (111, 2), (335, 1)):
        np.testing.assert_array_equal(ssb.sss_sequence(nid1, nid2),
                                      j_ssb.sss_sequence(nid1, nid2))
    for pci, i_ssb in ((0, 0), (345, 1), (1007, 3)):
        np.testing.assert_array_equal(ssb.pbch_dmrs(pci, i_ssb), j_ssb.pbch_dmrs(pci, i_ssb))
        for got, want in zip(ssb._ssb_re_maps(pci), j_ssb._ssb_re_maps(pci)):
            np.testing.assert_array_equal(got, want)
    # a noise-only capture (tests/test_nr_phy.py): same argmax, same metric
    noise = _noise(np.random.default_rng(0), (2, 4, 240), 2.0)
    want = _jit(j_ssb.search_pci)(noise)
    got = ssb.search_pci(torch.as_tensor(noise))
    for key in ("pci", "nid1", "nid2"):
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]))
    np.testing.assert_allclose(_np(got["metric"]), np.asarray(want["metric"]), atol=1e-3)
    assert float(got["metric"].max()) < 0.3


@pytest.mark.parametrize("pci", [0, 777])
def test_ssb_assemble_search_and_pbch(pci):
    jcfg = j_ssb.SsbConfig(pci=pci)
    cfg = convert.ssb_config_from_dict(dict(pci=pci, i_ssb=0))
    rng = np.random.default_rng(pci)
    payload = rng.integers(0, 2, (2, 32)).astype(np.int8)
    want_tx = np.asarray(_jit(j_ssb.assemble, jcfg)(payload))
    tx = ssb.assemble(cfg, payload, device=CPU)
    np.testing.assert_allclose(tx.numpy(), want_tx, **TOL)
    rx = want_tx + _noise(rng, want_tx.shape, 10 ** -0.8)   # 8 dB
    want = _jit(j_ssb.search_pci)(rx)
    got = ssb.search_pci(torch.as_tensor(rx))
    for key in ("pci", "nid1", "nid2"):
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]))
    assert (_np(got["pci"]) == pci).all()
    np.testing.assert_allclose(_np(got["metric"]), np.asarray(want["metric"]), atol=1e-3)
    want_p = _jit(j_ssb.decode_pbch, jcfg)(rx)
    got_p = ssb.decode_pbch(cfg, torch.as_tensor(rx))
    np.testing.assert_array_equal(_np(got_p["payload"]), np.asarray(want_p["payload"]))
    np.testing.assert_array_equal(_np(got_p["crc_ok"]), np.asarray(want_p["crc_ok"]))
    np.testing.assert_allclose(_np(got_p["snr_est"]), np.asarray(want_p["snr_est"]), rtol=1e-4)
    assert _np(got_p["crc_ok"]).all() and (_np(got_p["payload"]) == payload).all()


def test_ue_sync_nr_find_track_and_loss(monkeypatch):
    """The capture of tests/test_nr_sa_sync_csi.py: PCI 345 after 777 samples
    at 10 dB; offset, PCI and MIB equal; then noise until FIND again.  The
    JAX FSM is a host loop; the search functions it calls are replaced by
    jitted ones (eager JAX compiles op by op)."""
    for mod, name, static in ((j_sync, "pss_time_correlate", (1,)),
                              (j_sync, "extract_ssb_grid", (2, 3)),
                              (j_ssb, "search_pci", ()), (j_ssb, "decode_pbch", (0,))):
        monkeypatch.setattr(mod, name, jax.jit(getattr(mod, name), static_argnums=static,
                                               compiler_options=FAST))
    pci, delay = 345, 777
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 2, (1, 32)).astype(np.int8)
    t = np.asarray(_jit(lambda p: j_sync.ssb_to_samples(
        j_ssb.assemble(j_ssb.SsbConfig(pci=pci), p)))(payload))
    t_port = ue_sync_nr.ssb_to_samples(ssb.assemble(ssb.SsbConfig(pci=pci), payload,
                                                    device=CPU))
    np.testing.assert_allclose(t_port.numpy(), t, **TOL)
    stream = np.concatenate([np.zeros((1, delay), np.complex64), t,
                             np.zeros((1, 500), np.complex64)], axis=-1)
    rx = stream + _noise(rng, stream.shape, 0.1 * float(np.mean(np.abs(t) ** 2)))
    noise = _noise(rng, rx.shape, 1.0)
    j_us, us = j_sync.UeSyncNr(), ue_sync_nr.UeSyncNr()
    for capture in [rx] + [noise] * 6 + [rx]:
        want = j_us.process(jnp.asarray(capture))
        got = us.process(torch.as_tensor(capture))
        assert got.keys() == want.keys()
        for key in ("in_sync", "state", "pci", "offset"):
            assert got.get(key) == want.get(key), key
        assert abs(got["metric"] - want["metric"]) < 1e-3
        if want["in_sync"]:
            assert got["offset"] == delay + 18 and got["pci"] == pci
            np.testing.assert_allclose(got["ssb_grid"].numpy(), np.asarray(want["ssb_grid"]),
                                       **TOL)
            mib, j_mib = us.decode_mib(got["ssb_grid"]), j_us.decode_mib(want["ssb_grid"])
            np.testing.assert_array_equal(mib["payload"].numpy(), np.asarray(j_mib["payload"]))
            assert bool(mib["crc_ok"].all()) and (mib["payload"].numpy() == payload).all()
    assert vars(us.s) == vars(j_us.s)


@pytest.mark.parametrize("nof_prb", [24, 48])
def test_pdcch_nr_encode_and_blind_decode(nof_prb):
    """One DCI per row at each aggregation level the CORESET holds (at 48
    PRB: 8 CCEs, L = 1 at CCE 5 where 108 LLRs fold onto 64 positions, L = 2
    at 2, L = 4 at 4), blind-searched in one batch; the RNTI that was not
    sent finds nothing."""
    d = dict(nof_prb=nof_prb, pci=77, slot=2, start_sym=0, duration=1)
    jcfg, cfg = j_pdcch.CoresetConfig(**d), convert.coreset_config_from_dict(d)
    dci = j_dci.DciNr10(n_rb=52, rb_start=4, l_rbs=24, mcs=17, harq_pid=3)
    a = dci.nof_bits
    rng = np.random.default_rng(nof_prb)
    at = ((1, 1), (2, 2), (4, 0)) if nof_prb == 24 else ((1, 5), (2, 2), (4, 4), (2, 0))
    tx_j, tx_t = [], []
    for agg, start in at:
        bits = rng.integers(0, 2, a).astype(np.int8)
        tx_j.append(np.asarray(J_PDCCH_ENCODE(jcfg, tuple(bits.tolist()), 0x4601, agg,
                                              start))[0])
        tx_t.append(pdcch_nr.encode(cfg, bits, 0x4601, aggregation=agg, start_cce=start,
                                    device=CPU)[0].numpy())
    tx = np.stack(tx_j)
    np.testing.assert_allclose(np.stack(tx_t), tx, **TOL)
    rx = tx + _noise(rng, tx.shape, 0.1)
    want = _jit(j_pdcch.blind_decode, jcfg, rnti=0x4601, dci_len=a)(rx)
    got = pdcch_nr.blind_decode(cfg, torch.as_tensor(rx), rnti=0x4601, dci_len=a)
    for key in ("found", "bits", "agg"):
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]))
    assert _np(got["found"]).all()
    # the unsent RNTI: nothing found (held against JAX at 24 PRB, where its
    # search compiles in a third of the time)
    miss = pdcch_nr.blind_decode(cfg, torch.as_tensor(rx), rnti=0x1234, dci_len=a)
    assert not _np(miss["found"]).any()
    if nof_prb == 24:
        want = _jit(j_pdcch.blind_decode, jcfg, rnti=0x1234, dci_len=a)(rx)
        for key in ("found", "bits", "agg"):
            np.testing.assert_array_equal(_np(miss[key]), np.asarray(want[key]))


def test_pucch_nr_f0_f1():
    rng = np.random.default_rng(5)
    c0 = convert.pucch_nr_f0_config_from_dict(dict(pci=33, initial_shift=0, nof_bits=2))
    jc0 = j_pucch.PucchNrF0Config(pci=33, nof_bits=2)
    seqs = np.stack([np.asarray(j_pucch.f0_encode(jc0, v)) for v in range(4)])
    np.testing.assert_allclose(
        np.stack([pucch_nr.f0_encode(c0, v, device=CPU).numpy() for v in range(4)]), seqs,
        **TOL)
    rx = seqs + _noise(rng, seqs.shape, 10 ** -0.5)
    want, got = _jit(j_pucch.f0_detect, jc0)(rx), pucch_nr.f0_detect(c0, torch.as_tensor(rx))
    np.testing.assert_array_equal(_np(got["value"]), np.asarray(want["value"]))
    np.testing.assert_allclose(_np(got["metric"]), np.asarray(want["metric"]), atol=1e-3)
    assert (_np(got["value"]) == np.arange(4)).all()
    for nof_bits in (1, 2):
        d = dict(pci=33, initial_shift=2, nof_symb=4, occ_idx=1, nof_bits=nof_bits)
        jc1, c1 = j_pucch.PucchNrF1Config(**d), convert.pucch_nr_f1_config_from_dict(d)
        bits = rng.integers(0, 2, (6, nof_bits)).astype(np.int8)
        tx = np.asarray(_jit(j_pucch.f1_encode, jc1)(bits))
        np.testing.assert_allclose(pucch_nr.f1_encode(c1, torch.as_tensor(bits)).numpy(), tx,
                                   **TOL)
        rx = tx + _noise(rng, tx.shape, 10 ** -0.5)
        want, got = _jit(j_pucch.f1_decode, jc1)(rx), pucch_nr.f1_decode(c1, torch.as_tensor(rx))
        np.testing.assert_array_equal(_np(got["bits"]), np.asarray(want["bits"]))
        np.testing.assert_allclose(_np(got["symbol"]), np.asarray(want["symbol"]), **TOL)
        assert (_np(got["bits"]) == bits).all()


@pytest.mark.parametrize("a,prb", [(1, 1), (4, 1), (11, 2), (16, 4)])
def test_pucch_nr_f2(a, prb):
    d = dict(pci=33, rnti=0x777, nof_prb=prb, nof_symb=2, nof_uci_bits=a)
    jcfg, cfg = j_pucch.PucchNrF2Config(**d), convert.pucch_nr_f2_config_from_dict(d)
    rng = np.random.default_rng(a)
    ub = rng.integers(0, 2, (3, a)).astype(np.int8)
    tx = np.asarray(_jit(j_pucch.f2_encode, jcfg)(ub))
    np.testing.assert_allclose(pucch_nr.f2_encode(cfg, torch.as_tensor(ub)).numpy(), tx, **TOL)
    rx = tx + _noise(rng, tx.shape, 0.1)
    want, got = _jit(j_pucch.f2_decode, jcfg)(rx), pucch_nr.f2_decode(cfg, torch.as_tensor(rx))
    np.testing.assert_array_equal(_np(got["bits"]), np.asarray(want["bits"]))
    np.testing.assert_array_equal(_np(got["ok"]), np.asarray(want["ok"]))
    assert (_np(got["bits"]) == ub).all()


@pytest.mark.parametrize("a", [2, 7, 20])
def test_uci_code(a):
    """Repetition (A = 2), RM(32, A) (A = 7) and CRC11 + polar (A = 20) at
    E = 100, where every code repeats and the polar code's 100 bits fold onto
    64 positions: codewords equal, then decoded bits and CRC flags equal near
    the code's threshold, where a different sum order could flip a bit."""
    rng = np.random.default_rng(a)
    bits = rng.integers(0, 2, (64, a)).astype(np.int8)
    e = 100
    cw = np.asarray(_jit(j_pucch.uci_encode, e=e)(bits))
    np.testing.assert_array_equal(pucch_nr.uci_encode(torch.as_tensor(bits), e).numpy(), cw)
    s2 = 10 ** 0.1
    y = (1 - 2 * cw.astype(np.float64)) + rng.standard_normal(cw.shape) * np.sqrt(s2)
    llr = (-2 * y / s2).astype(np.float32)
    want = _jit(j_pucch.uci_decode, a=a)(llr)
    got = pucch_nr.uci_decode(torch.as_tensor(llr), a)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[0].numpy() == bits).all(axis=1).mean() > 0.5
