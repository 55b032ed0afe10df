"""Port parity: the sidelink — ``models/ra_sl`` (a copy), ``models/sidelink``
and ``models/sl_rx`` — against the JAX package on the same numpy inputs, at
the shapes of tests/test_sidelink_data.py and test_ref_captures_sl.py.

The TM3/4 signals come from the transmitter fixture of ``chip_smoke.py``
(the JAX package has none); each capture is first decoded by the JAX
receiver, every SCI and TB, so the fixture does not rest on the port alone.
Noise is a numpy array added to the same signal on both sides.  The JAX
side runs under ``jax.jit`` with the fast-compile options; its host-loop
receivers (``pscch34_decode``, ``pssch34_decode``, ``decode_capture``) run
eagerly with their Viterbi and DL-SCH decode jitted.  Both turbo decoders run
f32 (``TURBO_KERNEL=v4`` on the port).  Tolerances: bits, CRC flags, SCI
fields, offsets and ``events`` identical; grids and metrics within rtol 1e-4
/ atol 1e-3.
"""

import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from srsran_4g_tpu.models import ra_sl as j_ra_sl
from srsran_4g_tpu.models import sch as j_sch
from srsran_4g_tpu.models import sidelink as j_sl
from srsran_4g_tpu.models import sl_rx as j_rx
from srsran_4g_tpu.ops import convcode as j_conv
from srsran_4g_tpu_torch import convert
from srsran_4g_tpu_torch.models import ra, ra_sl, sidelink as SL, sl_rx

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-3)
CPU = torch.device("cpu")
FAST = dict(xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
            xla_cpu_parallel_codegen_split_count=1)


@functools.lru_cache(maxsize=None)
def _jit(fn, *static, **kw):
    """fn with its leading and keyword arguments fixed, under jax.jit (fast
    compile)."""
    return jax.jit(functools.partial(fn, *static, **kw), compiler_options=FAST)


def _jit_when_eager(fn, **static):
    """fn under jax.jit (fast compile) when called eagerly; inside another
    jit, fn itself."""
    jitted = jax.jit(fn, compiler_options=FAST, **static)

    def call(*args, **kw):
        traced = any(isinstance(a, jax.core.Tracer) for a in args)
        return (fn if traced else jitted)(*args, **kw)
    return call


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_receivers():
    """The JAX host-loop receivers' Viterbi, DL-SCH decode and PSBCH receive
    under jax.jit (eagerly, each call would compile op by op and its scans
    again), and the port's f32 turbo."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_conv, "viterbi_decode", _jit_when_eager(
            j_conv.viterbi_decode, static_argnames=("tail_biting",)))
        mp.setattr(j_sch, "dlsch_decode", _jit_when_eager(
            j_sch.dlsch_decode, static_argnums=(0,),
            static_argnames=("n_iter", "window", "early_stop", "cb_shard")))
        mp.setattr(j_sl, "pssch_decode", _jit_when_eager(
            j_sl.pssch_decode, static_argnums=(0, 2), static_argnames=("n_iter",)))
        mp.setattr(j_sl, "psbch_rx_subframe", _jit_when_eager(
            j_sl.psbch_rx_subframe, static_argnums=(0, 1, 3), static_argnames=("tm", "ext_cp")))
        mp.setattr(j_sl, "pssch_decode", _jit_when_eager(
            j_sl.pssch_decode, static_argnums=(0, 2), static_argnames=("n_iter",)))
        mp.setattr(j_sl, "psbch_rx_subframe", _jit_when_eager(
            j_sl.psbch_rx_subframe, static_argnums=(0, 1, 3), static_argnames=("tm", "ext_cp")))
        mp.setenv("TURBO_KERNEL", "v4")
        yield


def _noise(rng, shape, nv):
    return (np.sqrt(nv / 2) * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _events(r):
    """``events`` with each SCI as its fields (the two packages' classes differ)."""
    return [dict(e, sci=dataclasses.asdict(e["sci"])) if "sci" in e else e for e in r["events"]]


def test_ra_sl_copy_and_trp_tables():
    jax_src = (REPO / "srsran_4g_tpu" / "models" / "ra_sl.py").read_text()
    port_src = (REPO / "srsran_4g_tpu_torch" / "models" / "ra_sl.py").read_text()
    assert port_src == re.sub(r"\bsrsran_4g_tpu\.", "srsran_4g_tpu_torch.", jax_src)
    assert (REPO / "srsran_4g_tpu_torch/utils/trp_tables.npz").read_bytes() == \
        (REPO / "srsran_4g_tpu/utils/trp_tables.npz").read_bytes()
    bitmap = np.zeros(40, np.uint8)
    bitmap[::4] = 1
    for n in (0, 13, 37):
        assert ra_sl.pscch_resources(4, 2, 22, bitmap, n) == \
            j_ra_sl.pscch_resources(4, 2, 22, bitmap, n)
    for k in (1, 4, 8):
        idx = ra_sl.trp_idx_from_k(8, k)
        assert idx == j_ra_sl.trp_idx_from_k(8, k)
        assert [ra_sl.pssch_allowed_sf(i, idx) for i in range(16)] == \
            [j_ra_sl.pssch_allowed_sf(i, idx) for i in range(16)]


def test_sync_sequences_and_detectors():
    for root in (26, 37):
        np.testing.assert_array_equal(SL.psss_sequence(root), j_sl.psss_sequence(root))
    for nid in (0, 167, 168, 335):
        np.testing.assert_array_equal(SL.ssss_sequence(nid), j_sl.ssss_sequence(nid))
    rng = np.random.default_rng(3)
    ids = (5, 170, 335)
    rx = np.stack([SL.ssss_sequence(i) for i in ids]) + _noise(rng, (3, 62), 0.5)
    got, want = SL.ssss_detect(_t(rx)), _jit(j_sl.ssss_detect)(jnp.asarray(rx))
    np.testing.assert_array_equal(_np(got["n_sl_id"]), ids)
    np.testing.assert_array_equal(_np(got["n_sl_id"]), np.asarray(want["n_sl_id"]))
    np.testing.assert_allclose(_np(got["metric"]), np.asarray(want["metric"]), **TOL)
    rx = np.stack([SL.psss_for_id(i) for i in ids]) + _noise(rng, (3, 62), 0.5)
    got, want = SL.psss_detect(_t(rx)), _jit(j_sl.psss_detect)(jnp.asarray(rx))
    np.testing.assert_array_equal(_np(got["root_idx"]), [0, 1, 1])
    np.testing.assert_array_equal(_np(got["root_idx"]), np.asarray(want["root_idx"]))
    np.testing.assert_allclose(_np(got["metric"]), np.asarray(want["metric"]), **TOL)


def test_mib_and_sci_pack_unpack():
    mib = dict(sl_bandwidth=50, tdd_config=2, direct_frame_number=514,
               direct_subframe_number=3, in_coverage=False)
    assert convert.mib_sl_from_dict(dataclasses.asdict(j_sl.MibSl(**mib))) == SL.MibSl(**mib)
    for v2x in (False, True):
        bits = SL.MibSl(**mib).pack(v2x=v2x)
        np.testing.assert_array_equal(bits, j_sl.MibSl(**mib).pack(v2x=v2x))
        assert dataclasses.asdict(SL.MibSl.unpack(bits)) == mib
    sci0 = dict(freq_hopping=True, riv=113, trp=0x2A, mcs=9, timing_advance=700,
                group_dst_id=0xA5)
    for n in (25, 50, 100):
        bits = SL.SciFormat0(**sci0).pack(n)
        np.testing.assert_array_equal(bits, j_sl.SciFormat0(**sci0).pack(n))
        assert dataclasses.asdict(SL.SciFormat0.unpack(bits, n)) == sci0
        assert SL.sci0_n_x_id(bits) == j_sl.sci0_n_x_id(bits)
    sci1 = dict(priority=5, resource_reserv=9, riv=12, time_gap=7, mcs=22, retransmission=1,
                transmission_format=1)
    for n in (5, 10):
        bits = SL.SciFormat1(**sci1).pack(n)
        np.testing.assert_array_equal(bits, j_sl.SciFormat1(**sci1).pack(n))
        assert dataclasses.asdict(SL.SciFormat1.unpack(bits, n)) == \
            dataclasses.asdict(j_sl.SciFormat1.unpack(bits, n))


@pytest.mark.parametrize("tm", [2, 4])
def test_psbch_codecs(tm):
    """Both PSBCH codecs through noise, the self-loop cases of
    tests/test_ref_captures_sl.py (TM1/2: N_SL_ID 0, 1, 168, 335; TM3/4:
    169, 170, 335), the JAX package at one N_SL_ID of each list."""
    rng = np.random.default_rng(tm)
    mib = j_sl.MibSl(sl_bandwidth=50, direct_frame_number=514 if tm == 2 else 100,
                     direct_subframe_number=3 if tm == 2 else 2, in_coverage=tm == 2)
    bits = mib.pack(v2x=tm == 4)[None]
    for nid in ((0, 1, 168, 335) if tm == 2 else (169, 170, 335)):
        got = SL.psbch_tx_subframe(nid, 50, _t(bits), tm=tm)
        rx = got.numpy() + _noise(rng, got.shape, 0.05)
        out = SL.psbch_rx_subframe(nid, 50, _t(rx), tm=tm)
        assert bool(out["crc_ok"][0]), nid
        assert SL.MibSl.unpack(out["mib"][0].numpy()) == SL.MibSl(**dataclasses.asdict(mib))
        if nid in (1, 170):
            want = np.asarray(_jit(j_sl.psbch_tx_subframe, nid, 50, tm=tm)(jnp.asarray(bits)))
            np.testing.assert_allclose(got.numpy(), want, **TOL)
            jout = j_sl.psbch_rx_subframe(nid, 50, jnp.asarray(rx), 1e-2, tm=tm)
            for k in ("mib", "crc_ok"):
                np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    if tm == 2:   # the RE-level codec of the framework's own loop tests
        mbits = np.random.default_rng(5).integers(0, 2, (3, SL.MIB_SL_LEN)).astype(np.int8)
        want = np.asarray(_jit(j_sl.psbch_encode, 301)(jnp.asarray(mbits)))
        got = SL.psbch_encode(301, _t(mbits))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        rx = want + _noise(rng, want.shape, 0.3)
        jout = _jit(j_sl.psbch_decode, 301)(jnp.asarray(rx))
        out = SL.psbch_decode(301, _t(rx))
        for k in ("mib", "crc_ok"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
        np.testing.assert_array_equal(out["mib"].numpy(), mbits)


@pytest.mark.parametrize("mod,tbs", [("qpsk", 328), ("16qam", 936)])
def test_pscch_pssch_tm12(mod, tbs):
    """tests/test_sidelink_data.py's shapes: the SCI-0 PSCCH at PRB 5 of 25
    and the PSSCH (6 PRB at PRB 6) through noise."""
    rng = np.random.default_rng(tbs)
    ctrl = dict(nof_prb_cell=25, nof_prb_sl=50, prb_start=5)
    sci = j_sl.SciFormat0(riv=113, trp=0x2A, mcs=9, group_dst_id=0xA5).pack(nof_prb=50)
    sci = np.tile(sci, (2, 1))
    jc = j_sl.PscchConfig(**ctrl)
    pc = convert.pscch_config_from_dict(dataclasses.asdict(jc))
    assert pc == SL.PscchConfig(**ctrl) and pc.sci_len == jc.sci_len
    data = dict(tbs=tbs, nof_prb_cell=25, prb_start=6, nof_prb=6, mod=mod, n_x_id=0xBEEF,
                sf_idx=4)
    jd = j_sl.PsschConfig(**data)
    pd = convert.pssch_config_from_dict(dataclasses.asdict(jd))
    assert pd == SL.PsschConfig(**data) and pd.g_bits == jd.g_bits
    tb = rng.integers(0, 2, size=(2, tbs)).astype(np.int8)
    want = np.asarray(_jit(j_sl.pscch_encode, jc)(jnp.asarray(sci))
                      + _jit(j_sl.pssch_encode, jd)(jnp.asarray(tb)))
    got = SL.pscch_encode(pc, _t(sci)) + SL.pssch_encode(pd, _t(tb))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    rx = want + _noise(rng, want.shape, 0.03 if mod == "16qam" else 0.1)
    jc_out = _jit(j_sl.pscch_decode, jc)(jnp.asarray(rx))
    c_out = SL.pscch_decode(pc, _t(rx))
    for k in ("bits", "crc_ok", "n_x_id"):
        np.testing.assert_array_equal(c_out[k].numpy(), np.asarray(jc_out[k]))
    assert bool(c_out["crc_ok"].all()) and int(c_out["n_x_id"][0]) == SL.sci0_n_x_id(sci[0])
    jd_out = _jit(j_sl.pssch_decode, jd)(jnp.asarray(rx))
    d_out = SL.pssch_decode(pd, _t(rx))
    for k in ("bits", "crc_ok"):
        np.testing.assert_array_equal(d_out[k].numpy(), np.asarray(jd_out[k]))
    np.testing.assert_array_equal(d_out["bits"].numpy(), tb)


def _tm4_capture(lead):
    """SLSS + three data subframes at 25 PRB (5 subchannels of 5 PRB,
    symbol_sz 512): two vehicles of 2 subchannels (8 PRB) at MCS 12, then
    one on subchannel 1 at cyclic shift 3, then none; all retransmissions
    (rv 2)."""
    pool = sl_rx.SlPool.default(25, 4)
    mib = SL.MibSl(sl_bandwidth=25, direct_frame_number=100, in_coverage=False).pack(v2x=True)
    x, sent = chip_smoke.sl_tm4_stream(
        CPU, torch.Generator().manual_seed(lead), np.random.default_rng(lead), pool, 512,
        [[(0, 2, 12, 1), (2, 2, 12, 1)], [(1, 2, 12, 1, 3)], []], 335, mib, lead, 30.0)
    return x, sent, mib


def test_slss_find_and_psbch_sync():
    x, _, mib = _tm4_capture(901)
    xn = x.numpy()
    for root in (26, 37):
        got, want = SL.slss_find(x, 25, 512, root), j_sl.slss_find(xn, 25, 512, root)
        assert got["offset"] == want["offset"]
        np.testing.assert_allclose([got["metric"], got["corr"]], [want["metric"], want["corr"]],
                                   **TOL)
    assert SL.slss_find(x, 25, 512, 37)["offset"] == 901
    got, want = SL.psbch_sync_decode(x, 25, 512, 335, tm=4), \
        j_sl.psbch_sync_decode(xn, 25, 512, 335, tm=4)
    assert got["crc_ok"] and want["crc_ok"] and got["offset"] == want["offset"] == 901 - 8
    np.testing.assert_array_equal(got["mib"], np.asarray(want["mib"]))
    np.testing.assert_array_equal(got["mib"], mib)
    grid = SL.sl_subframe_grid(x[901:901 + 15 * 512], 25, 512)
    np.testing.assert_allclose(grid.numpy(), np.asarray(j_sl.sl_subframe_grid(
        xn[901:901 + 15 * 512], 25, 512)), **TOL)
    np.testing.assert_allclose(SL.sl_demodulate(x[None, 901:901 + 15 * 512], 25).numpy(),
                               np.asarray(j_sl.sl_demodulate(jnp.asarray(
                                   xn[None, 901:901 + 15 * 512]), 25)), **TOL)


def _tm2_capture():
    """SCI-0 on PSCCH PRB 3 in subframes 1 and 2, its PSSCH (6 PRB, QPSK,
    MCS 3: TBS 328, N_X_ID from the SCI's group id) in subframe 3 at rv 0,
    as ``decode_capture`` expects it (TRP with every subframe allowed)."""
    rng = np.random.default_rng(12)
    trp = ra_sl.trp_idx_from_k(8, 8)
    sci = SL.SciFormat0(riv=ra.riv_encode(25, 6, 4), trp=trp, mcs=3, group_dst_id=0x5A)
    ctrl = SL.PscchConfig(nof_prb_cell=25, nof_prb_sl=25, prb_start=3)
    tbs = ra.tbs_from_itbs(ra.ul_mcs_to_itbs(3), 6)
    tb = torch.as_tensor(rng.integers(0, 2, (1, tbs)).astype(np.int8))
    grids = torch.zeros((4, 14, 300), dtype=torch.complex64)
    for sf in (1, 2):
        grids[sf] = SL.pscch_encode(ctrl, _t(sci.pack(25)[None]))[0]
    cfg = SL.PsschConfig(tbs=tbs, nof_prb_cell=25, prb_start=4, nof_prb=6, mod="qpsk",
                         n_x_id=0x5A, sf_idx=0, rv=0)
    grids[3] = SL.pssch_encode(cfg, tb)[0]
    x = chip_smoke.sl_samples(grids, 512).numpy()
    return x + _noise(rng, x.shape, 1e-3), sci, tbs


@pytest.mark.parametrize("tm", [2, 4])
def test_decode_capture(tm, monkeypatch):
    """``decode_capture`` on a TM2 and a TM4 capture: ``events`` equal; on
    the TM4 one also ``pssch34_decode`` at every call JAX's receiver made
    and ``pscch34_decode`` at a sent (subchannel, cyclic shift), held to
    JAX's."""
    calls = {"pssch34_decode": [], "pscch34_blind": []}

    def spy(owner, name):
        orig = getattr(owner, name)

        def call(*args, **kw):
            out = orig(*args, **kw)
            calls[name].append((args, kw, out))
            return out
        monkeypatch.setattr(owner, name, call)

    spy(j_sl, "pssch34_decode")
    spy(j_rx, "pscch34_blind")
    if tm == 2:
        x, sci, tbs = _tm2_capture()
        pool, jpool = sl_rx.SlPool.default(25, 2), j_rx.SlPool.default(25, 2)
        kw = {}
    else:
        x, sent, _ = _tm4_capture(0)
        x = x.numpy()
        jpool = j_rx.SlPool.default(25, 4)
        pool = convert.sl_pool_from_dict(dataclasses.asdict(jpool))
        assert vars(pool).keys() == vars(sl_rx.SlPool.default(25, 4)).keys()
        kw = dict(max_subframes=4)
    want = j_rx.decode_capture(x, 25, tm, 512, jpool, **kw)
    got = sl_rx.decode_capture(_t(x), 25, tm, 512, pool, **kw)
    assert _events(got) == _events(want)
    assert (got["num_decoded_sci"], got["num_decoded_tb"]) == \
        (want["num_decoded_sci"], want["num_decoded_tb"])
    # the fixture's capture, as the JAX receiver reads it: every SCI and TB
    if tm == 2:
        assert want["num_decoded_sci"] == 2 and want["num_decoded_tb"] == 1
        assert [e["sci"] for e in got["events"] if "sci" in e] == [sci, sci]
        assert [e["tbs"] for e in got["events"] if "tbs" in e] == [tbs] == [328]
    else:
        assert want["num_decoded_sci"] == want["num_decoded_tb"] == len(sent) == 3
        assert [(e["sf"], e["sub_channel"], e["tbs"]) for e in want["events"]] == \
            [(s["sf"], s["sub_channel"], s["tbs"]) for s in sent]
        assert [e["sci"] for e in got["events"]] == [s["sci"] for s in sent]
        for (args, kw, jout), s in zip(calls["pssch34_decode"], sent):
            out = SL.pssch34_decode(_t(np.asarray(args[0])), *args[1:], **kw)
            assert (out["tbs"], out["mod"]) == (jout["tbs"], jout["mod"]) == (s["tbs"], "16qam")
            for k in ("bits", "crc_ok"):
                np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
            assert torch.equal(out["bits"][0], s["tb"])
        # pscch34_decode at each hypothesis JAX's blind search passed (its
        # batched pscch34_decode), e.g. subchannel 1 at cyclic shift 3
        hits = [(args[0], h) for args, _, out in calls["pscch34_blind"] for h in out]
        assert [(h["sub_channel"], h["cyclic_shift"]) for _, h in hits][2] == (1, 3)
        for grid, h in hits:
            out = SL.pscch34_decode(_t(grid[None]), 5 * h["sub_channel"], h["cyclic_shift"])
            assert bool(out["crc_ok"][0]) and int(out["n_x_id"][0]) == h["n_x_id"]
            np.testing.assert_array_equal(out["bits"][0].numpy(), h["bits"])
        grid = hits[2][0][None]
        assert not bool(SL.pscch34_decode(_t(grid), 5, 6)["crc_ok"][0])  # a wrong shift
