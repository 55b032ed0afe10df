"""Port parity: the NR PDSCH slice (grid_nr, sch_nr, pdsch_nr, the NR
``convert`` functions and the copied dci_nr, ra_nr and harq_ack_nr) against
the JAX package on the same numpy inputs, at the shapes of
tests/test_sch_nr.py and test_nr_phy.py (24 PRB carrier).

Tolerances: coded bits, decoded bits, CRC flags and payloads identical;
grids, channel estimates, noise variances and combined LLRs (the HARQ
soft-buffers) within rtol 1e-4 / atol 1e-3, the LLR bar of
tests/test_torch_phy.py (float32 sums in another order; at 30 dB a 256QAM
LLR reaches ~1,600, where one float32 rounding is already ~1e-4).
The JAX side runs under ``jax.jit``, one compiled function per config.
Noise is a numpy array added to the same transmitted grid on both sides.
"""

import dataclasses
import functools
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_4g_tpu.models import dci_nr as jdci
from srsran_4g_tpu.models import grid_nr as jgrid
from srsran_4g_tpu.models import harq_ack_nr as jack
from srsran_4g_tpu.models import pdsch_nr as jpdsch
from srsran_4g_tpu.models import ra_nr as jra
from srsran_4g_tpu.models import sch_nr as jsch
from srsran_4g_tpu_torch import convert
from srsran_4g_tpu_torch.models import dci_nr, grid_nr, harq_ack_nr, pdsch_nr, ra_nr, sch_nr

torch.set_num_threads(2)

# The JAX side runs once per config: the encoders (a few hundred rolls of
# the LDPC rows) are compiled for speed of compiling, the decoders for a
# quick run (the same results either way).
_FAST = dict(xla_cpu_use_fusion_emitters=False, xla_cpu_parallel_codegen_split_count=1)
_jit_enc = functools.partial(jax.jit, compiler_options=dict(_FAST,
                                                            xla_backend_optimization_level=0))
_jit_dec = functools.partial(jax.jit, compiler_options=_FAST)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-3)
CAR = dict(nof_prb=24, pci=101)
RNTI = 0x4601


def _awgn_llr(bits, snr_db, rng):
    s2 = 10 ** (-snr_db / 10)
    y = (1 - 2 * bits.astype(np.float64)) + rng.standard_normal(bits.shape) * np.sqrt(s2)
    return (-2 * y / s2).astype(np.float32)


def _cfgs(**kw):
    """The same PDSCH config in both packages (the port's through convert)."""
    j = jpdsch.PdschNrConfig(carrier=jgrid.NrCarrierConfig(**CAR), rnti=RNTI, slot=3, **kw)
    return j, convert.pdsch_nr_config_from_dict(dataclasses.asdict(j))


def _soft_np(soft):
    return {k: np.asarray(v) for k, v in soft.items()}


def _assert_soft(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL)


@pytest.mark.parametrize("name", ("dci_nr", "ra_nr", "harq_ack_nr"))
def test_copied_nr_module_equals_jax_source(name):
    jax_src = (REPO / "srsran_4g_tpu" / "models" / f"{name}.py").read_text()
    port_src = (REPO / "srsran_4g_tpu_torch" / "models" / f"{name}.py").read_text()
    assert port_src == re.sub(r"\bsrsran_4g_tpu\.", "srsran_4g_tpu_torch.", jax_src)
    mod = importlib.import_module(f"srsran_4g_tpu_torch.models.{name}")
    assert mod.__file__.endswith(f"srsran_4g_tpu_torch/models/{name}.py")


def test_copied_nr_modules_match_jax():
    for n_rb in (24, 52, 273):
        d10 = dict(n_rb=n_rb, rb_start=3, l_rbs=n_rb - 5, time_assign=2, mcs=27, ndi=1, rv=2,
                   harq_pid=9, dai=3, tpc=1, pucch_res=5, harq_timing=4)
        assert dci_nr.DciNr10(**d10).pack() == jdci.DciNr10(**d10).pack()
        assert dci_nr.DciNr10(**d10).nof_bits == jdci.DciNr10(**d10).nof_bits
        packed = jdci.DciNr10(**d10).pack()
        assert dataclasses.asdict(dci_nr.DciNr10.unpack(packed, n_rb)) == d10
        d00 = dict(n_rb=n_rb, rb_start=1, l_rbs=4, mcs=9, rv=3, harq_pid=2, tpc=2,
                   target_bits=jdci.DciNr10(n_rb=n_rb).nof_bits)
        assert dci_nr.DciNr00(**d00).pack() == jdci.DciNr00(**d00).pack()
        for mcs in range(28):
            assert ra_nr.dl_tbs(mcs, n_rb) == jra.dl_tbs(mcs, n_rb)
    for v in range(14 * 8):
        assert ra_nr.sliv_decode(14, v) == jra.sliv_decode(14, v)
    rx = [(1, True), (3, False), (4, True), (2, True)]
    assert harq_ack_nr.type2_codebook(rx) == jack.type2_codebook(rx)
    occ = [(0, 0), (1, 0), (1, 1), (3, 0)]
    acks = {(1, 0): True, (3, 0): True}
    assert harq_ack_nr.type1_codebook(occ, acks) == jack.type1_codebook(occ, acks)
    assert harq_ack_nr.multiplex_with_sr([1, 0], True) == jack.multiplex_with_sr([1, 0], True)


def test_nr_segment_matches():
    for args in ((200, 1200, 2, 0), (3000, 6144, 2, 1), (4000, 20000, 2, 2),
                 (20000, 36864, 4, 3), (213176, 288288, 8, 0), (159880, 216216, 6, 0),
                 (40000, 72072, 2, 2), (8450, 9000, 6, 0)):
        j = jsch.nr_segment(*args)
        got = sch_nr.nr_segment(*args)
        assert dataclasses.asdict(got) == dataclasses.asdict(j)
        assert convert.nr_segm_from_dict(dataclasses.asdict(j)) == got


def test_grid_nr_matches():
    jc, c = jgrid.NrCarrierConfig(nof_prb=24, pci=101, scs_khz=30), grid_nr.NrCarrierConfig(
        nof_prb=24, pci=101, scs_khz=30)
    assert (c.mu, c.nre, c.slots_per_frame, c.symbol_sz) == (
        jc.mu, jc.nre, jc.slots_per_frame, jc.symbol_sz)
    for slot, sym in ((0, 2), (7, 11), (19, 3)):
        np.testing.assert_array_equal(grid_nr.dmrs_symbols_type1(24, slot, sym, 101),
                                      jgrid.dmrs_symbols_type1(24, slot, sym, 101))
    rng = np.random.default_rng(3)
    g = (rng.standard_normal((2, 14, c.nre)) + 1j * rng.standard_normal((2, 14, c.nre))
         ).astype(np.complex64)
    for syms in ((2, 11), (3,)):
        np.testing.assert_array_equal(
            grid_nr.put_dmrs_type1(torch.as_tensor(g), c, 5, syms).numpy(),
            np.asarray(jgrid.put_dmrs_type1(jnp.asarray(g), jc, 5, syms)))
    for kw in (dict(), dict(rb_start=4, nof_rb=10, start_sym=2, nof_syms=10)):
        np.testing.assert_array_equal(grid_nr.data_re_indices_type1(c, **kw),
                                      jgrid.data_re_indices_type1(jc, **kw))


@pytest.mark.parametrize("tbs,g,qm,snr_db", [(280, 1000, 2, 0.0), (20000, 36864, 4, 2.0)])
def test_sch_nr_chain_matches(tbs, g, qm, snr_db):
    """Encode, then a decode near the waterfall: bits, CRC flags and the
    combined LLRs agree."""
    seg = sch_nr.nr_segment(tbs, g, qm)
    rng = np.random.default_rng(tbs)
    bits = rng.integers(0, 2, (2, tbs)).astype(np.int8)
    cw = np.asarray(_jit_enc(lambda b: jsch.encode(jsch.nr_segment(tbs, g, qm), b))(bits))
    np.testing.assert_array_equal(sch_nr.encode(seg, torch.as_tensor(bits)).numpy(), cw)
    llr = _awgn_llr(cw, snr_db, rng)
    want = _jit_dec(lambda x: jsch.decode(jsch.nr_segment(tbs, g, qm), x, n_iter=8))(llr)
    got = sch_nr.decode(seg, torch.as_tensor(llr), n_iter=8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _assert_soft(got[2], _soft_np(want[2]))


def test_sch_nr_harq_matches_across_packages():
    """rv 0 fails at -1 dB; rv 2 combined with its soft-buffers decodes, on
    either package, with the soft-buffers carried across through convert."""
    tbs, g = 3000, 4608
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (2, tbs)).astype(np.int8)
    segs = {rv: (jsch.nr_segment(tbs, g, 2, rv=rv), sch_nr.nr_segment(tbs, g, 2, rv=rv))
            for rv in (0, 2)}
    llr = {rv: _awgn_llr(sch_nr.encode(segs[rv][1], torch.as_tensor(bits)).numpy(), -1.0, rng)
           for rv in (0, 2)}
    jdec0 = _jit_dec(lambda x: jsch.decode(segs[0][0], x))
    jdec2 = _jit_dec(lambda x, sb: jsch.decode(segs[2][0], x, softbuffers=sb, n_iter=25))
    _, ok0, soft0 = jdec0(llr[0])
    t_bits0, t_ok0, t_soft0 = sch_nr.decode(segs[0][1], torch.as_tensor(llr[0]))
    np.testing.assert_array_equal(t_ok0.numpy(), np.asarray(ok0))
    assert not t_ok0.all()
    _assert_soft(t_soft0, _soft_np(soft0))
    # JAX rv 0 → port rv 2, and port rv 0 → JAX rv 2
    got = sch_nr.decode(segs[2][1], torch.as_tensor(llr[2]), n_iter=25,
                        softbuffers=convert.softbuffers_from_numpy(_soft_np(soft0), "cpu"))
    want = jdec2(llr[2], {k: jnp.asarray(v) for k, v in
                          convert.softbuffers_to_numpy(t_soft0).items()})
    assert got[1].all() and bool(np.asarray(want[1]).all())
    np.testing.assert_array_equal(got[0].numpy(), bits)
    np.testing.assert_array_equal(np.asarray(want[0]), bits)
    _assert_soft(got[2], _soft_np(want[2]))


@pytest.mark.parametrize("mod,tbs,snr_db", [("qpsk", 1032, 5.0), ("64qam", 8448, 22.0),
                                            ("256qam", 16896, 30.0)])
def test_pdsch_nr_matches(mod, tbs, snr_db):
    """Encode, AWGN from one numpy array, decode: channel estimate and noise
    variance within tolerance; bits, CRC flags and combined LLRs identical.
    The 256QAM grid is held against JAX's encode (the LDPC encoder is
    compiled once in this file for it); the others are the port's."""
    jcfg, cfg = _cfgs(mod=mod, tbs=tbs)
    rng = np.random.default_rng(tbs)
    bits = rng.integers(0, 2, (2, tbs)).astype(np.int8)
    tx = pdsch_nr.encode(cfg, torch.as_tensor(bits)).numpy()
    if mod == "256qam":
        np.testing.assert_allclose(tx, np.asarray(_jit_enc(lambda b: jpdsch.encode(jcfg, b))(
            bits)), **TOL)
    nv = 10 ** (-snr_db / 10)
    rx = (tx + np.sqrt(nv / 2) * (rng.standard_normal(tx.shape)
                                  + 1j * rng.standard_normal(tx.shape))).astype(np.complex64)
    jest = _jit_dec(lambda r: jpdsch.estimate(jcfg, r))(rx)
    est = pdsch_nr.estimate(cfg, torch.as_tensor(rx))
    np.testing.assert_allclose(est["h"].numpy(), np.asarray(jest["h"]), **TOL)
    np.testing.assert_allclose(est["noise_var"].numpy(), np.asarray(jest["noise_var"]), **TOL)
    want = _jit_dec(lambda r: jpdsch.decode(jcfg, r))(rx)
    got = pdsch_nr.decode(cfg, torch.as_tensor(rx))
    np.testing.assert_array_equal(got["crc_ok"].numpy(), np.asarray(want["crc_ok"]))
    np.testing.assert_array_equal(got["bits"].numpy(), np.asarray(want["bits"]))
    assert got["crc_ok"].all()
    np.testing.assert_array_equal(got["bits"].numpy(), bits)
    _assert_soft(got["softbuffers"], _soft_np(want["softbuffers"]))


def test_pdsch_nr_harq_ir_matches():
    """16QAM rv 0 then rv 2 at 3.5 dB (tests/test_nr_phy.py's HARQ point),
    the combined decode on both sides from the same soft-buffers."""
    (jcfg0, cfg0), (jcfg2, cfg2) = _cfgs(mod="16qam", tbs=4224), _cfgs(mod="16qam", tbs=4224, rv=2)
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (2, 4224)).astype(np.int8)
    nv = 10 ** (-3.5 / 10)

    def rx_of(cfg):
        tx = pdsch_nr.encode(cfg, torch.as_tensor(bits)).numpy()
        return (tx + np.sqrt(nv / 2) * (rng.standard_normal(tx.shape)
                                        + 1j * rng.standard_normal(tx.shape))).astype(np.complex64)

    rx0, rx2 = rx_of(cfg0), rx_of(cfg2)
    want0 = _jit_dec(lambda r: jpdsch.decode(jcfg0, r))(rx0)
    got0 = pdsch_nr.decode(cfg0, torch.as_tensor(rx0))
    np.testing.assert_array_equal(got0["crc_ok"].numpy(), np.asarray(want0["crc_ok"]))
    want2 = _jit_dec(lambda r, sb: jpdsch.decode(jcfg2, r, softbuffers=sb))(
        rx2, want0["softbuffers"])
    got2 = pdsch_nr.decode(cfg2, torch.as_tensor(rx2), softbuffers=got0["softbuffers"])
    np.testing.assert_array_equal(got2["crc_ok"].numpy(), np.asarray(want2["crc_ok"]))
    np.testing.assert_array_equal(got2["bits"].numpy(), np.asarray(want2["bits"]))
    assert got2["crc_ok"].all()
    np.testing.assert_array_equal(got2["bits"].numpy(), bits)
    _assert_soft(got2["softbuffers"], _soft_np(want2["softbuffers"]))
