"""Port parity: the downlink control channels — ``utils/bits``,
``ops/convcode``, the conv rate matching of ``ops/rate_match``,
``models/regs``, ``phich``, ``pbch``, ``pdcch``, ``dci``, ``ra`` and
``enb_dl.assemble_subframe`` with a MIB and DCIs — against the JAX package
on the same inputs, at 6 and 25 PRB.

Inputs, noise and channels come from numpy with a seed and go to both
packages as arrays; the JAX side runs its functions under ``jax.jit`` (as its
runtime does), which compiles each once instead of op by op.  Tolerances: bits, indices, flags, candidate lists and
payloads identical; grids and rate-dematched LLRs atol 1e-6 (the same
additions in the same order); PHICH metrics rtol 1e-4; PBCH LLR buffers
rtol 1e-4, atol 1e-3 (equaliser and demodulator in two frameworks).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_4g_tpu.models import dci as j_dci
from srsran_4g_tpu.models import enb_dl as j_enb
from srsran_4g_tpu.models import grid as j_grid
from srsran_4g_tpu.models import pbch as j_pbch
from srsran_4g_tpu.models import pdcch as j_pdcch
from srsran_4g_tpu.models import pdsch as j_pdsch
from srsran_4g_tpu.models import phich as j_phich
from srsran_4g_tpu.models import ra as j_ra
from srsran_4g_tpu.models import regs as j_regs
from srsran_4g_tpu.ops import convcode as j_cc
from srsran_4g_tpu.ops import rate_match as j_rm
from srsran_4g_tpu.utils import bits as j_bits
from srsran_4g_tpu_torch.models import dci, enb_dl, grid, pbch, pdcch, pdsch, phich, ra, regs
from srsran_4g_tpu_torch.ops import convcode, rate_match
from srsran_4g_tpu_torch.utils import bits

torch.set_num_threads(2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cells(nof_prb, cell_id, cfi=1, nof_ports=1):
    return (grid.CellConfig(nof_prb=nof_prb, cell_id=cell_id, cfi=cfi, nof_ports=nof_ports),
            j_grid.CellConfig(nof_prb=nof_prb, cell_id=cell_id, cfi=cfi, nof_ports=nof_ports))


def _jit(fn, *args, **kw):
    """fn with its leading and keyword arguments fixed, under jax.jit."""
    # The JAX side runs once per shape, so compiling it is most of its cost:
    # compile it for speed of compiling (the same results, sooner).
    return jax.jit(functools.partial(fn, *args, **kw), compiler_options=dict(
        xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
        xla_cpu_parallel_codegen_split_count=1))


def _noise(rng, shape, nv):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(nv / 2)).astype(np.complex64)


def _channel(rng, shape):
    """A smooth random channel over the grid (phase ramp along k, gain ~1)."""
    k = np.arange(shape[-1])
    ph = rng.uniform(0, 2 * np.pi) + 2 * np.pi * rng.uniform(-1, 1) * k / shape[-1]
    return np.broadcast_to((0.8 + 0.4 * rng.random()) * np.exp(1j * ph),
                           shape).astype(np.complex64).copy()


# --- bits, convolutional code, conv rate matching ----------------------------


def test_bits_match():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (3, 5)).astype(np.uint8)
    np.testing.assert_array_equal(bits.unpack_bytes_np(data, 37), j_bits.unpack_bytes_np(data, 37))
    b = rng.integers(0, 2, (3, 64)).astype(np.int8)
    np.testing.assert_array_equal(bits.pack_bytes_np(b), j_bits.pack_bytes_np(b))
    np.testing.assert_array_equal(_np(bits.pack_bits_to_u32(torch.as_tensor(b))),
                                  np.asarray(j_bits.pack_bits_to_u32(jnp.asarray(b))))


@pytest.mark.parametrize("n", [40, 44])
def test_conv_encode_matches(n):
    b = np.random.default_rng(n).integers(0, 2, (5, n)).astype(np.int8)
    np.testing.assert_array_equal(_np(convcode.conv_encode(torch.as_tensor(b))),
                                  np.asarray(j_cc.conv_encode(jnp.asarray(b))))


def test_viterbi_decode_matches_on_noisy_llrs():
    rng = np.random.default_rng(3)
    b = rng.integers(0, 2, (16, 44)).astype(np.int8)
    d = np.asarray(j_cc.conv_encode(jnp.asarray(b))).astype(np.float32)
    # BPSK LLRs at a few SNRs, strong enough that most decode and weak
    # enough that some do not
    snr = np.repeat([0.5, 1.0, 2.0, 4.0], 4)[:, None, None]
    llr = (4 * snr * (2 * d - 1) + 2 * np.sqrt(2 * snr) * rng.standard_normal(d.shape))
    llr = llr.astype(np.float32)
    got = _np(convcode.viterbi_decode(torch.as_tensor(llr)))
    want = np.asarray(j_cc.viterbi_decode(jnp.asarray(llr)))
    np.testing.assert_array_equal(got, want)
    assert (got == b).all(axis=1).sum() >= 8  # the strong half decodes


@pytest.mark.parametrize("n,e", [(44, 72), (44, 576), (40, 1920), (61, 100)])
def test_conv_rate_match_and_dematch_match(n, e):
    rng = np.random.default_rng(e)
    np.testing.assert_array_equal(rate_match.conv_rm_indices(n, e), j_rm.conv_rm_indices(n, e))
    d = rng.integers(0, 2, (3, 3, n)).astype(np.int8)
    np.testing.assert_array_equal(_np(rate_match.conv_rate_match(torch.as_tensor(d), e)),
                                  np.asarray(j_rm.conv_rate_match(jnp.asarray(d), e)))
    llr = rng.standard_normal((3, e)).astype(np.float32) * 3
    got = _np(rate_match.conv_rate_dematch(torch.as_tensor(llr), n))
    np.testing.assert_allclose(got, np.asarray(j_rm.conv_rate_dematch(jnp.asarray(llr), n)),
                               atol=1e-6, rtol=0)


# --- REG tables -------------------------------------------------------------------


@pytest.mark.parametrize("nof_prb,cell_id,ports", [(6, 7, 1), (6, 302, 2), (25, 123, 4),
                                                   (25, 41, 1)])
def test_regs_match(nof_prb, cell_id, ports):
    for cfi in (1, 2, 3):
        cell, jcell = _cells(nof_prb, cell_id, cfi, ports)
        for ng in (1 / 6, 0.5, 1.0, 2.0):
            np.testing.assert_array_equal(regs.phich_reg_indices(cell, ng),
                                          j_regs.phich_reg_indices(jcell, ng))
            np.testing.assert_array_equal(regs.pdcch_regs(cell, cfi, ng),
                                          j_regs.pdcch_regs(jcell, cfi, ng))
            np.testing.assert_array_equal(regs.pdcch_interleave_order(cell, cfi, ng),
                                          j_regs.pdcch_interleave_order(jcell, cfi, ng))
            assert regs.n_pdcch_cces(cell, cfi, ng) == j_regs.n_pdcch_cces(jcell, cfi, ng)
        for l in range(cfi):
            np.testing.assert_array_equal(regs.regs_in_symbol(cell, l),
                                          j_regs.regs_in_symbol(jcell, l))


# --- PHICH ------------------------------------------------------------------------


def test_phich_matches():
    cell, jcell = _cells(25, 77)
    rng = np.random.default_rng(11)
    b = 4
    ack = {(0, 1): rng.integers(0, 2, b), (0, 5): rng.integers(0, 2, b),
           (2, 6): rng.integers(0, 2, b), (3, 3): rng.integers(0, 2, b)}
    g = torch.zeros((b, 14, 300), dtype=torch.complex64)
    jg = jnp.zeros((b, 14, 300), jnp.complex64)
    for (group, nseq), a in ack.items():
        syms = phich.encode(cell, torch.as_tensor(a), group, nseq, 4)
        jsyms = j_phich.encode(jcell, jnp.asarray(a), group, nseq, 4)
        np.testing.assert_allclose(_np(syms), np.asarray(jsyms), atol=1e-6)
        g = phich.put_into_grid(cell, g, syms, group)
        jg = j_phich.put_into_grid(jcell, jg, jsyms, group)
    np.testing.assert_allclose(_np(g), np.asarray(jg), atol=1e-6)
    h = _channel(rng, g.shape)
    rx = (g.numpy() * h + _noise(rng, g.shape, 0.2)).astype(np.complex64)
    for (group, nseq), a in ack.items():
        got = phich.decode(cell, torch.as_tensor(rx), torch.as_tensor(h), 0.2, group, nseq, 4)
        want = j_phich.decode(jcell, jnp.asarray(rx), jnp.asarray(h), 0.2, group, nseq, 4)
        np.testing.assert_array_equal(_np(got["ack"]), np.asarray(want["ack"]))
        np.testing.assert_array_equal(_np(got["ack"]), a)
        np.testing.assert_allclose(_np(got["metric"]), np.asarray(want["metric"]),
                                   rtol=1e-4, atol=1e-5)
    for args in ((25, 13, 1, 1.0), (6, 4, 0, 0.5), (100, 77, 2, 2.0)):
        assert phich.phich_alloc(*args) == j_phich.phich_alloc(*args)


# --- PBCH -------------------------------------------------------------------------


@pytest.mark.parametrize("ports", [1, 2])
def test_pbch_matches(ports):
    cell, jcell = _cells(6 if ports == 1 else 25, 151, 1, ports)
    rng = np.random.default_rng(20 + ports)
    b = 2
    mib = rng.integers(0, 2, (b, 24)).astype(np.int8)
    syms = pbch.encode(cell, torch.as_tensor(mib), n_ports=ports)
    jsyms = j_pbch.encode(jcell, jnp.asarray(mib), n_ports=ports)
    np.testing.assert_allclose(_np(syms), np.asarray(jsyms), atol=1e-6)
    np.testing.assert_array_equal(pbch.pbch_re_indices(cell), j_pbch.pbch_re_indices(jcell))
    shape = (b, 2, 14, cell.nre) if ports == 2 else (b, 14, cell.nre)
    buf = jbuf = None
    # two frames of the 40 ms TTI at a noise level where one alone is weak
    for frame in (1, 2):
        g = pbch.put_into_grid(cell, torch.zeros(shape, dtype=torch.complex64), syms[:, frame])
        jg = j_pbch.put_into_grid(jcell, jnp.zeros(shape, jnp.complex64), jsyms[:, frame])
        np.testing.assert_allclose(_np(g), np.asarray(jg), atol=1e-6)
        hs = [_channel(rng, (b, 14, cell.nre)) for _ in range(ports)]
        tx = g.numpy()
        rx = sum(hs[p] * (tx[:, p] if ports == 2 else tx) for p in range(ports))
        rx = (rx + _noise(rng, rx.shape, 1.0)).astype(np.complex64)
        kw = dict(frame_idx=frame)
        h1 = dict(h1=torch.as_tensor(hs[1])) if ports == 2 else {}
        jh1 = dict(h1=jnp.asarray(hs[1])) if ports == 2 else {}
        got = pbch.decode(cell, torch.as_tensor(rx), torch.as_tensor(hs[0]), 1.0,
                          llr_buffer=buf, **kw, **h1)
        want = _jit(j_pbch.decode, jcell, **kw)(jnp.asarray(rx), jnp.asarray(hs[0]), 1.0,
                                                 llr_buffer=jbuf, **jh1)
        for key in ("mib", "crc_ok", "n_ports"):
            np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]))
        np.testing.assert_allclose(_np(got["llr_buffer"]), np.asarray(want["llr_buffer"]),
                                   rtol=1e-4, atol=1e-3)
        buf, jbuf = got["llr_buffer"], want["llr_buffer"]
    assert got["crc_ok"].all() and (got["n_ports"] == ports).all()
    np.testing.assert_array_equal(_np(got["mib"]), mib)


# --- PDCCH ------------------------------------------------------------------------


def test_pdcch_tables_and_encoding_match():
    for nof_prb, cid, cfi in ((6, 3, 2), (25, 123, 3), (25, 500, 1)):
        cell, jcell = _cells(nof_prb, cid, cfi)
        np.testing.assert_array_equal(pdcch.cce_re_indices(cell, cfi),
                                      j_pdcch.cce_re_indices(jcell, cfi))
        for rnti, sf in ((0x3D, 0), (0xFFFF, 5), (0x4601, 9), (0, 3)):
            assert (pdcch.search_space_candidates(cell, cfi, rnti, sf)
                    == j_pdcch.search_space_candidates(jcell, cfi, rnti, sf))
    cell, jcell = _cells(25, 123, 3)
    d = np.random.default_rng(5).integers(0, 2, (2, dci.format1a_len(25))).astype(np.int8)
    for l_agg in (1, 8):
        np.testing.assert_array_equal(
            _np(pdcch.encode_dci(cell, torch.as_tensor(d), 0x3D, l_agg)),
            np.asarray(j_pdcch.encode_dci(jcell, jnp.asarray(d), 0x3D, l_agg)))


def test_pdcch_blind_decode_matches():
    """One grid per aggregation level L = 1, 2, 4, 8, each with the RNTI's
    DCI on a UE-specific candidate of that level, blind-searched in one
    batch; a second RNTI that was not sent is not found among the same
    candidates."""
    cell, jcell = _cells(25, 123, 3)
    rnti, sf, n_bits = 0x4601, 6, dci.format1a_len(25)
    cands = pdcch.search_space_candidates(cell, 3, rnti, sf)
    rng = np.random.default_rng(8)
    payload = rng.integers(0, 2, (4, n_bits)).astype(np.int8)
    grids, jgrids, sent = [], [], []
    for i, l_agg in enumerate((1, 2, 4, 8)):
        cce = next(s for l, s in cands if l == l_agg)
        sent.append(cands.index((l_agg, cce)))
        z = torch.zeros((1, 14, 300), dtype=torch.complex64)
        grids.append(pdcch.put_dci(cell, 3, sf, z, torch.as_tensor(payload[i:i + 1]), rnti,
                                   l_agg, cce))
        put = _jit(j_pdcch.put_dci, jcell, 3, sf, rnti=rnti, l_agg=l_agg, cce_start=cce)
        jgrids.append(put(jnp.zeros((1, 14, 300), jnp.complex64),
                          jnp.asarray(payload[i:i + 1])))
        np.testing.assert_allclose(_np(grids[-1]), np.asarray(jgrids[-1]), atol=1e-6)
    g = torch.cat(grids).numpy()
    h = _channel(rng, g.shape)
    rx = (g * h + _noise(rng, g.shape, 0.05)).astype(np.complex64)
    for r in (rnti, 0x1234):
        got = pdcch.blind_decode(cell, 3, sf, torch.as_tensor(rx), torch.as_tensor(h), 0.05,
                                 rnti=r, dci_len=n_bits, candidates=cands)
        want = _jit(j_pdcch.blind_decode, jcell, 3, sf, rnti=r, dci_len=n_bits,
                    candidates=cands)(jnp.asarray(rx), jnp.asarray(h), 0.05)
        for key in ("found", "dci", "candidate", "ok_per_candidate", "payload_per_candidate"):
            np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]))
        if r == rnti:
            assert got["found"].all()
            np.testing.assert_array_equal(_np(got["dci"]), payload)
            assert got["ok_per_candidate"][torch.arange(4), sent].all()
        else:
            assert not got["found"].any()


# --- DCI formats and resource allocation -------------------------------------


@pytest.mark.parametrize("nof_prb", [6, 25, 50, 100])
def test_dci_formats_match(nof_prb):
    for fn in ("format0_len", "format1_len", "format1a_len", "format1c_len"):
        if hasattr(j_dci, fn):
            assert getattr(dci, fn)(nof_prb) == getattr(j_dci, fn)(nof_prb)
    riv = ra.riv_encode(nof_prb, nof_prb, 0)
    d = dci.Dci1A(rb_start=0, l_crbs=nof_prb, mcs=min(28, nof_prb), harq_pid=3, ndi=1,
                  rv=2, tpc=1)
    jd = j_dci.Dci1A(rb_start=0, l_crbs=nof_prb, mcs=min(28, nof_prb), harq_pid=3, ndi=1,
                     rv=2, tpc=1)
    packed = dci.pack_1a(d, nof_prb)
    np.testing.assert_array_equal(packed, j_dci.pack_1a(jd, nof_prb))
    assert dci.unpack_1a(packed, nof_prb) == d
    assert riv == j_ra.riv_encode(nof_prb, nof_prb, 0)


def test_ra_matches():
    for mcs in (0, 9, 10, 16, 17, 26, 28):
        assert ra.dl_mcs_to_mod(mcs) == j_ra.dl_mcs_to_mod(mcs)
        for n_prb in (1, 6, 25, 50, 100, 110):
            assert ra.dl_tbs(mcs, n_prb) == j_ra.dl_tbs(mcs, n_prb)
    assert ra.dl_tbs(28, 100) == 75376
    for n_rb in (6, 25, 100):
        for l_crbs, start in ((1, 0), (n_rb, 0), (n_rb // 2 + 1, n_rb // 3), (2, n_rb - 2)):
            riv = ra.riv_encode(n_rb, l_crbs, start)
            assert riv == j_ra.riv_encode(n_rb, l_crbs, start)
            assert ra.riv_decode(n_rb, riv) == j_ra.riv_decode(n_rb, riv) == (l_crbs, start)


# --- the eNB subframe with a MIB and DCIs -------------------------------------


def test_assemble_subframe_with_mib_and_dcis_matches():
    cell, jcell = _cells(25, 123, 2)
    cfg = pdsch.PdschConfig(cell=cell, rnti=0x3D, subframe=0, mod="qpsk", tbs=120)
    jcfg = j_pdsch.PdschConfig(cell=jcell, rnti=0x3D, subframe=0, mod="qpsk", tbs=120)
    rng = np.random.default_rng(30)
    tb = rng.integers(0, 2, (2, 120)).astype(np.int8)
    mib = rng.integers(0, 2, (2, 24)).astype(np.int8)
    n_bits = dci.format1a_len(25)
    d1, d2 = (rng.integers(0, 2, (2, n_bits)).astype(np.int8) for _ in range(2))
    dcis = [(d1, 0x3D, 2, 4), (d2, 0xFFFF, 4, 8)]
    got = enb_dl.assemble_subframe(cfg, tb, mib_bits=mib, frame_idx=3, dcis=dcis,
                                   device="cpu")
    jdcis = [(jnp.asarray(x), r, l, c) for x, r, l, c in dcis]

    def assemble(tb, mib, d1, d2):
        return j_enb.assemble_subframe(jcfg, tb, mib_bits=mib, frame_idx=3,
                                       dcis=[(d1, *jdcis[0][1:]), (d2, *jdcis[1][1:])])

    want = _jit(assemble)(jnp.asarray(tb), jnp.asarray(mib), jnp.asarray(d1),
                             jnp.asarray(d2))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6, rtol=0)
