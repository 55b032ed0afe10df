"""Port parity: NR FEC (LDPC, polar, the 38.212 DCI polar layer, the NR CRC
polynomials) against the JAX package on the same numpy inputs, at the shapes
of tests/test_ldpc.py, test_polar.py and test_polar_3gpp.py.

Tolerances: codewords, hard bits, decided u vectors, CRC bits and flags and
payloads identical; combined soft-buffers within atol 1e-3 (they are equal
here: repetitions add in transmit order on both sides).  The JAX decoders
run under ``jax.jit``, one compiled function per shape.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_4g_tpu.ops import crc as jcrc
from srsran_4g_tpu.ops import ldpc as jldpc
from srsran_4g_tpu.ops import polar as jpolar
from srsran_4g_tpu.ops import polar_3gpp as jp3
from srsran_4g_tpu_torch.ops import crc, ldpc, polar
from srsran_4g_tpu_torch.ops import polar_3gpp as p3

torch.set_num_threads(2)

RNTI = 0x4601
# The JAX side runs once per shape, so compiling it is most of its cost:
# compile it for speed of compiling (the same results, sooner).
_jit = functools.partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
    xla_cpu_parallel_codegen_split_count=1))


def _noisy_llr(cw, snr_db, rng, punct=0):
    """AWGN LLRs (positive ⇒ bit 1) of BPSK codeword bits, the first
    ``punct`` positions zeroed."""
    s2 = 10 ** (-snr_db / 10)
    y = (1 - 2 * cw.astype(np.float64)) + rng.standard_normal(cw.shape) * np.sqrt(s2)
    llr = (-2 * y / s2).astype(np.float32)
    llr[:, :punct] = 0.0
    return llr


def test_nr_crc_polynomials_match():
    rng = np.random.default_rng(5)
    for key in ("24C", "11", "6"):
        for n in (12, 164, 3000):
            bits = rng.integers(0, 2, (3, n)).astype(np.int8)
            want = np.asarray(jcrc.crc_compute(jnp.asarray(bits), key))
            got = crc.crc_compute(torch.as_tensor(bits), key).numpy()
            np.testing.assert_array_equal(got, want)
            both = np.concatenate([bits, want.astype(np.int8)], axis=-1)
            both[1, 3] ^= 1
            np.testing.assert_array_equal(crc.crc_check(torch.as_tensor(both), key).numpy(),
                                          np.asarray(jcrc.crc_check(jnp.asarray(both), key)))


@pytest.mark.parametrize("bg,z", [(1, 16), (2, 52)])
def test_ldpc_encode_matches(bg, z):
    kb = ldpc.bg_params(bg)[0]
    bits = np.random.default_rng(z).integers(0, 2, (3, kb * z)).astype(np.int8)
    got = ldpc.encode(torch.as_tensor(bits), bg, z)
    assert got.dtype == torch.int8
    want = _jit(lambda x: jldpc.encode(x, bg, z))(bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bg,z,snr_db", [(1, 64, 1.0), (2, 32, 1.5)])
def test_ldpc_flooded_decode_matches(bg, z, snr_db):
    """Near the waterfall, where some words keep errors: the hard bits
    agree word for word, failures included."""
    kb = ldpc.bg_params(bg)[0]
    rng = np.random.default_rng(7 + bg)
    bits = rng.integers(0, 2, (6, kb * z)).astype(np.int8)
    cw = ldpc.encode(torch.as_tensor(bits), bg, z).numpy()
    llr = _noisy_llr(cw, snr_db, rng, punct=2 * z)
    want = np.asarray(_jit(lambda x: jldpc.decode(x, bg, z, n_iter=12))(llr))
    got = ldpc.decode(torch.as_tensor(llr), bg, z, n_iter=12).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == bits).all(axis=1).any()


def test_ldpc_layered_decode_matches():
    for bg, z in ((1, 32), (2, 52)):
        kb = ldpc.bg_params(bg)[0]
        rng = np.random.default_rng(bg * 10 + z)
        bits = rng.integers(0, 2, (4, kb * z)).astype(np.int8)
        cw = ldpc.encode(torch.as_tensor(bits), bg, z).numpy()
        llr = _noisy_llr(cw, 1.5, rng, punct=2 * z)
        want = np.asarray(_jit(lambda x: jldpc.decode(x, bg, z, n_iter=4,
                                                      schedule="layered"))(llr))
        got = ldpc.decode(torch.as_tensor(llr), bg, z, n_iter=4, schedule="layered").numpy()
        np.testing.assert_array_equal(got, want)


def test_ldpc_rate_matching_matches():
    """Bit selection at every rv with fillers, and soft combining into a
    soft-buffer with E beyond the circular buffer (repeated positions)."""
    bg, z = 2, 16
    kb, _, nfull = ldpc.bg_params(bg)
    rng = np.random.default_rng(1)
    cw = ldpc.encode(torch.as_tensor(rng.integers(0, 2, (2, kb * z)).astype(np.int8)), bg,
                     z).numpy()
    e = (nfull - 2) * z * 2 + 40
    sb = rng.standard_normal((2, nfull * z)).astype(np.float32)
    for rv in range(4):
        kw = dict(rv=rv, n_filler=12, k_prime=kb * z - 12)
        np.testing.assert_array_equal(
            ldpc.rm_select(torch.as_tensor(cw), bg, z, e, **kw).numpy(),
            np.asarray(jldpc.rm_select(jnp.asarray(cw), bg, z, e, **kw)))
        llr = rng.standard_normal((2, e)).astype(np.float32)
        for soft in (None, sb):
            want = np.asarray(jldpc.rm_collect(jnp.asarray(llr), bg, z, softbuffer=None if soft
                                               is None else jnp.asarray(soft), **kw))
            got = ldpc.rm_collect(torch.as_tensor(llr), bg, z, softbuffer=None if soft is None
                                  else torch.as_tensor(soft), **kw).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("k,n_log,snr_db", [(32, 7, 1.0), (70, 8, 0.0)])
def test_polar_sc_decode_matches(k, n_log, snr_db):
    """The SC tree decides the same u as JAX's per-bit loop, errors included."""
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (6, k)).astype(np.int8)
    cw = np.asarray(_jit(lambda b: jpolar.encode_info(b, n_log))(bits))
    np.testing.assert_array_equal(polar.encode_info(torch.as_tensor(bits), n_log).numpy(), cw)
    llr = _noisy_llr(cw, snr_db, rng)
    mask = jpolar.frozen_mask(k, n_log)
    np.testing.assert_array_equal(polar.frozen_mask(k, n_log), mask)
    want = np.asarray(_jit(lambda x: jpolar.decode_masked(x, mask))(llr))
    got = polar.decode_masked(torch.as_tensor(llr), mask).numpy()
    np.testing.assert_array_equal(got, want)
    info = polar.decode(torch.as_tensor(llr), k, n_log).numpy()
    np.testing.assert_array_equal(info, want[:, ~mask])


def test_dci_sets_match():
    for k, e in ((61, 108), (41, 216), (44, 108), (61, 864), (68, 1728), (68, 432)):
        n, k_set, mask = p3.dci_sets(k, e)
        jn, jk_set, jmask = jp3.dci_sets(k, e)
        assert n == jn
        np.testing.assert_array_equal(k_set, jk_set)
        np.testing.assert_array_equal(mask, jmask)
    for k in (37, 61, 140, 164):
        np.testing.assert_array_equal(p3._il_perm(k), jp3._il_perm(k))


@pytest.mark.parametrize("a,e,snr_db", [(37, 108, 2.0), (20, 216, 0.0), (50, 864, -3.0),
                                        (44, 1728, -6.0)])
def test_dci_chain_matches(a, e, snr_db):
    """Shortening, puncturing, repetition over N = 512 and 3.4 repetitions:
    coded bits, decided payloads and CRC flags identical, and an RNTI that
    was not sent fails on both sides."""
    rng = np.random.default_rng(a * 1000 + e)
    pl = rng.integers(0, 2, (8, a)).astype(np.int8)
    coded = np.asarray(_jit(lambda p: jp3.dci_encode(p, e, RNTI))(pl))
    np.testing.assert_array_equal(p3.dci_encode(torch.as_tensor(pl), e, RNTI).numpy(), coded)
    llr = _noisy_llr(coded, snr_db, rng)
    want = _jit(lambda x: jp3.dci_decode(x, a, RNTI))(llr)
    got = p3.dci_decode(torch.as_tensor(llr), a, RNTI)
    np.testing.assert_array_equal(got["bits"].numpy(), np.asarray(want["bits"]))
    np.testing.assert_array_equal(got["crc_ok"].numpy(), np.asarray(want["crc_ok"]))
    ok = got["crc_ok"].numpy()
    assert got["crc_ok"].dtype == torch.bool and ok.any()
    np.testing.assert_array_equal(got["bits"].numpy()[ok], pl[ok])
    # the decisions do not depend on the RNTI, only the CRC mask does
    other = p3.dci_decode(torch.as_tensor(llr), a, RNTI + 1)
    np.testing.assert_array_equal(other["bits"].numpy(), np.asarray(want["bits"]))
    assert not other["crc_ok"].any()
    np.testing.assert_array_equal(p3.pdcch_scramble_seq(e, 500, RNTI),
                                  jp3.pdcch_scramble_seq(e, 500, RNTI))
