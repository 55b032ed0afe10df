"""Port parity: turbo encoder, the max-log-MAP half-iteration and the
decoder (srsran_4g_tpu_torch.ops.turbo / ops.cuda.turbo_map) against the
JAX package on the same numpy inputs.

Tolerances: f32 half-iterations and decodes within atol 1e-3 with identical
hard bits (these run the f32 ``map_windowed`` route, TURBO_KERNEL=v4);
against the bf16 Pallas v9 kernel (interpret mode) the 16-bit bars of
tests/test_turbo_pallas.py (atol 2.5, mean |Δ| < 0.5, identical hard
bits).  tests/test_torch_cuda.py holds the CUDA kernel against its plain
version on a card.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from srsran_4g_tpu.ops import crc as jcrc
from srsran_4g_tpu.ops import turbo as jturbo
from srsran_4g_tpu_torch.ops import turbo
from srsran_4g_tpu_torch.ops.cuda import turbo_map

torch.set_num_threads(2)

# The JAX side runs once per shape, so compiling it is most of its cost:
# compile it for speed of compiling (the same results, sooner).
_jit = functools.partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
    xla_cpu_parallel_codegen_split_count=1))


def _gammas(rng, b, k):
    lsa = (rng.standard_normal((b, k)) * 3).astype(np.float32)
    lp = (rng.standard_normal((b, k)) * 3).astype(np.float32)
    ts = rng.standard_normal((b, 3)).astype(np.float32)
    tp = rng.standard_normal((b, 3)).astype(np.float32)
    return lsa, lp, ts, tp


@pytest.mark.parametrize("k", [40, 424, 5824])
def test_turbo_encode_bit_identical(k):
    bits = np.random.default_rng(k).integers(0, 2, size=(3, k)).astype(np.int8)
    want = np.asarray(_jit(jturbo.turbo_encode)(bits))
    got = turbo.turbo_encode(torch.as_tensor(bits)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


# L ≡ 0 and ≡ 2 (mod 4), and odd T, through map_windowed (v4; the default,
# v9, runs bf16 metrics and is held to the JAX v9 kernel in
# tests/test_torch_turbo16.py)
@pytest.mark.parametrize("k,l,t", [(512, 64, 32), (424, 106, 32), (512, 64, 31)])
def test_map_windowed_ref_matches_xla(k, l, t, monkeypatch):
    monkeypatch.setenv("TURBO_KERNEL", "v4")
    args = _gammas(np.random.default_rng(k + t), 3, k)
    want = np.asarray(_jit(jturbo._map_windowed, static_argnums=(4, 5))(*args, l, t))
    got = turbo._map_windowed(*map(torch.as_tensor, args), l, t).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_map_full_matches_xla():
    args = _gammas(np.random.default_rng(7), 2, 40)
    want = np.asarray(_jit(jturbo._map_full)(*args))
    got = turbo._map_full(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def _noisy_codeword(rng, b, k, snr_db, crc=None):
    n_data = k - 24 if crc else k
    bits = rng.integers(0, 2, size=(b, n_data)).astype(np.int8)
    if crc:
        bits = jcrc.crc_attach_np(bits, crc).astype(np.int8)
    d = np.asarray(_jit(jturbo.turbo_encode)(bits)).astype(np.float64)
    sigma2 = 10 ** (-snr_db / 10)
    y = (1 - 2 * d) + rng.standard_normal(d.shape) * np.sqrt(sigma2)
    return bits, (-2 * y / sigma2).astype(np.float32)


def test_turbo_decode_early_stop_matches_xla(monkeypatch):
    monkeypatch.setenv("TURBO_KERNEL", "v4")  # f32, as the XLA decoder
    # 0.5 dB per-bit SNR: some blocks converge after the first half, some
    # need more halves, so the per-block freeze is exercised
    rng = np.random.default_rng(3)
    _, llr = _noisy_codeword(rng, 4, 512, 0.5, crc="24B")
    h_x, a_x = _jit(lambda x: jturbo.turbo_decode(x, n_iter=4, window=64, train=32,
                                                  backend="xla", early_crc="24B"))(llr)
    h_t, a_t = turbo.turbo_decode(torch.as_tensor(llr), n_iter=4, window=64,
                                  train=32, early_crc="24B")
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_x))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_x), atol=1e-3, rtol=0)


def test_turbo_decode_matches_pallas_v9_interpret(monkeypatch):
    monkeypatch.setenv("TURBO_KERNEL", "v9")
    rng = np.random.default_rng(256)
    bits = rng.integers(0, 2, size=(2, 256)).astype(np.int8)
    d = np.asarray(_jit(jturbo.turbo_encode)(bits)).astype(np.float32)
    llr = (2 * d - 1) * 2 + rng.standard_normal(d.shape).astype(np.float32) * 0.7
    h_p, a_p = _jit(lambda x: jturbo.turbo_decode(x, n_iter=1, window=64, train=16,
                                                  backend="pallas_interpret"))(llr)
    h_t, a_t = turbo.turbo_decode(torch.as_tensor(llr), n_iter=1, window=64,
                                  train=16)
    a_p = np.asarray(a_p)
    np.testing.assert_allclose(a_t.numpy(), a_p, atol=2.5, rtol=0)
    assert float(np.abs(a_t.numpy() - a_p).mean()) < 0.5
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_p))


def test_map_windowed_checks_its_inputs():
    gs = torch.zeros((64 + 64, 6))
    a = torch.zeros((8, 6))
    with pytest.raises(ValueError):
        turbo_map.map_windowed(gs, gs, a, a, 32, 64, 2, 4)  # N != B*W
    with pytest.raises(TypeError):
        turbo_map.map_windowed(gs.double(), gs, a, a, 32, 64, 2, 3)


# a window above 320, L = 512 at K = 1024: the default route (v9, bf16
# metrics, map_fused16) to the 16-bit bars and the f32 route (v4,
# map_windowed) to atol 1e-3, both with identical hard bits, against the XLA
# decoder
@functools.lru_cache(maxsize=None)
def _window_512_case():
    """The LLRs and the XLA decoder's output, shared by both routes."""
    _, llr = _noisy_codeword(np.random.default_rng(5), 2, 1024, 1.0)
    h_x, a_x = _jit(lambda x: jturbo.turbo_decode(x, n_iter=2, window=512, train=32,
                                                  backend="xla"))(llr)
    return llr, np.asarray(h_x), np.asarray(a_x)


@pytest.mark.parametrize("kernel", ["v9", "v4"])
def test_turbo_decode_window_512_matches_xla(kernel, monkeypatch):
    monkeypatch.setenv("TURBO_KERNEL", kernel)
    llr, h_x, a_x = _window_512_case()
    h_t, a_t = turbo.turbo_decode(torch.as_tensor(llr), n_iter=2, window=512, train=32)
    np.testing.assert_array_equal(h_t.numpy(), h_x)
    if kernel == "v9":
        np.testing.assert_allclose(a_t.numpy(), a_x, atol=2.5, rtol=0)
        assert float(np.abs(a_t.numpy() - a_x).mean()) < 0.5
    else:
        np.testing.assert_allclose(a_t.numpy(), a_x, atol=1e-3, rtol=0)
