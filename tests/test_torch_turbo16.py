"""Port parity: the 16-bit and v3 half-iteration routes against the JAX
package's Pallas kernels in interpret mode.

- ``TURBO_KERNEL=v9`` (the default): ``map_fused16`` against
  ``map_windowed_pallas_v9`` (v7's fused dataflow with bf16 gammas, metrics
  and stores, normalised in training too).
- ``TURBO_KERNEL=bf16``: ``map_windowed16`` against ``map_windowed_pallas``'s
  16-bit ``_make_kernel`` body (v1 dataflow, bf16 throughout, LLRs bf16).
- ``TURBO_KERNEL=v3``: ``map_v3`` against ``_make_kernel_v3`` (f32, v1's
  arithmetic, two chains per lane pair).

On CPU tensors each route runs its kernel's plain version (``*_ref``);
tests/test_torch_turbo_variants.py holds ``kernel_route`` against the JAX
rule for every name, v3 and bf16 included.

Inputs are random gammas made with numpy from a seed, so many decisions lie
near zero.  Tolerances: the 16-bit bars of tests/test_turbo_pallas.py:29-38
(hard bits identical, atol 2.5, mean |diff| < 0.5) for the bf16 routes, which
in practice agree exactly because every bf16 op rounds the same way in torch
and in XLA; atol 1e-3 for v3 (f32).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_4g_tpu.ops import turbo as jturbo
from srsran_4g_tpu_torch.ops import turbo
from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm
from srsran_4g_tpu_torch.utils import constants

torch.set_num_threads(2)

B, K, L, T = 2, 256, 64, 16


@functools.lru_cache(maxsize=None)
def _gammas(scale: float, seed: int, b: int = B, k: int = K):
    """(lsa, lp, tail_sys, tail_par) as numpy: random gammas, not a codeword."""
    rng = np.random.default_rng(seed)
    lsa, lp = ((rng.standard_normal((b, k)) * scale).astype(np.float32) for _ in range(2))
    ts, tp = ((rng.standard_normal((b, 3)) * scale).astype(np.float32) for _ in range(2))
    return lsa, lp, ts, tp


def _laid_out(g, l, t):
    """The half-iteration inputs (gs_ext, gp_ext, a_init, b_init) as numpy."""
    laid = turbo._windowed_inputs(*map(torch.as_tensor, g), l, t)
    return tuple(x.numpy() for x in laid[:4]) + (t, l, g[0].shape[0], g[0].shape[1] // l)


def _assert_16bit(got: np.ndarray, want: np.ndarray) -> None:
    """The 16-bit bars: hard bits identical, atol 2.5, mean |diff| < 0.5."""
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=2.5, rtol=0)
    assert float(np.abs(got - want).mean()) < 0.5


def _half(kernel, monkeypatch, g, l=L, t=T):
    """Port and JAX (interpret) half-iteration on the same gammas."""
    monkeypatch.setenv("TURBO_KERNEL", kernel)
    got = turbo._map_windowed(*map(torch.as_tensor, g), l, t).numpy()
    want = np.asarray(jturbo._map_windowed_pl(*map(jnp.asarray, g), l, t,
                                              interpret=True))
    return got, want


# Seeds at which the f32 v1 dataflow the v9 route used to run flips 4 and 3
# of the 512 hard decisions against map_windowed_pallas_v9.  The plain
# version map_fused16_ref is held against the Pallas call as well.
@pytest.mark.parametrize("scale,seed", [(1.0, 273), (3.0, 5)])
def test_v9_route_matches_pallas_v9(monkeypatch, scale, seed):
    got, want = _half("v9", monkeypatch, _gammas(scale, seed))
    _assert_16bit(got, want)
    np.testing.assert_array_equal(got, want)  # measured: exact
    args = _laid_out(_gammas(scale, seed), L, T)
    ref = tm.map_fused16_ref(*map(torch.as_tensor, args[:4]), *args[4:])
    np.testing.assert_array_equal(ref.reshape(L, K // L, B).permute(2, 1, 0)
                                  .reshape(B, K).numpy(), want)


# bf16 runs map_windowed_pallas's 16-bit body at every shape, odd T included;
# the first seed flips 2 decisions under the f32 v1 kernel
@pytest.mark.parametrize("scale,seed,t", [(1.0, 1, T), (2.0, 3, 15)])
def test_bf16_route_matches_pallas_bf16(monkeypatch, scale, seed, t):
    got, want = _half("bf16", monkeypatch, _gammas(scale, seed), t=t)
    _assert_16bit(got, want)
    np.testing.assert_array_equal(got, want)
    args = _laid_out(_gammas(scale, seed), L, t)
    ref = tm.map_windowed16_ref(*map(torch.as_tensor, args[:4]), *args[4:])
    np.testing.assert_array_equal(ref.reshape(L, K // L, B).permute(2, 1, 0)
                                  .reshape(B, K).numpy(), want)


def test_v3_route_matches_pallas_v3(monkeypatch):
    got, want = _half("v3", monkeypatch, _gammas(3.0, 21), t=15)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got > 0, want > 0)


@functools.lru_cache(maxsize=None)
def _codeword_llrs():
    rng = np.random.default_rng(256)
    bits = rng.integers(0, 2, size=(B, K)).astype(np.int8)
    d = np.asarray(jturbo.turbo_encode(bits)).astype(np.float32)
    return bits, (2 * d - 1) * 1.2 + rng.standard_normal(d.shape).astype(np.float32) * 1.0


@pytest.mark.parametrize("kernel", ["bf16", "v3"])
def test_turbo_decode_matches_pallas_interpret(kernel, monkeypatch):
    monkeypatch.setenv("TURBO_KERNEL", kernel)
    _, llr = _codeword_llrs()
    h_p, a_p = jturbo.turbo_decode(llr, n_iter=1, window=L, train=T,
                                   backend="pallas_interpret")
    h_t, a_t = turbo.turbo_decode(torch.as_tensor(llr), n_iter=1, window=L, train=T)
    a_p = np.asarray(a_p)
    if kernel == "bf16":
        _assert_16bit(a_t.numpy(), a_p)
    else:
        np.testing.assert_allclose(a_t.numpy(), a_p, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_p))


def test_new_wrappers_check_their_inputs():
    args = tuple(map(torch.as_tensor, _laid_out(_gammas(1.0, 0), L, T)[:4]))
    with pytest.raises(ValueError):
        tm.map_fused16(*args, T, 62, B, K // L)  # L % 4 != 0
    with pytest.raises(ValueError):
        tm.map_fused16(*args, T - 1, L, B, K // L)  # odd T
    for fn in (tm.map_windowed16, tm.map_v3, tm.map_fused16):
        with pytest.raises(ValueError):
            fn(*args, T, L, B, K // L + 1)  # N != B*W
        with pytest.raises(TypeError):
            fn(args[0].double(), *args[1:], T, L, B, K // L)


# map_fused16's launch at every code-block size that turbo_decode sends to the
# v9 route (window 208, training 32; L % 4 == 0), for one block, a few, and the
# 20 MHz bench batch (128 subframes of 13 code blocks)
@pytest.mark.parametrize("nof_b", [1, 5, 1664])
def test_fused16_geometry_covers_every_v9_block_size(nof_b):
    v9 = [(k, l) for k in map(int, constants.cb_sizes())
          if (l := turbo.window_length(k, 208, 32)) and turbo.kernel_route("v9", l, 32) == "v9"]
    assert len(v9) == 167 and (5824, 208) in v9 and (40, 40) in v9
    for k, l in v9:
        n = nof_b * (k // l)
        geo = tm.fused16_geometry(n, l)
        # the 48 KB a block gets without opting in (the C entry does not opt
        # in), so under the 232,448 B an H100 block may opt into as well
        assert geo.smem_bytes <= 48 * 1024
        assert geo.smem_bytes == geo.lanes * (32 * -(-l // 8) + 256)
        assert geo.threads == 2 * geo.lanes <= 256 and geo.lanes % 32 == 0
        tiles = [range(i * geo.lanes, min((i + 1) * geo.lanes, n)) for i in range(geo.grid)]
        assert all(len(t) for t in tiles)  # no empty block
        assert [lane for t in tiles for lane in t] == list(range(n))
