"""Port parity: the paired half-iteration dataflows of
``srsran_4g_tpu_torch.ops.cuda.turbo_map`` (``map_fused``, ``sweep``,
``emit``) against the JAX package's Pallas kernels in interpret mode, the
``TURBO_KERNEL`` route against the JAX rule, and the decoder under each
route against the JAX XLA decoder.

Inputs are made with numpy from a seed at B=2, K=256, L=64, T=16 and laid
out once by the port's ``_windowed_inputs``; both packages get the same
arrays.  Tolerances: stores and LLRs within atol 1e-3 (f32, same schedule);
decoder APP within atol 1e-3 with identical hard bits
(tests/test_turbo_pallas.py:37-38).  tests/test_torch_cuda.py holds the CUDA
kernels against these plain versions on a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_4g_tpu.ops import turbo as jturbo
from srsran_4g_tpu.ops.pallas import turbo_map as jtm
from srsran_4g_tpu_torch.ops import turbo
from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

torch.set_num_threads(2)

B, K, L, T = 2, 256, 64, 16
W = K // L
N = B * W
TOL = dict(atol=1e-3, rtol=0)
# The JAX side runs once per shape, so compiling it is most of its cost:
# compile it for speed of compiling (the same results, sooner).
_jit = functools.partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
    xla_cpu_parallel_codegen_split_count=1))


@functools.lru_cache(maxsize=None)
def _inputs():
    """(gs_ext, gp_ext, a_init, b_init) as numpy, from one seed."""
    rng = np.random.default_rng(2024)
    lsa, lp = ((rng.standard_normal((B, K)) * 3).astype(np.float32) for _ in range(2))
    ts, tp = (rng.standard_normal((B, 3)).astype(np.float32) for _ in range(2))
    laid = turbo._windowed_inputs(*map(torch.as_tensor, (lsa, lp, ts, tp)), L, T)
    return tuple(x.numpy() for x in laid[:4])


def _port_args():
    return tuple(map(torch.as_tensor, _inputs())) + (T, L, B, W)


def _jax(entry, *arrays, **kw):
    """A Pallas entry in interpret mode on (arrays, T, L, B, W), jitted."""
    return _jit(lambda *a: entry(*a, T, L, B, W, interpret=True, **kw))(*arrays)


def test_sweep_r4_stores_match_pallas_v5():
    want_a, want_b = _jax(jtm.map_windowed_pallas_v5, *_inputs())
    got_a, got_b = tm.sweep(*_port_args(), radix=4)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **TOL)


def test_emit_matches_emit_llr_pallas():
    rng = np.random.default_rng(5)
    gs, gp = _inputs()[:2]
    g2s = gs[T:T + L].reshape(L // 2, 2, N)
    g2p = gp[T:T + L].reshape(L // 2, 2, N)
    ast, bst = ((rng.standard_normal((L // 2, 8, N)) * 4).astype(np.float32)
                for _ in range(2))
    want = _jit(lambda *a: jtm.emit_llr_pallas(*a, interpret=True))(g2s, g2p, ast, bst)
    got = tm.emit(*map(torch.as_tensor, (g2s, g2p, ast, bst)))
    assert got.shape == (L // 2, 2, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


class _CapturePallas:
    """Stands in for ``jax.experimental.pallas`` in the JAX kernel module and
    keeps every ``pallas_call``'s outputs."""

    def __init__(self, real):
        self._real, self.outputs = real, []

    def __getattr__(self, name):
        return getattr(self._real, name)

    def pallas_call(self, *args, **kw):
        call = self._real.pallas_call(*args, **kw)

        def run(*inputs):
            self.outputs.append(call(*inputs))
            return self.outputs[-1]
        return run


def test_sweep_r2_and_emit_match_pallas_v6(monkeypatch):
    capture = _CapturePallas(jtm.pl)
    monkeypatch.setattr(jtm, "pl", capture)
    want, calls = _jit(lambda *a: (jtm.map_windowed_pallas_v6(*a, T, L, B, W, interpret=True),
                                   capture.outputs))(*_inputs())
    args = _port_args()
    stores = tm.sweep(*args, radix=2)
    # v6's sweep call returns its stores in the (8, C) lane fold: lane = sub·C + col
    for got, folded in zip(stores, calls[0]):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(folded).reshape(L // 2, 8, -1)[:, :, :N], **TOL)
    g2s, g2p = (x[T:T + L].view(L // 2, 2, N) for x in args[:2])
    got = tm.emit(g2s, g2p, *stores).reshape(L, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("radix", [2, 4])
def test_map_fused_matches_pallas_v7(radix):
    want = _jax(jtm.map_windowed_pallas_v7, *_inputs(), radix4=radix == 4)
    got = tm.map_fused(*_port_args(), radix=radix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _decode_case():
    rng = np.random.default_rng(256)
    bits = rng.integers(0, 2, size=(B, K)).astype(np.int8)
    d = np.asarray(_jit(jturbo.turbo_encode)(bits)).astype(np.float32)
    llr = (2 * d - 1) * 2 + rng.standard_normal(d.shape).astype(np.float32) * 0.7
    h_x, a_x = _jit(lambda x: jturbo.turbo_decode(x, n_iter=2, window=L, train=T,
                                                  backend="xla"))(llr)
    return llr, np.asarray(h_x), np.asarray(a_x)


@pytest.mark.parametrize("kernel", ["v5", "v6", "v7", "v8"])
def test_turbo_decode_matches_xla(kernel, monkeypatch):
    monkeypatch.setenv("TURBO_KERNEL", kernel)
    llr, h_x, a_x = _decode_case()
    before = dict(tm.launches)
    h_t, a_t = turbo.turbo_decode(torch.as_tensor(llr), n_iter=2, window=L, train=T)
    np.testing.assert_allclose(a_t.numpy(), a_x, **TOL)
    np.testing.assert_array_equal(h_t.numpy(), h_x)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert dict(tm.launches) == before


# The JAX rule's outcome, read off the Pallas entry it calls, in the port's
# route names ("v1" is map_windowed_pallas, whose body is the v3 or bf16 one
# when TURBO_KERNEL names it).
_JAX_ENTRIES = {"map_windowed_pallas_v9": "v9", "map_windowed_pallas_r4": "v4",
                "map_windowed_pallas_v6": "v6", "map_windowed_pallas_v5": "v5",
                "map_windowed_pallas": "v1"}


def _jax_route(name, l, t, monkeypatch):
    monkeypatch.setenv("TURBO_KERNEL", name)
    called = []

    def stub(entry):
        def fn(*args, **kw):
            if entry == "v1" and name in ("v3", "bf16"):
                called.append(name)
            else:
                called.append("v8" if kw.get("radix4") else entry)
            n = args[0].shape[1]
            if entry == "v5":
                return (jnp.zeros((l // 2, 8, n)),) * 2
            return jnp.zeros((l // 2, 2, n) if entry == "emit" else (l, n))
        return fn

    for attr, entry in {**_JAX_ENTRIES, "map_windowed_pallas_v7": "v7",
                        "emit_llr_pallas": "emit"}.items():
        monkeypatch.setattr(jtm, attr, stub(entry))
    k = 2 * l
    z = np.zeros((1, k), np.float32)
    # tracing alone reaches the entry the rule picks; nothing is compiled
    jax.eval_shape(lambda: jturbo._map_windowed_pl(z, z, np.zeros((1, 3), np.float32),
                                                   np.zeros((1, 3), np.float32), l, t))
    return called[0]


@pytest.mark.parametrize("name", ["v1", "v3", "v4", "v5", "v6", "v7", "v8", "v9",
                                  "bf16", "nonesuch"])
def test_kernel_route_matches_jax_rule(name, monkeypatch):
    # L ≡ 0 and ≡ 2 (mod 4), odd L, and T even, odd, 0 and 1
    for l, t in [(64, 16), (64, 2), (106, 32), (64, 31), (64, 1), (64, 0), (63, 16)]:
        assert turbo.kernel_route(name, l, t) == _jax_route(name, l, t, monkeypatch), \
            (name, l, t)


def test_kernel_route_keeps_v6_where_jax_demotes_it(monkeypatch):
    # at the 20 MHz bench shape v6's stores exceed the TPU's scoped VMEM, so
    # JAX runs v7 there; the port has no such limit and runs v6
    assert _jax_route("v6", 208, 32, monkeypatch) == "v7"
    assert turbo.kernel_route("v6", 208, 32) == "v6"


def test_wrappers_check_their_inputs():
    args = _port_args()
    with pytest.raises(ValueError):
        tm.map_fused(*args[:4], T, 62, B, W, radix=2)  # L % 4 != 0
    with pytest.raises(ValueError):
        tm.map_fused(*args, radix=3)
    with pytest.raises(ValueError):
        tm.sweep(*args[:4], T - 1, L, B, W, radix=4)  # odd T
    with pytest.raises(ValueError):
        tm.sweep(*args[:5], L, B, W + 1, radix=2)  # N != B*W
    g = torch.zeros((L // 2, 2, N))
    s = torch.zeros((L // 2, 8, N))
    with pytest.raises(ValueError):
        tm.emit(g, g, s, s[:-1])
    with pytest.raises(TypeError):
        tm.emit(g.double(), g, s, s)
