"""The plain versions of the H100 probe kernels (``ops/cuda/probes.py``)
against the TPU probes' own Pallas bodies in interpret mode on the CPU, at a
tiny lane count.

Each TPU probe times its kernel and returns no output, so the test takes the
probe's kernel body and ``pallas_call`` arguments as the probe builds them
(``pallas_call`` is replaced while the probe's own build code runs by one
that records them) and then calls the real ``pallas_call`` with
``interpret=True`` on the test's inputs.  ``turbo_probe2.py`` and
``turbo_probe3.py`` run their sweeps at import, so their definitions are
taken from the source with ``ast`` and run with small constants;
``turbo_probe6.py`` is imported with ``N``/``TILE`` set small, and
``turbo_probe7.py`` with ``sys.argv`` patched.  Nothing in ``tools/``
changes.

Tolerances: f32 atol 1e-3 (the same ops in the same order; in practice
equal); bf16 the 16-bit bars (atol 2.5, mean |diff| < 0.5, signs identical),
and in practice equal, since torch and XLA round every bf16 op alike.
Probe 2 and 3 bodies write row 0 only, so only row 0 is compared.
"""

import ast
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from srsran_4g_tpu_torch.ops.cuda import probes

torch.set_num_threads(2)

TOOLS = Path(__file__).resolve().parents[1] / "tools"


class _Recorder:
    """Stands in for ``pl.pallas_call``: records the body and arguments and
    returns zeros of the output shape, so the probe's timing runs on
    nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, kernel, **kw):
        self.calls.append((kernel, kw))
        shapes = kw["out_shape"]

        def fake(*args):
            if isinstance(shapes, (list, tuple)):
                return [jnp.zeros(s.shape, s.dtype) for s in shapes]
            return jnp.zeros(shapes.shape, shapes.dtype)

        return fake


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(pl, "pallas_call", rec)
    return rec


def _interpret(call, *args):
    """The recorded call in interpret mode, jitted: it runs once per shape,
    so it is compiled for speed of compiling (the same results, sooner)."""
    kernel, kw = call
    real = _Recorder.real
    return jax.jit(real(kernel, interpret=True, **kw), compiler_options=dict(
        xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
        xla_cpu_parallel_codegen_split_count=1))(*args)


_Recorder.real = pl.pallas_call


def _source_defs(name: str, keep_assign=()) -> str:
    """The imports, the named assignments and the function definitions of
    ``tools/<name>.py``, without its top-level runs and data."""
    tree = ast.parse((TOOLS / f"{name}.py").read_text())
    body = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef)):
            body.append(node)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in keep_assign
                or isinstance(t, ast.Tuple) for t in node.targets):
            body.append(node)
    return ast.unparse(ast.Module(body=body, type_ignores=[]))


def _load_module(name: str, argv=None):
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    old = sys.argv
    sys.argv = argv or [str(TOOLS / f"{name}.py")]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = old
    return mod


def _row0(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], atol=1e-3, rtol=0)


# --- probe 2 -----------------------------------------------------------------

# tiny sweep: window 16, training 4 -> 24 gamma rows, 10 radix-4 steps, one
# tile of 128 lanes
P2 = dict(K=32, B=8, WIN=16, TRAIN=4, TILE=128)


@pytest.fixture(scope="module")
def probe2_ns():
    ns = {"__name__": "_tpu_turbo_probe2"}
    exec(_source_defs("turbo_probe2", ("tab", "r4", "a_pred", "a_c")), ns)
    w = P2["K"] // P2["WIN"]
    ns.update(P2, W=w, N=P2["B"] * w, NP=P2["TILE"], STEPS=P2["WIN"] + 2 * P2["TRAIN"],
              t2=P2["TRAIN"] // 2, l2=P2["WIN"] // 2)
    rng = np.random.default_rng(0)
    ns["g"] = jnp.asarray(rng.normal(0, 4.0, (ns["STEPS"], ns["NP"])).astype(np.float32))
    ns["a0"] = jnp.asarray(rng.normal(0, 1.0, (8, ns["NP"])).astype(np.float32))
    return ns


@pytest.mark.parametrize("variant", probes.PROBE2_VARIANTS)
def test_probe2_plain_matches_pallas_body(probe2_ns, recorder, variant):
    ns = probe2_ns
    make = ns["make"] if variant in probes.PROBE2_VARIANTS[:7] else ns["make2"]
    ns["run"](variant, make(variant))
    want = _interpret(recorder.calls[-1], ns["g"], ns["g"], ns["a0"])
    g, a0 = (torch.as_tensor(np.array(x)) for x in (ns["g"], ns["a0"]))
    got = probes.probe2(variant, g, g, a0, ns["t2"] + ns["l2"], ns["WIN"], ns["l2"])
    assert got.shape == want.shape
    _row0(got, want)


# --- probe 3 -----------------------------------------------------------------


@pytest.mark.parametrize("tile,steps,win,nin", [(512, 176, 112, 2), (1024, 16, 8, 1)])
def test_probe3_plain_matches_pallas_body(recorder, tile, steps, win, nin):
    ns = {"__name__": "_tpu_turbo_probe3"}
    exec(_source_defs("turbo_probe3"), ns)
    ns["N"], ns["rng"] = 1500, np.random.default_rng(0)
    ns["empty_bench"]("empty", tile, steps=steps, win=win, nin=nin)
    npad = -(-ns["N"] // tile) * tile
    g = np.random.default_rng(1).normal(0, 4.0, (steps, npad)).astype(np.float32)
    want = _interpret(recorder.calls[-1], *([jnp.asarray(g)] * nin))
    x = torch.as_tensor(g)
    got = probes.probe_empty([x] * nin, win, threads=tile)
    assert got.shape == want.shape
    _row0(got, want)


# --- probe 6 -----------------------------------------------------------------


@pytest.fixture(scope="module")
def probe6():
    mod = _load_module("turbo_probe6")
    mod.N, mod.TILE = 256, 128
    return mod


def _probe6_inputs(n, steps):
    rng = np.random.default_rng(6)
    g2s, g2p = (rng.normal(0, 4, (steps, 2, n)).astype(np.float32) for _ in range(2))
    a0, b0 = (rng.normal(0, 1, (8, n)).astype(np.float32) for _ in range(2))
    return g2s, g2p, a0, b0


def test_probe6_full_plain_matches_pallas_body(probe6, recorder):
    probe6.make_full()(*[jnp.zeros(s) for s in ((72, 2, 256),) * 2 + ((8, 256),) * 2])
    args = _probe6_inputs(probe6.N, probe6.STEPS)
    want = _interpret(recorder.calls[-1], *map(jnp.asarray, args))
    got = probes.probe6_full(*map(torch.as_tensor, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=0)


def test_probe6_skel_plain_matches_pallas_body(probe6, recorder):
    probe6.make_skel()(jnp.zeros((8, 256)), jnp.zeros((8, 256)))
    a0, b0 = _probe6_inputs(probe6.N, probe6.STEPS)[2:]
    want = _interpret(recorder.calls[-1], jnp.asarray(a0), jnp.asarray(b0))
    got = probes.probe6_skel(torch.as_tensor(a0), torch.as_tensor(b0), probe6.STEPS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=0)


def _bars16(got: torch.Tensor, want):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    diff = np.abs(g - w)
    assert diff.max() <= 2.5 and diff.mean() < 0.5
    np.testing.assert_array_equal(g > 0, w > 0)
    return diff.max()


def test_probe6_bf16_plain_matches_pallas_body(probe6, recorder):
    half = probe6.N // 2
    probe6.make_bf16()(*[jnp.zeros(s, jnp.bfloat16) for s in
                         ((72, 2, 2, half),) * 2 + ((16, half),) * 2])
    rng = np.random.default_rng(16)
    g2s, g2p = (rng.normal(0, 4, (probe6.STEPS, 2, 2, half)).astype(np.float32)
                for _ in range(2))
    a0, b0 = (rng.normal(0, 1, (16, half)).astype(np.float32) for _ in range(2))
    jx = [jnp.asarray(x).astype(jnp.bfloat16) for x in (g2s, g2p, a0, b0)]
    want = _interpret(recorder.calls[-1], *jx)
    got = probes.probe6_bf16(*(torch.as_tensor(x).to(torch.bfloat16)
                               for x in (g2s, g2p, a0, b0)))
    for g, w in zip(got, want):
        _bars16(g, w)


# --- probe 7 -----------------------------------------------------------------


@pytest.mark.parametrize("dtype,rows", [("float32", 8), ("bfloat16", 16)])
def test_probe7_plain_matches_pallas_body(recorder, dtype, rows):
    iters, tc = 24, 128
    mod = _load_module("turbo_probe7", ["turbo_probe7.py", str(iters), str(tc)])
    assert (mod.ITERS, mod.TC) == (iters, tc)
    mod.run(getattr(jnp, dtype), rows)
    rng = np.random.default_rng(7)
    g = (rng.normal(0, 0.5, (2, rows, tc))).astype(np.float32)
    a0 = rng.normal(0, 1, (8, rows, tc)).astype(np.float32)
    want = _interpret(recorder.calls[-1], jnp.asarray(g).astype(getattr(jnp, dtype)),
                      jnp.asarray(a0).astype(getattr(jnp, dtype)))
    tdt = getattr(torch, dtype)
    got = probes.probe7(torch.as_tensor(g).reshape(2, -1).to(tdt),
                        torch.as_tensor(a0).reshape(8, -1).to(tdt), iters)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(8, -1),
                                   atol=1e-3, rtol=0)
    else:
        _bars16(got, jnp.asarray(want).reshape(8, -1))


def test_probe7_plain_pairs_equal_from_the_first_step():
    """What ``csrc/probe_acs.cu``'s probe 7 kernel rests on: states s and
    s ^ 1 take the same two candidates in swapped order, so the plain
    version's rows 2p and 2p + 1 are equal after one step, and after one and
    three iterations, on ``check_inputs``' seeded inputs, f32 and bf16."""
    from srsran_4g_tpu_torch.tools import turbo_probe7

    for dtype, rows in ((torch.float32, 8), (torch.bfloat16, 16)):
        g, a0 = turbo_probe7.check_inputs(dtype, rows, 32, device="cpu")
        assert not torch.equal(a0[0::2], a0[1::2])
        combos = torch.stack([torch.zeros_like(g[0]), g[0], g[1], g[0] + g[1]])
        c = a0[torch.as_tensor(probes.A_SRC)] + combos[torch.as_tensor(probes.A_CMB)]
        step = torch.maximum(c[:, 0], c[:, 1])
        for a in (step, probes.probe7_ref(g, a0, 1), probes.probe7_ref(g, a0, 3)):
            assert torch.equal(a[0::2], a[1::2])


# --- the wrappers' checks ------------------------------------------------------


def test_probe_wrappers_refuse_bad_inputs():
    g, a0 = torch.zeros((24, 16)), torch.zeros((8, 16))
    with pytest.raises(ValueError):
        probes.probe2("nosuch", g, g, a0, 10, 16, 8)
    with pytest.raises(ValueError):
        probes.probe2("full", g, g, a0, 13, 16, 8)  # 26 rows needed
    with pytest.raises(TypeError):
        probes.probe2("full", g.double(), g.double(), a0.double(), 10, 16, 8)
    with pytest.raises(ValueError):
        probes.probe6_full(torch.zeros((4, 2, 16)), torch.zeros((4, 2, 16)),
                           torch.zeros((8, 15)), torch.zeros((8, 16)))
    with pytest.raises(TypeError):
        probes.probe6_bf16(*(torch.zeros(s) for s in ((4, 2, 2, 8),) * 2 + ((16, 8),) * 2))
    with pytest.raises(ValueError):
        probes.probe7(torch.zeros((2, 7), dtype=torch.bfloat16),
                      torch.zeros((8, 7), dtype=torch.bfloat16), 4)
    with pytest.raises(ValueError):
        probes.probe_empty([g, g, g], 8)


def test_probe2_geometry_fits_the_ring_or_raises():
    # the probe's shape: 56 rows of 32 B and 13 gamma stages of 16 B a lane;
    # 110 lanes a tile (219,120 of 232,448 B), one block an SM, 787 tiles on
    # 132 blocks in 6 even rounds
    geo = probes.probe2_geometry("astore", 86528, 56)
    assert geo == (110, 110 * (56 * 32 + 13 * 16), 787, 132, 1, 6)
    assert geo.smem_bytes <= probes.ONE_BLOCK_PER_SM_SMEM
    assert geo.tiles * geo.lanes >= 86528 > (geo.tiles - 1) * geo.lanes
    # 20,001 lanes: 2 rounds of 76-lane tiles, the last tile ragged
    assert probes.probe2_geometry("astore", 20001, 56) == (76, 76 * 2000, 264, 132, 1, 2)
    # the largest ring a block holds is one lane's 7,257 rows; no fallback
    assert probes.probe2_geometry("astore", 10, 7257).lanes == 1
    with pytest.raises(ValueError):
        probes.probe2_geometry("astore", 10, 7258)
    # the plain version, on CPU tensors, takes any ring
    g, a0 = torch.zeros((24, 16)), torch.zeros((8, 16))
    assert probes.probe2("astore", g, g, a0, 10, 16, 7258).shape == (16, 16)
    # full: tiles of one warp, a block each, all 2,704 resident at once; the
    # rest 128 lanes
    assert probes.probe2_geometry("full", 86528, 56)[:4] == (32, 0, 2704, 2704)
    assert probes.probe2_geometry("fixedrow", 86528, 56)[:4] == (128, 0, 676, 676)


# --- the work behind each kernel's bound -----------------------------------------


@pytest.mark.parametrize("name", probes.KERNELS)
def test_probe_work_counts_adds_and_maxes(name):
    # per lane and step: probe 2's ACS bodies 24 + 7 maxes, probe 6's pair
    # and skeleton 2 x 24, probe 7 4 a step (8 an iteration); every kernel
    # counts at least as many adds as maxes, so that the instruction
    # dispatch, not the max pipe, bounds its operations
    n, steps, iters = 64, 72, 10
    nbytes, adds, maxes, kind = probes.work(name, n, n_steps=steps, iters=iters)
    assert nbytes > 0 and adds >= maxes >= 0
    assert kind == ("bf16x2" if name in ("probe6_bf16", "probe7_bf16") else "f32")
    want_maxes = {"probe2_full": 31, "probe2_fixedrow": 31, "probe2_block8": 31,
                  "probe2_acsonly": 31, "probe2_unroll4": 31, "probe2_astore": 31,
                  "probe6_full": 48, "probe6_skel": 48, "probe6_bf16": 48}
    if name in want_maxes:
        assert maxes == n * steps * want_maxes[name]
    elif name.startswith("probe7"):
        assert (adds, maxes) == (n * (16 * iters + 1), n * 8 * iters)
    else:
        assert maxes == 0
