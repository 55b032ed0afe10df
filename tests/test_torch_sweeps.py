"""Port parity: the error-rate tools (``srsran_4g_tpu_torch/tools/ber_sweep.py``
and ``bler_sweep.py``) against the JAX package in the waterfall, and the
public names the port added beside them (``ops/crc.crc_np``,
``crc_attach_np``, ``runtime/lte_air.UePucchRes``).

- Turbo: the JAX tool's loop (``tools/ber_sweep.py``: bits, then float64
  noise per point from ``np.random.default_rng(0)``) written out here with
  the JAX package's encoder, and its decode at window 128 / training 32 run
  with ``backend="pallas_interpret"``, the v9 kernel the JAX tool runs on a
  TPU (its ``--cpu`` run takes the f32 XLA decoder instead, whose bits differ
  in the waterfall).  K = 512 (L = 128), 4 frames, 5 iterations, three
  points, one of them with 0 < FER < 1: LLRs, hard bits and APP LLRs
  identical, and the BER/FER rows equal.
- LDPC: one waterfall point (1.0 dB) at the tool's TBS 4224, the same numpy
  noise through the port's ``ldpc_point`` and a JAX composition of
  ``sch_nr.encode``/``decode``: CRC flags, bits and error counts identical.
- PDSCH: a 6 PRB QPSK cell with one K = 512 block (L = 128, the v9 route) at
  a point where some TBs fail, the same numpy noise on both sides, JAX's
  ``turbo_decode`` patched to ``backend="pallas_interpret"`` for the test:
  CRC flags and bits identical.
- The BLER tool's checkpoint on a tiny grid, its output paths, and the CRC
  and PUCCH names.

Inputs are made with numpy from a seed; the JAX side is jitted once per
shape.
"""

import dataclasses
import functools
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_4g_tpu.models import grid as jgrid
from srsran_4g_tpu.models import pdsch as jpdsch
from srsran_4g_tpu.models import sch_nr as jsch
from srsran_4g_tpu.ops import crc as jcrc
from srsran_4g_tpu.ops import turbo as jturbo
from srsran_4g_tpu.runtime import lte_air as jair
from srsran_4g_tpu_torch import convert
from srsran_4g_tpu_torch.models import pdsch, sch_nr
from srsran_4g_tpu_torch.ops import crc
from srsran_4g_tpu_torch.runtime import lte_air
from srsran_4g_tpu_torch.tools import ber_sweep, bler_sweep
from srsran_4g_tpu_torch.utils.constants import CRC_POLYS

torch.set_num_threads(2)

# The JAX side runs once per shape, so compiling it is most of its cost:
# compile it for speed of compiling (the same results, sooner); but the
# interpreted turbo kernel runs long, so the decodes that hold one keep
# XLA's optimisation (4 CPU-s a run against 15 at level 0).
_FAST = dict(xla_cpu_use_fusion_emitters=False, xla_cpu_parallel_codegen_split_count=1)
_jit = functools.partial(jax.jit, compiler_options=dict(_FAST, xla_backend_optimization_level=0))
_jit_interpret = functools.partial(jax.jit, compiler_options=_FAST)

K, FRAMES, ITERS = 512, 4, 5
EBN0 = (0.25, 0.5, 0.75)  # dB: the waterfall of K = 512 on this seed
PDSCH_SNR = 0.0  # dB: one TB of four passes on this seed
SMALL_CELL = dict(nof_prb=6, cell_id=1, cfi=1)
SMALL_CASE = ("qpsk", 488, (-0.5, 6.0))  # one code block of K = 512


@pytest.fixture(autouse=True)
def _default_route(monkeypatch):
    monkeypatch.delenv("TURBO_KERNEL", raising=False)


def test_ber_sweep_matches_jax_v9_in_the_waterfall():
    seen = []
    rows = ber_sweep.sweep(K, FRAMES, ITERS, ber_sweep.grid(EBN0[0], EBN0[-1], 0.25), "cpu",
                           on_point=lambda r, dt, llr, hard, app: seen.append((llr, hard, app)))
    assert len(rows) == len(seen) == len(EBN0)
    # tools/ber_sweep.py's loop, on the JAX package; its decodes of the three
    # points as one batch (each block decodes alone), so one interpreted run
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(FRAMES, K)).astype(np.int8)
    d = np.asarray(_jit(jturbo.turbo_encode)(bits))
    rate = K / (3.0 * (K + 4))
    llrs = []
    for ebn0_db in EBN0:
        ebn0 = 10 ** (ebn0_db / 10)
        sigma2 = 1.0 / (2 * rate * ebn0)
        y = (1 - 2 * d.astype(np.float64)) + rng.standard_normal(d.shape) * np.sqrt(sigma2)
        llrs.append((-2 * y / sigma2).astype(np.float32))
    hard, app = map(np.asarray, _jit_interpret(lambda llr: jturbo.turbo_decode(
        llr, n_iter=ITERS, window=ber_sweep.WINDOW, train=ber_sweep.TRAIN,
        backend="pallas_interpret"))(np.concatenate(llrs)))
    for i, (ebn0_db, row, (llr_t, hard_t, app_t)) in enumerate(zip(EBN0, rows, seen)):
        at = slice(i * FRAMES, (i + 1) * FRAMES)
        np.testing.assert_array_equal(llr_t.numpy(), llrs[i])
        np.testing.assert_array_equal(hard_t.numpy(), hard[at])
        np.testing.assert_array_equal(app_t.numpy(), app[at])
        err = hard[at] != bits
        assert row["ebn0_db"] == round(ebn0_db, 3)
        assert (row["ber"], row["fer"]) == (float(np.mean(err)), float(np.mean(err.any(axis=1))))
    assert any(0 < r["fer"] < 1 for r in rows), rows


def test_ldpc_point_matches_jax():
    tbs, g_bits, qm = bler_sweep.LDPC
    seg = sch_nr.nr_segment(tbs, g_bits, qm)
    rng = np.random.default_rng(10)
    bits = rng.integers(0, 2, (FRAMES, tbs)).astype(np.int8)
    noise = rng.standard_normal((FRAMES, g_bits)).astype(np.float32)
    nv = float(10 ** (-1.0 / 10) / (2 * tbs / g_bits))

    @_jit
    def jax_point(bits, noise, nv):  # tools/bler_sweep.py's ldpc_step on given noise
        jseg = jsch.nr_segment(tbs, g_bits, qm)
        x = 1.0 - 2.0 * jsch.encode(jseg, bits).astype(jnp.float32)
        y = x + jnp.sqrt(nv) * noise
        dec, ok, _ = jsch.decode(jseg, -2.0 * y / nv)
        return dec, ok

    want_bits, want_ok = map(np.asarray, jax_point(bits, noise, nv))
    got_bits, got_ok = bler_sweep.ldpc_point(seg, torch.as_tensor(bits), torch.as_tensor(noise),
                                             nv)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    np.testing.assert_array_equal(got_bits.numpy(), want_bits)
    assert int((got_bits.numpy() != bits).sum()) == int((want_bits != bits).sum()) > 0


def _small_cfgs():
    mod, tbs, _ = SMALL_CASE
    jcfg = jpdsch.PdschConfig(cell=jgrid.CellConfig(**SMALL_CELL), rnti=bler_sweep.RNTI,
                              subframe=bler_sweep.SUBFRAME, mod=mod, tbs=tbs)
    return jcfg, convert.pdsch_config_from_dict(dataclasses.asdict(jcfg))


def test_pdsch_point_matches_jax_v9(monkeypatch):
    jcfg, cfg = _small_cfgs()
    (grp,) = cfg.plan.groups
    assert (grp.count, grp.K) == (1, 512)
    decode = jturbo.turbo_decode
    monkeypatch.setattr(jturbo, "turbo_decode", functools.partial(
        decode, backend="pallas_interpret"))
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (FRAMES, cfg.tbs)).astype(np.int8)
    shape = (FRAMES, cfg.cell.nsymb, cfg.cell.nre)
    noise = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    nv = float(10 ** (-PDSCH_SNR / 10))

    @_jit_interpret
    def jax_point(bits, noise, nv):  # tools/bler_sweep.py's pdsch_step on given noise
        tx = jpdsch.add_crs(jcfg, jpdsch.encode(jcfg, bits))
        out = jpdsch.decode(jcfg, tx + jnp.sqrt(nv / 2.0).astype(jnp.complex64) * noise)
        return out["bits"], out["crc_ok"]

    want_bits, want_ok = map(np.asarray, jax_point(bits, noise, nv))
    got_bits, got_ok = bler_sweep.pdsch_point(cfg, torch.as_tensor(bits), torch.as_tensor(noise),
                                              nv)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    np.testing.assert_array_equal(got_bits.numpy(), want_bits)
    assert 0 < want_ok.sum() < FRAMES, want_ok


@pytest.fixture
def tiny_grid(monkeypatch):
    """The BLER tool on a grid small enough for the CPU: two LDPC points and
    the small cell's case at two points."""
    monkeypatch.setattr(bler_sweep, "LDPC_EBN0", (1.5, 2.0))
    monkeypatch.setattr(bler_sweep, "CELL", SMALL_CELL)
    monkeypatch.setattr(bler_sweep, "PDSCH_CASES", (SMALL_CASE,))
    monkeypatch.setattr(bler_sweep, "PDSCH_POINTS", 2)
    calls, point = [], bler_sweep.pdsch_point

    def counted(cfg, *args):
        calls.append(cfg)
        return point(cfg, *args)

    monkeypatch.setattr(bler_sweep, "pdsch_point", counted)
    return calls


def _tables(out):
    return {n: (out / f"bler_{n}.json").read_text() for n in ("ldpc", "pdsch")}


def test_bler_sweep_resumes_from_its_checkpoint(tiny_grid, tmp_path, monkeypatch):
    full = tmp_path / "full"
    bler_sweep.run(2, "cpu", str(full), str(tmp_path / "full.ckpt"))
    assert len(tiny_grid) == 2
    ckpt = tmp_path / "cut.ckpt"
    first = json.loads((full / "bler_pdsch.json").read_text())[0]
    rows = {"ldpc/ebn0=1.50": json.loads((full / "bler_ldpc.json").read_text())[0],
            "pdsch/qpsk/snr=-0.5": first}
    ckpt.write_text(json.dumps({"meta": {"frames": 2}, "rows": rows}))
    tiny_grid.clear()
    bler_sweep.run(2, "cpu", str(tmp_path / "resumed"), str(ckpt))
    assert len(tiny_grid) == 1  # only the point not saved
    assert _tables(tmp_path / "resumed") == _tables(full)
    assert not ckpt.exists()
    # a checkpoint of another configuration is discarded
    ckpt.write_text(json.dumps({"meta": {"frames": 3},
                                "rows": {k: dict(v, bler=0.5) for k, v in rows.items()}}))
    tiny_grid.clear()
    bler_sweep.run(2, "cpu", str(tmp_path / "fresh"), str(ckpt))
    assert len(tiny_grid) == 2
    assert _tables(tmp_path / "fresh") == _tables(full)


def test_tools_write_only_under_artifacts_torch(tiny_grid, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ber_sweep.main(["--device", "cpu", "--k", "40", "--frames", "2", "--snr-max", "0"])
    bler_sweep.main(["--cpu", "--frames", "1"])
    written = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*") if p.is_file())
    assert written == [os.path.join("artifacts", "torch", f) for f in
                       ("ber_turbo.json", "bler_ldpc.json", "bler_pdsch.json")]
    assert json.loads(Path("artifacts/torch/ber_turbo.json").read_text())["k"] == 40
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ber_sweep.main(["--k", "40", "--frames", "1"])


@pytest.mark.parametrize("key", sorted(CRC_POLYS))
def test_host_crc_matches_jax(key):
    rng = np.random.default_rng(len(key))
    bits = rng.integers(0, 2, (3, 2, 77)).astype(np.int8)
    np.testing.assert_array_equal(crc.crc_np(bits, key), jcrc.crc_np(bits, key))
    got = crc.crc_attach_np(bits, key)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, jcrc.crc_attach_np(bits, key))
    assert crc.crc_check(torch.as_tensor(got), key).all()


def test_ue_pucch_res_matches_jax():
    res = lte_air.UePucchRes(n_pucch_sr=3, n_pucch_2=7)
    assert dataclasses.asdict(res) == dataclasses.asdict(jair.UePucchRes(3, 7))
    with pytest.raises(dataclasses.FrozenInstanceError):
        res.n_pucch_sr = 1
