"""The port's measuring tools (``srsran_4g_tpu_torch/tools/{profile_components,
turbo_kernel_bench,trace_bench,dp_evidence,scaling_bench}.py``) on the CPU.

- ``profile_components``: at 6 PRB, QPSK (TBS 488, one K = 512 block), the
  staged front end's descrambled LLRs against the same chain composed of
  the JAX package's ``chest.estimate``, ``equalizer.equalize_single``,
  ``modem.demodulate_soft`` and ``scrambling.descramble_llrs`` on the same
  noisy grids (atol 1e-3, and rtol 1e-6: at 30 dB the LLRs reach ~2,500,
  where one float32 step is 2.4e-4); ``stage_times`` raises unless the staged bits
  and CRC flags equal ``pdsch.decode``'s; the tool's seven lines parse.  The
  JAX tool itself runs at import, so the chain is composed here.
- ``turbo_kernel_bench``: ``work`` and ``bound`` at the bench shape (B =
  1,664, K = 5,824, L = 208, T = 32) pinned to ``PERF.md``'s table; the
  wrappers each ``TURBO_KERNEL`` path launches; ``half``
  mode's half-iteration equal to ``ops/turbo._map_windowed``'s at a tiny
  shape on the v9 and v4 routes.
- ``dp_evidence``, ``scaling_bench`` (dp 1 and 2 over Gloo, child
  processes) and ``trace_bench`` at 6 PRB: every CRC passes, the BLER is 0,
  the JSON has the JAX tools' keys, the trace file is written.
- Each tool's ``main`` defaults to CUDA and raises without a card.

Inputs are made with numpy from a seed; the JAX side is jitted once.
"""

import contextlib
import functools
import io
import json

import jax
import numpy as np
import pytest
import torch

from srsran_4g_tpu.models import chest as jchest
from srsran_4g_tpu.models import equalizer as jeq
from srsran_4g_tpu.models import grid as jgrid
from srsran_4g_tpu.models import pdsch as jpdsch
from srsran_4g_tpu.ops import modem as jmodem
from srsran_4g_tpu.ops import scrambling as jscr
from srsran_4g_tpu_torch.models import pdsch
from srsran_4g_tpu_torch.ops import turbo
from srsran_4g_tpu_torch.tools import (dp_evidence, profile_components, scaling_bench,
                                       trace_bench, turbo_kernel_bench)

torch.set_num_threads(2)

_jit = functools.partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
    xla_cpu_parallel_codegen_split_count=1))

SMALL = dict(profile_components.SETTING, nof_prb=6, mod="qpsk", tbs=488)
LLR_TOL = dict(atol=1e-3, rtol=1e-6)


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(profile_components, "SETTING", SMALL)
    monkeypatch.delenv("TURBO_KERNEL", raising=False)


def test_staged_front_end_matches_jax_chain(small):
    cfg = profile_components.config()
    jcfg = jpdsch.PdschConfig(cell=jgrid.CellConfig(nof_prb=6, cell_id=SMALL["cell_id"], cfi=1),
                              rnti=SMALL["rnti"], subframe=SMALL["subframe"], mod="qpsk",
                              tbs=SMALL["tbs"])
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=(2, cfg.tbs)).astype(np.int8)
    tx = pdsch.add_crs(cfg, pdsch.encode(cfg, bits, device="cpu")).numpy()
    noise = rng.standard_normal(tx.shape) + 1j * rng.standard_normal(tx.shape)
    rx = (tx + noise * np.sqrt(10 ** (-SMALL["snr_db"] / 10) / 2)).astype(np.complex64)

    def jax_front_end(g):
        est = jchest.estimate(jchest.ChestConfig(cell=jcfg.cell), g, jcfg.subframe)
        idx = np.asarray(jcfg.re_indices)
        y, h = g.reshape(2, -1)[:, idx], est["h"].reshape(2, -1)[:, idx]
        x, eff = jeq.equalize_single(y, h, est["noise_var"])
        llr = jmodem.demodulate_soft(jcfg.mod, x, eff)
        return jscr.descramble_llrs(llr.reshape(2, -1), np.asarray(jcfg.scramble_seq))

    want = np.asarray(_jit(jax_front_end)(rx))
    rx_t = torch.as_tensor(rx)
    got = profile_components.front_end(cfg, rx_t).numpy()
    assert got.shape == want.shape == (2, cfg.g_bits)
    np.testing.assert_allclose(got, want, **LLR_TOL)
    stages = profile_components.stage_times(cfg, rx_t)  # raises if the bits differ
    assert set(stages) == {"chest", "equalise_demod_descramble", "dlsch_decode"}
    assert bool(pdsch.decode(cfg, rx_t, n_iter=4)["crc_ok"].all())


def test_profile_components_lines_parse(small, tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_BATCH", "2")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = profile_components.main(["--device", "cpu", "--out", str(tmp_path / "pc.json")])
    lines = profile_components.parse(buf.getvalue())
    assert tuple(lines) == profile_components.NAMES
    assert all(v["device_busy_ms"] is None and v["host_ms"] > 0 for v in lines.values())
    assert json.loads((tmp_path / "pc.json").read_text())["lines"].keys() == lines.keys()
    assert res["batch"] == 2


def test_work_and_bound_pinned_to_the_table():
    shape = (1664, 5824, 208, 32)
    nbytes, adds, maxes = turbo_kernel_bench.work("map_fused16", *shape)
    assert nbytes == 143_130_624
    ms, by = turbo_kernel_bench.bound(nbytes, adds, maxes, "bf16")
    assert (round(ms, 4), by) == (0.0427, "bytes")
    assert turbo_kernel_bench.work("sweep", *shape)[0] == 414_482_432
    assert turbo_kernel_bench.work("emit", *shape)[0] == 426_409_984
    assert turbo_kernel_bench.route_bound(("map_fused16",), *shape) == (ms, by)


def test_path_kernels_follow_the_dataflows():
    tkb = turbo_kernel_bench
    assert tkb.PATH_KERNELS == {
        "v9": ("map_fused16",), "v7": ("map_fused",), "v8": ("map_fused",),
        "v5": ("sweep", "emit"), "v6": ("sweep", "emit"), "bf16": ("map_windowed16",),
        "v3": ("map_v3",), "v4": ("map_windowed",), "v1": ("map_windowed",)}
    assert tkb.PATH_OF == {"turbo_map": "v4", "map_windowed16": "bf16", "map_v3": "v3",
                           "map_fused16": "v9", "map_fused_r2": "v7", "map_fused_r4": "v8",
                           "sweep_r2": "v6", "sweep_r4": "v5", "emit": "v5"}
    assert all(turbo.kernel_route(flow, 208, 32) == flow for flow in tkb.DATAFLOWS)


@pytest.mark.parametrize("kernel", ["v9", "v4"])
def test_half_mode_matches_map_windowed(kernel, monkeypatch):
    monkeypatch.setenv("TURBO_KERNEL", kernel)
    d = turbo_kernel_bench.make_llrs(4, 512, "cpu")
    res = turbo_kernel_bench.half(d, 128, 32, iters=1)
    k = 512
    t1_sys = torch.stack([d[:, 0, k], d[:, 2, k], d[:, 1, k + 1]], -1)
    t1_par = torch.stack([d[:, 1, k], d[:, 0, k + 1], d[:, 2, k + 1]], -1)
    want = turbo._map_windowed(d[:, 0, :k], d[:, 1, :k], t1_sys, t1_par, 128, 32)
    assert torch.equal(res["llr"], want)
    assert res["dataflow"] == kernel and res["max_abs_err"] == 0
    assert res["kernel_device_ms"] is None and res["half_iter_device_ms"] is None


def test_dp_evidence_on_cpu(small, tmp_path, monkeypatch):
    monkeypatch.setenv("DP_BATCHES", "2,4")
    monkeypatch.setenv("BENCH_REPS", "1")
    monkeypatch.setenv("BENCH_BATCH", "4")
    res = dp_evidence.main(["--device", "cpu", "--out", str(tmp_path / "dp.json")])
    assert json.loads((tmp_path / "dp.json").read_text()) == res
    assert [r["batch"] for r in res["batch_sweep"]] == [2, 4]
    assert all(r["crc_all_ok"] and r["sf_per_s"] > 0 and r["device_busy_ms"] is None
               for r in res["batch_sweep"])
    assert set(res["concurrency"]) == {"single_stream_sf_per_s",
                                       "two_stream_aggregate_sf_per_s", "overhead_pct"}


def test_scaling_bench_two_ranks_over_gloo(tmp_path):
    res = scaling_bench.main(["--device", "cpu", "--dps", "1,2", "--prb", "6", "--tbs", "1544",
                              "--per-dev", "2", "--iters", "1",
                              "--out", str(tmp_path / "scaling.json")])
    assert [(r["dp"], r["batch"], r["backend"], r["bler"]) for r in res["rows"]] == [
        (1, 2, "gloo", 0.0), (2, 4, "gloo", 0.0)]
    assert res["rows"][0]["weak_scaling_eff"] == 1.0
    assert "share" in res["note"]
    assert json.loads((tmp_path / "scaling.json").read_text()) == res


def test_trace_bench_writes_a_trace(small, tmp_path):
    res = trace_bench.main(["--device", "cpu", "--batch", "2", "--reps", "1",
                            "--out", str(tmp_path)])
    assert res["trace"] == str(tmp_path / "trace.json")
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert res["profile"] is None  # no device time on the CPU


@pytest.mark.parametrize("tool", [profile_components, turbo_kernel_bench, trace_bench,
                                  dp_evidence, scaling_bench])
def test_tools_default_to_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])
