"""Port parity: the multi-device PHY pipeline — ``parallel/{mesh,dist,stream,
pipeline}``, ``sch.dlsch_decode(cb_shard=…)`` and ``tools/multichip`` —
over torch.distributed against the JAX package's ``shard_map`` programs.

One module fixture launches, through ``tools/multichip``'s launcher, a
2-rank (1, 2) and a 4-rank (2, 2) Gloo run on the CPU: child processes that
import no JAX, one thread each, meeting at a ``file://`` store.  Each rank
runs the sharded FIR and OFDM demod, the ``cb_shard`` decode (at dp = 1),
``PipelineStep.local_step`` on given noise, writes them to an npz, then runs
the tool's dry run at the tiny configuration and prints its result line.
The inputs come from numpy seeds, written by this process before the launch.
The JAX side runs here on the conftest's virtual CPU devices, under
``shard_map`` with the fast-compile options.  The children decode on the f32
route (``TURBO_KERNEL=v4``), as the JAX decoder on the CPU does.

Tolerances: bits, CRC flags, mesh layouts, block counts and the reduced
metrics identical; samples, grids and soft-buffer LLRs within rtol 1e-4 /
atol 1e-3.
"""

import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from srsran_4g_tpu.models import grid as jgrid
from srsran_4g_tpu.models import pdsch as jpdsch
from srsran_4g_tpu.models import sch as jsch
from srsran_4g_tpu.ops import ofdm as jofdm
from srsran_4g_tpu.parallel import mesh as jmesh
from srsran_4g_tpu.parallel import pipeline as jpipeline
from srsran_4g_tpu.parallel import stream as jstream
from srsran_4g_tpu_torch.models import sch
from srsran_4g_tpu_torch.parallel import dist, mesh, pipeline
from srsran_4g_tpu_torch.tools import multichip

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-3)
FAST = dict(xla_backend_optimization_level=0, xla_cpu_use_fusion_emitters=False,
            xla_cpu_parallel_codegen_split_count=1)
MESHES = {2: (1, 2), 4: (2, 2)}
STREAM_PRB, STREAM_ROWS = 25, 4
# cb_shard: 3 TBs of 3 code blocks (K = 4352): 9 lanes, padded to 10 at sp = 2;
# the lanes pass their CRC after 1 or 2 iterations, or (amplitude 0) never
DLSCH = dict(tbs=12960, g=36000, qm=2, n_iter=4)
DLSCH_AMPS = ((4.0, 2.2, 2.4), (2.6, 2.8, 3.0), (3.2, 0.0, 2.0))
STEP_ROWS_PER_DP, STEP_SNR_DB, STEP_N_ITER = 3, 20.0, 2  # 3 TBs a dp row: padded lanes

_WORKER = """
import json, os, sys
sys.path.insert(0, {repo!r})
from pathlib import Path
import numpy as np
import torch
import torch.distributed as tdist
from srsran_4g_tpu_torch.models import sch
from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig
from srsran_4g_tpu_torch.parallel import dist, mesh as mesh_mod, pipeline, stream
from srsran_4g_tpu_torch.tools import multichip

out = Path(sys.argv[1])
args = multichip.parse_args(sys.argv[2:])
mesh = multichip.rank_setup(args)
inp = np.load(out / "inputs.npz")
dp, sp = mesh.shape["dp"], mesh.shape["sp"]
i, j = mesh.coordinate
group = mesh.get_group("sp")
res = {{}}

# the stream operators on a dp-sharded, sp-chunked batch; with four ranks
# also on a (1, 4) mesh, whose ring tells left from right
ocfg = OfdmConfig(nof_prb={prb})
for key, m in (("", mesh),) + ((("_1x4", mesh_mod.make_mesh(1, 4, device=mesh.device)),)
                                if args.world == 4 else ()):
    (mdp, msp), (mi, mj) = m.ranks.shape, m.coordinate
    rows, chunk = inp["stream"].shape[0] // mdp, ocfg.sf_len // msp
    x = dist.host_local_batch(m, inp["stream"][mi * rows:(mi + 1) * rows,
                                               mj * chunk:(mj + 1) * chunk])
    g = m.get_group("sp")
    res["fir" + key] = stream.fir_filter_sharded(x, torch.as_tensor(inp["taps"]), g).numpy()
    res["demod" + key] = stream.ofdm_demodulate_sharded(ocfg, x, g).numpy()

# the code-block-sharded decode, on the f32 and the bf16 route
if dp == 1:
    plan = sch.dlsch_plan({tbs}, {g}, {qm})
    for route in ("v4", "v9"):
        os.environ["TURBO_KERNEL"] = route
        bits, ok, _ = sch.dlsch_decode(plan, torch.as_tensor(inp["llr"]), n_iter={n_iter},
                                       cb_shard=(group, sp))
        res["cb_bits_" + route], res["cb_ok_" + route] = bits.numpy(), ok.numpy()
    os.environ["TURBO_KERNEL"] = "v4"

# the pipeline body on given noise
cfg = multichip.pdsch_config("tiny")
step = pipeline.make_pipeline_step(cfg, mesh, snr_db={snr}, n_iter={step_iter})
b = {rows_per_dp}
chunk = step.chunk
metrics, rx = step.local_step(
    torch.as_tensor(inp["step_bits"][i * b:(i + 1) * b]),
    torch.as_tensor(inp["step_noise"][i * b:(i + 1) * b, j * chunk:(j + 1) * chunk]))
res.update(grid=rx["rx_grid"].numpy(), bits=rx["bits"].numpy(), crc_ok=rx["crc_ok"].numpy(),
           soft0=rx["softbuffers"][0].numpy(),
           metrics=np.array([metrics[k] for k in ("bit_errors", "blocks_ok", "blocks", "bler")]),
           jax_imported="jax" in sys.modules)
np.savez(out / f"w{{args.world}}_r{{mesh.rank}}.npz", **res)

# the tool's own dry run at the tiny configuration
result = multichip.rank_run(args, mesh)
print(json.dumps(result), flush=True)
tdist.destroy_process_group()
"""


def _step_inputs(rng, rows):
    cfg = multichip.pdsch_config("tiny")
    sf_len = jofdm.OfdmConfig(nof_prb=cfg.cell.nof_prb).sf_len
    bits = rng.integers(0, 2, size=(rows, cfg.tbs)).astype(np.int8)
    noise = (rng.standard_normal((rows, sf_len))
             + 1j * rng.standard_normal((rows, sf_len))).astype(np.complex64)
    return bits, noise


def _dlsch_llr():
    """Noisy BPSK LLRs of three encoded TBs, each code block at its own
    amplitude (DLSCH_AMPS) under unit-amplitude-2 noise."""
    rng = np.random.default_rng(5)
    plan = sch.dlsch_plan(DLSCH["tbs"], DLSCH["g"], DLSCH["qm"])
    bits = rng.integers(0, 2, size=(3, DLSCH["tbs"])).astype(np.int8)
    cw = sch.dlsch_encode(plan, torch.as_tensor(bits)).numpy()
    amp = np.repeat(np.asarray(DLSCH_AMPS, np.float32), plan.groups[0].e_bits, axis=1)
    return (amp * (2.0 * cw - 1) + 2.0 * rng.standard_normal(cw.shape)).astype(np.float32)


def _jax_mesh(world, shape=None):
    dp, sp = shape or MESHES[world]
    return jmesh.make_mesh(dp=dp, sp=sp, devices=jax.devices()[:world])


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(11)
    ocfg = jofdm.OfdmConfig(nof_prb=STREAM_PRB)
    grid = (rng.standard_normal((STREAM_ROWS, ocfg.nsymb_sf, ocfg.nre))
            + 1j * rng.standard_normal((STREAM_ROWS, ocfg.nsymb_sf, ocfg.nre))
            ).astype(np.complex64)
    samples = np.asarray(_compile(lambda g: jofdm.modulate(ocfg, g), grid)(grid))
    step_bits, step_noise = _step_inputs(rng, 2 * STEP_ROWS_PER_DP)
    data = dict(stream=samples, taps=pipeline.channel_taps(), llr=_dlsch_llr(),
                step_bits=step_bits, step_noise=step_noise)
    np.savez(out / "inputs.npz", **data)
    return out, data


@pytest.fixture(scope="module")
def runs(inputs):
    """{world: (the launcher's result lines, each rank's npz)} of one
    2-rank and one 4-rank Gloo launch on the CPU."""
    out, _ = inputs
    worker = out / "worker.py"
    worker.write_text(_WORKER.format(
        repo=str(REPO), prb=STREAM_PRB, n_iter=DLSCH["n_iter"], snr=STEP_SNR_DB,
        step_iter=STEP_N_ITER, rows_per_dp=STEP_ROWS_PER_DP,
        **{k: DLSCH[k] for k in ("tbs", "g", "qm")}))
    env = dict(os.environ, OMP_NUM_THREADS="1", TURBO_KERNEL="v4")
    done = {}
    for world in MESHES:
        results = multichip.launch(world, device="cpu", backend="gloo", configs="tiny",
                                   timeout=240, child=[sys.executable, str(worker), str(out)],
                                   env=env)
        done[world] = (results, [dict(np.load(out / f"w{world}_r{r}.npz"))
                                 for r in range(world)])
    return done


@pytest.mark.parametrize("dp,sp,world", [(4, 2, 8), (2, 2, 4), (1, 2, 2), (3, 2, 8)])
def test_mesh_layout_matches_jax(dp, sp, world):
    """Rank r sits where JAX puts device r; a dp*sp that misses the world
    fails in both."""
    if dp * sp != world:
        with pytest.raises(AssertionError, match="dp\\*sp=6"):
            jmesh.make_mesh(dp=dp, sp=sp, devices=jax.devices()[:world])
        with pytest.raises(ValueError, match="dp\\*sp=6 != 8 ranks"):
            mesh.rank_grid(world, dp, sp)
        return
    jm = jmesh.make_mesh(dp=dp, sp=sp, devices=jax.devices()[:world])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(mesh.rank_grid(world, dp, sp), ids)
    np.testing.assert_array_equal(mesh.rank_grid(world, sp=sp), ids)  # dp=None
    assert dict(jm.shape) == {"dp": dp, "sp": sp}


def test_channel_taps_equal_jax():
    """The taps JAX's make_pipeline_step closes over, read off its body."""
    cfg = jpdsch.PdschConfig(cell=jgrid.CellConfig(nof_prb=6, cell_id=1, cfi=1), rnti=0x46,
                             subframe=4, mod="qpsk", tbs=152)
    body = jpipeline.make_pipeline_step(cfg, _jax_mesh(4)).__wrapped__.__wrapped__
    cells = dict(zip(body.__code__.co_freevars, (c.cell_contents for c in body.__closure__)))
    np.testing.assert_array_equal(pipeline.channel_taps(), np.asarray(cells["taps_j"]))


@pytest.mark.parametrize("world", list(MESHES))
def test_stream_ops_match_jax(runs, inputs, world):
    """fir_filter_sharded and ofdm_demodulate_sharded at 25 PRB, each rank's
    shard against JAX's shard_map outputs (rtol 1e-4 / atol 1e-3), on the
    run's mesh and, with four ranks, on a (1, 4) mesh too (at sp = 2 the
    left and the right neighbour are one rank)."""
    data = inputs[1]
    x, taps = data["stream"], data["taps"]
    ocfg = jofdm.OfdmConfig(nof_prb=STREAM_PRB)
    for key, (dp, sp) in (("", MESHES[world]),) + ((("_1x4", (1, 4)),) if world == 4 else ()):
        jm = _jax_mesh(world, (dp, sp))
        fir = np.asarray(_compile(shard_map(
            lambda s: jstream.fir_filter_sharded(s, jax.numpy.asarray(taps), "sp"), mesh=jm,
            in_specs=P("dp", "sp"), out_specs=P("dp", "sp")), x)(x))
        demod = np.asarray(_compile(shard_map(
            lambda s: jstream.ofdm_demodulate_sharded(ocfg, s, "sp"), mesh=jm,
            in_specs=P("dp", "sp"), out_specs=P("dp"), check_vma=False), x)(x))
        rows, chunk = STREAM_ROWS // dp, ocfg.sf_len // sp
        for r, rank in enumerate(runs[world][1]):
            i, j = divmod(r, sp)
            np.testing.assert_allclose(rank["fir" + key], fir[i * rows:(i + 1) * rows,
                                                               j * chunk:(j + 1) * chunk], **TOL)
            np.testing.assert_allclose(rank["demod" + key], demod[i * rows:(i + 1) * rows],
                                       **TOL)
            assert not rank["jax_imported"]


def test_cb_shard_decode_matches_jax_and_unsharded(runs, inputs, monkeypatch):
    """9 lanes over sp = 2 (one lane of padding): bits and CRC flags equal to
    JAX's sharded decode and to the port's own unsharded decode, on the f32
    route (JAX's) and the bf16 one, on both ranks."""
    llr = inputs[1]["llr"]
    plan_j = jsch.dlsch_plan(DLSCH["tbs"], DLSCH["g"], DLSCH["qm"])
    plan = sch.dlsch_plan(DLSCH["tbs"], DLSCH["g"], DLSCH["qm"])
    assert (plan.segm.C, len(plan.groups)) == (3, 1)
    jbits, jok = _compile(shard_map(
        lambda l: jsch.dlsch_decode(plan_j, l, n_iter=DLSCH["n_iter"], cb_shard=("sp", 2))[:2],
        mesh=_jax_mesh(2), in_specs=P(), out_specs=(P(), P()), check_vma=False), llr)(llr)
    assert np.asarray(jok).tolist() == [True, True, False]  # lane 7 never passes
    for route in ("v4", "v9"):
        monkeypatch.setenv("TURBO_KERNEL", route)
        bits, ok, _ = sch.dlsch_decode(plan, torch.as_tensor(llr), n_iter=DLSCH["n_iter"])
        for rank in runs[2][1]:
            np.testing.assert_array_equal(rank["cb_bits_" + route], bits.numpy())
            np.testing.assert_array_equal(rank["cb_ok_" + route], ok.numpy())
            if route == "v4":
                np.testing.assert_array_equal(rank["cb_bits_v4"], np.asarray(jbits))
                np.testing.assert_array_equal(rank["cb_ok_v4"], np.asarray(jok))


def _jax_local_step(world, bits, noise):
    """JAX's pipeline body composed from its pieces on given noise, under
    shard_map: (grid, bits, crc_ok, soft-buffer 0, psum'd stats)."""
    dp, sp = MESHES[world]
    cfg = jpdsch.PdschConfig(cell=jgrid.CellConfig(nof_prb=6, cell_id=1, cfi=1), rnti=0x46,
                             subframe=4, mod="qpsk", tbs=152)
    ocfg = jofdm.OfdmConfig(nof_prb=6)
    taps = jax.numpy.asarray(pipeline.channel_taps())
    std = np.sqrt(np.float32(10.0 ** (-STEP_SNR_DB / 10.0)) / 2, dtype=np.float32)
    jnp = jax.numpy

    def body(tb, n):
        samples = jofdm.modulate(ocfg, jpdsch.add_crs(cfg, jpdsch.encode(cfg, tb)))
        chunk = ocfg.sf_len // sp
        local = jax.lax.dynamic_slice_in_dim(samples, jax.lax.axis_index("sp") * chunk,
                                             chunk, -1)
        noisy = jstream.fir_filter_sharded(local, taps, "sp") + std.astype(np.complex64) * n
        grid = jstream.ofdm_demodulate_sharded(ocfg, noisy, "sp")
        out = jpdsch.decode(cfg, grid, n_iter=STEP_N_ITER, cb_shard=("sp", sp))
        stats = jnp.stack([jnp.sum(out["bits"] != tb) / sp, jnp.sum(out["crc_ok"]) / sp,
                           jnp.asarray(tb.shape[0] / sp, jnp.float32)]).astype(jnp.float32)
        return (grid, out["bits"], out["crc_ok"], out["softbuffers"][0],
                jax.lax.psum(stats, ("dp", "sp")))

    fn = shard_map(body, mesh=_jax_mesh(world), in_specs=(P("dp", None), P("dp", "sp")),
                   out_specs=(P("dp"), P("dp"), P("dp"), P("dp"), P()), check_vma=False)
    return [np.asarray(a) for a in _compile(fn, bits, noise)(bits, noise)]


@pytest.mark.parametrize("world", list(MESHES))
def test_local_step_matches_jax(runs, inputs, world):
    """local_step at 6 PRB QPSK TBS 152 on the same noise as JAX's body:
    grids and soft-buffer LLRs within rtol 1e-4 / atol 1e-3; bits, CRCs and
    the reduced metrics identical."""
    dp, sp = MESHES[world]
    rows = dp * STEP_ROWS_PER_DP
    bits, noise = inputs[1]["step_bits"][:rows], inputs[1]["step_noise"][:rows]
    grid, jbits, jok, soft0, stats = _jax_local_step(world, bits, noise)
    b = STEP_ROWS_PER_DP
    for r, rank in enumerate(runs[world][1]):
        i = r // sp
        np.testing.assert_allclose(rank["grid"], grid[i * b:(i + 1) * b], **TOL)
        np.testing.assert_allclose(rank["soft0"], soft0[i * b:(i + 1) * b], **TOL)
        np.testing.assert_array_equal(rank["bits"], jbits[i * b:(i + 1) * b])
        np.testing.assert_array_equal(rank["crc_ok"], jok[i * b:(i + 1) * b])
        np.testing.assert_array_equal(rank["metrics"][:3], stats)
        assert rank["metrics"][3] == np.float32(1.0) - stats[1] / stats[2]


def test_pipeline_step_2x2_matches_jax(runs):
    """The tool's tiny step at (2, 2) against JAX's make_pipeline_step on the
    same bits at 20 dB.  The two packages draw different noise, so only the
    block count and the clean result (no bit or block error) are compared."""
    results, _ = runs[4]
    bits = multichip.config_bits("tiny", 4)
    cfg = jpdsch.PdschConfig(cell=jgrid.CellConfig(nof_prb=6, cell_id=1, cfi=1), rnti=0x46,
                             subframe=4, mod="qpsk", tbs=152)
    jm = _jax_mesh(4)
    step = jpipeline.make_pipeline_step(cfg, jm, snr_db=20.0, n_iter=2)
    sharded = jpipeline.shard_batch(jm, bits)
    key = jax.random.PRNGKey(0)
    out = step.lower(sharded, key).compile(compiler_options=FAST)(sharded, key)
    jax_m = {k: float(v) for k, v in out.items()}
    for r in results:
        m = r["configs"]["tiny"]["metrics"]
        assert m["blocks"] == jax_m["blocks"] == 4.0
        assert m["bler"] == jax_m["bler"] == 0.0
        assert m["bit_errors"] == jax_m["bit_errors"] == 0.0


@pytest.mark.parametrize("world", list(MESHES))
def test_multichip_dry_run(runs, world):
    """tools/multichip at n ranks, the tiny configuration: the JAX dry run's
    mesh rule, 2·dp subframes, a finite BLER, every rank agreeing."""
    results, _ = runs[world]
    dp, sp = MESHES[world]
    assert multichip.mesh_shape(world) == (dp, sp)
    assert multichip.check(results) == []
    for r, res in enumerate(results):
        assert (res["rank"], res["mesh"], res["coordinate"]) == (
            r, {"dp": dp, "sp": sp}, list(divmod(r, sp)))
        assert res["backend"] == "gloo" and res["ok"]
        assert res["configs"]["tiny"]["metrics"]["blocks"] == 2 * dp
        assert json.dumps(res["configs"]["tiny"]["metrics"]) == json.dumps(
            results[0]["configs"]["tiny"]["metrics"])


def test_nccl_refuses_more_ranks_than_cards():
    """NCCL takes one card a rank and CUDA devices only: the error names Gloo,
    and nothing falls back (here, with no card, even one rank is refused)."""
    with pytest.raises(ValueError, match="backend='gloo'"):
        dist.check_backend("nccl", torch.cuda.device_count() + 1, torch.device("cuda"))
    with pytest.raises(ValueError, match="backend='gloo'"):
        dist.check_backend("nccl", 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="backend='gloo'"):
        multichip.launch(torch.cuda.device_count() + 1, device="cuda", backend="nccl")
    dist.check_backend("gloo", 4, torch.device("cpu"))
