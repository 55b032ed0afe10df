"""Multi-device dry run of the sharded PHY pipeline over torch.distributed.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip(n)``:
n ranks, one OS process each, form a (dp, sp) mesh (sp = 2 when n is even,
dp = n // sp) and run ``parallel/pipeline``'s step on two configurations:

- tiny: 6 PRB, QPSK, TBS 152, turbo n_iter 2, 20 dB, 2·dp subframes; the
  BLER must be finite;
- bench: 100 PRB, 64QAM, TBS 75376 (13 code blocks, K = 5824), n_iter 4,
  30 dB, dp subframes; every bit must equal the one sent and every CRC pass.

    python -m srsran_4g_tpu_torch.tools.multichip --n 4 --device cpu
    python -m srsran_4g_tpu_torch.tools.multichip --n 1            # NCCL, one card
    python -m srsran_4g_tpu_torch.tools.multichip --n 2 --backend gloo

The launcher starts the ranks as child processes that meet at a ``file://``
store in a temporary directory (no port is fixed), gives them one deadline,
and exits non-zero if any rank fails, disagrees or runs out of time.  Each
rank prints one JSON line of its results.  ``--device`` defaults to CUDA,
with no fallback; ``--backend`` to NCCL on CUDA (one rank a card) and Gloo
on the CPU.  Gloo also puts several ranks on one card.  ``--batch``,
``--reps`` and ``--measure`` add a wider batch, timed steps, and a profiled
step (on a card), the collectives' times and the sharded stream operators
held against the dense ones.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist

CONFIGS = {
    "tiny": dict(nof_prb=6, cell_id=1, rnti=0x46, mod="qpsk", tbs=152, snr_db=20.0,
                 n_iter=2, rows_per_dp=2, seed=0, exact=False),
    "bench": dict(nof_prb=100, cell_id=123, rnti=0x1234, mod="64qam", tbs=75376,
                  snr_db=30.0, n_iter=4, rows_per_dp=1, seed=1, exact=True),
}
STREAM_ATOL = 1e-4  # sharded FIR / OFDM demod against the dense ones (f32)
ROOT = Path(__file__).resolve().parents[2]  # the directory holding the package


def mesh_shape(n: int) -> tuple[int, int]:
    """(dp, sp) for n ranks, the JAX dry run's rule."""
    sp = 2 if n % 2 == 0 and n >= 2 else 1
    return n // sp, sp


def pdsch_config(name: str):
    from srsran_4g_tpu_torch.models import grid, pdsch

    c = CONFIGS[name]
    return pdsch.PdschConfig(cell=grid.CellConfig(nof_prb=c["nof_prb"], cell_id=c["cell_id"],
                                                  cfi=1),
                             rnti=c["rnti"], subframe=4, mod=c["mod"], tbs=c["tbs"])


def config_bits(name: str, rows: int) -> np.ndarray:
    """The global batch of TBs (rows, tbs) int8 a configuration sends."""
    c = CONFIGS[name]
    rng = np.random.default_rng(c["seed"])
    return rng.integers(0, 2, size=(rows, c["tbs"])).astype(np.int8)


def parser() -> argparse.ArgumentParser:
    """The launcher's and a rank's arguments."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1, help="ranks (OS processes)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, help="nccl or gloo")
    ap.add_argument("--configs", default="tiny,bench")
    ap.add_argument("--batch", type=int, default=None,
                    help="global subframes a step (default: rows_per_dp * dp)")
    ap.add_argument("--reps", type=int, default=0, help="timed steps after the first")
    ap.add_argument("--measure", action="store_true",
                    help="time the collectives and check the sharded stream operators")
    ap.add_argument("--timeout", type=float, default=600.0)
    # set by the launcher for each rank
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh", default=None, help=argparse.SUPPRESS)  # "dp,sp"
    return ap


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    return parser().parse_args(argv)


# ---- one rank ---------------------------------------------------------------


def rank_setup(args: argparse.Namespace):
    """Join the group, bind the device, load the kernels; → the mesh."""
    from srsran_4g_tpu_torch.parallel import dist, mesh as mesh_mod

    dev = dist.init_distributed(args.init, args.world, args.rank, device=args.device,
                                backend=args.backend)
    if dev.type == "cuda":
        from srsran_4g_tpu_torch.ops.cuda import turbo_map

        turbo_map.load_kernels()  # no rank waits in a collective for a build
        torch.cuda.reset_peak_memory_stats(dev)
    dp, sp = (tuple(int(x) for x in args.mesh.split(",")) if args.mesh
              else mesh_shape(args.world))
    return mesh_mod.make_mesh(dp=dp, sp=sp, device=dev)


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _best_ms(fn, mesh, reps: int = 3) -> float:
    """Best of ``reps`` calls, each bracketed by synchronises."""
    best = math.inf
    for _ in range(reps):
        _sync(mesh)
        t0 = time.perf_counter()
        fn()
        _sync(mesh)
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _collective_ms(mesh, step, rows: int) -> dict[str, float]:
    """The step's collectives alone at its shapes: the halo exchange (the
    FIR's left tails and the OFDM demod's right heads), the grid
    all_reduce and the hard-bit all_gather of the code-block lanes."""
    from srsran_4g_tpu_torch.parallel import dist, stream

    group = mesh.get_group("sp")
    cfg, ocfg = step.cfg, step.ofdm_cfg
    x = torch.zeros((rows, step.chunk), dtype=torch.complex64, device=mesh.device)
    h = min(ocfg.symbol_sz + ocfg.cp_len(0), step.chunk)
    grid = torch.zeros((rows, ocfg.nsymb_sf, ocfg.nre), dtype=torch.complex64,
                       device=mesh.device)
    grp = cfg.plan.groups[-1]
    lanes = -(-rows * grp.count // step.sp)
    hard = torch.zeros((lanes, grp.K), dtype=torch.int8, device=mesh.device)
    return {"halo": _best_ms(lambda: (stream.left_halo(x, step.taps.shape[0] - 1, group),
                                      stream.right_halo(x, h, group)), mesh),
            "grid_all_reduce": _best_ms(lambda: dist.all_reduce_sum(grid, group), mesh),
            "bits_all_gather": _best_ms(lambda: dist.all_gather(hard, group), mesh)}


def _stream_check(mesh, step, rows: int) -> dict[str, float]:
    """The sharded FIR and OFDM demod on this rank's chunk against the dense
    ``np.convolve`` and ``ofdm.demodulate`` of the whole stream."""
    from srsran_4g_tpu_torch.ops import ofdm
    from srsran_4g_tpu_torch.parallel import stream

    group = mesh.get_group("sp")
    ocfg, chunk = step.ofdm_cfg, step.chunk
    lo = mesh.coordinate[1] * chunk
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((rows, ocfg.sf_len))
         + 1j * rng.standard_normal((rows, ocfg.sf_len))).astype(np.complex64)
    taps = step.taps.cpu().numpy()
    fir = stream.fir_filter_sharded(torch.as_tensor(x[:, lo:lo + chunk]).to(mesh.device),
                                    step.taps, group)
    dense = np.stack([np.convolve(r, taps)[:ocfg.sf_len] for r in x])[:, lo:lo + chunk]
    g = (rng.standard_normal((rows, ocfg.nsymb_sf, ocfg.nre))
         + 1j * rng.standard_normal((rows, ocfg.nsymb_sf, ocfg.nre))).astype(np.complex64)
    samples = ofdm.modulate(ocfg, torch.as_tensor(g).to(mesh.device))
    got = stream.ofdm_demodulate_sharded(ocfg, samples[:, lo:lo + chunk].contiguous(), group)
    want = ofdm.demodulate(ocfg, samples)
    return {"fir_max_abs_err": float(np.abs(fir.cpu().numpy() - dense).max()),
            "ofdm_max_abs_err": float((got - want).abs().max())}


def _profile(fn) -> dict:
    """One call of fn under torch.profiler: device ms (kernels and copies),
    their count, and the three costliest by name."""
    from srsran_4g_tpu_torch.tools import trace_bench

    ops = trace_bench.kernel_events(fn, 1)
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:3]
    return {"device_ms": sum(e.self_device_time_total for e in ops) / 1e3,
            "kernels": sum(e.count for e in ops),
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top]}


def run_config(mesh, name: str, batch: int | None = None, reps: int = 0,
               measure: bool = False) -> dict:
    """One configuration's step on this rank: metrics, launches, times."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map
    from srsran_4g_tpu_torch.parallel import pipeline

    c = CONFIGS[name]
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    cfg = pdsch_config(name)
    step = pipeline.make_pipeline_step(cfg, mesh, snr_db=c["snr_db"], n_iter=c["n_iter"])
    rows = batch or c["rows_per_dp"] * dp
    bits = pipeline.shard_batch(mesh, config_bits(name, rows))
    turbo_map.launches.clear()
    _sync(mesh)
    t0 = time.perf_counter()
    metrics = step(bits, c["seed"])
    _sync(mesh)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(turbo_map.launches)
    grp = cfg.plan.groups[-1]
    cb_lanes = -(-bits.shape[0] * grp.count // sp)
    res = dict(rows=rows, rows_local=bits.shape[0], metrics=metrics, first_ms=first_ms,
               launches=launches, cb_lanes=cb_lanes, K=grp.K)
    if reps:
        times = []
        for _ in range(reps):
            tdist.barrier()
            _sync(mesh)
            t0 = time.perf_counter()
            step(bits, c["seed"])
            _sync(mesh)
            times.append((time.perf_counter() - t0) * 1e3)
        res["step_ms"] = times
    if measure:
        if mesh.device.type == "cuda":
            res["profile"] = _profile(lambda: step(bits, c["seed"]))
        res["stream_check"] = _stream_check(mesh, step, bits.shape[0])
        if sp > 1:
            res["collective_ms"] = _collective_ms(mesh, step, bits.shape[0])
    failures = []
    if not math.isfinite(metrics["bler"]):
        failures.append("the BLER is not finite")
    if metrics["blocks"] != rows:
        failures.append(f"{metrics['blocks']} blocks counted of {rows}")
    if c["exact"] and (metrics["bit_errors"] or metrics["blocks_ok"] != metrics["blocks"]):
        failures.append("bits or CRCs differ from those sent")
    for key, err in res.get("stream_check", {}).items():
        if not err <= STREAM_ATOL:
            failures.append(f"{key} {err} > {STREAM_ATOL}")
    res["failures"] = failures
    return res


def rank_run(args: argparse.Namespace, mesh) -> dict:
    """Every asked configuration on this rank → its JSON-able result."""
    configs = {name: run_config(mesh, name, batch=args.batch, reps=args.reps,
                                measure=args.measure)
               for name in args.configs.split(",")}
    out = dict(rank=mesh.rank, world=args.world, mesh=mesh.shape,
               coordinate=list(mesh.coordinate), backend=tdist.get_backend(),
               device=(torch.cuda.get_device_name(mesh.device)
                       if mesh.device.type == "cuda" else "cpu"),
               configs=configs, ok=not any(r["failures"] for r in configs.values()))
    if mesh.device.type == "cuda":
        out["peak_mib"] = torch.cuda.max_memory_allocated(mesh.device) / 2**20
    return out


def rank_main(args: argparse.Namespace) -> None:
    mesh = rank_setup(args)
    try:
        print(json.dumps(rank_run(args, mesh)), flush=True)
    finally:
        tdist.destroy_process_group()


# ---- the launcher -------------------------------------------------------------


def launch(n: int, device: str = "cuda", backend: str | None = None,
           configs: str = "tiny,bench", batch: int | None = None, reps: int = 0,
           measure: bool = False, timeout: float = 600.0, child: list[str] | None = None,
           env: dict | None = None, mesh: tuple[int, int] | None = None) -> list[dict]:
    """Start n ranks and return their results in rank order.

    ``child`` is the rank's command before its arguments (default this
    module); ``mesh`` its (dp, sp) shape (default ``mesh_shape(n)``);
    ``env`` its environment (default this process's; the package's
    directory is put first on PYTHONPATH, and on the CPU OMP_NUM_THREADS
    shares the host's cores out unless it is set).  Raises with
    every rank's output tail if a rank fails, prints no result, or the
    deadline passes.
    """
    from srsran_4g_tpu_torch.parallel import dist

    dev = torch.device(device)
    dist.check_backend(backend or ("nccl" if dev.type == "cuda" else "gloo"), n, dev)
    env = dict(os.environ if env is None else env)
    # the ranks import the package this launcher was imported from
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    if dev.type == "cpu":
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    cmd = child or [sys.executable, "-m", "srsran_4g_tpu_torch.tools.multichip"]
    extra = ["--device", device, "--configs", configs, "--reps", str(reps)]
    extra += ["--backend", backend] if backend else []
    extra += ["--batch", str(batch)] if batch else []
    extra += ["--measure"] if measure else []
    if mesh:
        if mesh[0] * mesh[1] != n:
            raise ValueError(f"a mesh of {mesh} is not {n} ranks")
        extra += ["--mesh", f"{mesh[0]},{mesh[1]}"]
    with tempfile.TemporaryDirectory(prefix="multichip-") as tmp:
        init = Path(tmp, "store").as_uri()
        logs = [Path(tmp, f"rank{r}.log") for r in range(n)]
        procs = []
        for r in range(n):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [*cmd, "--rank", str(r), "--world", str(n), "--init", init, *extra],
                    stdout=f, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout
        problem = None
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    problem = "a rank failed"
                    break
                if time.monotonic() > deadline:
                    problem = f"the ranks ran past {timeout} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:  # the survivors of a failure wait in a collective
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = [log.read_text() for log in logs]
    results = []
    for r, (p, text) in enumerate(zip(procs, texts)):
        found = [json.loads(line) for line in text.splitlines() if line.startswith('{"rank"')]
        if p.returncode != 0 or not found:
            problem = problem or f"rank {r} exited {p.returncode} with no result line"
        results.append(found[-1] if found else None)
    if problem:
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{t[-3000:]}"
                          for r, (p, t) in enumerate(zip(procs, texts)))
        raise RuntimeError(f"multichip: {problem}\n{tails}")
    return results


def check(results: list[dict]) -> list[str]:
    """What is wrong with a launch's results (empty when nothing is): a
    rank's failures, or ranks that disagree on the mesh-summed metrics."""
    bad = [f"rank {r['rank']} {name}: {f}" for r in results
           for name, c in r["configs"].items() for f in c["failures"]]
    for name in results[0]["configs"]:
        if len({json.dumps(r["configs"][name]["metrics"]) for r in results}) != 1:
            bad.append(f"{name}: the ranks' summed metrics differ")
    return bad


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return
    try:
        results = launch(args.n, device=args.device, backend=args.backend,
                         configs=args.configs, batch=args.batch, reps=args.reps,
                         measure=args.measure, timeout=args.timeout)
    except (RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        sys.exit(1)
    for r in results:
        print(json.dumps(r))
    dp, sp = mesh_shape(args.n)
    for name, c in results[0]["configs"].items():
        m = c["metrics"]
        print(f"multichip({args.n}): mesh dp={dp} sp={sp} {name}: {c['rows']} subframes, "
              f"bler={m['bler']:.3f}, bit errors {m['bit_errors']:.0f}")
    bad = check(results)
    if bad:
        print("multichip: " + "; ".join(bad), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
