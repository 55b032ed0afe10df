"""Weak scaling of the sharded pipeline step over dp: the port's counterpart
of the JAX package's ``tools/scaling_bench.py``.

The full encode → channel → receive → decode step (``parallel/pipeline``) on
(dp, 1) meshes at dp = 1, 2, 4, 8 with a fixed batch a rank (``--per-dev``,
8): 15 PRB (``--prb``), cell 1, RNTI 0x46, 16QAM, TBS 4,392 (``--tbs``),
25 dB, n_iter 4.  The ranks are child processes of ``tools/multichip``'s
launcher (one a rank, meeting at a ``file://`` store); each runs the step
once (its BLER must be 0: every bit and CRC exact), then ``--iters`` timed
steps, each after a barrier, ended by a synchronise on the host clock, and
on a card one more under torch.profiler (``multichip --measure``, which also
holds the sharded stream operators against the dense ones).  A row a dp:
the slowest rank's mean step ms (host) and the largest rank's device busy ms
a step (``step_device_busy_ms``), subframes/s and the weak-scaling
efficiency (subframes/s over dp times dp = 1's).

Backends: Gloo on the CPU (the counterpart of the JAX tool's virtual CPU
devices); on CUDA, NCCL where there are as many cards as ranks and Gloo
otherwise (NCCL refuses two ranks on one card), or ``--backend`` for every
dp.  Several ranks on one card share its SMs and Gloo's collectives go
through the host, so there the efficiency measures the sharing and the
host's transport, not NVLink; the JSON's note says which was measured.

By default the dp list stops at the largest dp the machine can hold: no more
ranks than the host has CPU cores (each rank's host thread paces its
kernels), and on one card no more than its free memory over
``RANK_BYTES``.  Writes ``artifacts/torch/scaling.json`` and prints a table.

    python -m srsran_4g_tpu_torch.tools.scaling_bench [--per-dev 8] [--iters 5]
        [--prb 15] [--tbs 4392] [--dps 1,2,4,8] [--device cuda] [--backend gloo]

``--device`` defaults to cuda and raises without a card.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.tools import multichip

CONFIG = "scaling"
DPS = (1, 2, 4, 8)
RANK_BYTES = 2 << 30  # a 15 PRB rank's CUDA context, kernels and tensors, with room
DEFAULT_OUT = os.path.join("artifacts", "torch", "scaling.json")


def config(prb: int, tbs: int) -> dict:
    """The step's configuration, in ``multichip.CONFIGS``' form."""
    return dict(nof_prb=prb, cell_id=1, rnti=0x46, mod="16qam", tbs=tbs, snr_db=25.0,
                n_iter=4, rows_per_dp=1, seed=0, exact=True)


def max_dp(device: torch.device) -> tuple[int, str]:
    """The largest dp this machine holds, and what limits it."""
    cores = os.cpu_count() or 1
    if device.type != "cuda" or torch.cuda.device_count() > 1:
        return cores, f"{cores} CPU cores"
    free, _ = torch.cuda.mem_get_info(device)
    by_mem = free // RANK_BYTES
    if by_mem < cores:
        return by_mem, f"{free / 2**30:.1f} GiB free on the card at {RANK_BYTES >> 30} GiB a rank"
    return cores, f"{cores} CPU cores"


def backend_for(dp: int, device: torch.device, backend: str | None) -> str:
    if backend:
        return backend
    if device.type == "cuda" and dp <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def run(dps, per_dev: int = 8, iters: int = 5, prb: int = 15, tbs: int = 4392,
        device=None, backend: str | None = None, timeout: float = 600.0,
        out: str | None = DEFAULT_OUT) -> dict:
    """A row a dp in ``dps``; writes the JSON to ``out`` (None: nowhere)."""
    dev = resolve_device(device)
    child = [sys.executable, "-m", "srsran_4g_tpu_torch.tools.scaling_bench",
             "--prb", str(prb), "--tbs", str(tbs)]
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
    rows = []
    for dp in dps:
        be = backend_for(dp, dev, backend)
        res = multichip.launch(dp, device=dev.type, backend=be, configs=CONFIG,
                               batch=per_dev * dp, reps=iters, measure=dev.type == "cuda",
                               timeout=timeout, child=child, env=env, mesh=(dp, 1))
        bad = multichip.check(res)
        bler = res[0]["configs"][CONFIG]["metrics"]["bler"]
        if bad or bler != 0.0:
            raise AssertionError(f"dp={dp}: BLER {bler}; {bad}")
        runs = [r["configs"][CONFIG] for r in res]
        step_ms = max(sum(c["step_ms"]) / iters for c in runs)
        busy = max(c["profile"]["device_ms"] for c in runs) if "profile" in runs[0] else None
        b = per_dev * dp
        rows.append(dict(dp=dp, batch=b, backend=be, step_ms=step_ms, step_device_busy_ms=busy,
                         subframes_per_s=b / step_ms * 1e3, bler=bler))
        dev_s = f"{busy:.2f} ms" if busy is not None else "not measured"
        print(f"dp={dp}: batch={b} step={step_ms:.1f} ms (device busy {dev_s}) over {be} "
              f"-> {b / step_ms * 1e3:.0f} sf/s", flush=True)
    base = rows[0]["subframes_per_s"] / rows[0]["dp"]
    for r in rows:
        r["weak_scaling_eff"] = r["subframes_per_s"] / (r["dp"] * base)
    where = (f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(dev)}"
             if dev.type == "cuda" else "cpu")
    shared = dev.type == "cpu" or max(dps) > torch.cuda.device_count()
    note = (f"{where}: ranks are processes that share "
            + ("the host's cores" if dev.type == "cpu" else "one card's SMs")
            + " and Gloo's collectives go through the host, so efficiency measures the "
              "sharing and the transport, not chip (NVLink) speedup; the dp axis's only "
              "collective is the metrics' sum" if shared else
            f"{where}: one rank a card over NCCL")
    result = dict(config=dict(prb=prb, mod="16qam", tbs=tbs, per_dev_batch=per_dev,
                              iters=iters, snr_db=25.0, n_iter=4),
                  device=where, note=note, rows=rows)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    print("| dp | batch | step ms | device busy ms | sf/s | weak-scaling eff |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        busy = r["step_device_busy_ms"]
        dev_s = f"{busy:.2f}" if busy is not None else "-"
        print(f"| {r['dp']} | {r['batch']} | {r['step_ms']:.1f} | {dev_s} | "
              f"{r['subframes_per_s']:.0f} | {r['weak_scaling_eff']:.2f} |", flush=True)
    return result


def main(argv=None) -> dict | None:
    ap = multichip.parser()
    ap.description = __doc__.split("\n\n")[0]
    ap.add_argument("--per-dev", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--prb", type=int, default=15)
    ap.add_argument("--tbs", type=int, default=4392)
    ap.add_argument("--dps", default=None, help="dp values (default 1,2,4,8 up to the machine's)")
    ap.add_argument("--out", default=DEFAULT_OUT, help="the JSON file")
    args = ap.parse_args(argv)
    if args.rank is not None:  # a rank the launcher started
        multichip.CONFIGS[CONFIG] = config(args.prb, args.tbs)
        multichip.rank_main(args)
        return None
    dev = resolve_device(args.device)
    if args.dps:
        dps = [int(x) for x in args.dps.split(",")]
    else:
        top, why = max_dp(dev)
        dps = [dp for dp in DPS if dp <= top]
        print(f"dp up to {max(dps)}: this machine holds {top} ranks ({why})", flush=True)
    return run(dps, args.per_dev, args.iters, args.prb, args.tbs, dev, args.backend,
               args.timeout, args.out)


if __name__ == "__main__":
    main()
