"""Data-parallel evidence on one card: the port's counterpart of the JAX
package's ``tools/dp_evidence.py``.

The sharded pipeline's dp axis has no dependency between ranks beyond the
metrics' sum, so a rank's rate is the one card's rate at its batch.  Two
measurements on the card anchor that, at ``profile_components.SETTING``
(100 PRB, 64QAM, TBS 75,376, 30 dB; bits from ``np.random.default_rng(0)``,
noise from a ``torch.Generator``), decoding with n_iter ``BENCH_TURBO_ITERS``
(4) and ``BENCH_REPS`` (16) timed decodes a point:

1. batch saturation over ``DP_BATCHES`` (16,32,64,96,128,160): subframes/s
   and ms a decode from the host clock (each decode to a synchronise),
   ``crc_all_ok`` of the last timed decode, and the device's busy ms a
   decode under torch.profiler (``device_busy_ms``, ``trace_bench.busy_ms``);
2. two programs alternating on the one stream, each at half of
   ``BENCH_BATCH`` (128), against one stream of the full batch: the
   aggregate subframes/s of each and the overhead.

Writes ``artifacts/torch/dp_evidence.json`` (the JAX tool's keys,
``batch_sweep`` and ``concurrency``) and prints its JSON last.

    python -m srsran_4g_tpu_torch.tools.dp_evidence [--device cuda]
        [--out artifacts/torch/dp_evidence.json]

``--device`` defaults to cuda and raises without a card; on ``--device
cpu`` the same code runs the kernels' plain versions and no device time is
read.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device

DEFAULT_OUT = os.path.join("artifacts", "torch", "dp_evidence.json")


def time_batch(cfg, rx: torch.Tensor, bits: torch.Tensor, reps: int, n_iter: int) -> dict:
    """A warm decode of the grids ``rx``, ``reps`` timed ones, then three
    under torch.profiler.  Returns crc_all_ok (every CRC of the last timed
    decode), exact (its bits equal ``bits`` too), the host ms of each timed
    decode (``tools.clock_ms``), subframes/s over them, the kernel launches
    of the last (by kernel) and the device's busy ms a decode
    (``trace_bench.busy_ms``; None on the CPU)."""
    from srsran_4g_tpu_torch.models import pdsch
    from srsran_4g_tpu_torch.tools import clock_ms, trace_bench

    def decode():
        return pdsch.decode(cfg, rx, n_iter=n_iter)

    timed = clock_ms(decode, reps, warm=True)
    ok = bool(timed.out["crc_ok"].all())
    batch = rx.shape[0]
    return dict(batch=batch, crc_all_ok=ok, exact=ok and torch.equal(timed.out["bits"], bits),
                host_ms=timed.ms, sf_per_s=batch * reps / (sum(timed.ms) / 1e3),
                launches=timed.launches, device_busy_ms=trace_bench.busy_ms(decode, rx.device))


def build(cfg, batch: int, rng: np.random.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(grids, bits) of ``batch`` fresh TBs from ``rng``."""
    from srsran_4g_tpu_torch.tools import profile_components as pc

    bits = rng.integers(0, 2, (batch, cfg.tbs)).astype(np.int8)
    rx = pc.received(cfg, bits, device)
    return rx, torch.as_tensor(bits, device=rx.device)


def batch_sweep(cfg, batches, reps: int, n_iter: int, device, rng) -> list[dict]:
    """Batch saturation: a row a batch (the JAX tool's keys, the host ms and
    the device's busy ms a decode)."""
    rows = []
    for batch in batches:
        rx, bits = build(cfg, batch, rng, device)
        r = time_batch(cfg, rx, bits, reps, n_iter)
        busy = r["device_busy_ms"]
        rows.append(dict(batch=batch, sf_per_s=round(r["sf_per_s"], 1),
                         crc_all_ok=r["crc_all_ok"], host_ms=sum(r["host_ms"]) / reps,
                         device_busy_ms=busy))
        busy_s = f"{busy:.3f} ms a decode" if busy is not None else "not measured"
        print(f"batch {batch:4d}: {r['sf_per_s']:9.1f} sf/s crc_ok={r['crc_all_ok']} "
              f"device busy {busy_s}", flush=True)
        del rx, bits
    return rows


def concurrency(cfg, batch: int, reps: int, n_iter: int, device, rng) -> dict:
    """Two programs alternating on the one stream, half a batch each (so the
    work in flight matches one stream of ``batch``), against that stream:
    subframes/s from the host clock over ``reps`` rounds."""
    from srsran_4g_tpu_torch.models import pdsch
    from srsran_4g_tpu_torch.tools import clock_ms

    dev = resolve_device(device)
    rx_a, _ = build(cfg, batch // 2, rng, dev)
    rx_b, _ = build(cfg, batch // 2, rng, dev)
    rx_s, _ = build(cfg, batch, rng, dev)
    for rx in (rx_a, rx_b, rx_s):  # warm
        pdsch.decode(cfg, rx, n_iter=n_iter)

    def rounds(*grids):
        for _ in range(reps):
            for rx in grids:
                pdsch.decode(cfg, rx, n_iter=n_iter)

    agg = batch * reps / (clock_ms(lambda: rounds(rx_a, rx_b)).ms[0] / 1e3)
    single = batch * reps / (clock_ms(lambda: rounds(rx_s)).ms[0] / 1e3)
    res = dict(single_stream_sf_per_s=round(single, 1),
               two_stream_aggregate_sf_per_s=round(agg, 1),
               overhead_pct=round(100 * (1 - agg / single), 1))
    print(f"single-stream {single:.1f} sf/s vs two-stream aggregate {agg:.1f} sf/s "
          f"({res['overhead_pct']}% overhead)", flush=True)
    return res


def run(batches, reps: int, n_iter: int, batch: int, device=None,
        out: str | None = DEFAULT_OUT) -> dict:
    """Both measurements; writes the JSON to ``out`` (None: nowhere) and
    prints it."""
    from srsran_4g_tpu_torch.tools import profile_components as pc

    dev = resolve_device(device)
    cfg = pc.config()
    rng = np.random.default_rng(0)
    results = {"batch_sweep": batch_sweep(cfg, batches, reps, n_iter, dev, rng),
               "concurrency": concurrency(cfg, batch, reps, n_iter, dev, rng),
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--out", default=DEFAULT_OUT, help="the JSON file")
    args = ap.parse_args(argv)
    env = os.environ
    return run([int(b) for b in env.get("DP_BATCHES", "16,32,64,96,128,160").split(",")],
               int(env.get("BENCH_REPS", "16")), int(env.get("BENCH_TURBO_ITERS", "4")),
               int(env.get("BENCH_BATCH", "128")), args.device, args.out)


if __name__ == "__main__":
    main()
