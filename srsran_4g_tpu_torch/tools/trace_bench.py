"""A profiler trace of the 20 MHz PDSCH decode on the card: the port's
counterpart of the JAX package's ``tools/trace_bench.py``.

``profile_components.SETTING`` (100 PRB, 64QAM, TBS 75,376, 30 dB) at a
batch of 32: one warm decode, ``--reps`` decodes timed on the host clock
(each to a synchronise; the best is the unprofiled time), then ``--reps``
decodes under ``torch.profiler`` with CPU and CUDA activity.  Writes the
Chrome trace to ``artifacts/torch/trace/`` and prints the device's busy ms
and kernels a decode, the idle share against the unprofiled best time, and
the costliest kernels.

``profile`` is the measurement ``chip_smoke.py`` takes of every profiled
decode; ``busy_ms`` is the device time the other measuring tools report
beside their host clock.

    python -m srsran_4g_tpu_torch.tools.trace_bench [--device cuda] [--batch 32]
        [--reps 3] [--out artifacts/torch/trace]

``--device`` defaults to cuda and raises without a card; on ``--device
cpu`` the profiler records CPU activity only, and the device's times are
"not measured".
"""

from __future__ import annotations

import argparse
import os
import statistics

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device

DEFAULT_OUT = os.path.join("artifacts", "torch", "trace")


def kernel_events(fn, reps: int, trace: str | None = None, cpu_ops: bool = True) -> list:
    """The device entries of ``torch.profiler``'s ``key_averages()`` (kernels
    and copies) over ``reps`` calls of ``fn()``, with CPU activity (unless
    ``cpu_ops`` is False: the host ops' events of a call of tens of
    thousands of kernels take the profiler seconds to aggregate) and, on a
    card, CUDA activity; ``trace`` names a file for the Chrome trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    cuda = torch.cuda.is_available()
    acts = ([ProfilerActivity.CPU] if cpu_ops else []) + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        if cuda:
            torch.cuda.synchronize()
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def busy_ms(fn, device: torch.device, reps: int = 3) -> float | None:
    """The device's busy ms in a call of ``fn()``: its kernels' and copies'
    summed device time under torch.profiler, the median of ``reps`` calls,
    each profiled alone.  On an H100 a session now and then misses a batch
    of device records (20 of a 20 MHz decode's 343 kernels, or all 28 of a
    channel estimate's) or reads another call's as well (2.5 ms for a
    1.2 ms decode), so one reading may be off either way.  None on the CPU,
    or when the median session saw no device time."""
    if device.type != "cuda":
        return None
    return statistics.median(sum(e.self_device_time_total for e in kernel_events(fn, 1))
                             for _ in range(reps)) / 1e3 or None


def profile(fn, reps: int = 3, host_s: float | None = None, card: str = "",
            match: str = "fused", trace: str | None = None) -> dict | None:
    """Device busy ms and kernels a call of ``fn()`` (a decode) over ``reps``
    calls under torch.profiler, the idle share against ``host_s`` (the
    unprofiled best seconds a call), and the device ms of the kernels whose
    name holds ``match``; prints them and the 8 costliest kernels, each line
    after ``[card]``.  ``trace`` names a file for the Chrome trace.  Returns
    dict(device_ms, kernels, match_ms, idle, top) a call, or None when the
    profiler saw no device time (as on the CPU)."""
    kernels = kernel_events(fn, reps, trace)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    tag = f"[{card}] " if card else ""
    if busy <= 0:
        print(f"{tag}profiler saw no device time: idle share not measured", flush=True)
        return None
    n_kernels = sum(e.count for e in kernels) / reps
    match_ms = sum(e.self_device_time_total for e in kernels if match in e.key) / 1e3 / reps
    idle = 1 - busy / (host_s * 1e3) if host_s else None
    idle_s = (f"idle share {idle:.3f} of the unprofiled {host_s * 1e3:.2f} ms"
              if host_s else "idle share not measured")
    print(f"{tag}decode device time {busy:.3f} ms in {n_kernels:.0f} kernels per decode; "
          f"{idle_s}; kernels named *{match}* {match_ms:.4f} ms "
          f"({match_ms / busy:.3f} of the device time)", flush=True)
    costliest = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in costliest:
        print(f"  {e.self_device_time_total / 1e3 / reps:8.3f} ms  x{e.count // reps:<4d} "
              f"{e.key[:90]}", flush=True)
    return dict(device_ms=busy, kernels=n_kernels, match_ms=match_ms, idle=idle,
                top=[[e.key[:90], e.self_device_time_total / 1e3 / reps, e.count // reps]
                     for e in costliest])


def run(batch: int = 32, reps: int = 3, device=None, out: str = DEFAULT_OUT) -> dict:
    """The decode of ``batch`` subframes traced ``reps`` times into
    ``out``/trace.json; returns the profile, the host times and the trace's
    path."""
    from srsran_4g_tpu_torch.models import pdsch
    from srsran_4g_tpu_torch.tools import clock_ms
    from srsran_4g_tpu_torch.tools import profile_components as pc

    dev = resolve_device(device)
    cfg = pc.config()
    rng = np.random.default_rng(0)
    rx = pc.received(cfg, rng.integers(0, 2, size=(batch, cfg.tbs)).astype(np.int8), dev)

    def decode():
        return pdsch.decode(cfg, rx, n_iter=pc.N_ITER)

    host = clock_ms(decode, reps, warm=True)
    if not bool(host.out["crc_ok"].all()):
        raise AssertionError("the traced decode fails a CRC")
    path = os.path.join(out, "trace.json")
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    prof = profile(decode, reps, min(host.ms) / 1e3, card, trace=path)
    print(f"host ms a decode {', '.join(f'{t:.2f}' for t in host.ms)}; trace done: {path}",
          flush=True)
    return dict(batch=batch, reps=reps, host_ms=host.ms, profile=prof, trace=path)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=DEFAULT_OUT, help="the trace's directory")
    args = ap.parse_args(argv)
    return run(args.batch, args.reps, args.device, args.out)


if __name__ == "__main__":
    main()
