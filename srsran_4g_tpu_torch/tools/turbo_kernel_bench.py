"""Microbench of one windowed max-log-MAP half-iteration and of the turbo
decode on the card: the port's counterpart of the JAX package's
``tools/turbo_kernel_bench.py``.

At the headline bench configuration (``BENCH_CBS`` = 1,664 code blocks of
``BENCH_K`` = 5,824: 128 subframes of 13 blocks at 100 PRB 64QAM) from
random LLRs (``np.random.default_rng(0)``, the JAX tool's stream), ``half``
mode prints three lines:

- the half-iteration with its preparation, ``ops/turbo._map_windowed``: the
  gammas laid out in windows (``_windowed_inputs``), the kernel of the
  ``TURBO_KERNEL`` route, the LLRs transposed back;
- the route's kernel alone on the gammas prebuilt from the same inputs,
  held against its plain version: v9 → ``map_fused16``; v7 / v8 →
  ``map_fused`` at radix 2 / 4; v4 and v1 → ``map_windowed``; bf16 →
  ``map_windowed16``; v3 → ``map_v3``; v5 / v6 → ``sweep`` at radix 4 / 2,
  then ``emit``;
- their difference: the preparation and the transpose.

Each line gives host ms (``tools.clock_ms``: the host clock up to a
synchronise, the mean of 10 calls), device ms (``tools.event_ms``: CUDA
events, each call after a write of twice the L2 and queued behind a spin,
so the device's time with no host gap) and the kernel's bound (``work``,
``bound``).  ``full`` mode times ``turbo_decode``, 4 iterations, no early
stop: host ms (3 calls), the device's busy ms under torch.profiler
(``trace_bench.busy_ms``: on an H100 ``event_ms`` could not queue this
decode behind its spin, so something in it waits for the device), and its
launches; ``all`` runs both.

Environment, with the JAX tool's defaults: ``BENCH_K`` (5824), ``BENCH_CBS``
(1664), ``TURBO_WINDOW`` (208), ``TURBO_TRAIN`` (32) and ``TURBO_KERNEL``
(v9, read by the decoder).  The port's decoder has no tile or unroll
setting, so ``TURBO_TILE`` and ``TURBO_UNROLL`` are ignored.

The module also holds what ``chip_smoke.py`` and the split tools measure the
kernels with: the card's rates (``op_ms``, ``bound``), each wrapper's bytes
and operations (``work``), the route table ``ROUTES`` / ``EXACT``, which
kernels each ``TURBO_KERNEL`` path launches (``DATAFLOWS``, and from it
``PATH_KERNELS`` and ``PATH_OF``), and the half-iteration inputs and calls
(``gamma_inputs``, ``kernel_calls``).

    python -m srsran_4g_tpu_torch.tools.turbo_kernel_bench [half|full|all]
        [--device cuda]

``--device`` defaults to cuda and raises without a card; on ``--device
cpu`` the wrappers run their plain versions and no device time is read.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device

# The rates the bounds below are computed against.  Bytes: the H100 SXM's
# HBM3 bandwidth (NVIDIA data sheet).  Operations: the CUDA cores, at 132 SMs
# and the 1.98 GHz boost clock.  Per SM and clock, for compute capability
# 9.0 (CUDA C++ Programming Guide, "Arithmetic Instructions", throughput
# table): 128 results of 32-bit float add/multiply (one f32 add or subtract
# an instruction), 256 of 16-bit float add/multiply (128 packed bf16x2
# instructions; a scalar bf16 add takes one instruction too), and 64 of
# compare/minimum/maximum (the guide has no packed 16-bit row: a bf16x2 max
# is taken as one such instruction giving two elements).  Each of the SM's
# four partitions dispatches one warp instruction a clock (NVIDIA H100
# Tensor Core GPU Architecture whitepaper), 128 thread instructions per SM
# and clock of any kind.  So n_add add and n_max max instructions take at
# least max(n_add / 128, n_max / 64, (n_add + n_max) / 128) SM clocks; in
# every kernel here n_add >= n_max, so dispatch binds, whatever pipe the
# maxes use.  The data sheet's 67 TFLOP/s f32 counts an FMA as two
# operations and its 989 TFLOP/s bf16 is the tensor cores', which no
# elementwise max can use.
PEAK_BYTES_PER_S = 3.35e12
SM_COUNT, CLOCK_HZ = 132, 1.98e9
ADD_PER_SM_CLOCK, MAX_PER_SM_CLOCK, DISPATCH_PER_SM_CLOCK = 128, 64, 128
ELEMENTS_PER_INSTR = {"f32": 1, "bf16": 1, "bf16x2": 2}
BF16_WRAPPERS = ("map_windowed16", "map_fused16")
# kernel route -> (its wrapper and radix, its source under csrc/, and the line
# of the TPU kernel it replaces in srsran_4g_tpu/ops/pallas/turbo_map.py)
ROUTES = {
    "turbo_map": ("map_windowed", None, "turbo_windowed.cu", 272),
    "map_windowed16": ("map_windowed16", None, "turbo_windowed.cu", 1323),
    "map_v3": ("map_v3", None, "turbo_windowed.cu", 1189),
    "map_fused16": ("map_fused16", None, "turbo_fused16.cu", 942),
    "map_fused_r2": ("map_fused", 2, "turbo_fused.cu", 872),
    "map_fused_r4": ("map_fused", 4, "turbo_fused.cu", 872),
    "sweep_r2": ("sweep", 2, "turbo_sweep.cu", 1022),
    "sweep_r4": ("sweep", 4, "turbo_sweep.cu", 426),
    "emit": ("emit", None, "turbo_emit.cu", 1150),
}
# routes held to max |diff| 0: every route but sweep and emit
EXACT = ("turbo_map", "map_windowed16", "map_v3", "map_fused16", "map_fused_r2",
         "map_fused_r4")
# the decoder's dataflow (ops/turbo.kernel_route, as ops/turbo._map_windowed
# dispatches it) -> the routes one half-iteration launches, in order
DATAFLOWS = {"v9": ("map_fused16",), "v7": ("map_fused_r2",), "v8": ("map_fused_r4",),
             "v5": ("sweep_r4", "emit"), "v6": ("sweep_r2", "emit"),
             "bf16": ("map_windowed16",), "v3": ("map_v3",), "v4": ("turbo_map",),
             "v1": ("turbo_map",)}
# TURBO_KERNEL -> the wrappers whose kernels a decode under it launches
PATH_KERNELS = {flow: tuple(dict.fromkeys(ROUTES[r][0] for r in routes))
                for flow, routes in DATAFLOWS.items()}
# kernel route -> the first TURBO_KERNEL path that launches it
PATH_OF = {r: next(flow for flow, routes in DATAFLOWS.items() if r in routes) for r in ROUTES}
ITERS_FULL = 4


def op_ms(adds: int, maxes: int, kind: str) -> float:
    """Least time (ms) the CUDA cores take for ``adds`` adds and subtracts
    and ``maxes`` maxes of type ``kind`` ("f32", "bf16" or "bf16x2",
    counted in elements): the rates above."""
    per = ELEMENTS_PER_INSTR[kind]
    i_add, i_max = adds / per, maxes / per
    clocks = max(i_add / ADD_PER_SM_CLOCK, i_max / MAX_PER_SM_CLOCK,
                 (i_add + i_max) / DISPATCH_PER_SM_CLOCK) / SM_COUNT
    return clocks / CLOCK_HZ * 1e3


def bound(nbytes: int, adds: int, maxes: int, kind: str) -> tuple[float, str]:
    """Least time (ms) for work that moves ``nbytes`` and does ``adds`` adds
    and ``maxes`` maxes of type ``kind``, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, op_ms(adds, maxes, kind)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def work(wrapper: str, b: int, k: int, l: int, t: int) -> tuple[int, int, int]:
    """Bytes (each input read once, each output written once), adds
    (subtracts included) and maxes of one call of ``wrapper`` at these
    shapes.  The half-iteration (map_windowed, map_windowed16, map_v3,
    map_fused, map_fused16) reads the float32 gammas and initial metrics
    and writes L float32 LLRs per lane; sweep writes the L/2 even-position
    stores of both chains instead, and emit reads those stores and the body
    gammas.  Operations (bf16 for the 16-bit kernels, else f32), counting
    only lanes whose training is not frozen: per trellis step per chain 24
    adds (16 branch adds, 8 normalising subtracts) and 15 maxes (8 + 7);
    per LLR 26 adds (16 alpha + beta, 8 parity terms, the input term and
    the difference) and 14 maxes; for emit's two odd-position steps per
    pair 32 adds and 16 maxes."""
    w = k // l
    n = w * b
    gammas, inits, llrs = 2 * (l + 2 * t) * n, 2 * 8 * n, l * n
    stores = 2 * (l // 2) * 8 * n
    steps = (n - b) * t + (w - 1) * b * t + 2 * n * (l - 1)
    if wrapper == "sweep":
        return 4 * (gammas + inits + stores), 24 * steps, 15 * steps
    if wrapper == "emit":
        pairs = (l // 2) * n
        return (4 * (2 * l * n + stores + llrs), (26 * 2 + 32) * pairs,
                (14 * 2 + 16) * pairs)
    return 4 * (gammas + inits + llrs), 24 * steps + 26 * llrs, 15 * steps + 14 * llrs


def route_bound(routes, b: int, k: int, l: int, t: int) -> tuple[float, str]:
    """The least time of the routes' kernels one after the other at these
    shapes: the sum of their bounds, and what bounds the first."""
    total, by = 0.0, None
    for route in routes:
        wrapper = ROUTES[route][0]
        ms, this_by = bound(*work(wrapper, b, k, l, t),
                            "bf16" if wrapper in BF16_WRAPPERS else "f32")
        total, by = total + ms, by or this_by
    return total, by


def gamma_inputs(dev, gen, b, k, l, t):
    """Random half-iteration inputs laid out as the decoder lays them out."""
    from srsran_4g_tpu_torch.ops import turbo

    lsa = torch.randn((b, k), generator=gen, device=dev) * 3
    lp = torch.randn((b, k), generator=gen, device=dev) * 3
    ts = torch.randn((b, 3), generator=gen, device=dev)
    tp = torch.randn((b, 3), generator=gen, device=dev)
    gs, gp, a0, b0, w = turbo._windowed_inputs(lsa, lp, ts, tp, l, t)
    return gs, gp, a0, b0, t, l, b, w


def kernel_calls(args, route: str):
    """(kernel call, plain call) of one route on half-iteration inputs; emit
    takes the body gammas and the radix-4 sweep kernel's stores."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    wrapper, radix = ROUTES[route][:2]
    fn, ref = getattr(tm, wrapper), getattr(tm, wrapper + "_ref")
    if wrapper == "emit":
        gs, gp, _, _, t, l, b, w = args
        args = (gs[t:t + l].view(l // 2, 2, b * w), gp[t:t + l].view(l // 2, 2, b * w),
                *tm.sweep(*args, radix=4))
    kw = {} if radix is None else {"radix": radix}
    return lambda: fn(*args, **kw), lambda: ref(*args, **kw)


def dataflow_calls(args, dataflow: str):
    """(kernel call, plain call) of everything one half-iteration launches
    under ``dataflow`` on prebuilt inputs: no layout, no transpose."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    routes = DATAFLOWS[dataflow]
    if len(routes) == 1:
        return kernel_calls(args, routes[0])
    gs, gp, _, _, t, l, b, w = args
    g2 = gs[t:t + l].view(l // 2, 2, b * w), gp[t:t + l].view(l // 2, 2, b * w)
    radix = ROUTES[routes[0]][1]
    return (lambda: tm.emit(*g2, *tm.sweep(*args, radix=radix)),
            lambda: tm.emit_ref(*g2, *tm.sweep_ref(*args, radix=radix)))


def settings() -> dict:
    """The bench's shape and route from the environment (the JAX tool's
    variables and defaults)."""
    env = os.environ
    return dict(k=int(env.get("BENCH_K", "5824")), cbs=int(env.get("BENCH_CBS", "1664")),
                window=int(env.get("TURBO_WINDOW", "208")),
                train=int(env.get("TURBO_TRAIN", "32")),
                kernel=env.get("TURBO_KERNEL", "v9"))


def make_llrs(cbs: int, k: int, device) -> torch.Tensor:
    """Random d-stream LLRs (B, 3, K + 4), N(0, 4²), from the JAX tool's
    stream: ``default_rng(0)`` draws the (unused) bits first."""
    rng = np.random.default_rng(0)
    rng.integers(0, 2, size=(cbs, k))
    return torch.as_tensor(rng.normal(0, 4.0, (cbs, 3, k + 4)).astype(np.float32),
                           device=device)


def _ms(fn, device: torch.device, iters: int) -> tuple[float, float | None]:
    """(host ms, device ms) of ``fn``: ``clock_ms`` over ``iters`` calls
    after a warm one; ``event_ms`` on a card, None on the CPU."""
    from srsran_4g_tpu_torch.tools import clock_ms, event_ms

    host = sum(clock_ms(fn, iters, warm=True).ms) / iters
    return host, (event_ms(fn, iters=iters, warmup=1) if device.type == "cuda" else None)


def _line(name: str, host: float, dev: float | None, bound_ms: float, by: str) -> str:
    dev_s = f"{dev:8.4f} ms device" if dev is not None else "device not measured"
    return f"{name:36s} {host:8.3f} ms host, {dev_s}, bound {bound_ms:.4f} ms ({by})"


def half(d_llr: torch.Tensor, window: int, train: int, iters: int = 10) -> dict:
    """``half`` mode on the LLRs (B, 3, K + 4): prints its three lines and
    returns their times, the kernel's bound, its max |diff| against its
    plain version, and the half-iteration's LLRs (B, K) (``llr``)."""
    from srsran_4g_tpu_torch.ops import turbo

    dev = d_llr.device
    b, k = d_llr.shape[0], d_llr.shape[-1] - 4
    ls, lp1 = d_llr[:, 0, :k], d_llr[:, 1, :k]
    t1_sys = torch.stack([d_llr[:, 0, k], d_llr[:, 2, k], d_llr[:, 1, k + 1]], -1)
    t1_par = torch.stack([d_llr[:, 1, k], d_llr[:, 0, k + 1], d_llr[:, 2, k + 1]], -1)
    dataflow = turbo.kernel_route(os.environ.get("TURBO_KERNEL", "v9"), window, train)
    routes = DATAFLOWS[dataflow]
    bound_ms, by = route_bound(routes, b, k, window, train)

    def whole():
        return turbo._map_windowed(ls, lp1, t1_sys, t1_par, window, train)

    args = turbo._windowed_inputs(ls, lp1, t1_sys, t1_par, window, train)[:4] + (
        train, window, b, k // window)
    kernel, plain = dataflow_calls(args, dataflow)
    got, want = kernel(), plain()
    err = float((got - want).abs().max())
    llr = whole()
    h_whole, d_whole = _ms(whole, dev, iters)
    h_kern, d_kern = _ms(kernel, dev, iters)
    d_prep = d_whole - d_kern if d_kern is not None else None
    names = "+".join(ROUTES[r][0] for r in routes)
    print(_line(f"half-iter incl prep (W={window},T={train})", h_whole, d_whole, bound_ms, by))
    print(_line(f"kernel only ({dataflow}: {names})", h_kern, d_kern, bound_ms, by))
    print(_line("prep (half-iter - kernel)", h_whole - h_kern, d_prep, bound_ms, by), flush=True)
    print(f"kernel vs plain: max |diff| {err}", flush=True)
    return dict(dataflow=dataflow, kernels=[ROUTES[r][0] for r in routes],
                shape=dict(blocks=b, K=k, L=window, T=train, lanes=b * (k // window)),
                half_iter_ms=h_whole, half_iter_device_ms=d_whole, kernel_ms=h_kern,
                kernel_device_ms=d_kern, prep_ms=h_whole - h_kern, prep_device_ms=d_prep,
                bound_ms=bound_ms, bound_by=by, max_abs_err=err, llr=llr)


def full(d_llr: torch.Tensor, window: int, train: int, iters: int = 3) -> dict:
    """``full`` mode: ``turbo_decode`` of the LLRs, ITERS_FULL iterations,
    no early stop; prints its line and returns its times, the kernel
    launches a decode (by wrapper) and the hard bits."""
    from srsran_4g_tpu_torch.ops import turbo
    from srsran_4g_tpu_torch.tools import clock_ms, trace_bench

    def dec():
        return turbo.turbo_decode(d_llr, n_iter=ITERS_FULL, window=window, train=train,
                                  early_crc=None)

    host = sum(clock_ms(dec, iters, warm=True).ms) / iters
    busy = trace_bench.busy_ms(dec, d_llr.device)
    last = clock_ms(dec)
    dev_s = f"{busy:8.3f} ms device busy" if busy is not None else "device not measured"
    print(f"{'turbo_decode 4 iters (no early)':36s} {host:8.3f} ms host, {dev_s}, "
          f"launches {last.launches}", flush=True)
    return dict(decode_ms=host, decode_busy_ms=busy, launches=last.launches,
                hard=last.out[0])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="half", choices=("half", "full", "all"))
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    s = settings()
    d_llr = make_llrs(s["cbs"], s["k"], dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"B={s['cbs']} K={s['k']} W={s['window']} T={s['train']} "
          f"TURBO_KERNEL={s['kernel']} on {where}", flush=True)
    out = {}
    if args.mode in ("half", "all"):
        out["half"] = half(d_llr, s["window"], s["train"])
    if args.mode in ("full", "all"):
        out["full"] = full(d_llr, s["window"], s["train"])
    return out


if __name__ == "__main__":
    main()
