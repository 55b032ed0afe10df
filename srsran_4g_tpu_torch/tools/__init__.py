"""H100 micro-benchmarks: the port's counterparts of the JAX package's TPU
probes ``tools/turbo_probe{2,3,6,7}.py``.

Each module asks its TPU probe's question of the card with the kernels of
``ops/cuda/probes.py``; it does nothing at import, exposes one function per
variant (returning the kernel's output), ``inputs`` made from a numpy seed at
the TPU probe's shapes, ``measure`` (prints the TPU probe's lines, with ms
from CUDA events, and returns the numbers) and ``main``:

    python -m srsran_4g_tpu_torch.tools.turbo_probe6

The inputs default to the CUDA device and raise without one: on CPU tensors
the kernels' plain versions run, and they time nothing of the card.

Beside them are the port's tools (``run_lte``, ``run_nr``, ``multichip``,
the error-rate sweeps, the measuring tools ``profile_components``,
``turbo_kernel_bench``, ``trace_bench``, ``dp_evidence`` and
``scaling_bench``) and the clocks they share: ``event_ms`` (device time of
calls queued ahead of the device) and ``clock_ms`` (host time of calls, each
to a synchronise).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

SPIN_CYCLES_PER_S = 2e9  # torch.cuda._sleep counts clocks; the H100's boost is 1.98 GHz


def event_ms(fn, iters: int = 10, warmup: int = 1, flush: bool = True) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` calls after
    ``warmup`` calls.

    With ``flush`` (the default) each call runs after a write of twice the
    L2 cache (2 x 50 MB on an H100), so that its inputs come from device
    memory as its byte bound assumes, and CUDA events time each call alone.
    Without it the events time the calls back to back, inputs warm in L2
    where they fit: the device's cost per call of a stream of launches.

    The stream waits in a spin (``torch.cuda._sleep``) while the calls are
    queued, three times as long as the host took to queue one call after
    the warm-up, so that the host does not pace kernels shorter than its
    cost of a launch (30-50 us through the package's ctypes path on an
    H100 host).  If the spin ended before the last call was queued, the
    measurement is made again with a spin four times as long; raises after
    three tries."""
    scrub = (torch.empty(2 * torch.cuda.get_device_properties(0).L2_cache_size,
                         dtype=torch.uint8, device="cuda") if flush else None)

    def queue(marks):
        if not flush:
            marks[0].record()
        for i in range(iters):
            if flush:
                scrub.zero_()
                marks[2 * i].record()
            fn()
            if flush:
                marks[2 * i + 1].record()
        if not flush:
            marks[1].record()

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    queue([torch.cuda.Event(enable_timing=True) for _ in range(2 * iters)])
    host_s = (time.perf_counter() - t0) / iters
    spin_s = 3 * iters * host_s
    for _ in range(3):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2 * iters)]
        spun = torch.cuda.Event()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        spun.record()
        queue(marks)
        paced = spun.query()  # the spin had ended: the host paced some calls
        torch.cuda.synchronize()
        if not paced:
            pairs = range(0, 2 * iters if flush else 2, 2)
            return sum(marks[i].elapsed_time(marks[i + 1]) for i in pairs) / iters
        spin_s *= 4
    raise RuntimeError(f"event_ms: the host took longer than a {spin_s / 4:.3f} s spin "
                       f"to queue {iters} calls")


class Timed(NamedTuple):
    """What ``clock_ms`` measured: host ms of each call, the kernel launches
    of the last (``ops/cuda/turbo_map.launches``, by kernel) and its result."""

    ms: list[float]
    launches: dict[str, int]
    out: object


def clock_ms(fn, reps: int = 1, warm: bool = False) -> Timed:
    """``reps`` calls of ``fn()``, after a warm one with ``warm``, each from
    an idle device to a synchronise, on the host clock.  This is the only
    clock for a call that the host paces (a decode, a chain of small
    kernels): CUDA events around such a call read its span, within a few
    hundredths of a ms of the host's, not the device's busy time, which is
    ``trace_bench.busy_ms``'s (or ``event_ms``'s, for a call that never
    waits for the device)."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    if warm:
        fn()
    ms, before, out = [], {}, None
    for _ in range(reps):
        sync()
        before = dict(tm.launches)
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: n - before.get(k, 0) for k, n in tm.launches.items() if n != before.get(k, 0)}
    return Timed(ms, launches, out)
