"""What one launch and one block cost on the card: the port of the TPU probe
``tools/turbo_probe3.py`` (grid-step overhead of an empty kernel that copies
row 0 of its first input to row 0 of its output over N = 86,528 lanes).

The TPU question, what one grid step costs, becomes three:

1. the device time of the empty kernel at 128, 256, 512 and 1,024 threads a
   block (the TPU probe's tile);
2. the same with a dynamic shared-memory request that leaves one block per
   SM (``probes.ONE_BLOCK_PER_SM_SMEM``), standing in for the TPU probe's
   (56, 8, tile) VMEM scratch, which at tile 1,024 is 1.8 MB and fits no SM;
3. the host time of one launch through the package's ctypes path, over
   ``HOST_LAUNCHES`` back-to-back launches, against its device time.

As the TPU probe, it also reports one input against two and 16 input rows
against 176, and 8 output rows against 112.  Device times are CUDA events
around launches queued behind a spin, so that they run back to back (no L2
flush between them: the kernel reads one row, and what it measures is the
launch); the host time is the host clock over launches made as fast as the
host can.

    python -m srsran_4g_tpu_torch.tools.turbo_probe3
"""

from __future__ import annotations

import time

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.ops.cuda import probes
from srsran_4g_tpu_torch.tools import event_ms

N = 86528
THREADS = (128, 256, 512, 1024)
HOST_LAUNCHES = 1000


def inputs(steps: int = 176, nin: int = 2, device=None, n: int = N,
           seed: int = 0) -> list[torch.Tensor]:
    """``nin`` inputs, each the same (steps, n) ~ N(0, 4²) float32 array, as
    the TPU probe passes one array ``nin`` times."""
    dev = resolve_device(device)
    g = np.random.default_rng(seed).normal(0, 4.0, (steps, n)).astype(np.float32)
    return [torch.as_tensor(g, device=dev)] * nin


def empty(ins: list[torch.Tensor], win: int = 112, threads: int = 1024,
          scratch: bool = False) -> torch.Tensor:
    """The empty kernel → (win, n), row 0 = ins[0][0]; ``scratch`` asks for
    the shared memory that leaves one block per SM."""
    return probes.probe_empty(ins, win, threads=threads,
                              smem=probes.ONE_BLOCK_PER_SM_SMEM if scratch else 0)


def measure(device=None, iters: int = 100) -> dict:
    """Device ms per launch of each configuration and the host/device ms per
    launch of ``HOST_LAUNCHES`` back-to-back launches, printed as the TPU
    probe prints its lines."""
    res = {}

    def line(name, ins, blocks_of, **kw):
        ms = event_ms(lambda: empty(ins, **kw), iters=iters, flush=False)
        res[name] = ms
        print(f"{name + f' (blocks={blocks_of})':44s} {ms:8.4f} ms", flush=True)

    two = inputs(device=device)
    for threads in THREADS:
        blocks = -(-N // threads)
        line(f"empty threads={threads}", two, blocks, threads=threads)
        line(f"empty threads={threads} one block/SM", two, blocks, threads=threads,
             scratch=True)
    line("empty threads=1024 1-input", two[:1], -(-N // 1024))
    line("empty threads=1024 16-step blocks", inputs(steps=16, device=device),
         -(-N // 1024))
    line("empty threads=1024 win=8", two, -(-N // 1024), win=8)

    empty(two)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(HOST_LAUNCHES):
        empty(two)
    host_ms = (time.perf_counter() - t0) * 1e3 / HOST_LAUNCHES
    stop.record()
    torch.cuda.synchronize()
    res["host_ms_per_launch"] = host_ms
    res["stream_ms_per_launch"] = start.elapsed_time(stop) / HOST_LAUNCHES
    res["device_ms_per_launch"] = res["empty threads=1024"]
    print(f"{HOST_LAUNCHES} launches through ctypes: host {host_ms * 1e3:.2f} us per "
          f"launch, stream {res['stream_ms_per_launch'] * 1e3:.2f} us per launch, "
          f"device {res['device_ms_per_launch'] * 1e3:.2f} us per launch back to back",
          flush=True)
    return res


def main() -> None:
    measure()


if __name__ == "__main__":
    main()
