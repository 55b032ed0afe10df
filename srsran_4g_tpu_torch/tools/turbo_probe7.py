"""Does packed bf16 run the ACS op mix at twice the f32 element rate on the
card?  The port of the TPU probe ``tools/turbo_probe7.py``.

The v7 inner-loop op mix (two radix-2 ACS steps, 1 add + 1 max per
candidate, 2 candidates per state, then a normalising subtract per state),
``iters`` times, for

  * f32:  (8, tile_c) lanes, one lane a thread
  * bf16: (16, tile_c) lanes, two lanes a thread in one __nv_bfloat162

so both run the same number of threads and instructions and bf16 touches
twice the elements.  If bf16 takes the f32 time, packed bf16 doubles the
element rate.

    python -m srsran_4g_tpu_torch.tools.turbo_probe7 [iters] [tile_c]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.ops.cuda import probes
from srsran_4g_tpu_torch.tools import event_ms

ITERS = 4096
TC = 256


def inputs(dtype: torch.dtype, rows: int, tile_c: int = TC, device=None):
    """The TPU probe's timing inputs: g = 0.001 (2, rows·tile_c) and a0 = 0
    (8, rows·tile_c) in ``dtype``; every lane is the same."""
    dev = resolve_device(device)
    n = rows * tile_c
    return (torch.ones((2, n), dtype=dtype, device=dev) * 0.001,
            torch.zeros((8, n), dtype=dtype, device=dev))


def check_inputs(dtype: torch.dtype, rows: int, tile_c: int = TC, device=None,
                 seed: int = 0):
    """Inputs that tell lanes apart, for holding the kernel against its plain
    version (``inputs`` gives every lane the same values): g ~ N(0, 0.5²)
    (2, rows·tile_c) and a0 ~ N(0, 1) (8, rows·tile_c) from a numpy seed,
    rounded to ``dtype``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = rows * tile_c
    g = rng.normal(0, 0.5, (2, n)).astype(np.float32)
    a0 = rng.normal(0, 1.0, (8, n)).astype(np.float32)
    return (torch.as_tensor(g, device=dev).to(dtype),
            torch.as_tensor(a0, device=dev).to(dtype))


def op_mix(g, a0, iters: int = ITERS) -> torch.Tensor:
    """The op mix on g (2, n), a0 (8, n) → (8, n): f32 inputs run one lane a
    thread, bf16 inputs two lanes a thread."""
    return probes.probe7(g, a0, iters)


def run(dtype: torch.dtype, rows: int, iters: int = ITERS, tile_c: int = TC,
        device=None) -> tuple[float, float]:
    """(ms per call, elements per second) at (rows, tile_c) lanes."""
    g, a0 = inputs(dtype, rows, tile_c, device)
    ms = event_ms(lambda: op_mix(g, a0, iters), iters=8)
    return ms, 8 * rows * tile_c * 2 * iters / (ms * 1e-3)


def measure(iters: int = ITERS, tile_c: int = TC, device=None) -> dict[str, float]:
    """The TPU probe's three lines; returns ms and Gelem/s of both types."""
    print(f"iters={iters} tile_c={tile_c} dev={resolve_device(device).type}")
    t32, e32 = run(torch.float32, 8, iters, tile_c, device)
    print(f"f32  (8,{tile_c}) : {t32:8.3f} ms   {e32 / 1e9:8.2f} Gelem/s")
    t16, e16 = run(torch.bfloat16, 16, iters, tile_c, device)
    print(f"bf16 (16,{tile_c}): {t16:8.3f} ms   {e16 / 1e9:8.2f} Gelem/s")
    print(f"bf16 element-throughput advantage: {e16 / e32:.2f}x", flush=True)
    return dict(f32_ms=t32, f32_gelem_s=e32 / 1e9, bf16_ms=t16, bf16_gelem_s=e16 / 1e9,
                ratio=e16 / e32)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    measure(int(argv[0]) if argv else ITERS, int(argv[1]) if len(argv) > 1 else TC)


if __name__ == "__main__":
    main()
