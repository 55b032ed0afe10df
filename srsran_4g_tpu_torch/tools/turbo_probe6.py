"""What bounds the windowed ACS on the card: the port of the TPU probe
``tools/turbo_probe6.py``.

Three kernels over the bench-shaped lane set (86,528 lanes × 72 radix-4
steps = 144 trellis steps, T = 32, L = 112), no LLR emission:

  full  - the v5 radix-4 ACS pair (alpha and beta interleaved) with real
          gamma row loads, f32, one lane a thread
  skel  - the same loop without gamma arithmetic (gather + constant + max +
          normalise): the serial skeleton
  bf16  - the full pair in bf16 with two lane groups packed in one
          __nv_bfloat162 per state (43,264 threads): does packed bf16 run
          the ACS at twice the f32 element rate on this card?

    python -m srsran_4g_tpu_torch.tools.turbo_probe6
"""

from __future__ import annotations

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.ops.cuda import probes
from srsran_4g_tpu_torch.tools import event_ms

N = 86528
STEPS = 72  # radix-4 steps per sweep (= (T + L)/2 at T = 32, L = 112)


def inputs(device=None, n: int = N, seed: int = 0) -> dict:
    """The TPU probe's inputs from one numpy generator: f32 g2s, g2p
    (STEPS, 2, n) ~ N(0, 4²) and zero a0, b0 (8, n); then bf16 g2s16, g2p16
    (STEPS, 2, 2, n/2) and zero a016, b016 (16, n/2)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    g2s, g2p = (torch.as_tensor(rng.normal(0, 4, (STEPS, 2, n)).astype(np.float32),
                                device=dev) for _ in range(2))
    half = n // 2
    g2s16, g2p16 = (torch.as_tensor(
        rng.normal(0, 4, (STEPS, 2, 2, half)).astype(np.float32),
        device=dev).to(torch.bfloat16) for _ in range(2))
    zeros = dict(a0=torch.zeros((8, n), device=dev), b0=torch.zeros((8, n), device=dev),
                 a016=torch.zeros((16, half), dtype=torch.bfloat16, device=dev),
                 b016=torch.zeros((16, half), dtype=torch.bfloat16, device=dev))
    return dict(g2s=g2s, g2p=g2p, g2s16=g2s16, g2p16=g2p16, **zeros)


def full(g2s, g2p, a0, b0) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 radix-4 pair → alpha, beta (8, N) after STEPS steps."""
    return probes.probe6_full(g2s, g2p, a0, b0)


def skel(a0, b0) -> tuple[torch.Tensor, torch.Tensor]:
    """The serial skeleton → (8, N) ×2 after STEPS steps."""
    return probes.probe6_skel(a0, b0, STEPS)


def bf16(g2s16, g2p16, a016, b016) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 two-group pair → (16, N/2) ×2 after STEPS steps."""
    return probes.probe6_bf16(g2s16, g2p16, a016, b016)


def measure(device=None, iters: int = 10) -> dict[str, float]:
    """ms per call of the three kernels (CUDA events), printed as the TPU
    probe prints them."""
    x = inputs(device)
    res = {}
    for key, name, fn in (
            ("full", "A full f32 r4 pair", lambda: full(x["g2s"], x["g2p"], x["a0"], x["b0"])),
            ("skel", "B skeleton f32", lambda: skel(x["a0"], x["b0"])),
            ("bf16", "C bf16x2 two-group r4 pair",
             lambda: bf16(x["g2s16"], x["g2p16"], x["a016"], x["b016"]))):
        res[key] = event_ms(fn, iters=iters)
        print(f"{name:34s} {res[key]:8.3f} ms", flush=True)
    return res


def main() -> None:
    measure()


if __name__ == "__main__":
    main()
