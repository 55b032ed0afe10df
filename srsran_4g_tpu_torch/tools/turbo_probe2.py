"""Per-step costs of the radix-4 alpha sweep on the card: the port of the
TPU probe ``tools/turbo_probe2.py``.

One thread per lane (N = 86,528 lanes, the TPU probe's K=5824 blocks of
1,664 at window 112, training 32) runs 72 radix-4 steps, (T + L)/2, from
``a0`` over the gamma rows, in one of twelve bodies that keep or drop the
gamma loads, the ACS arithmetic and the alpha stores (``VARIANTS``; the
``make2`` bodies in ``VARIANTS2``).  Only row 0 of the (112, N) output is
written, as on the TPU.

    python -m srsran_4g_tpu_torch.tools.turbo_probe2 [variant ...]

prints one line per body (default ``VARIANTS``; the ``PROBE2`` environment
variable adds comma-separated ``VARIANTS2`` bodies), ms from CUDA events
over 10 calls.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.ops.cuda import probes
from srsran_4g_tpu_torch.tools import event_ms

K, B, WIN, TRAIN = 5824, 1664, 112, 32
W = K // WIN
N = B * W
STEPS = WIN + 2 * TRAIN  # gamma rows
N_STEPS = TRAIN // 2 + WIN // 2  # radix-4 steps of one sweep
VARIANTS = probes.PROBE2_VARIANTS[:7]
VARIANTS2 = probes.PROBE2_VARIANTS[7:]


def inputs(device=None, n: int = N, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """g (STEPS, n) ~ N(0, 4²) and a0 (8, n) ~ N(0, 1), float32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 4.0, (STEPS, n)).astype(np.float32)
    a0 = rng.normal(0, 1.0, (8, n)).astype(np.float32)
    return torch.as_tensor(g, device=dev), torch.as_tensor(a0, device=dev)


def _body(name: str):
    def fn(g: torch.Tensor, a0: torch.Tensor) -> torch.Tensor:
        return probes.probe2(name, g, g, a0, N_STEPS, WIN, WIN // 2)

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = (f"The ``{name}`` body over g (STEPS, N), passed as both gamma "
                  f"arrays as the TPU probe passes it, and a0 (8, N) → (WIN, N), "
                  f"row 0 written.")
    return fn


(full, fixedrow, block8, loadsonly, acsonly, unroll4, astore,
 empty, load1, addchain, addpar, load1x) = map(_body, probes.PROBE2_VARIANTS)


def measure(variants=VARIANTS, device=None, iters: int = 10) -> dict[str, float]:
    """ms per call of each body (CUDA events), printed as the TPU probe
    prints it."""
    g, a0 = inputs(device)
    res = {}
    for v in variants:
        body = globals()[v]
        res[v] = event_ms(lambda: body(g, a0), iters=iters)
        print(f"{v:40s} {res[v]:8.3f} ms", flush=True)
    return res


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    extra = os.environ.get("PROBE2")
    measure(list(argv or VARIANTS) + (extra.split(",") if extra else []))


if __name__ == "__main__":
    main()
