"""BER parity sweep: the turbo codec over an Eb/N0 grid, on the port.

Port counterpart of the JAX package's ``tools/ber_sweep.py`` (the shape of
the reference's ``lib/src/phy/fec/turbo/test/turbodecoder_test.c``: BER and
FER per point and a Mb/s print): the same flags, the same random stream and
the same table, plus ``--device`` (default cuda; no fallback: ``--device
cpu`` or ``--cpu`` asks for the CPU) and ``--out``.

The stream: ``np.random.default_rng(0)`` draws the bits, then at every point
``standard_normal`` noise in float64 on the host; BPSK at rate K/(3(K+4)),
LLR = -2y/sigma^2 cast to float32.  At equal arguments the LLRs equal the
JAX tool's bit for bit.  Each point decodes with ``ops/turbo.turbo_decode``
at window 128, training 32 and no CRC stop (2 x iters half-iterations), the
clock bracketing the decode and a synchronise.

The decoder the JAX tool runs depends on its device: on a TPU the Pallas v9
kernel (bf16 metrics, ``train_norm``), on the CPU (``--cpu``) the f32 XLA
``lax.scan``.  The port runs v9's counterpart (``map_fused16``) wherever it
runs, so its curves follow the JAX tool's on a TPU, and in the waterfall its
bits differ from those of the JAX tool's ``--cpu`` run; the parity tests hold
it against the JAX decoder with ``backend="pallas_interpret"``.

Writes ``artifacts/torch/ber_turbo.json`` (relative to the working
directory) unless ``--out`` names another file; never the JAX tool's
``artifacts/ber_turbo.json``.

Usage: python -m srsran_4g_tpu_torch.tools.ber_sweep [--k 6144] [--frames 64]
           [--iters 5] [--snr-min 0] [--snr-max 3] [--snr-step 0.25]
           [--device cuda] [--out artifacts/torch/ber_turbo.json]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.ops import turbo

DEFAULT_OUT = os.path.join("artifacts", "torch", "ber_turbo.json")
WINDOW, TRAIN = 128, 32


def grid(snr_min: float, snr_max: float, snr_step: float) -> np.ndarray:
    """The Eb/N0 points in dB."""
    return np.arange(snr_min, snr_max + 1e-9, snr_step)


def llr_point(rng: np.random.Generator, d: np.ndarray, rate: float,
              ebn0_db: float) -> np.ndarray:
    """BPSK over AWGN at ``ebn0_db``: the codewords' LLRs (float32), the
    noise drawn from ``rng`` in float64."""
    ebn0 = 10 ** (ebn0_db / 10)
    sigma2 = 1.0 / (2 * rate * ebn0)
    y = (1 - 2 * d.astype(np.float64)) + rng.standard_normal(d.shape) * np.sqrt(sigma2)
    return (-2 * y / sigma2).astype(np.float32)


def decode_point(llr: torch.Tensor, iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hard bits (B, K) int8, APP LLRs (B, K) float32) of the LLRs
    (B, 3, K + 4): ``iters`` full iterations, no early stop."""
    return turbo.turbo_decode(llr, n_iter=iters, window=WINDOW, train=TRAIN)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sweep(k: int, frames: int, iters: int, points, device=None, on_point=None) -> list[dict]:
    """The table's rows over ``points`` (Eb/N0 in dB).  ``on_point(row,
    seconds, llr, hard, app)``, if given, sees each point's timed seconds and
    its device tensors."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(frames, k)).astype(np.int8)
    d = turbo.turbo_encode(torch.as_tensor(bits, device=dev)).cpu().numpy()
    rate = k / (3.0 * (k + 4))
    rows = []
    for ebn0_db in points:
        llr = torch.as_tensor(llr_point(rng, d, rate, ebn0_db), device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        hard, app = decode_point(llr, iters)
        _sync(dev)
        dt = time.perf_counter() - t0
        err = hard.cpu().numpy() != bits
        r = dict(ebn0_db=round(float(ebn0_db), 3), ber=float(np.mean(err)),
                 fer=float(np.mean(err.any(axis=1))), mbps=round(frames * k / dt / 1e6, 2))
        rows.append(r)
        print(f"Eb/N0 {ebn0_db:5.2f} dB   BER {r['ber']:.2e}   FER {r['fer']:.3f}   "
              f"{r['mbps']:8.1f} Mb/s", flush=True)
        if on_point is not None:
            on_point(r, dt, llr, hard, app)
    return rows


def run(k: int, frames: int, iters: int, points, device=None, out: str = DEFAULT_OUT,
        on_point=None) -> dict:
    """Sweep, then write the table (the JAX tool's JSON) to ``out``."""
    table = dict(k=k, frames=frames, iters=iters,
                 points=sweep(k, frames, iters, points, device, on_point))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(table, f, indent=1)
    print(f"wrote {os.path.abspath(out)}")
    return table


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--k", type=int, default=6144)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--snr-min", type=float, default=0.0)
    p.add_argument("--snr-max", type=float, default=3.0)
    p.add_argument("--snr-step", type=float, default=0.25)
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--out", default=DEFAULT_OUT, help="the table's JSON file")
    args = p.parse_args(argv)
    run(args.k, args.frames, args.iters, grid(args.snr_min, args.snr_max, args.snr_step),
        "cpu" if args.cpu else args.device, args.out)


if __name__ == "__main__":
    main()
