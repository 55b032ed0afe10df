"""BLER parity sweeps on the port: the NR LDPC chain and the LTE PDSCH over
SNR grids.

Port counterpart of the JAX package's ``tools/bler_sweep.py`` (the
reference's ``ldpc_chain_test.c``, and ``pdsch_test.c`` /
``pusch_nr_bler_test.c``): the same grids, checkpoint keys, meta and tables,
plus ``--device`` (default cuda; no fallback: ``--device cpu`` or ``--cpu``
asks for the CPU) and ``--out-dir``.

- LDPC: BG1, one code block (TBS 4224, G 12672, Qm 4) through
  ``models/sch_nr`` (``n_iter`` 15), BPSK over AWGN at nv =
  10^(-Eb/N0/10) / (2 rate), LLR = -2y/nv, Eb/N0 0.5-4.0 dB in steps of 0.5;
  BLER and BER per point, Mb/s over all points.
- PDSCH: 50 PRB, cell 1, CFI 1, RNTI 0x46, subframe 4; QPSK TBS 4392 at
  -2..6 dB, 16QAM 12960 at 4..14, 64QAM 22920 at 10..22, 5 points each:
  ``add_crs(encode(...))``, AWGN at ``snr_to_noise_var(snr)``, then
  ``pdsch.decode`` (n_iter 5, CRC early stop); BLER from ``crc_ok``.  The
  three cases decode blocks of K = 4416, 4352 and 5760, at windows of 192,
  136 and 192, through ``map_fused16``.

The bits come from ``np.random.default_rng(0)``, drawn for every point, also
for points already in the checkpoint, so a resumed run sees the same bits.
The JAX tool draws its noise with ``jax.random`` inside its jitted step, a
stream torch cannot reproduce; here each point's noise comes from a
``torch.Generator`` on the tool's device seeded with the JAX tool's seed
(``int(ebn0 * 10)``, ``int(snr * 7)``).  The curves therefore match the JAX
tool's in distribution, not sample by sample; ``ldpc_point`` and
``pdsch_point`` take the noise as an argument, so that tests can give both
packages the same draws.

Interrupted sweeps resume from the checkpoint (``utils/checkpoint``): every
finished point is saved at once and skipped on restart.  Writes
``bler_ldpc.json`` and ``bler_pdsch.json`` to ``artifacts/torch/`` (relative
to the working directory) unless ``--out-dir`` names another directory, and
checkpoints to ``artifacts/torch/bler_sweep.ckpt.json``; never to the JAX
tool's files under ``artifacts/``.

Usage: python -m srsran_4g_tpu_torch.tools.bler_sweep [--frames 32]
           [--device cuda] [--out-dir artifacts/torch] [--checkpoint PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.channel import awgn
from srsran_4g_tpu_torch.models import grid as G
from srsran_4g_tpu_torch.models import pdsch, sch_nr
from srsran_4g_tpu_torch.utils.checkpoint import SweepCheckpoint

DEFAULT_OUT_DIR = os.path.join("artifacts", "torch")
DEFAULT_CHECKPOINT = os.path.join(DEFAULT_OUT_DIR, "bler_sweep.ckpt.json")
LDPC = (4224, 12672, 4)  # TBS, G, Qm: BG1, one code block
LDPC_EBN0 = tuple(float(x) for x in np.arange(0.5, 4.01, 0.5))
CELL = dict(nof_prb=50, cell_id=1, cfi=1)
RNTI, SUBFRAME = 0x46, 4
PDSCH_CASES = (("qpsk", 4392, (-2.0, 6.0)), ("16qam", 12960, (4.0, 14.0)),
               ("64qam", 22920, (10.0, 22.0)))
PDSCH_POINTS = 5


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ldpc_point(seg: sch_nr.NrSegm, bits: torch.Tensor, noise: torch.Tensor,
               nv: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode, BPSK, AWGN of variance ``nv`` from unit ``noise`` (B, G),
    decode: (decoded bits (B, tbs) int8, crc_ok (B,))."""
    x = 1.0 - 2.0 * sch_nr.encode(seg, bits).to(torch.float32)
    nv_t = torch.tensor(nv, dtype=torch.float32, device=x.device)
    y = x + torch.sqrt(nv_t) * noise
    dec, ok, _ = sch_nr.decode(seg, -2.0 * y / nv_t)
    return dec, ok


def pdsch_point(cfg: pdsch.PdschConfig, bits: torch.Tensor, noise: torch.Tensor,
                nv: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode with CRS, add ``noise`` (B, nsymb, nre) complex64 of unit
    variance per component scaled to total variance ``nv``, decode:
    (decoded bits (B, tbs) int8, crc_ok (B,))."""
    tx = pdsch.add_crs(cfg, pdsch.encode(cfg, bits))
    nv_t = torch.tensor(nv, dtype=torch.float32, device=tx.device)
    out = pdsch.decode(cfg, tx + torch.sqrt(nv_t / 2.0).to(torch.complex64) * noise)
    return out["bits"], out["crc_ok"]


def ldpc_sweep(frames: int, device, rng: np.random.Generator, ckpt: SweepCheckpoint,
               on_point=None) -> list[dict]:
    """The LDPC table.  ``on_point(key, row, seconds)`` sees each point that
    was computed (not read from the checkpoint)."""
    dev = resolve_device(device)
    tbs, g_bits, qm = LDPC
    seg = sch_nr.nr_segment(tbs, g_bits, qm)
    rate = tbs / g_bits
    rows, t_tot = [], 0.0
    for ebn0 in LDPC_EBN0:
        key = f"ldpc/ebn0={ebn0:.2f}"
        bits = rng.integers(0, 2, (frames, tbs)).astype(np.int8)
        if key in ckpt:
            row = ckpt.get(key)
        else:
            nv = float(10 ** (-ebn0 / 10) / (2 * rate))
            bits_t = torch.as_tensor(bits, device=dev)
            _sync(dev)
            t0 = time.perf_counter()
            noise = torch.randn((frames, seg.g), generator=_generator(int(ebn0 * 10), dev),
                                device=dev)
            dec, ok = ldpc_point(seg, bits_t, noise, nv)
            n_ok, n_err = int(ok.sum()), int((dec != bits_t).sum())
            dt = time.perf_counter() - t0
            t_tot += dt
            row = dict(ebn0_db=round(ebn0, 2), bler=round(1 - n_ok / frames, 4),
                       ber=round(n_err / (frames * tbs), 6))
            ckpt.put(key, row)
            if on_point is not None:
                on_point(key, row, dt)
        rows.append(row)
        print("ldpc", row, file=sys.stderr)
    info_bps = frames * tbs * 8 / max(t_tot, 1e-9)
    print(f"ldpc chain: {info_bps/1e6:.1f} Mb/s info (all points)", file=sys.stderr)
    return rows


def pdsch_sweep(frames: int, device, rng: np.random.Generator, ckpt: SweepCheckpoint,
                on_point=None) -> list[dict]:
    """The PDSCH table.  ``on_point(key, row, seconds, (cfg, bits, noise,
    nv), (decoded bits, crc_ok))`` sees each point that was computed."""
    dev = resolve_device(device)
    cell = G.CellConfig(**CELL)
    rows = []
    for mod, tbs, (lo, hi) in PDSCH_CASES:
        cfg = pdsch.PdschConfig(cell=cell, rnti=RNTI, subframe=SUBFRAME, mod=mod, tbs=tbs)
        for snr in np.linspace(lo, hi, PDSCH_POINTS):
            key = f"pdsch/{mod}/snr={float(snr):.1f}"
            bits = rng.integers(0, 2, (frames, tbs)).astype(np.int8)
            if key in ckpt:
                row = ckpt.get(key)
            else:
                nv = float(awgn.snr_to_noise_var(float(snr), device=dev))
                bits_t = torch.as_tensor(bits, device=dev)
                _sync(dev)
                t0 = time.perf_counter()
                gen = _generator(int(snr * 7), dev)
                shape = (frames, cell.nsymb, cell.nre)
                noise = torch.complex(torch.randn(shape, generator=gen, device=dev),
                                      torch.randn(shape, generator=gen, device=dev))
                dec, ok = pdsch_point(cfg, bits_t, noise, nv)
                n_ok = int(ok.sum())
                dt = time.perf_counter() - t0
                row = dict(mod=mod, tbs=tbs, snr_db=round(float(snr), 1),
                           bler=round(1 - n_ok / frames, 4))
                ckpt.put(key, row)
                if on_point is not None:
                    on_point(key, row, dt, (cfg, bits_t, noise, nv), (dec, ok))
            rows.append(row)
            print("pdsch", row, file=sys.stderr)
    return rows


def run(frames: int, device=None, out_dir: str = DEFAULT_OUT_DIR,
        checkpoint: str = DEFAULT_CHECKPOINT, on_ldpc=None, on_pdsch=None) -> dict:
    """Both sweeps, resuming from ``checkpoint``; writes both tables to
    ``out_dir``, removes the checkpoint and prints the JAX tool's last line."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    ckpt = SweepCheckpoint(checkpoint, meta={"frames": frames})
    out = {"ldpc": ldpc_sweep(frames, dev, rng, ckpt, on_ldpc),
           "pdsch": pdsch_sweep(frames, dev, rng, ckpt, on_pdsch)}
    os.makedirs(out_dir, exist_ok=True)
    for name in ("ldpc", "pdsch"):
        with open(os.path.join(out_dir, f"bler_{name}.json"), "w") as f:
            json.dump(out[name], f, indent=1)
    ckpt.done()
    print(json.dumps({"metric": "pdsch_bler_points", "value": len(out["pdsch"]),
                      "unit": "rows"}))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT)
    p.add_argument("--out-dir", default=DEFAULT_OUT_DIR, help="where the tables go")
    args = p.parse_args(argv)
    run(args.frames, "cpu" if args.cpu else args.device, args.out_dir, args.checkpoint)


if __name__ == "__main__":
    main()
