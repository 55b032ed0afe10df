"""Per-stage times of the 20 MHz PDSCH receiver on the card: the port's
counterpart of the JAX package's ``tools/profile_components.py``.

``SETTING``: 100 PRB, cell 123, CFI 1, RNTI 0x1234, subframe 4, 64QAM, TBS
75,376 (13 code blocks of K = 5,824) at 30 dB, ``BENCH_BATCH`` subframes (32
by default).  The bits come from ``np.random.default_rng(0)``, the noise
from a ``torch.Generator`` seeded 1.  The JAX tool's seven lines, each with
host ms (``tools.clock_ms``: the host clock up to a synchronise, the mean of
its calls after a warm one), µs a subframe (host) and device ms: the
device's busy time under torch.profiler, the median of three more calls
(``trace_bench.busy_ms``), which leaves out the idle gaps in which the host
queues the next kernel:

- ``full_decode``: ``pdsch.decode``, n_iter 4 (3 calls);
- ``chest``: ``chest.estimate`` (5 calls);
- ``chest+eq+demod``: the estimate, ``equalizer.equalize_single`` and
  ``modem.demodulate_soft`` (5 calls);
- ``frontend_total``: the same and ``scrambling.descramble_llrs`` (5 calls);
- ``dlsch_decode(it=4)``, ``dlsch_decode(it=2)``: ``sch.dlsch_decode`` on
  the front end's LLRs (3 calls each);
- ``turbo_4it_w128``: ``turbo_decode`` of B × 13 random code blocks at the
  plan's K, window 128, training 32 (3 calls).

Then the stages of the last of three decodes: ``stage_times`` reads CUDA
events recorded between the three stages of one decode (``chip_smoke.py``'s
per-stage split), so each stage's span on the device's clock, idle gaps
included (``stage_span_ms``), and raises unless the staged chain's bits and
CRC flags equal ``pdsch.decode``'s.  Writes
``artifacts/torch/profile_components.json``: ``lines`` (``host_ms``,
``us_per_sf``, ``device_busy_ms``) and ``stage_span_ms``.

    python -m srsran_4g_tpu_torch.tools.profile_components [--device cuda]
        [--out artifacts/torch/profile_components.json]

``--device`` defaults to cuda and raises without a card; on ``--device
cpu`` the same code runs the kernels' plain versions and no device time is
read ("not measured").
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device

SETTING = dict(nof_prb=100, cell_id=123, cfi=1, rnti=0x1234, subframe=4, mod="64qam",
               tbs=75376, snr_db=30.0)
N_ITER = 4
DEFAULT_OUT = os.path.join("artifacts", "torch", "profile_components.json")
NAMES = ("full_decode", "chest", "chest+eq+demod", "frontend_total", "dlsch_decode(it=4)",
         "dlsch_decode(it=2)", "turbo_4it_w128")
LINE = re.compile(r"^(\S+)\s+([0-9.]+) ms\s+\(\s*([0-9.]+) us/sf\)\s+device\s+"
                  r"(not measured|[0-9.]+)")


def config():
    """The PdschConfig of SETTING."""
    from srsran_4g_tpu_torch.models import grid, pdsch

    s = SETTING
    return pdsch.PdschConfig(cell=grid.CellConfig(nof_prb=s["nof_prb"], cell_id=s["cell_id"],
                                                  cfi=s["cfi"]),
                             rnti=s["rnti"], subframe=s["subframe"], mod=s["mod"], tbs=s["tbs"])


def received(cfg, bits: np.ndarray, device) -> torch.Tensor:
    """The grids (B, nsymb, nre) of the TBs ``bits`` (B, tbs) after the CRS
    and AWGN at SETTING's SNR, noise from a ``torch.Generator`` seeded 1."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import pdsch

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    tx = pdsch.add_crs(cfg, pdsch.encode(cfg, torch.as_tensor(bits, device=dev)))
    return awgn.awgn(tx, awgn.snr_to_noise_var(SETTING["snr_db"], device=dev), generator=gen)


def estimate(cfg, rx: torch.Tensor) -> dict:
    """The CRS channel estimate of the grids."""
    from srsran_4g_tpu_torch.models import chest

    return chest.estimate(chest.ChestConfig(cell=cfg.cell), rx, cfg.subframe)


def demod(cfg, rx: torch.Tensor, est: dict) -> torch.Tensor:
    """Equalised, demodulated soft bits (B, G), still scrambled."""
    from srsran_4g_tpu_torch.models import equalizer, pdsch
    from srsran_4g_tpu_torch.ops import modem

    idx = pdsch._tables(cfg, rx.device)["re_idx"]
    b = rx.shape[0]
    x, eff_nv = equalizer.equalize_single(rx.reshape(b, -1)[:, idx],
                                          est["h"].reshape(b, -1)[:, idx], est["noise_var"])
    return modem.demodulate_soft(cfg.mod, x, eff_nv).reshape(b, cfg.g_bits)


def descramble(cfg, llr_scr: torch.Tensor) -> torch.Tensor:
    from srsran_4g_tpu_torch.models import pdsch
    from srsran_4g_tpu_torch.ops import scrambling

    return scrambling.descramble_llrs(llr_scr, pdsch._tables(cfg, llr_scr.device)["seq"])


def front_end(cfg, rx: torch.Tensor) -> torch.Tensor:
    """The descrambled LLRs (B, G) that ``pdsch.decode`` hands to DL-SCH."""
    return descramble(cfg, demod(cfg, rx, estimate(cfg, rx)))


def stage_times(cfg, rx: torch.Tensor, n_iter: int = N_ITER) -> dict[str, float]:
    """``pdsch.decode``'s stages run one by one: ms of the channel estimate,
    of equalising + demodulating + descrambling, and of the DL-SCH decode,
    from CUDA events recorded between the stages on a card: each stage's
    span on the device's clock, the gaps in which the host queues its
    kernels included (from the host clock on the CPU, where each op ends
    before the next).  Raises unless the staged
    chain's bits and CRC flags equal ``pdsch.decode``'s."""
    from srsran_4g_tpu_torch.models import pdsch, sch

    cuda = rx.device.type == "cuda"
    marks = []

    def mark():
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())

    mark()
    est = estimate(cfg, rx)
    mark()
    llr = descramble(cfg, demod(cfg, rx, est))
    mark()
    bits, ok, _ = sch.dlsch_decode(cfg.plan, llr, n_iter=n_iter)
    mark()
    if cuda:
        torch.cuda.synchronize(rx.device)
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    want = pdsch.decode(cfg, rx, n_iter=n_iter)
    if not (torch.equal(bits, want["bits"]) and torch.equal(ok, want["crc_ok"])):
        raise AssertionError("the staged decode's bits or CRC flags differ from pdsch.decode's")
    return dict(zip(("chest", "equalise_demod_descramble", "dlsch_decode"), ms))


def timeit(name: str, fn, batch: int, device: torch.device, iters: int = 5) -> dict:
    """One line: ``fn`` timed on the host clock over ``iters`` calls after a
    warm one, then ``trace_bench.busy_ms`` for the device's busy time."""
    from srsran_4g_tpu_torch.tools import clock_ms, trace_bench

    host = sum(clock_ms(fn, iters, warm=True).ms) / iters
    busy = trace_bench.busy_ms(fn, device)
    dev_s = f"{busy:8.2f}" if busy is not None else "not measured"
    print(f"{name:30s} {host:8.2f} ms  ({host / batch * 1000:6.1f} us/sf)  device {dev_s}",
          flush=True)
    return dict(host_ms=host, us_per_sf=host / batch * 1000, device_busy_ms=busy)


def parse(text: str) -> dict[str, dict]:
    """The lines of ``run``'s print in ``text``, by name."""
    out = {}
    for line in text.splitlines():
        m = LINE.match(line)
        if m:
            dev = None if m.group(4) == "not measured" else float(m.group(4))
            out[m.group(1)] = dict(host_ms=float(m.group(2)), us_per_sf=float(m.group(3)),
                                   device_busy_ms=dev)
    return out


def run(batch: int, device=None, out: str | None = DEFAULT_OUT) -> dict:
    """The seven lines at ``batch`` subframes, then the three stages of the
    last of three decodes (``stage_times``); writes the JSON to ``out`` (None: nowhere)."""
    from srsran_4g_tpu_torch.models import pdsch, sch
    from srsran_4g_tpu_torch.ops import turbo

    dev = resolve_device(device)
    cfg = config()
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(batch, cfg.tbs)).astype(np.int8)
    rx = received(cfg, bits, dev)
    lines = {
        "full_decode": timeit("full_decode", lambda: pdsch.decode(cfg, rx, n_iter=N_ITER),
                              batch, dev, iters=3),
        "chest": timeit("chest", lambda: estimate(cfg, rx), batch, dev),
        "chest+eq+demod": timeit("chest+eq+demod", lambda: demod(cfg, rx, estimate(cfg, rx)),
                                 batch, dev),
        "frontend_total": timeit("frontend_total", lambda: front_end(cfg, rx), batch, dev),
    }
    llrs = front_end(cfg, rx)
    for it in (4, 2):
        name = f"dlsch_decode(it={it})"
        lines[name] = timeit(name, lambda: sch.dlsch_decode(cfg.plan, llrs, n_iter=it),
                             batch, dev, iters=3)
    k = cfg.plan.groups[-1].K
    d = torch.as_tensor(rng.standard_normal((batch * cfg.plan.segm.C, 3, k + 4))
                        .astype(np.float32), device=dev)
    lines["turbo_4it_w128"] = timeit(
        "turbo_4it_w128", lambda: turbo.turbo_decode(d, n_iter=4, window=128, train=32),
        batch, dev, iters=3)
    stages = [stage_times(cfg, rx) for _ in range(3)][-1]
    clock = "spans between CUDA events" if dev.type == "cuda" else "host clock"
    print(f"stages (the last of 3 decodes, {clock}, ms): "
          + ", ".join(f"{key} {v:.3f}" for key, v in stages.items()), flush=True)
    res = dict(batch=batch, device=torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else "cpu", setting=SETTING, lines=lines, stage_span_ms=stages)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--out", default=DEFAULT_OUT, help="the JSON file")
    args = ap.parse_args(argv)
    return run(int(os.environ.get("BENCH_BATCH", "32")), args.device, args.out)


if __name__ == "__main__":
    main()
