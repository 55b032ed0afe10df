"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``srsran_4g_tpu_torch/csrc`` (one
``nvcc`` per source, all started together), holds each kernel against its
plain PyTorch version on the card at the shapes the main path gives it (and
at small shapes), then drives the port's paths:

- the main path — PDSCH encode → CRS → AWGN at 30 dB → decode at 20 MHz
  (100 PRB, 64QAM, TBS 75376, 13 code blocks of K=5824), turbo n_iter 4
  with the CRC early stop, 128 subframes a batch — under each value of
  ``TURBO_KERNEL`` (v9, the default, then v7, v8, v5, v6), each checked for
  every CRC passing, every decoded bit equal to the sent one, and the
  launch counters of its own kernels moving while the others stay at 0;
  v9 is also timed by stage, profiled, and swept over batch and SNR;
- the TM4 2x2 dual-codeword lane (``models/pdsch_mimo``) at pmi 2, batch 64,
  30 dB through the fixed 2x2 channel of the JAX package's MIMO gate, both
  codewords checked the same way.

Output (stdout): the card's name and power limit, the build and check
lines, per-path subframes/s (best of 3), a per-stage split, then one JSON
line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
Any failure raises and the script exits non-zero without the last line;
there is no CPU fallback.  Imports nothing of JAX or of srsran_4g_tpu.
"""

from __future__ import annotations

import importlib.metadata
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth and f32 outside
# the tensor cores, the rates the bounds below are computed against
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
ATOL = 1e-3  # kernel vs plain version: f32, same arithmetic in the same order
SEED = 1234
BATCH = 128  # subframes per decode call
N_ITER = 4
SNR_DB = 30.0
DECODE_REPS = 5
SWEEP_BATCHES = (16, 32, 64, 256, 512)  # decode the 128 subframes cut or tiled
SWEEP_SNR_DB = (22.0, 20.0, 18.0)       # fresh noise on the same TX grids
PATH_REPS = 3  # best of 3 for each TURBO_KERNEL path and the MIMO lane
MIMO_BATCH = 64
MIMO_PMI = 2
# the fixed 2x2 channel of the JAX package's MIMO gate (tools/tpu_smoke.py)
MIMO_H = ((1.0 + 0.1j, 0.3 - 0.4j), (0.2 + 0.4j, -0.9 + 0.2j))
# TURBO_KERNEL -> the wrappers whose kernels that path launches
PATH_KERNELS = {"v9": ("map_windowed",), "v7": ("map_fused",),
                "v8": ("map_fused",), "v5": ("sweep", "emit"),
                "v6": ("sweep", "emit")}
WRAPPERS = ("map_windowed", "map_fused", "sweep", "emit")
# kernel route -> (its wrapper and radix, its source under csrc/, the line of
# the TPU kernel it replaces in srsran_4g_tpu/ops/pallas/turbo_map.py, and the
# TURBO_KERNEL path whose decode gives its launches)
ROUTES = {
    "turbo_map": ("map_windowed", None, "turbo_map.cu", 942, "v9"),
    "map_fused_r2": ("map_fused", 2, "turbo_fused.cu", 872, "v7"),
    "map_fused_r4": ("map_fused", 4, "turbo_fused.cu", 872, "v8"),
    "sweep_r2": ("sweep", 2, "turbo_sweep.cu", 1022, "v6"),
    "sweep_r4": ("sweep", 4, "turbo_sweep.cu", 426, "v5"),
    "emit": ("emit", None, "turbo_emit.cu", 1150, "v5"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def pkg_version(name: str) -> str:
    try:
        return importlib.metadata.version(name)
    except importlib.metadata.PackageNotFoundError:
        return "not installed"


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time (ms) for work that moves ``nbytes`` and does ``ops`` f32
    operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def work(wrapper: str, b: int, k: int, l: int, t: int) -> tuple[int, int]:
    """Bytes (each input read once, each output written once) and f32
    operations of one call of ``wrapper`` at these shapes.  The
    half-iteration (map_windowed, map_fused) reads the gammas and initial
    metrics and writes L LLRs per lane; sweep writes the L/2 even-position
    stores of both chains instead, and emit reads those stores and the body
    gammas.  Operations: 39 per
    trellis step per chain (16 branch adds, 8+7 max, 8 normalising
    subtracts), counting only lanes whose training is not frozen, 40 per
    LLR, and 48 for emit's two odd-position steps per pair."""
    w = k // l
    n = w * b
    gammas, inits, llrs = 2 * (l + 2 * t) * n, 2 * 8 * n, l * n
    stores = 2 * (l // 2) * 8 * n
    steps = (n - b) * t + (w - 1) * b * t + 2 * n * (l - 1)
    if wrapper == "sweep":
        return 4 * (gammas + inits + stores), 39 * steps
    if wrapper == "emit":
        return 4 * (2 * l * n + stores + llrs), (40 * 2 + 48) * (l // 2) * n
    return 4 * (gammas + inits + llrs), 39 * steps + 40 * llrs


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


def check_kernel(route: str, args, time_it=False) -> dict:
    """One route's kernel vs its plain version on the card, same inputs."""
    gs, _, _, _, t, l, b, w = args
    kernel, plain = kernel_calls(args, route)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    err = max(float((g - p).abs().max()) for g, p in pairs)
    desc = f"B={b} L={l} T={t} N={w * b}"
    if not np.isfinite(err) or err > ATOL:
        raise AssertionError(f"{route} kernel vs plain at {desc}: max |diff| {err} > {ATOL}")
    res = dict(max_abs_err=err)
    if time_it:
        res["ms"] = cuda_ms(kernel, reps=20)
        res["plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
    log(f"check {route} {desc}: max|diff| {err:.3g}"
        + (f", kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.2f} ms" if time_it else ""))
    return res


def check_kernels(dev, gen, b, k) -> dict:
    """Every route at the bench shape (timed) and at small shapes; the
    largest |diff| of each route over its checks."""
    routes = tuple(ROUTES)
    bench = gamma_inputs(dev, gen, b, k, 208, 32)
    out = {r: check_kernel(r, bench, time_it=True) for r in routes}
    small = [((64, 424, 106, 32), ("turbo_map", "sweep_r2", "sweep_r4", "emit")),  # L ≡ 2 (mod 4)
             ((32, 512, 64, 31), ("turbo_map",)),                                 # odd T
             ((16, 40, 40, 0), ("turbo_map",)),                                   # L = K, T = 0
             ((64, 512, 64, 16), routes[1:])]                                     # L % 4 == 0
    for shape, names in small:
        args = gamma_inputs(dev, gen, *shape)
        for r in names:
            out[r]["max_abs_err"] = max(out[r]["max_abs_err"],
                                        check_kernel(r, args)["max_abs_err"])
    return out


def launch_counts() -> dict[str, int]:
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    return {name: getattr(tm, name).launches for name in WRAPPERS}


def reset_counts() -> None:
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    for name in WRAPPERS:
        getattr(tm, name).launches = 0


def timed_decodes(cfg, rx, reps: int, decode=None):
    """Decode `reps` times; host-clock seconds of each (ends in a sync), the
    turbo kernel launches of the last decode (all wrappers), and its
    output."""
    from srsran_4g_tpu_torch.models import pdsch

    decode = decode or pdsch.decode
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        before = sum(launch_counts().values())
        t0 = time.perf_counter()
        out = decode(cfg, rx, n_iter=N_ITER)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, sum(launch_counts().values()) - before, out


def sweeps(cfg, tx, rx, bits, gen, card) -> None:
    """Batch size and SNR against decode time (reported, not asserted on,
    except that every batch of the 30 dB sweep must decode exactly)."""
    from srsran_4g_tpu_torch.channel import awgn

    for b in SWEEP_BATCHES:
        tile = -(-b // BATCH)
        times, launches, out = timed_decodes(cfg, rx.repeat(tile, 1, 1)[:b], 3)
        if not (bool(out["crc_ok"].all())
                and torch.equal(out["bits"], bits.repeat(tile, 1)[:b])):
            raise AssertionError(f"batch {b}: decode is not exact")
        log(f"[{card}] batch sweep {SNR_DB} dB: batch {b}: best {min(times) * 1e3:.2f} ms "
            f"= {b / min(times):.1f} subframes/s, turbo_map launches {launches}")
    for snr in SWEEP_SNR_DB:
        rx_s = awgn.awgn(tx, awgn.snr_to_noise_var(snr), generator=gen)
        times, launches, out = timed_decodes(cfg, rx_s, 3)
        n_ok = int(out["crc_ok"].sum())
        n_exact = int((out["bits"] == bits).all(dim=1).sum())
        log(f"[{card}] SNR sweep batch {BATCH}: {snr} dB: best {min(times) * 1e3:.2f} ms "
            f"= {BATCH / min(times):.1f} subframes/s, turbo_map launches {launches}, "
            f"crc_ok {n_ok}/{BATCH}, exact {n_exact}/{BATCH}")


def staged_decode(cfg, rx):
    """pdsch.decode's stages run one by one, each timed with CUDA events."""
    from srsran_4g_tpu_torch.models import chest, equalizer, pdsch, sch
    from srsran_4g_tpu_torch.ops import modem, scrambling

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    tab = pdsch._tables(cfg, rx.device)
    b = rx.shape[0]
    ev[0].record()
    est = chest.estimate(chest.ChestConfig(cell=cfg.cell), rx, cfg.subframe)
    ev[1].record()
    y = rx.reshape(b, -1)[:, tab["re_idx"]]
    h = est["h"].reshape(b, -1)[:, tab["re_idx"]]
    x, eff_nv = equalizer.equalize_single(y, h, est["noise_var"])
    llr = scrambling.descramble_llrs(
        modem.demodulate_soft(cfg.mod, x, eff_nv).reshape(b, cfg.g_bits), tab["seq"])
    ev[2].record()
    sch.dlsch_decode(cfg.plan, llr, n_iter=N_ITER)
    ev[3].record()
    torch.cuda.synchronize()
    return dict(chest=ev[0].elapsed_time(ev[1]),
                          equalise_demod_descramble=ev[1].elapsed_time(ev[2]),
                          dlsch_decode=ev[2].elapsed_time(ev[3]))


def profile_decode(cfg, rx, decode_s: float, card: str, reps: int = 3,
                   decode=None) -> None:
    """Device busy/idle share of the decode and its costliest kernels, from
    torch.profiler over `reps` decodes against the unprofiled best time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from srsran_4g_tpu_torch.models import pdsch

    decode = decode or pdsch.decode
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            decode(cfg, rx, n_iter=N_ITER)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if busy_ms <= 0:
        log(f"[{card}] profiler saw no device time: idle share not measured")
        return
    n_kernels = sum(e.count for e in kernels) / reps
    log(f"[{card}] decode device time {busy_ms:.3f} ms in {n_kernels:.0f} kernels "
        f"per decode; idle share {1 - busy_ms / (decode_s * 1e3):.3f} of the "
        f"unprofiled {decode_s * 1e3:.2f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3 / reps:8.3f} ms  x{e.count // reps:<4d} "
            f"{e.key[:90]}")


def check_exact(ok: torch.Tensor, got: torch.Tensor, sent: torch.Tensor, what: str) -> None:
    if not bool(ok.all()):
        raise AssertionError(f"{what}: crc_ok {int(ok.sum())}/{ok.numel()}")
    if not torch.equal(got, sent):
        raise AssertionError(f"{what}: decoded bits differ from the sent bits")


def drive_path(cfg, rx, bits, kernel: str) -> dict[str, int]:
    """Decode under TURBO_KERNEL=kernel with the counts at 0: the decode must
    be exact and only that path's kernels may launch.  Returns the counts."""
    from srsran_4g_tpu_torch.models import pdsch

    os.environ["TURBO_KERNEL"] = kernel
    reset_counts()
    out = pdsch.decode(cfg, rx, n_iter=N_ITER)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_exact(out["crc_ok"], out["bits"], bits, f"TURBO_KERNEL={kernel}")
    moved = {name for name, n in counts.items() if n}
    if moved != set(PATH_KERNELS[kernel]):
        raise AssertionError(f"TURBO_KERNEL={kernel} launched {counts}, expected only "
                             f"{PATH_KERNELS[kernel]}")
    log(f"TURBO_KERNEL={kernel}: crc_ok {int(out['crc_ok'].sum())}/{BATCH}, bits "
        f"equal, launches {counts}")
    return counts


def time_paths(cfg, rx, bits, card: str) -> None:
    """Best of PATH_REPS decodes under each TURBO_KERNEL, the paths taken in
    turn in every round so that host noise falls on all of them alike."""
    times = {kernel: [] for kernel in PATH_KERNELS}
    for _ in range(PATH_REPS):
        for kernel in PATH_KERNELS:
            os.environ["TURBO_KERNEL"] = kernel
            t, _, out = timed_decodes(cfg, rx, 1)
            check_exact(out["crc_ok"], out["bits"], bits, f"TURBO_KERNEL={kernel} (timed)")
            times[kernel] += t
    for kernel, t in times.items():
        log(f"[{card}] TURBO_KERNEL={kernel}: decode of {BATCH} subframes best of "
            f"{PATH_REPS} {min(t) * 1e3:.2f} ms ({', '.join(f'{x * 1e3:.2f}' for x in t)})"
            f" = {BATCH / min(t):.1f} subframes/s")


def mimo_lane(dev, gen, card: str) -> dict[str, int]:
    """TM4 2x2, two codewords of 100 PRB / 64QAM / TBS 75376 at pmi 2,
    through the fixed channel at 30 dB, decoded with the default kernel."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import grid, pdsch, pdsch_mimo

    os.environ["TURBO_KERNEL"] = "v9"
    mcfg = pdsch_mimo.PdschMimoConfig(
        cell=grid.CellConfig(nof_prb=100, cell_id=123, cfi=1, nof_ports=2),
        rnti=0x1234, subframe=4, mod0="64qam", tbs0=75376, mod1="64qam", tbs1=75376,
        tm="tm4", pmi=MIMO_PMI)
    tbs = [torch.randint(0, 2, (MIMO_BATCH, mcfg.tbs0), generator=gen, device=dev,
                         dtype=torch.int8) for _ in range(2)]
    tx = pdsch.add_crs(mcfg.cw[0], pdsch_mimo.encode(mcfg, *tbs))
    hmat = torch.tensor(MIMO_H, dtype=torch.complex64, device=dev)
    rx = awgn.awgn(torch.einsum("rt,btsk->brsk", hmat, tx), 10 ** (-SNR_DB / 10),
                   generator=gen)
    reset_counts()
    out = pdsch_mimo.decode(mcfg, rx, n_iter=N_ITER)
    torch.cuda.synchronize()
    counts = launch_counts()
    for q in (0, 1):
        check_exact(out[f"crc_ok{q}"], out[f"bits{q}"], tbs[q], f"TM4 codeword {q}")
    if not counts["map_windowed"]:
        raise AssertionError(f"the TM4 lane launched no turbo kernel: {counts}")
    times, _, out = timed_decodes(mcfg, rx, PATH_REPS, decode=pdsch_mimo.decode)
    for q in (0, 1):
        check_exact(out[f"crc_ok{q}"], out[f"bits{q}"], tbs[q], f"TM4 codeword {q} (timed)")
    log(f"[{card}] TM4 2x2 pmi {MIMO_PMI}, batch {MIMO_BATCH} x 2 codewords, "
        f"{SNR_DB} dB: crc_ok and bits exact on both, launches {counts}, best of "
        f"{PATH_REPS} {min(times) * 1e3:.2f} ms "
        f"({', '.join(f'{t * 1e3:.2f}' for t in times)}) = "
        f"{MIMO_BATCH / min(times):.1f} subframes/s")
    profile_decode(mcfg, rx, min(times), card, decode=pdsch_mimo.decode)
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        sys.exit(2)

    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import grid, pdsch
    from srsran_4g_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False  # CRC matmuls: plain f32
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    log(card)
    log(" ".join(subprocess.run(["nvidia-smi", "--version"], check=True,
                                capture_output=True, text=True).stdout.split()))
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton "
        f"{pkg_version('triton')}, numpy {np.__version__}, python {sys.version.split()[0]}")
    log(subprocess.run([build._nvcc(), "--version"], check=True, capture_output=True,
                       text=True).stdout.strip().splitlines()[-1])

    # ---- build every kernel source, all nvcc processes at once ------------
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    libs = build.build(sources)
    log(f"built {sources} in {time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- each kernel against its plain version, on the card ---------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = pdsch.PdschConfig(cell=grid.CellConfig(nof_prb=100, cell_id=123, cfi=1),
                            rnti=0x1234, subframe=4, mod="64qam", tbs=75376)
    grp = cfg.plan.groups[0]
    if (len(cfg.plan.groups), grp.count, grp.K) != (1, 13, 5824):
        raise AssertionError(f"unexpected segmentation {cfg.plan}")
    kern = check_kernels(dev, gen, BATCH * grp.count, grp.K)

    # ---- the main path: encode → CRS → AWGN → decode ----------------------
    log(f"main path: 100 PRB 64QAM TBS {cfg.tbs}, G={cfg.g_bits}, "
        f"{cfg.plan.segm.C} CBs of K={grp.K}, batch {BATCH} subframes, "
        f"n_iter {N_ITER}, {SNR_DB} dB")
    bits = torch.randint(0, 2, (BATCH, cfg.tbs), generator=gen, device=dev,
                         dtype=torch.int8)
    t0 = time.perf_counter()
    tx = pdsch.add_crs(cfg, pdsch.encode(cfg, bits))
    rx = awgn.awgn(tx, awgn.snr_to_noise_var(SNR_DB), generator=gen)
    torch.cuda.synchronize()
    log(f"encode + CRS + AWGN: {time.perf_counter() - t0:.2f} s (first call)")

    paths = {"v9": drive_path(cfg, rx, bits, "v9")}
    out = pdsch.decode(cfg, rx, n_iter=N_ITER)
    h, nv, snr = out["h"], out["noise_var"], out["snr_db"]
    if h.shape != (BATCH, cfg.cell.nsymb, cfg.cell.nre) or not (
            torch.isfinite(h).all() and torch.isfinite(nv).all()):
        raise AssertionError("channel estimate is not finite or has the wrong shape")
    log(f"estimated SNR {float(snr.mean()):.2f} dB")

    # ---- the default path's timing (the card's name and power limit beside
    # every number) ----------------------------------------------------------
    times, _, out = timed_decodes(cfg, rx, DECODE_REPS)
    if not bool(out["crc_ok"].all()):
        raise AssertionError("a timed decode failed its CRC")
    best = min(times)
    stages = [staged_decode(cfg, rx) for _ in range(3)][-1]
    log(f"[{card}] decode of {BATCH} subframes: best {best * 1e3:.2f} ms of "
        f"{DECODE_REPS} ({', '.join(f'{t * 1e3:.2f}' for t in times)} ms) = "
        f"{BATCH / best:.1f} subframes/s")
    log(f"[{card}] per-stage (CUDA events, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; turbo_map kernel {paths['v9']['map_windowed']} x "
        f"{kern['turbo_map']['ms']:.4f} ms")
    profile_decode(cfg, rx, best, card)
    sweeps(cfg, tx, rx, bits, gen, card)

    # ---- the other TURBO_KERNEL paths, then the 2x2 lane -------------------
    for kernel in ("v7", "v8", "v5", "v6"):
        paths[kernel] = drive_path(cfg, rx, bits, kernel)
    time_paths(cfg, rx, bits, card)
    mimo_lane(dev, gen, card)

    b, k, l, t = BATCH * grp.count, grp.K, 208, 32
    kernels = []
    for route, (wrapper, _, source, line, path) in ROUTES.items():
        nbytes, ops = work(wrapper, b, k, l, t)
        bound_ms, bound_by = bound(nbytes, ops)
        log(f"{route} bound at B={b} K={k} L={l} T={t}: {nbytes} bytes, {ops} f32 ops "
            f"-> {bound_ms:.4f} ms ({bound_by}); kernel {kern[route]['ms']:.4f} ms")
        kernels.append(dict(
            name=route, route="cuda", source=f"srsran_4g_tpu_torch/csrc/{source}",
            replaces=f"srsran_4g_tpu/ops/pallas/turbo_map.py:{line}",
            path=f"TURBO_KERNEL={path}",
            shapes=dict(blocks=b, K=k, L=l, T=t, lanes=b * (k // l)),
            launches=paths[path][wrapper], max_abs_err=kern[route]["max_abs_err"],
            ms=kern[route]["ms"], plain_ms=kern[route]["plain_ms"], bound_ms=bound_ms,
            bound_by=bound_by, bytes=nbytes, library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
