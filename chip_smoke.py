"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``srsran_4g_tpu_torch/csrc`` (one
``nvcc`` per source, all started together), holds each kernel against its
plain PyTorch version on the card at the shapes the main path gives it (and
at small shapes: odd L and T, L ≡ 2 mod 4, L = K with T = 0), then drives
the port's paths, each with the launch counters set to 0 just before it and
read just after:

- the main path — PDSCH encode → CRS → AWGN at 30 dB → decode at 20 MHz
  (100 PRB, 64QAM, TBS 75376, 13 code blocks of K=5824), turbo n_iter 4
  with the CRC early stop, 128 subframes a batch — under each value of
  ``TURBO_KERNEL`` (v9, the default, then bf16, v3, v4, v7, v8, v5, v6),
  each checked for every CRC passing, every decoded bit equal to the sent
  one, and the launch counters of its own kernels moving while the others
  stay at 0; v9 is also timed by stage, profiled, and swept over batch and
  SNR;
- the TM4 2x2 dual-codeword lane (``models/pdsch_mimo``) at pmi 2, batch 64,
  30 dB through the fixed 2x2 channel of the JAX package's MIMO gate, both
  codewords checked the same way;
- the downlink from time-domain samples: 128 captures of a 100 PRB
  subframe 5 (``models/enb_dl``, ``ops/ofdm``) after a random lead, with a
  random phase, a CFO and AWGN at 30 dB, searched blind
  (``models/ue_dl.cell_search``: PSS, CFO, alignment, OFDM demod, SSS) and
  decoded from the grid the search returns, each capture checked for its
  cell id, frame phase, exact timing offset, CFO, CRCs and bits.

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

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth, f32 outside the
# tensor cores, and bf16 (the data sheet's one bf16 rate, the tensor cores'),
# the rates the bounds below are computed against
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12}
ATOL = 1e-3  # f32 kernel vs plain version: same arithmetic in the same order
# bf16 kernels vs plain version: the repo's 16-bit bars (hard bits identical,
# atol 2.5, mean |diff| < 0.5); the same bf16 ops in the same order, so 0 is
# expected
ATOL16, MEAN16 = 2.5, 0.5
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
PATH_KERNELS = {"v9": ("map_fused16",), "bf16": ("map_windowed16",),
                "v3": ("map_v3",), "v4": ("map_windowed",),
                "v7": ("map_fused",), "v8": ("map_fused",),
                "v5": ("sweep", "emit"), "v6": ("sweep", "emit")}
WRAPPERS = ("map_windowed", "map_windowed16", "map_v3", "map_fused",
            "map_fused16", "sweep", "emit")
BF16_WRAPPERS = ("map_windowed16", "map_fused16")
# the downlink from samples: 100 PRB, subframe 5 (PSS/SSS present), a cell id
# that is not a multiple of 3; captures of a random lead of 0..DL_LEAD_MAX
# samples, the subframe, and a tail of at least DL_TAIL; CFO uniform in
# +-DL_CFO subcarriers (the largest of 0.1, 0.05, 0 at which the JAX package
# on the CPU searched, took the CFO from the CP and decoded a batch-2 capture
# exactly).  Above 6 PRB cell_search takes the CFO from the CP and refines
# the timing from the PSS's phase slope, so the offset must be exact.
DL_CELL_ID = 301
DL_SUBFRAME = 5
DL_LEAD_MAX, DL_TAIL = 2000, 400
DL_CFO = 0.1
DL_CFO_TOL = 0.02
# kernel route -> (its wrapper and radix, its source under csrc/, the line of
# the TPU kernel it replaces in srsran_4g_tpu/ops/pallas/turbo_map.py, and the
# TURBO_KERNEL path whose decode gives its launches)
ROUTES = {
    "turbo_map": ("map_windowed", None, "turbo_map.cu", 272, "v4"),
    "map_windowed16": ("map_windowed16", None, "turbo_map.cu", 1323, "bf16"),
    "map_v3": ("map_v3", None, "turbo_v3.cu", 1189, "v3"),
    "map_fused16": ("map_fused16", None, "turbo_fused.cu", 942, "v9"),
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


def bound(nbytes: int, ops: int, kind: str) -> tuple[float, str]:
    """Least time (ms) for work that moves ``nbytes`` and does ``ops``
    operations of type ``kind`` ("f32" or "bf16"), and which of the two
    bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def work(wrapper: str, b: int, k: int, l: int, t: int) -> tuple[int, int]:
    """Bytes (each input read once, each output written once) and
    operations of one call of ``wrapper`` at these shapes.  The
    half-iteration (map_windowed, map_windowed16, map_v3, map_fused,
    map_fused16) reads the float32 gammas and initial metrics and writes L
    float32 LLRs per lane; sweep writes the L/2 even-position stores of both
    chains instead, and emit reads those stores and the body gammas.
    Operations (bf16 for the 16-bit kernels, else f32): 39 per
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
    """One route's kernel vs its plain version on the card, same inputs: f32
    kernels to atol 1e-3, bf16 kernels to the 16-bit bars; map_v3 also
    against turbo_map's LLRs."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    gs, _, _, _, t, l, b, w = args
    kernel, plain = kernel_calls(args, route)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = max(float((g - p).abs().max()) for g, p in pairs)
    desc = f"B={b} L={l} T={t} N={w * b}"
    if not np.isfinite(err):
        raise AssertionError(f"{route} kernel vs plain at {desc}: not finite")
    if ROUTES[route][0] in BF16_WRAPPERS:
        mean = float((got - want).abs().mean())
        if err > ATOL16 or mean >= MEAN16 or not torch.equal(got > 0, want > 0):
            raise AssertionError(f"{route} kernel vs plain at {desc}: max |diff| {err}, "
                                 f"mean {mean}, or a hard decision differs")
    elif err > ATOL:
        raise AssertionError(f"{route} kernel vs plain at {desc}: max |diff| {err} > {ATOL}")
    res = dict(max_abs_err=err)
    if route == "map_v3":
        res["vs_turbo_map"] = float((got - tm.map_windowed(*args)).abs().max())
        torch.cuda.synchronize()
        if res["vs_turbo_map"] > ATOL:
            raise AssertionError(f"map_v3 vs turbo_map at {desc}: max |diff| "
                                 f"{res['vs_turbo_map']} > {ATOL}")
    if time_it:
        res["ms"] = cuda_ms(kernel, reps=20)
        res["plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
    log(f"check {route} {desc}: max|diff| {err:.3g}"
        + (f" (vs turbo_map {res['vs_turbo_map']:.3g})" if "vs_turbo_map" in res else "")
        + (f", kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.2f} ms" if time_it else ""))
    return res


def check_kernels(dev, gen, b, k) -> dict:
    """Every route at the bench shape (timed) and at small shapes; the
    largest |diff| of each route over its checks."""
    bench = gamma_inputs(dev, gen, b, k, 208, 32)
    out = {r: check_kernel(r, bench, time_it=True) for r in ROUTES}
    any_shape = ("turbo_map", "map_windowed16", "map_v3")  # the v1 bodies
    small = [((64, 424, 106, 32), any_shape + ("sweep_r2", "sweep_r4", "emit")),  # L ≡ 2 (mod 4)
             ((32, 512, 64, 31), any_shape),                                      # odd T
             ((32, 504, 63, 16), any_shape),                                      # odd L
             ((33, 40, 40, 0), any_shape),                                        # L = K, T = 0, N odd
             ((64, 512, 64, 16), tuple(r for r in ROUTES if r not in any_shape))]  # L % 4 == 0
    for shape, names in small:
        args = gamma_inputs(dev, gen, *shape)
        for r in names:
            res = check_kernel(r, args)
            for key in ("max_abs_err", "vs_turbo_map"):
                if key in res:
                    out[r][key] = max(out[r][key], res[key])
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
            f"= {b / min(times):.1f} subframes/s, turbo launches {launches}")
    for snr in SWEEP_SNR_DB:
        rx_s = awgn.awgn(tx, awgn.snr_to_noise_var(snr), generator=gen)
        times, launches, out = timed_decodes(cfg, rx_s, 3)
        n_ok = int(out["crc_ok"].sum())
        n_exact = int((out["bits"] == bits).all(dim=1).sum())
        log(f"[{card}] SNR sweep batch {BATCH}: {snr} dB: best {min(times) * 1e3:.2f} ms "
            f"= {BATCH / min(times):.1f} subframes/s, turbo launches {launches}, "
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
    if not counts["map_fused16"]:
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


def dl_captures(dev, gen, cfg, cfo_max: float):
    """DL-from-samples traffic: BATCH captures of one subframe of ``cfg``,
    each after a random lead and with a random phase, a CFO uniform in
    +-cfo_max subcarriers and AWGN at SNR_DB.  Returns (captures (B, n)
    complex64, sent bits, lead (B,), cfo (B,))."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import enb_dl
    from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig

    ocfg = OfdmConfig(nof_prb=cfg.cell.nof_prb)
    bits = torch.randint(0, 2, (BATCH, cfg.tbs), generator=gen, device=dev,
                         dtype=torch.int8)
    sf = enb_dl.subframe_to_samples(cfg.cell, enb_dl.assemble_subframe(cfg, bits))
    n = DL_LEAD_MAX + ocfg.sf_len + DL_TAIL
    lead = torch.randint(0, DL_LEAD_MAX + 1, (BATCH,), generator=gen, device=dev)
    gain = torch.polar(torch.ones(BATCH, device=dev),
                       2 * np.pi * torch.rand(BATCH, generator=gen, device=dev))
    cap = torch.zeros((BATCH, n), dtype=torch.complex64, device=dev)
    cap.scatter_(1, lead[:, None] + torch.arange(ocfg.sf_len, device=dev),
                 sf * gain[:, None])
    cfo = (2 * torch.rand(BATCH, generator=gen, device=dev) - 1) * cfo_max
    phase = 2 * np.pi * cfo.double()[:, None] * torch.arange(n, device=dev) / ocfg.symbol_sz
    cap = cap * torch.polar(torch.ones_like(phase), phase).to(torch.complex64)
    return (awgn.awgn(cap, awgn.snr_to_noise_var(SNR_DB, device=dev), generator=gen), bits,
            lead, cfo)


def profile_search(search, card: str, reps: int = 3) -> None:
    """Device time of the cell search split into the FFTs (cuFFT kernels)
    and the rest, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            search()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if total <= 0:
        log(f"[{card}] profiler saw no device time: cell search split not measured")
        return
    fft = sum(e.self_device_time_total for e in kernels if "fft" in e.key.lower()) / 1e3 / reps
    log(f"[{card}] cell search device time {total:.3f} ms per search of {BATCH}: FFT "
        f"{fft:.3f} ms ({fft / total:.3f}), the rest {total - fft:.3f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3 / reps:8.3f} ms  x{e.count // reps:<4d} "
            f"{e.key[:90]}")


def dl_path(dev, gen, card: str) -> dict[str, int]:
    """The downlink from samples at 100 PRB, under the default TURBO_KERNEL:
    blind cell search of BATCH captures with the CFO from the CP (cell id,
    frame phase and timing offset exact, |CFO error| < DL_CFO_TOL on every
    capture), ``pdsch.decode`` of the grid it returns and
    ``receive_pdsch_subframe`` of the aligned samples, every CRC and bit
    checked.  Returns the launch counts of the search and decode."""
    from srsran_4g_tpu_torch.models import grid, pdsch, ue_dl
    from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig, _symbol_offsets

    os.environ.pop("TURBO_KERNEL", None)
    cfg = pdsch.PdschConfig(cell=grid.CellConfig(nof_prb=100, cell_id=DL_CELL_ID, cfi=1),
                            rnti=0x1234, subframe=DL_SUBFRAME, mod="64qam", tbs=75376)
    plan = [(g.count, g.K) for g in cfg.plan.groups]
    if plan != [(13, 5824)]:
        log(f"DL path: segmentation {plan} (not 13 CBs of K=5824)")
    ocfg = OfdmConfig(nof_prb=100)
    t0 = time.perf_counter()
    cap, bits, lead, cfo = dl_captures(dev, gen, cfg, DL_CFO)
    torch.cuda.synchronize()
    log(f"DL path: {BATCH} captures of {cap.shape[-1]} samples (lead 0..{DL_LEAD_MAX}, "
        f"sf_len {ocfg.sf_len}, tail >= {DL_TAIL}), cell {DL_CELL_ID}, subframe "
        f"{DL_SUBFRAME}, CFO within +-{DL_CFO}, {SNR_DB} dB: made in "
        f"{time.perf_counter() - t0:.2f} s (first call)")

    def search():
        return ue_dl.cell_search(cap, 100)

    def search_decode():
        return pdsch.decode(cfg, search()["grid"], n_iter=N_ITER)

    reset_counts()
    found = search()
    out = pdsch.decode(cfg, found["grid"], n_iter=N_ITER)
    torch.cuda.synchronize()
    counts = launch_counts()
    off_err = found["offset"] - (lead + int(_symbol_offsets(ocfg)[6]))
    cfo_err = float((found["cfo"] - cfo).abs().max())
    checks = {"cell_id": bool((found["cell_id"] == DL_CELL_ID).all()),
              "phase 1": bool((found["phase"] == 1).all()),
              "offset exact": bool((off_err == 0).all()),
              f"|CFO error| < {DL_CFO_TOL}": cfo_err < DL_CFO_TOL}
    if not all(checks.values()):
        raise AssertionError(f"DL cell search: {checks}; cell ids "
                             f"{found['cell_id'].unique().tolist()}, offset errors "
                             f"{off_err.unique().tolist()}, max |CFO error| {cfo_err}")
    check_exact(out["crc_ok"], out["bits"], bits, "DL from samples")
    moved = {name for name, n in counts.items() if n}
    if moved != set(PATH_KERNELS["v9"]):
        raise AssertionError(f"the DL path launched {counts}, expected only "
                             f"{PATH_KERNELS['v9']}")
    rx = ue_dl.receive_pdsch_subframe(cfg, found["sf_samples"], n_iter=N_ITER)
    check_exact(rx["crc_ok"], rx["bits"], bits, "receive_pdsch_subframe on the aligned samples")
    log(f"DL path: cell_id {DL_CELL_ID}, phase 1 and offset exact on "
        f"all {BATCH}, max |CFO error| {cfo_err:.6f}; decode of the "
        f"search grid: crc_ok {int(out['crc_ok'].sum())}/{BATCH}, bits equal; "
        f"receive_pdsch_subframe on the aligned samples exact; launches {counts}")

    t_search, t_all = [], []
    for _ in range(PATH_REPS):
        for fn, acc in ((search, t_search), (search_decode, t_all)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            acc.append(time.perf_counter() - t0)
        check_exact(res["crc_ok"], res["bits"], bits, "DL from samples (timed)")
    log(f"[{card}] DL cell search of {BATCH} captures: best of {PATH_REPS} "
        f"{min(t_search) * 1e3:.2f} ms ({', '.join(f'{x * 1e3:.2f}' for x in t_search)})")
    log(f"[{card}] DL search + decode of {BATCH} captures: best of {PATH_REPS} "
        f"{min(t_all) * 1e3:.2f} ms ({', '.join(f'{x * 1e3:.2f}' for x in t_all)}) = "
        f"{BATCH / min(t_all):.1f} subframes/s")
    profile_search(search, card)
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
        + f"; map_fused16 kernel {paths['v9']['map_fused16']} x "
        f"{kern['map_fused16']['ms']:.4f} ms")
    profile_decode(cfg, rx, best, card)
    sweeps(cfg, tx, rx, bits, gen, card)

    # ---- the other TURBO_KERNEL paths, then the 2x2 lane -------------------
    for kernel in PATH_KERNELS:
        if kernel != "v9":
            paths[kernel] = drive_path(cfg, rx, bits, kernel)
    time_paths(cfg, rx, bits, card)
    mimo_lane(dev, gen, card)
    dl_path(dev, gen, card)

    b, k, l, t = BATCH * grp.count, grp.K, 208, 32
    kernels = []
    for route, (wrapper, _, source, line, path) in ROUTES.items():
        nbytes, ops = work(wrapper, b, k, l, t)
        kind = "bf16" if wrapper in BF16_WRAPPERS else "f32"
        bound_ms, bound_by = bound(nbytes, ops, kind)
        log(f"{route} bound at B={b} K={k} L={l} T={t}: {nbytes} bytes, {ops} {kind} ops "
            f"-> {bound_ms:.4f} ms ({bound_by}); kernel {kern[route]['ms']:.4f} ms")
        kernels.append(dict(
            name=route, route="cuda", source=f"srsran_4g_tpu_torch/csrc/{source}",
            replaces=f"srsran_4g_tpu/ops/pallas/turbo_map.py:{line}",
            path=f"TURBO_KERNEL={path}",
            shapes=dict(blocks=b, K=k, L=l, T=t, lanes=b * (k // l)),
            launches=paths[path][wrapper], max_abs_err=kern[route]["max_abs_err"],
            ms=kern[route]["ms"], plain_ms=kern[route]["plain_ms"], bound_ms=bound_ms,
            bound_by=bound_by, bytes=nbytes, library_ms=None,
            **({"vs_turbo_map_max_abs_err": kern[route]["vs_turbo_map"]}
               if "vs_turbo_map" in kern[route] else {})))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
