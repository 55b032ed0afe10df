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
- the default route at a block size whose window is L ≡ 2 (mod 4): 100 PRB,
  64QAM, MCS 23 (TBS 51024, 9 code blocks of K=5696, L=178), which the
  default TURBO_KERNEL decodes through ``map_windowed``; exact, only
  ``map_windowed`` launched, its launches, kernel ms and the decode's device
  time logged;
- the TM4 2x2 dual-codeword lane (``models/pdsch_mimo``) at pmi 2, batch 64,
  30 dB through the fixed 2x2 channel of the JAX package's MIMO gate, both
  codewords checked the same way;
- the downlink from time-domain samples: 128 captures of a 100 PRB
  subframe 5 (``models/enb_dl``, ``ops/ofdm``) after a random lead, with a
  random phase, a CFO and AWGN at 30 dB, searched blind
  (``models/ue_dl.cell_search``: PSS, CFO, alignment, OFDM demod, SSS) and
  decoded from the grid the search returns, each capture checked for its
  cell id, frame phase, exact timing offset, CFO, CRCs and bits;
- the probes: every H100 micro-benchmark of ``srsran_4g_tpu_torch/tools``
  (the ports of the TPU probes tools/turbo_probe{2,3,6,7}.py) at the TPU
  probes' shapes, through their ``measure`` entry points, each kernel then
  held against its plain version;
- the downlink control path from samples: 128 captures of a 100 PRB
  subframe 0 (cell 301, CFI 1, Ng 1) carrying a MIB, two PHICH ACKs, a
  format-1A DCI for a C-RNTI granting the whole band at MCS 28 and one for
  SI-RNTI, and the granted PDSCH, after the same impairments; the receiver
  searches the cell, estimates the channel, decodes PCFICH, PBCH, PHICH,
  blind-searches the PDCCH for both RNTIs and one that was not sent,
  unpacks the grant and decodes the PDSCH it names, every field checked
  exactly on every capture;
- the eNB uplink receiver: 128 subframes of a 100 PRB cell (301, subframe
  2) at 30 dB carrying a PUSCH on PRB 2-97 (64QAM, TBS 71112, 12 code
  blocks of K=5952 at L=192, with 2 HARQ-ACK and 20 long-CQI bits) and four
  PUCCH UEs on PRB 0-1 and 98-99 (formats 1a, 2, 2b and 3), every data, ACK,
  CQI and PUCCH bit checked; SRS sounding over the 96 PRB through a two-tap
  channel, its estimate within a stated normalised MSE; PRACH at symbol_sz
  2048, 128 captures with one preamble each (the sent one detected and no
  other, its delay as the detector reads it) and 32 of noise alone (nothing
  detected); the PUSCH decode timed and each stage profiled;
- PMCH: 128 MBSFN subframes of 100 PRB, area 1, 64QAM, TBS 46888 (8 code
  blocks of K=5888 at L=184) at 30 dB, decoded exactly;
- the UE around the downlink: a 40-subframe FDD stream of cell 301 at 100
  PRB with a random lead, a CFO and a neighbour cell 6 dB weaker on its own
  timing; ``UeSync`` FIND then TRACK on every subframe, the MIB, CRS
  measurements (RSRP, SNR against the SINR put in, CFO), the neighbour
  search, FDD/TDD detection, resampling to 23.04 Msps (polyphase and FFT,
  in-band EVM, a search at symbol_sz 1536) and back, AGC from -20 dB and CFR
  (PAPR drop, in-band EVM), with the per-subframe tracking time.

``map_fused16`` (the default route's kernel), ``map_windowed``,
``map_windowed16``, ``map_v3`` and ``map_fused`` (radix 2 and 4) are held
exactly equal to their plain versions (max |diff| 0), also at five tiles, a
ragged last tile, one window, L/4 odd, L = 178, 512 and 6144 (the full
recursion at T = 0 for the single-chain kernels, T = 32 for the fused
ones), and ``map_fused16`` also at the uplink's and the PMCH's shapes
(L = 192 and 184, timed, their launches per decode in its entry of the
kernels line); each kernel's launch geometry is logged beside its build's
registers and spills, and given in the kernels line.  The decodes under ``bf16``,
``v7`` and ``v8`` are profiled for their device time.

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

# The rates the bounds below are computed against.  Bytes: the H100 SXM's
# HBM3 bandwidth (NVIDIA data sheet).  Operations: the CUDA cores, at 132 SMs
# and the 1.98 GHz boost clock.  Per SM and clock, for compute capability
# 9.0 (CUDA C++ Programming Guide, "Arithmetic Instructions", throughput
# table): 128 results of 32-bit float add/multiply (one f32 add or subtract
# an instruction), 256 of 16-bit float add/multiply (128 packed bf16x2
# instructions; a scalar bf16 add takes one instruction too), and 64 of
# compare/minimum/maximum (the guide has no packed 16-bit row: a bf16x2 max
# is taken as one such instruction giving two elements).  Each of the SM's
# four partitions dispatches one warp instruction a clock (NVIDIA H100
# Tensor Core GPU Architecture whitepaper), 128 thread instructions per SM
# and clock of any kind.  So n_add add and n_max max instructions take at
# least max(n_add / 128, n_max / 64, (n_add + n_max) / 128) SM clocks; in
# every kernel here n_add >= n_max, so dispatch binds, whatever pipe the
# maxes use.  The data sheet's 67 TFLOP/s f32 counts an FMA as two
# operations and its 989 TFLOP/s bf16 is the tensor cores', which no
# elementwise max can use.
PEAK_BYTES_PER_S = 3.35e12
SM_COUNT, CLOCK_HZ = 132, 1.98e9
ADD_PER_SM_CLOCK, MAX_PER_SM_CLOCK, DISPATCH_PER_SM_CLOCK = 128, 64, 128
ELEMENTS_PER_INSTR = {"f32": 1, "bf16": 1, "bf16x2": 2}
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
# the probes: probe 7 also at a lane count that fills the card (132 SMs x
# 2,048 resident threads, one lane or lane pair a thread)
P7_FULL_TILE_C = 132 * 2048 // 8
# the control path: 100 PRB subframe 0 of cell 301, CFI 1, Ng 1, one port; a
# format-1A DCI for C-RNTI 0x003d at L=2, CCE 8 (candidate (2, 8) of its
# search space) granting all 100 PRB at MCS 28 (I_TBS 26, TBS 75376), one for
# SI-RNTI at L=4, CCE 0 (common space); one ACK on each of two PHICH groups,
# one of them with nseq >= 4; a third RNTI searched but not sent
CTRL_CELL_ID, CTRL_SUBFRAME = 301, 0
C_RNTI, SI_RNTI, UNSENT_RNTI = 0x003D, 0xFFFF, 0x1234
C_DCI_AT, SI_DCI_AT = (2, 8), (4, 0)
GRANT_MCS, GRANT_TBS = 28, 75376
PHICH_AT = ((3, 1), (7, 5))  # (group, nseq)
# kernel route -> (its wrapper and radix, its source under csrc/, the line of
# the TPU kernel it replaces in srsran_4g_tpu/ops/pallas/turbo_map.py, and the
# TURBO_KERNEL path whose decode gives its launches)
ROUTES = {
    "turbo_map": ("map_windowed", None, "turbo_windowed.cu", 272, "v4"),
    "map_windowed16": ("map_windowed16", None, "turbo_windowed.cu", 1323, "bf16"),
    "map_v3": ("map_v3", None, "turbo_windowed.cu", 1189, "v3"),
    "map_fused16": ("map_fused16", None, "turbo_fused16.cu", 942, "v9"),
    "map_fused_r2": ("map_fused", 2, "turbo_fused.cu", 872, "v7"),
    "map_fused_r4": ("map_fused", 4, "turbo_fused.cu", 872, "v8"),
    "sweep_r2": ("sweep", 2, "turbo_sweep.cu", 1022, "v6"),
    "sweep_r4": ("sweep", 4, "turbo_sweep.cu", 426, "v5"),
    "emit": ("emit", None, "turbo_emit.cu", 1150, "v5"),
}
# routes held to max |diff| 0: every route but sweep and emit
EXACT = ("turbo_map", "map_windowed16", "map_v3", "map_fused16", "map_fused_r2",
         "map_fused_r4")
# the default route at L ≡ 2 (mod 4): 100 PRB, MCS 23 (I_TBS 21, 64QAM), TBS
# 51024, 9 code blocks of K = 5696, window L = 178
MCS23_TBS, MCS23_K, MCS23_L = 51024, 5696, 178
# the eNB uplink receiver: 100 PRB, cell 301, subframe 2; the PUSCH on PRB
# 2-97 (96 PRB), 64QAM, I_TBS 26 (TBS 71112: 12 code blocks of K = 5952,
# window L = 192, map_fused16), UCI with 2 ACK bits and 20 CQI bits (long
# CQI: CRC8 + tail-biting Viterbi); four PUCCH UEs on PRB 0-1 and 98-99, each
# (PRB, slot) used once: format 1a (m = 2), 2 with 11 CQI bits (m = 0), 2b
# with 11 CQI and 2 ACK bits (m = 1), 3 with 11 ACK bits (n_pucch 15, m = 3)
UL_CELL_ID, UL_SUBFRAME = 301, 2
UL_PRB_START, UL_NOF_PRB = 2, 96
UL_TBS, UL_CBS, UL_K, UL_L = 71112, 12, 5952, 192
UL_UCI = dict(o_ack=2, o_cqi=20)
UL_PUCCH = {"1a": dict(n_pucch=0, n_rb_2=2), "2": dict(n_pucch=0, rnti=0x0047),
            "2b": dict(n_pucch=0, n_rb_2=1, rnti=0x0048), "3": dict(n_pucch=15, rnti=0x0049)}
# SRS over the 96 PRB through two taps (the second SRS_TAP_DELAY samples of
# 2048 later, -10 dB): the estimate's normalised MSE against the channel
# applied; at 30 dB the 3-tap smoother leaves 0.375 of the 1e-3 noise
# variance, ~4e-4
SRS_TAP_DELAY, SRS_NMSE_MAX = 5, 1e-3
# PRACH at symbol_sz 2048, root 128 and zero-correlation zone 5 (N_cs = 26,
# 32 shifts a root: two roots for the 64 preambles), delays of 0..12·60
# samples (the zone is 63 detector bins of 12 samples), PRACH_NOISE captures
# of noise alone
PRACH_ROOT, PRACH_ZCZ, PRACH_NOISE, PRACH_MAX_BIN = 128, 5, 32, 60
# PMCH: 100 PRB, area 1, subframe 1, 64QAM, I_TBS 20 (TBS 46888, code rate
# 0.77: 8 code blocks of K = 5888, window L = 184, map_fused16)
PMCH_TBS, PMCH_CBS, PMCH_K, PMCH_L = 46888, 8, 5888, 184
# the UE around the downlink: a 40-subframe FDD stream of cell 301 at 100
# PRB after a random lead, a neighbour (cell 152, another N_ID_2) 6 dB weaker
# with its own timing, a CFO inside +-DL_CFO; the bounds of its checks
SYNC_CELL_ID, SYNC_NBR_ID, SYNC_NBR_DB = 301, 152, 6.0
SYNC_SF, SYNC_LEAD_MAX = 40, 2000
SYNC_CFO_TOL = 0.005       # subcarriers, the tracked CFO against the one put in
SYNC_CFO_HZ_TOL = 50.0     # tracked CFO + measure_cell's residual, against the one put in
SYNC_RSRP_TOL_DB = 0.5     # the serving CRS is sent at 0 dB
SYNC_SNR_TOL_DB = 1.0    # measure_cell's SNR, against the SINR put in on the CRS REs
SYNC_EVM_POLY_DB, SYNC_EVM_FFT_DB = -20.0, -40.0
AGC_FRAMES, AGC_TOL_DB = 20, 1.5
CFR_DROP_DB, CFR_EVM_DB = 2.0, -15.0


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


def op_ms(adds: int, maxes: int, kind: str) -> float:
    """Least time (ms) the CUDA cores take for ``adds`` adds and subtracts
    and ``maxes`` maxes of type ``kind`` ("f32", "bf16" or "bf16x2",
    counted in elements): the rates above."""
    per = ELEMENTS_PER_INSTR[kind]
    i_add, i_max = adds / per, maxes / per
    clocks = max(i_add / ADD_PER_SM_CLOCK, i_max / MAX_PER_SM_CLOCK,
                 (i_add + i_max) / DISPATCH_PER_SM_CLOCK) / SM_COUNT
    return clocks / CLOCK_HZ * 1e3


def bound(nbytes: int, adds: int, maxes: int, kind: str) -> tuple[float, str]:
    """Least time (ms) for work that moves ``nbytes`` and does ``adds`` adds
    and ``maxes`` maxes of type ``kind``, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, op_ms(adds, maxes, kind)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def work(wrapper: str, b: int, k: int, l: int, t: int) -> tuple[int, int, int]:
    """Bytes (each input read once, each output written once), adds
    (subtracts included) and maxes of one call of ``wrapper`` at these
    shapes.  The half-iteration (map_windowed, map_windowed16, map_v3,
    map_fused, map_fused16) reads the float32 gammas and initial metrics
    and writes L float32 LLRs per lane; sweep writes the L/2 even-position
    stores of both chains instead, and emit reads those stores and the body
    gammas.  Operations (bf16 for the 16-bit kernels, else f32), counting
    only lanes whose training is not frozen: per trellis step per chain 24
    adds (16 branch adds, 8 normalising subtracts) and 15 maxes (8 + 7);
    per LLR 26 adds (16 alpha + beta, 8 parity terms, the input term and
    the difference) and 14 maxes; for emit's two odd-position steps per
    pair 32 adds and 16 maxes."""
    w = k // l
    n = w * b
    gammas, inits, llrs = 2 * (l + 2 * t) * n, 2 * 8 * n, l * n
    stores = 2 * (l // 2) * 8 * n
    steps = (n - b) * t + (w - 1) * b * t + 2 * n * (l - 1)
    if wrapper == "sweep":
        return 4 * (gammas + inits + stores), 24 * steps, 15 * steps
    if wrapper == "emit":
        pairs = (l // 2) * n
        return (4 * (2 * l * n + stores + llrs), (26 * 2 + 32) * pairs,
                (14 * 2 + 16) * pairs)
    return 4 * (gammas + inits + llrs), 24 * steps + 26 * llrs, 15 * steps + 14 * llrs


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
    kernels to atol 1e-3, bf16 kernels to the 16-bit bars, and the routes of
    EXACT to max |diff| 0; map_v3 also equal to turbo_map's LLRs."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm
    from srsran_4g_tpu_torch.tools import event_ms, host_ms

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
    if route in EXACT and err != 0:
        raise AssertionError(f"{route} kernel vs plain at {desc}: max |diff| {err}, not 0")
    res = dict(max_abs_err=err)
    if route == "map_v3":
        res["vs_turbo_map"] = float((got - tm.map_windowed(*args)).abs().max())
        torch.cuda.synchronize()
        if res["vs_turbo_map"] != 0:
            raise AssertionError(f"map_v3 vs turbo_map at {desc}: max |diff| "
                                 f"{res['vs_turbo_map']}, not 0")
    if time_it:
        res["ms"] = event_ms(kernel, iters=20, warmup=2)
        res["plain_ms"] = host_ms(plain, iters=2)
    log(f"check {route} {desc}: max|diff| {err:.3g}"
        + (f" (vs turbo_map {res['vs_turbo_map']:.3g})" if "vs_turbo_map" in res else "")
        + (f", kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.2f} ms" if time_it else ""))
    return res


def check_kernels(dev, gen, b, k) -> dict:
    """Every route at the bench shape (timed), the single-chain routes also
    at the MCS 23 path's shape (timed, under ``out["mcs23"]``), and every
    route at small shapes; the largest |diff| of each route over its
    checks."""
    bench = gamma_inputs(dev, gen, b, k, 208, 32)
    out = {r: check_kernel(r, bench, time_it=True) for r in ROUTES}
    any_shape = ("turbo_map", "map_windowed16", "map_v3")  # the v1 bodies
    mcs23 = gamma_inputs(dev, gen, BATCH * 9, MCS23_K, MCS23_L, 32)
    out["mcs23"] = {r: check_kernel(r, mcs23, time_it=True) for r in any_shape}
    del mcs23
    fused = ("map_fused16", "map_fused_r2", "map_fused_r4")
    small = [((64, 424, 106, 32), any_shape + ("sweep_r2", "sweep_r4", "emit")),  # L ≡ 2 (mod 4)
             ((32, 512, 64, 31), any_shape),                                      # odd T
             ((32, 504, 63, 16), any_shape),                                      # odd L
             ((33, 40, 40, 0), any_shape),                                        # L = K, T = 0, N odd
             ((64, 512, 64, 16), tuple(r for r in ROUTES if r not in any_shape)),  # L % 4 == 0
             ((5, 6144, 192, 32), ("map_fused16",)),  # N = 160, W = 32
             ((3, 5824, 208, 32), fused),             # N = 84: a ragged last tile
             ((3, 40, 40, 32), fused),                # W = 1
             ((2, 6016, 188, 32), fused),             # L/4 odd
             ((32, 1024, 512, 32), any_shape + fused),  # L = 512
             ((3, 6144, 6144, 0), any_shape),  # the full recursion at K = 6144
             ((3, 6144, 6144, 32), fused)]  # L = K = 6144, W = 1
    for shape, names in small:
        args = gamma_inputs(dev, gen, *shape)
        for r in names:
            res = check_kernel(r, args)
            for key in ("max_abs_err", "vs_turbo_map"):
                if key in res:
                    out[r][key] = max(out[r][key], res[key])
    for r, res in out["mcs23"].items():
        out[r]["max_abs_err"] = max(out[r]["max_abs_err"], res["max_abs_err"])
    # the default kernel at the uplink's and the PMCH's shapes (timed)
    for key, (cbs, k_cb, l_win) in (("ul_path", (UL_CBS, UL_K, UL_L)),
                                    ("mbsfn_path", (PMCH_CBS, PMCH_K, PMCH_L))):
        out[key] = check_kernel("map_fused16", gamma_inputs(dev, gen, BATCH * cbs, k_cb, l_win,
                                                            32), time_it=True)
        out["map_fused16"]["max_abs_err"] = max(out["map_fused16"]["max_abs_err"],
                                                out[key]["max_abs_err"])
    return out


def kernel_symbol(route: str, radix, geo) -> tuple[str, ...]:
    """Pieces of the mangled name of the kernel that ``route`` launches at
    the bench shape (``geo``: its geometry), to find it in the build log."""
    if route in ("turbo_map", "map_windowed16"):
        return f"windowed_kernelILi{geo.every}E", "F32" if route == "turbo_map" else "B16"
    if route == "map_v3":
        return (f"v3_kernelILi{geo.every}E",)
    if route == "map_fused16":
        return (f"fused16_kernelILi{geo.lanes}E",)
    if route in ("map_fused_r2", "map_fused_r4"):
        return (f"fused_kernelILi{geo.every}ELi{radix}E",)
    if route == "emit":
        return ("emit_kernel",)
    return (f"sweep_kernelILi{radix}E",)


def launch_counts(names=WRAPPERS) -> dict[str, int]:
    """The port's launch counts (``turbo_map.launches``) of these kernels."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    return {name: tm.launches[name] for name in names}


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    tm.launches.clear()


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
                   decode=None, turbo: str = "fused") -> tuple[float, float] | None:
    """Device busy/idle share of the decode and its costliest kernels, from
    torch.profiler over `reps` decodes against the unprofiled best time, and
    the share of the turbo kernels (named *fused*, as the v9 route's is, or
    *<turbo>*).  Returns (device ms, turbo kernels' ms) per decode, None if
    the profiler saw no device time."""
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
        return None
    n_kernels = sum(e.count for e in kernels) / reps
    turbo_ms = sum(e.self_device_time_total for e in kernels if turbo in e.key) / 1e3 / reps
    log(f"[{card}] decode device time {busy_ms:.3f} ms in {n_kernels:.0f} kernels "
        f"per decode; idle share {1 - busy_ms / (decode_s * 1e3):.3f} of the "
        f"unprofiled {decode_s * 1e3:.2f} ms; kernels named *{turbo}* {turbo_ms:.4f} ms "
        f"({turbo_ms / busy_ms:.3f} of the device time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3 / reps:8.3f} ms  x{e.count // reps:<4d} "
            f"{e.key[:90]}")
    return busy_ms, turbo_ms


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


def time_paths(cfg, rx, bits, card: str) -> dict[str, float]:
    """Best of PATH_REPS decodes under each TURBO_KERNEL, the paths taken in
    turn in every round so that host noise falls on all of them alike.
    Returns each path's best time in seconds."""
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
    return {kernel: min(t) for kernel, t in times.items()}


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


def mcs23_path(dev, gen, card: str, kern: dict) -> dict:
    """The default route at L ≡ 2 (mod 4): 100 PRB, 64QAM, MCS 23 (TBS 51024:
    9 code blocks of K = 5696, window L = 178), BATCH subframes at SNR_DB,
    decoded under the default TURBO_KERNEL, which turns v9 into v4 at this L
    and runs ``map_windowed``.  With the counts at 0: exact, and only
    ``map_windowed`` launched.  Logs its launches, kernel ms (``kern``, the
    MCS 23 shape timed in check_kernels) and the decode's host and device
    time.  Returns the default_route entry of turbo_map's kernels line."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import grid, pdsch
    from srsran_4g_tpu_torch.ops import turbo

    os.environ.pop("TURBO_KERNEL", None)
    cfg = pdsch.PdschConfig(cell=grid.CellConfig(nof_prb=100, cell_id=123, cfi=1),
                            rnti=0x1234, subframe=4, mod="64qam", tbs=MCS23_TBS)
    grp = cfg.plan.groups[0]
    l_win = turbo.window_length(grp.K, 208, 32)
    if ((len(cfg.plan.groups), grp.count, grp.K, l_win) != (1, 9, MCS23_K, MCS23_L)
            or turbo.kernel_route("v9", l_win, 32) != "v4"):
        raise AssertionError(f"MCS 23: segmentation {cfg.plan}, window {l_win}: not 9 CBs "
                             f"of K={MCS23_K} at L={MCS23_L} on the v4 route")
    bits = torch.randint(0, 2, (BATCH, cfg.tbs), generator=gen, device=dev,
                         dtype=torch.int8)
    rx = awgn.awgn(pdsch.add_crs(cfg, pdsch.encode(cfg, bits)),
                   awgn.snr_to_noise_var(SNR_DB), generator=gen)
    torch.cuda.synchronize()
    reset_counts()
    out = pdsch.decode(cfg, rx, n_iter=N_ITER)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_exact(out["crc_ok"], out["bits"], bits, "MCS 23 default route")
    moved = {name for name, n in counts.items() if n}
    if moved != {"map_windowed"}:
        raise AssertionError(f"the MCS 23 default route launched {counts}, expected only "
                             f"map_windowed")
    times, _, out = timed_decodes(cfg, rx, PATH_REPS)
    check_exact(out["crc_ok"], out["bits"], bits, "MCS 23 default route (timed)")
    b = BATCH * grp.count
    nbytes, adds, maxes = work("map_windowed", b, MCS23_K, MCS23_L, 32)
    bound_ms, bound_by = bound(nbytes, adds, maxes, "f32")
    ms = kern["mcs23"]["turbo_map"]["ms"]
    log(f"MCS 23 default route: 100 PRB 64QAM TBS {cfg.tbs}, {grp.count} CBs of K={grp.K}, "
        f"L={l_win} (N={b * (grp.K // l_win)}), batch {BATCH}, {SNR_DB} dB: crc_ok "
        f"{int(out['crc_ok'].sum())}/{BATCH}, bits equal, launches {counts}")
    log(f"[{card}] MCS 23 default route: decode best of {PATH_REPS} "
        f"{min(times) * 1e3:.2f} ms ({', '.join(f'{t * 1e3:.2f}' for t in times)}) = "
        f"{BATCH / min(times):.1f} subframes/s; map_windowed {counts['map_windowed']} x "
        f"{ms:.4f} ms (map_v3 at this shape {kern['mcs23']['map_v3']['ms']:.4f} ms), bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    prof = profile_decode(cfg, rx, min(times), card, turbo="windowed_kernel")
    return dict(path="pdsch.decode, 100 PRB 64QAM MCS 23 (TBS 51024), default TURBO_KERNEL",
                shapes=dict(blocks=b, K=MCS23_K, L=MCS23_L, T=32,
                            lanes=b * (MCS23_K // MCS23_L)),
                launches=counts["map_windowed"], ms=ms,
                plain_ms=kern["mcs23"]["turbo_map"]["plain_ms"], bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, decode_ms=min(times) * 1e3,
                decode_device_ms=prof[0] if prof else None,
                map_windowed_device_ms=prof[1] if prof else None)


def impair(dev, gen, sf: torch.Tensor, cfo_max: float, symbol_sz: int):
    """Captures of the subframes ``sf`` (B, sf_len), each after a random lead
    of 0..DL_LEAD_MAX samples and before a tail of at least DL_TAIL, with a
    random phase, a CFO uniform in +-cfo_max subcarriers and AWGN at SNR_DB.
    Returns (captures (B, n) complex64, lead (B,), cfo (B,))."""
    from srsran_4g_tpu_torch.channel import awgn

    b, sf_len = sf.shape
    n = DL_LEAD_MAX + sf_len + DL_TAIL
    lead = torch.randint(0, DL_LEAD_MAX + 1, (b,), generator=gen, device=dev)
    gain = torch.polar(torch.ones(b, device=dev),
                       2 * np.pi * torch.rand(b, generator=gen, device=dev))
    cap = torch.zeros((b, n), dtype=torch.complex64, device=dev)
    cap.scatter_(1, lead[:, None] + torch.arange(sf_len, device=dev), sf * gain[:, None])
    cfo = (2 * torch.rand(b, generator=gen, device=dev) - 1) * cfo_max
    phase = 2 * np.pi * cfo.double()[:, None] * torch.arange(n, device=dev) / symbol_sz
    cap = cap * torch.polar(torch.ones_like(phase), phase).to(torch.complex64)
    return (awgn.awgn(cap, awgn.snr_to_noise_var(SNR_DB, device=dev), generator=gen),
            lead, cfo)


def dl_captures(dev, gen, cfg, cfo_max: float):
    """DL-from-samples traffic: BATCH captures of one subframe of ``cfg``
    (``impair``).  Returns (captures (B, n) complex64, sent bits, lead (B,),
    cfo (B,))."""
    from srsran_4g_tpu_torch.models import enb_dl
    from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig

    bits = torch.randint(0, 2, (BATCH, cfg.tbs), generator=gen, device=dev,
                         dtype=torch.int8)
    sf = enb_dl.subframe_to_samples(cfg.cell, enb_dl.assemble_subframe(cfg, bits))
    cap, lead, cfo = impair(dev, gen, sf, cfo_max, OfdmConfig(nof_prb=cfg.cell.nof_prb).symbol_sz)
    return cap, bits, lead, cfo


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


def probes_phase(card: str) -> list[dict]:
    """The probes' path: every H100 micro-benchmark at its TPU probe's
    shapes through the tools' ``measure`` entry points (each kernel's ms from
    CUDA events), the launch counts of that run, then each kernel against
    its plain version on the same inputs (f32 atol 1e-3, bf16 the 16-bit
    bars).  Returns the probes' entries of the kernels line."""
    from srsran_4g_tpu_torch.ops.cuda import probes
    from srsran_4g_tpu_torch.tools import host_ms
    from srsran_4g_tpu_torch.tools import turbo_probe2 as p2
    from srsran_4g_tpu_torch.tools import turbo_probe3 as p3
    from srsran_4g_tpu_torch.tools import turbo_probe6 as p6
    from srsran_4g_tpu_torch.tools import turbo_probe7 as p7

    reset_counts()
    log(f"[{card}] probe 2 (N={p2.N} lanes, {p2.N_STEPS} radix-4 steps):")
    r2 = p2.measure(probes.PROBE2_VARIANTS)
    log(f"[{card}] probe 3 (N={p3.N} lanes):")
    r3 = p3.measure()
    log(f"[{card}] probe 6 (N={p6.N} lanes, {p6.STEPS} radix-4 steps):")
    r6 = p6.measure()
    log(f"[{card}] probe 7 at the TPU probe's default, then filling the card:")
    r7 = p7.measure()
    r7_full = p7.measure(tile_c=P7_FULL_TILE_C)
    torch.cuda.synchronize()
    counts = launch_counts(probes.KERNELS)
    if not all(counts.values()):
        raise AssertionError(f"the probes' run launched no kernel for "
                             f"{[k for k, n in counts.items() if not n]}")
    log(f"probe launches: {counts}")

    # ---- each kernel against its plain version (launches not counted) ----
    def check(name, kernel, plain, bf16=False):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        if name.startswith("probe2_") or name == "probe3_empty":
            pairs = [(g[0], w[0]) for g, w in pairs]  # row 0 is the output
        err = max(float((g.float() - w.float()).abs().max()) for g, w in pairs)
        if not np.isfinite(err):
            raise AssertionError(f"{name} kernel vs plain: not finite")
        # the outputs must be far from 0 for the tolerance to mean anything
        size = min(float(w.float().abs().mean()) for _, w in pairs)
        if size < 100 * ATOL:
            raise AssertionError(f"{name}: plain output's mean |value| {size} is within "
                                 f"100x of the tolerance {ATOL}")
        if bf16:
            # the 16-bit bars, and, since kernel and plain version round the
            # same bf16 ops in the same order, equality
            mean = max(float((g.float() - w.float()).abs().mean()) for g, w in pairs)
            if err > ATOL16 or mean >= MEAN16 or not all(
                    torch.equal(g > 0, w > 0) for g, w in pairs):
                raise AssertionError(f"{name} kernel vs plain: max |diff| {err}, "
                                     f"mean {mean}, or a sign differs")
            if err:
                raise AssertionError(f"{name} kernel vs plain: max |diff| {err}, not equal")
        elif err > ATOL:
            raise AssertionError(f"{name} kernel vs plain: max |diff| {err} > {ATOL}")
        log(f"check {name}: max |diff| {err:.3g}, plain mean |value| {size:.4g}")
        plain_ms = host_ms(plain)
        return err, plain_ms

    res = {}
    g, a0 = p2.inputs()
    for v in probes.PROBE2_VARIANTS:
        res[f"probe2_{v}"] = dict(ms=r2[v], n=p2.N, n_steps=p2.N_STEPS, checks=check(
            f"probe2_{v}", lambda: getattr(p2, v)(g, a0),
            lambda: probes.probe2_ref(v, g, g, a0, p2.N_STEPS, p2.WIN, p2.WIN // 2)))
    ins = p3.inputs()
    err3 = max(check("probe3_empty", lambda: p3.empty(ins, threads=t, scratch=sc),
                     lambda: probes.probe_empty_ref(ins, 112))[0]
               for t in p3.THREADS for sc in (False, True))
    res["probe3_empty"] = dict(ms=r3["empty threads=1024"], n=p3.N,
                               checks=(err3, host_ms(lambda: probes.probe_empty_ref(ins, 112))))
    x = p6.inputs()
    # random start metrics: from p6.inputs' zeros the skeleton's output is 0
    rng = np.random.default_rng(SEED)

    def metrics(rows, n, dtype):
        x = rng.normal(0, 1, (rows, n)).astype(np.float32)
        return torch.as_tensor(x, device="cuda").to(dtype)

    a6, b6 = metrics(8, p6.N, torch.float32), metrics(8, p6.N, torch.float32)
    a16, b16 = (metrics(16, p6.N // 2, torch.bfloat16), metrics(16, p6.N // 2, torch.bfloat16))
    res["probe6_full"] = dict(ms=r6["full"], n=p6.N, n_steps=p6.STEPS, checks=check(
        "probe6_full", lambda: p6.full(x["g2s"], x["g2p"], a6, b6),
        lambda: probes.probe6_full_ref(x["g2s"], x["g2p"], a6, b6)))
    res["probe6_skel"] = dict(ms=r6["skel"], n=p6.N, n_steps=p6.STEPS, checks=check(
        "probe6_skel", lambda: p6.skel(a6, b6),
        lambda: probes.probe6_skel_ref(a6, b6, p6.STEPS)))
    res["probe6_bf16"] = dict(ms=r6["bf16"], n=p6.N, n_steps=p6.STEPS, checks=check(
        "probe6_bf16", lambda: p6.bf16(x["g2s16"], x["g2p16"], a16, b16),
        lambda: probes.probe6_bf16_ref(x["g2s16"], x["g2p16"], a16, b16), bf16=True))
    for dt, rows, key in ((torch.float32, 8, "f32"), (torch.bfloat16, 16, "bf16")):
        errs = []
        for tc in (p7.TC, P7_FULL_TILE_C):
            g7, a7 = p7.check_inputs(dt, rows, tc)  # lanes differ, unlike p7.inputs
            errs.append(check(f"probe7_{key}", lambda: probes.probe7(g7, a7, p7.ITERS),
                              lambda: probes.probe7_ref(g7, a7, p7.ITERS), bf16=key == "bf16"))
        res[f"probe7_{key}"] = dict(
            ms=r7_full[f"{key}_ms"], n=rows * P7_FULL_TILE_C, iters=p7.ITERS,
            checks=(max(e for e, _ in errs), errs[-1][1]),
            gelem_s=r7_full[f"{key}_gelem_s"], ms_tpu_default=r7[f"{key}_ms"],
            gelem_s_tpu_default=r7[f"{key}_gelem_s"])
    log(f"[{card}] probe 7 bf16/f32 element-rate ratio: {r7['ratio']:.3f} at "
        f"{8 * p7.TC} f32 lanes, {r7_full['ratio']:.3f} at {8 * P7_FULL_TILE_C}")
    log(f"[{card}] probe 3: host {r3['host_ms_per_launch'] * 1e3:.2f} us per ctypes "
        f"launch against {r3['device_ms_per_launch'] * 1e3:.2f} us of device time")

    kernels = []
    for name in probes.KERNELS:
        r = res[name]
        nbytes, adds, maxes, kind = probes.work(name, r["n"], n_steps=r.get("n_steps", 0),
                                                iters=r.get("iters", 0))
        bound_ms, bound_by = bound(nbytes, adds, maxes, kind)
        err, plain_ms = r["checks"]
        log(f"[{card}] {name}: {r['ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{nbytes} B; {adds} adds + {maxes} maxes {kind}, {op_ms(adds, maxes, kind):.4f} "
            f"ms), {bound_ms / r['ms']:.3f} of the bound; plain "
            f"{plain_ms:.2f} ms, max |diff| {err:.3g}")
        source = "probe_launch.cu" if name == "probe3_empty" else "probe_acs.cu"
        extra = {k: r[k] for k in ("gelem_s", "ms_tpu_default", "gelem_s_tpu_default")
                 if k in r}
        if name == "probe3_empty":
            extra = dict(host_ms_per_launch=r3["host_ms_per_launch"],
                         configs={k: v for k, v in r3.items() if k.startswith("empty")})
        kernels.append(dict(
            name=name, route="cuda", source=f"srsran_4g_tpu_torch/csrc/{source}",
            replaces=probes.REPLACES[name], path="probes", shapes=dict(
                lanes=r["n"], **{k: r[k] for k in ("n_steps", "iters") if k in r}),
            launches=counts[name], max_abs_err=err, ms=r["ms"], plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, library_ms=None, **extra))
    return kernels


def ctrl_traffic(dev, gen):
    """The control path's transmitter: BATCH subframe-0 grids of 100 PRB with
    a MIB, the two DCIs, the granted PDSCH and the two PHICH ACKs, made into
    samples.  Returns (samples (B, sf_len), the PDSCH config, what was sent)."""
    from srsran_4g_tpu_torch.models import dci, enb_dl, grid, pdsch, phich

    cell = grid.CellConfig(nof_prb=100, cell_id=CTRL_CELL_ID, cfi=1)
    cfg = pdsch.PdschConfig(cell=cell, rnti=C_RNTI, subframe=CTRL_SUBFRAME, mod="64qam",
                            tbs=GRANT_TBS)
    rng = np.random.default_rng(SEED)
    sent = dict(mib=rng.integers(0, 2, (BATCH, 24)).astype(np.int8),
                si=rng.integers(0, 2, (BATCH, dci.format1a_len(100))).astype(np.int8),
                acks=[rng.integers(0, 2, BATCH).astype(np.int8) for _ in PHICH_AT])
    sent["c"] = np.stack([dci.pack_1a(dci.Dci1A(
        rb_start=0, l_crbs=100, mcs=GRANT_MCS, harq_pid=int(rng.integers(8)),
        ndi=int(rng.integers(2)), rv=0, tpc=int(rng.integers(4))), 100) for _ in range(BATCH)])
    sent["tb"] = torch.randint(0, 2, (BATCH, GRANT_TBS), generator=gen, device=dev,
                               dtype=torch.int8)
    g = enb_dl.assemble_subframe(cfg, sent["tb"], mib_bits=sent["mib"], frame_idx=0,
                                 dcis=[(sent["c"], C_RNTI, *C_DCI_AT),
                                       (sent["si"], SI_RNTI, *SI_DCI_AT)])
    for (group, nseq), ack in zip(PHICH_AT, sent["acks"]):
        g = phich.put_into_grid(cell, g, phich.encode(
            cell, torch.as_tensor(ack, device=dev), group, nseq, CTRL_SUBFRAME), group)
    return enb_dl.subframe_to_samples(cell, g), cfg, sent


def profile_window(fn, card: str, what: str, host_s: float, reps: int = 3) -> None:
    """Device time, kernel count and idle share of fn() from torch.profiler
    over ``reps`` calls, against the unprofiled host time ``host_s``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if busy_ms <= 0:
        log(f"[{card}] profiler saw no device time: {what} idle share not measured")
        return
    n_kernels = sum(e.count for e in kernels) / reps
    log(f"[{card}] {what}: device time {busy_ms:.3f} ms in {n_kernels:.0f} kernels; idle "
        f"share {1 - busy_ms / (host_s * 1e3):.3f} of the unprofiled {host_s * 1e3:.2f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3 / reps:8.3f} ms  x{e.count // reps:<5d} "
            f"{e.key[:90]}")


def control_path(dev, gen, card: str) -> dict[str, int]:
    """The DL control path from samples at 100 PRB under the default
    TURBO_KERNEL, every field checked on every capture: cell search, channel
    estimate, PCFICH, PBCH, PHICH, PDCCH blind search for both RNTIs and an
    unsent one, the 1A grant through ``ra``, then the PDSCH it grants.
    Returns the launch counts of the checked run."""
    from srsran_4g_tpu_torch.models import (chest, dci, pbch, pcfich, pdcch, pdsch, phich, ra,
                                            ue_dl)
    from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig, _symbol_offsets

    os.environ.pop("TURBO_KERNEL", None)
    t0 = time.perf_counter()
    sf, cfg, sent = ctrl_traffic(dev, gen)
    cap, lead, cfo = impair(dev, gen, sf, DL_CFO, OfdmConfig(nof_prb=100).symbol_sz)
    torch.cuda.synchronize()
    cell, n_bits = cfg.cell, dci.format1a_len(100)
    cands = {r: pdcch.search_space_candidates(cell, 1, r, CTRL_SUBFRAME)
             for r in (C_RNTI, SI_RNTI)}
    log(f"control path: {BATCH} captures of 100 PRB subframe {CTRL_SUBFRAME}, cell "
        f"{CTRL_CELL_ID}, CFI 1, {pdcch.cce_re_indices(cell, 1).shape[0]} CCEs, "
        f"format 1A {n_bits} bits; C-RNTI {C_RNTI:#06x} at {C_DCI_AT} (candidate "
        f"{cands[C_RNTI].index(C_DCI_AT)} of {len(cands[C_RNTI])}), SI-RNTI at {SI_DCI_AT} "
        f"(candidate {cands[SI_RNTI].index(SI_DCI_AT)} of {len(cands[SI_RNTI])}); PHICH "
        f"{PHICH_AT}; made in {time.perf_counter() - t0:.2f} s (first call)")

    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages.setdefault(name, []).append(time.perf_counter() - t)
        return out

    def receive():
        found = stage("cell_search", lambda: ue_dl.cell_search(cap, 100))
        grid_rx = found["grid"]
        est = stage("chest", lambda: chest.estimate(chest.ChestConfig(cell=cell), grid_rx,
                                                    CTRL_SUBFRAME))
        h, nv = est["h"], est["noise_var"]
        out = dict(found=found)
        out["cfi"] = stage("pcfich", lambda: pcfich.decode(cell, grid_rx, h, nv,
                                                           CTRL_SUBFRAME)["cfi"])
        out["mib"] = stage("pbch", lambda: pbch.decode(cell, grid_rx, h, nv, frame_idx=0))
        out["phich"] = stage("phich", lambda: [phich.decode(
            cell, grid_rx, h, nv, group, nseq, CTRL_SUBFRAME) for group, nseq in PHICH_AT])
        out["pdcch"] = stage("pdcch", lambda: {r: pdcch.blind_decode(
            cell, 1, CTRL_SUBFRAME, grid_rx, h, nv, rnti=r, dci_len=n_bits)
            for r in (C_RNTI, SI_RNTI, UNSENT_RNTI)})

        def grant():
            grants = [dci.unpack_1a(p, 100) for p in out["pdcch"][C_RNTI]["dci"].cpu().numpy()]
            g = grants[0]
            return grants, pdsch.PdschConfig(
                cell=cell, rnti=C_RNTI, subframe=CTRL_SUBFRAME, mod=ra.dl_mcs_to_mod(g.mcs),
                tbs=ra.dl_tbs(g.mcs, g.l_crbs), rv=g.rv,
                prb_alloc=tuple(range(g.rb_start, g.rb_start + g.l_crbs)))
        out["grants"], out["cfg"] = stage("dci_ra", grant)
        out["pdsch"] = stage("pdsch", lambda: pdsch.decode(out["cfg"], grid_rx, h=h,
                                                           noise_var=nv, n_iter=N_ITER))
        return out

    reset_counts()
    out = receive()
    counts = launch_counts()
    found = out["found"]
    off_err = found["offset"] - (lead + int(_symbol_offsets(OfdmConfig(nof_prb=100))[6]))
    cfo_err = float((found["cfo"] - cfo).abs().max())
    pd = out["pdcch"]
    c_idx, si_idx = cands[C_RNTI].index(C_DCI_AT), cands[SI_RNTI].index(SI_DCI_AT)
    grant = out["grants"][0]
    checks = {
        "cell_id": bool((found["cell_id"] == CTRL_CELL_ID).all()),
        "phase 0": bool((found["phase"] == 0).all()),
        "offset exact": bool((off_err == 0).all()),
        f"|CFO error| < {DL_CFO_TOL}": cfo_err < DL_CFO_TOL,
        "CFI 1": bool((out["cfi"] == 1).all()),
        "MIB crc_ok": bool(out["mib"]["crc_ok"].all()),
        "MIB n_ports 1": bool((out["mib"]["n_ports"] == 1).all()),
        "MIB bits": np.array_equal(out["mib"]["mib"].cpu().numpy(), sent["mib"]),
        "PHICH ACKs": all(np.array_equal(r["ack"].cpu().numpy(), a)
                          for r, a in zip(out["phich"], sent["acks"])),
        "C-RNTI DCI found": bool(pd[C_RNTI]["found"].all()),
        "C-RNTI DCI at its candidate": bool(pd[C_RNTI]["ok_per_candidate"][:, c_idx].all()),
        "C-RNTI DCI bits": np.array_equal(pd[C_RNTI]["dci"].cpu().numpy(), sent["c"]),
        "SI-RNTI DCI found": bool(pd[SI_RNTI]["found"].all()),
        "SI-RNTI DCI at its candidate": bool(pd[SI_RNTI]["ok_per_candidate"][:, si_idx].all()),
        "SI-RNTI DCI bits": np.array_equal(pd[SI_RNTI]["dci"].cpu().numpy(), sent["si"]),
        "unsent RNTI not found": not bool(pd[UNSENT_RNTI]["found"].any()),
        "grant 100 PRB / 64QAM / TBS 75376": (
            len({(g.rb_start, g.l_crbs, g.mcs, g.rv) for g in out["grants"]}) == 1
            and (grant.rb_start, grant.l_crbs) == (0, 100)
            and out["cfg"].mod == "64qam" and out["cfg"].tbs == GRANT_TBS),
    }
    if not all(checks.values()):
        raise AssertionError(f"control path: {checks}; offset errors "
                             f"{off_err.unique().tolist()}, max |CFO error| {cfo_err}")
    check_exact(out["pdsch"]["crc_ok"], out["pdsch"]["bits"], sent["tb"],
                "control path: the granted PDSCH")
    moved = {name for name, n in counts.items() if n}
    if moved != set(PATH_KERNELS["v9"]):
        raise AssertionError(f"the control path launched {counts}, expected only "
                             f"{PATH_KERNELS['v9']}")
    reported = {r: sorted(set(pd[r]["candidate"].tolist())) for r in (C_RNTI, SI_RNTI)}
    echoes = {r: int(pd[r]["ok_per_candidate"].sum(dim=1).max()) for r in (C_RNTI, SI_RNTI)}
    log(f"control path: every check exact on {BATCH}/{BATCH} ({', '.join(checks)}, PDSCH "
        f"crc_ok and bits); first-match candidates {reported} (sent at {c_idx} and "
        f"{si_idx}), at most {echoes} candidates pass per capture; launches {counts}")

    stages.clear()
    t_all = []
    for _ in range(PATH_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = receive()
        torch.cuda.synchronize()
        t_all.append(time.perf_counter() - t0)
        check_exact(res["pdsch"]["crc_ok"], res["pdsch"]["bits"], sent["tb"],
                    "control path (timed)")
    log(f"[{card}] control path stages, host clock, best of {PATH_REPS} (ms): " + ", ".join(
        f"{k} {min(v) * 1e3:.2f}" for k, v in stages.items()))
    log(f"[{card}] control path, search to PDSCH bits, {BATCH} captures: best of "
        f"{PATH_REPS} {min(t_all) * 1e3:.2f} ms "
        f"({', '.join(f'{x * 1e3:.2f}' for x in t_all)}) = {BATCH / min(t_all):.1f} "
        f"decoded subframes/s")
    grid_rx = res["found"]["grid"]
    est = chest.estimate(chest.ChestConfig(cell=cell), grid_rx, CTRL_SUBFRAME)
    h, nv = est["h"], est["noise_var"]

    def control_stages():
        pcfich.decode(cell, grid_rx, h, nv, CTRL_SUBFRAME)
        pbch.decode(cell, grid_rx, h, nv, frame_idx=0)
        for group, nseq in PHICH_AT:
            phich.decode(cell, grid_rx, h, nv, group, nseq, CTRL_SUBFRAME)
        for r in (C_RNTI, SI_RNTI, UNSENT_RNTI):
            pdcch.blind_decode(cell, 1, CTRL_SUBFRAME, grid_rx, h, nv, rnti=r, dci_len=n_bits)

    ctrl_s = sum(min(stages[k]) for k in ("pcfich", "pbch", "phich", "pdcch"))
    profile_window(control_stages, card, "control stages (PCFICH, PBCH, PHICH, 3 blind "
                   "searches)", ctrl_s)
    return counts


# ---- the eNB uplink receiver, PMCH and the UE around the downlink ---------------


def ul_cfgs():
    """The uplink phase's configs: the 100 PRB cell, the PUSCH of 96 PRB with
    UCI, the four PUCCH UEs at the band edges and the SRS."""
    from srsran_4g_tpu_torch.models import grid, pucch, pusch, srs, uci

    cell = grid.CellConfig(nof_prb=100, cell_id=UL_CELL_ID, cfi=1)
    pcfg = pusch.PuschConfig(cell=cell, rnti=0x0046, subframe=UL_SUBFRAME, mod="64qam",
                             tbs=UL_TBS, prb_start=UL_PRB_START, nof_prb_alloc=UL_NOF_PRB,
                             uci=uci.UciCfg(**UL_UCI))
    pucchs = {name: pucch.PucchConfig(cell=cell, subframe=UL_SUBFRAME, **kw)
              for name, kw in UL_PUCCH.items()}
    scfg = srs.SrsConfig(cell=cell, n_prb_srs=UL_NOF_PRB, prb_offset=UL_PRB_START)
    return pcfg, pucchs, scfg


def pucch_prbs(cfg, name: str) -> tuple[int, int]:
    from srsran_4g_tpu_torch.models import pucch

    prb = pucch.pucch3_prb if name == "3" else pucch.pucch_prb
    return tuple(prb(cfg, 2 * cfg.subframe + s) for s in (0, 1))


def ul_traffic(dev, gen, batch: int):
    """``batch`` UL subframes of the 100 PRB cell: the PUSCH (random TBs,
    ACK and CQI bits) and the four PUCCH UEs (format 1a, 2 with 11 CQI bits,
    2b with 11 CQI and 2 ACK bits, 3 with 11 ACK bits), summed into one grid
    each, then AWGN at SNR_DB.  Returns (rx grid, what was sent)."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import pucch, pusch

    pcfg, pucchs, _ = ul_cfgs()

    def bits(n):
        return torch.randint(0, 2, (batch, n), generator=gen, device=dev, dtype=torch.int8)

    sent = dict(tb=bits(UL_TBS), ack=bits(UL_UCI["o_ack"]), cqi=bits(UL_UCI["o_cqi"]),
                f1a=bits(1), f2_cqi=bits(11), f2b_cqi=bits(11), f2b_ack=bits(2), f3=bits(11))
    g = pusch.encode(pcfg, sent["tb"], cqi_bits=sent["cqi"], ack_bits=sent["ack"])
    g = g + pucch.encode_format1(pucchs["1a"], sent["f1a"])
    g = g + pucch.encode_format2(pucchs["2"], sent["f2_cqi"])
    g = g + pucch.encode_format2(pucchs["2b"], sent["f2b_cqi"], sent["f2b_ack"])
    g = g + pucch.encode_format3(pucchs["3"], sent["f3"])
    return awgn.awgn(g, awgn.snr_to_noise_var(SNR_DB, device=dev), generator=gen), sent


def ul_receive(rx):
    """The eNB's uplink receive of one batch: the PUSCH with its UCI, then
    the four PUCCH UEs."""
    from srsran_4g_tpu_torch.models import pucch, pusch

    pcfg, pucchs, _ = ul_cfgs()
    return dict(pusch=pusch.decode(pcfg, rx, n_iter=N_ITER),
                f1a=pucch.decode_format1(pucchs["1a"], rx, 1),
                f2=pucch.decode_format2(pucchs["2"], rx, 11),
                f2b=pucch.decode_format2(pucchs["2b"], rx, 11, nof_ack=2),
                f3=pucch.decode_format3(pucchs["3"], rx, 11))


def check_ul(out, sent, what: str) -> dict[str, bool]:
    p = out["pusch"]
    checks = {"PUSCH crc_ok": bool(p["crc_ok"].all()),
              "PUSCH bits": torch.equal(p["bits"], sent["tb"]),
              "ACK bits": torch.equal(p["ack_bits"], sent["ack"]),
              "CQI crc_ok": bool(p["cqi_ok"].all()),
              "CQI bits": torch.equal(p["cqi_bits"], sent["cqi"]),
              "PUCCH 1a bits": torch.equal(out["f1a"]["bits"], sent["f1a"]),
              "PUCCH 1a detected": bool(out["f1a"]["detected"].all()),
              "PUCCH 2 CQI bits": torch.equal(out["f2"]["bits"], sent["f2_cqi"]),
              "PUCCH 2b CQI bits": torch.equal(out["f2b"]["bits"], sent["f2b_cqi"]),
              "PUCCH 2b ACK bits": torch.equal(out["f2b"]["ack_bits"], sent["f2b_ack"]),
              "PUCCH 3 bits": torch.equal(out["f3"]["bits"], sent["f3"])}
    if not all(checks.values()):
        raise AssertionError(f"{what}: {checks}")
    return checks


def srs_sounding(dev, gen, batch: int) -> tuple[float, object]:
    """``batch`` SRS grids over UL_NOF_PRB PRB through a two-tap channel of
    random complex gains per capture (a second tap SRS_TAP_DELAY samples of
    2048 later, -10 dB) and AWGN at SNR_DB; the estimate against the channel
    applied on the sounded subcarriers.  Returns (normalised MSE, the
    estimate call)."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import srs

    _, _, scfg = ul_cfgs()
    cell = scfg.cell
    g = srs.put_srs(scfg, torch.zeros((batch, cell.nsymb, cell.nre), dtype=torch.complex64,
                                      device=dev), UL_SUBFRAME)
    taps = torch.randn((batch, 2), generator=gen, device=dev, dtype=torch.complex64)
    taps[:, 1] *= 10 ** (-10 / 20)
    k = torch.arange(cell.nre, device=dev)
    ramp = torch.polar(torch.ones(cell.nre, device=dev), -2 * np.pi * SRS_TAP_DELAY * k / 2048)
    chan = taps[:, :1] + taps[:, 1:] * ramp  # (B, nre)
    rx = awgn.awgn(g * chan[:, None, :], awgn.snr_to_noise_var(SNR_DB, device=dev),
                   generator=gen)

    def estimate():
        return srs.estimate_srs(scfg, rx, UL_SUBFRAME)

    est = estimate()
    ks = torch.as_tensor(srs.srs_subcarriers(scfg), device=dev)
    want = chan[:, ks]
    nmse = float(((est["h"] - want).abs() ** 2).mean() / (want.abs() ** 2).mean())
    if not (est["h"].shape == want.shape and torch.isfinite(est["h"]).all()):
        raise AssertionError("SRS estimate: not finite or of the wrong shape")
    return nmse, estimate


def prach_captures(dev, gen, cfg, n_sent: int, n_noise: int):
    """``n_sent`` PRACH captures of cp+seq samples, each with one preamble at
    a seeded index and a seeded integer delay of 0..12·PRACH_MAX_BIN samples
    (inside its zero-correlation zone), then ``n_noise`` captures of noise
    alone; AWGN at SNR_DB against the preamble's mean sample power.  Returns
    (captures, indices, delays)."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import prach

    n = cfg.cp_len + cfg.seq_len_samples
    pre = torch.stack([prach.generate(cfg, i, device=dev) for i in range(64)])  # (64, n)
    idx = torch.randint(0, 64, (n_sent,), generator=gen, device=dev)
    delay = torch.randint(0, 12 * PRACH_MAX_BIN + 1, (n_sent,), generator=gen, device=dev)
    t = torch.arange(n, device=dev) - delay[:, None]
    cap = torch.where(t >= 0, pre[idx[:, None], t.clamp(min=0)], 0)
    cap = torch.cat([cap, cap.new_zeros((n_noise, n))])
    power = float((pre.abs() ** 2).mean())
    return (awgn.awgn(cap, awgn.snr_to_noise_var(SNR_DB, signal_power=power, device=dev),
                      generator=gen), idx, delay)


def prach_expected_delay(cfg, idx: torch.Tensor, delay: torch.Tensor):
    """The delay the detector reads for a noise-free capture: its windows
    start at rounded IFFT bins, and a delay moves the peak by delay·2048/seq
    bins, so the reading is seq/2048·(the nearest bin to the peak − the
    window's start).  Returns (expected reading, whether the peak sits
    within 0.1 bin of the midpoint of two bins, where noise picks either)."""
    from srsran_4g_tpu_torch.models import prach

    scale = prach.NFFT_DETECT / prach.N_ZC
    step = cfg.seq_len_samples / prach.NFFT_DETECT
    start = torch.as_tensor([((prach.N_ZC - s) % prach.N_ZC) * scale
                             for _, s in cfg.preamble_plan()], dtype=torch.float64,
                            device=idx.device)[idx]
    peak = start + delay.double() / step
    near_half = ((peak - peak.floor()) - 0.5).abs() < 0.1
    return (torch.round(peak) - torch.round(start)) * step, near_half


def ul_path(dev, gen, card: str) -> dict:
    """The eNB uplink receiver at 100 PRB, under the default TURBO_KERNEL:
    BATCH subframes of the PUSCH (96 PRB, 64QAM, TBS 71112, 2 ACK and 20
    long-CQI bits) and the four PUCCH UEs, every bit checked; SRS sounding
    within SRS_NMSE_MAX; PRACH at symbol_sz 2048 (BATCH captures with one
    preamble, PRACH_NOISE captures of noise alone).  Returns map_fused16's
    ul_path entry for the kernels line."""
    from srsran_4g_tpu_torch.models import prach, pucch, pusch
    from srsran_4g_tpu_torch.ops import turbo

    os.environ.pop("TURBO_KERNEL", None)
    pcfg, pucchs, _ = ul_cfgs()
    grp = pcfg.plan.groups[0]
    l_win = turbo.window_length(grp.K, 208, 32)
    if ((len(pcfg.plan.groups), grp.count, grp.K, l_win) != (1, UL_CBS, UL_K, UL_L)
            or turbo.kernel_route("v9", l_win, 32) != "v9"):
        raise AssertionError(f"PUSCH: segmentation {pcfg.plan}, window {l_win}: not "
                             f"{UL_CBS} CBs of K={UL_K} at L={UL_L} on the v9 route")
    occupied = {name: pucch_prbs(c, name) for name, c in pucchs.items()}
    used = [(prb, s) for prbs in occupied.values() for s, prb in enumerate(prbs)]
    if len(set(used)) != len(used) or any(UL_PRB_START <= p < UL_PRB_START + UL_NOF_PRB
                                          for p, _ in used):
        raise AssertionError(f"PUCCH resources overlap each other or the PUSCH: {occupied}")
    plan = pcfg.uci_plan
    t0 = time.perf_counter()
    rx, sent = ul_traffic(dev, gen, BATCH)
    torch.cuda.synchronize()
    log(f"UL path: cell {UL_CELL_ID}, 100 PRB, subframe {UL_SUBFRAME}, batch {BATCH}, "
        f"{SNR_DB} dB; PUSCH PRB {UL_PRB_START}-{UL_PRB_START + UL_NOF_PRB - 1} 64QAM TBS "
        f"{UL_TBS} ({grp.count} CBs of K={grp.K}, L={l_win}), UCI {UL_UCI} (Q'_CQI "
        f"{plan.q_prime_cqi}, Q'_ACK {plan.q_prime_ack}, G_data {plan.g_data}); PUCCH PRBs "
        f"(slot 0, slot 1) {occupied}; made in {time.perf_counter() - t0:.2f} s (first call)")

    reset_counts()
    out = ul_receive(rx)
    torch.cuda.synchronize()
    counts = launch_counts()
    checks = check_ul(out, sent, "UL path")
    if {name for name, n in counts.items() if n} != {"map_fused16"}:
        raise AssertionError(f"the UL path launched {counts}, expected only map_fused16")
    per_decode = counts["map_fused16"]
    log(f"UL path: every check exact on {BATCH}/{BATCH} ({', '.join(checks)}); launches "
        f"{counts}: {per_decode} map_fused16 launches a PUSCH decode")

    nmse, srs_estimate = srs_sounding(dev, gen, BATCH)
    if not nmse < SRS_NMSE_MAX:
        raise AssertionError(f"SRS estimate: normalised MSE {nmse} >= {SRS_NMSE_MAX}")
    log(f"UL path: SRS over {UL_NOF_PRB} PRB, {BATCH} captures through a two-tap channel: "
        f"normalised MSE of the estimate {nmse:.3e} (< {SRS_NMSE_MAX})")

    pr_cfg = prach.PrachConfig(symbol_sz=2048, root_seq_index=PRACH_ROOT,
                               zero_corr_zone=PRACH_ZCZ)
    caps, idx, delay = prach_captures(dev, gen, pr_cfg, BATCH, PRACH_NOISE)
    det = prach.detect(pr_cfg, caps)
    want = torch.zeros((BATCH + PRACH_NOISE, 64), dtype=torch.bool, device=dev)
    want[torch.arange(BATCH, device=dev), idx] = True
    got_delay = det["delay_samples"][torch.arange(BATCH, device=dev), idx].double()
    expected, near_half = prach_expected_delay(pr_cfg, idx, delay)
    err = (got_delay - expected).abs()
    vs_sent = float((got_delay - delay.double()).abs().max())
    step = pr_cfg.seq_len_samples / prach.NFFT_DETECT
    if not torch.equal(det["detected"], want):
        raise AssertionError(f"PRACH: detections differ from the sent preambles: "
                             f"{int((det['detected'] != want).sum())} of "
                             f"{want.numel()} flags")
    if not (bool((err[~near_half] <= 1).all()) and bool((err[near_half] <= step + 1).all())
            and vs_sent <= step):
        raise AssertionError(f"PRACH delays: max error {float(err.max())} samples against the "
                             f"detector's reading, {vs_sent} against the sent delay")
    log(f"UL path: PRACH root {PRACH_ROOT}, zero-correlation zone {PRACH_ZCZ} (N_cs "
        f"{pr_cfg.n_cs}): the sent preamble and only it detected on {BATCH}/{BATCH}, nothing "
        f"on {PRACH_NOISE} captures of noise; delays within 1 sample of the detector's "
        f"reading on {int((~near_half).sum())} captures (within one {step:.0f}-sample step on "
        f"{int(near_half.sum())} whose peak lies within 0.1 bin of a bin midpoint), max "
        f"|reading - sent delay| {vs_sent:.1f} samples; min sent power "
        f"{float(det['power'][want].min()):.3f}, max other {float(det['power'][~want].max()):.3f}")

    # ---- timing: the PUSCH decode alone, then each stage's device time -----
    times = []
    for _ in range(PATH_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = pusch.decode(pcfg, rx, n_iter=N_ITER)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_exact(p["crc_ok"], p["bits"], sent["tb"], "PUSCH (timed)")
    log(f"[{card}] PUSCH decode (96 PRB 64QAM TBS {UL_TBS}, UCI) of {BATCH} subframes: best "
        f"of {PATH_REPS} {min(times) * 1e3:.2f} ms "
        f"({', '.join(f'{x * 1e3:.2f}' for x in times)}) = {BATCH / min(times):.1f} "
        f"subframes/s")
    profile_window(lambda: pusch.decode(pcfg, rx, n_iter=N_ITER), card,
                   f"PUSCH decode of {BATCH}", min(times))
    stages = {"PUCCH 1a": lambda: pucch.decode_format1(pucchs["1a"], rx, 1),
              "PUCCH 2": lambda: pucch.decode_format2(pucchs["2"], rx, 11),
              "PUCCH 2b": lambda: pucch.decode_format2(pucchs["2b"], rx, 11, nof_ack=2),
              "PUCCH 3": lambda: pucch.decode_format3(pucchs["3"], rx, 11),
              "SRS estimate": srs_estimate,
              f"PRACH detect of {BATCH + PRACH_NOISE}": lambda: prach.detect(pr_cfg, caps)}
    for name, fn in stages.items():
        host_s = min(stage_time(fn) for _ in range(PATH_REPS))
        profile_window(fn, card, f"{name} (host best of {PATH_REPS} {host_s * 1e3:.3f} ms)",
                       host_s)
    return dict(path="pusch.decode, 100 PRB, PUSCH 96 PRB 64QAM TBS 71112 with UCI, "
                "default TURBO_KERNEL", launches=per_decode,
                decode_ms=min(times) * 1e3)


def stage_time(fn) -> float:
    """Host-clock seconds of one call of fn, to its end on the device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def mbsfn_path(dev, gen, card: str) -> dict:
    """PMCH at 100 PRB (area 1, subframe 1, 64QAM, TBS 46888), BATCH grids
    through AWGN at SNR_DB, decoded under the default TURBO_KERNEL: every
    crc_ok and bit exact, only map_fused16 launched.  Returns map_fused16's
    mbsfn_path entry for the kernels line."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import pmch
    from srsran_4g_tpu_torch.ops import turbo

    os.environ.pop("TURBO_KERNEL", None)
    cfg = pmch.PmchConfig(nof_prb=100, area_id=1, subframe=1, mod="64qam", tbs=PMCH_TBS)
    grp = cfg.plan.groups[0]
    l_win = turbo.window_length(grp.K, 208, 32)
    if (len(cfg.plan.groups), grp.count, grp.K, l_win) != (1, PMCH_CBS, PMCH_K, PMCH_L):
        raise AssertionError(f"PMCH: segmentation {cfg.plan}, window {l_win}")
    bits = torch.randint(0, 2, (BATCH, cfg.tbs), generator=gen, device=dev, dtype=torch.int8)
    rx = awgn.awgn(pmch.encode(cfg, bits), awgn.snr_to_noise_var(SNR_DB, device=dev),
                   generator=gen)
    reset_counts()
    out = pmch.decode(cfg, rx, n_iter=N_ITER)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_exact(out["crc_ok"], out["bits"], bits, "PMCH")
    if {name for name, n in counts.items() if n} != {"map_fused16"}:
        raise AssertionError(f"the PMCH path launched {counts}, expected only map_fused16")
    log(f"MBSFN path: PMCH 100 PRB area 1 subframe 1 64QAM TBS {cfg.tbs} (code rate "
        f"{cfg.tbs / cfg.g_bits:.3f}, {grp.count} CBs of K={grp.K}, L={l_win}), batch {BATCH}, "
        f"{SNR_DB} dB: crc_ok {int(out['crc_ok'].sum())}/{BATCH}, bits equal; launches {counts}")
    times, _, out = timed_decodes(cfg, rx, PATH_REPS, decode=pmch.decode)
    check_exact(out["crc_ok"], out["bits"], bits, "PMCH (timed)")
    log(f"[{card}] PMCH decode of {BATCH} subframes: best of {PATH_REPS} "
        f"{min(times) * 1e3:.2f} ms ({', '.join(f'{t * 1e3:.2f}' for t in times)}) = "
        f"{BATCH / min(times):.1f} subframes/s")
    profile_window(lambda: pmch.decode(cfg, rx, n_iter=N_ITER), card,
                   f"PMCH decode of {BATCH}", min(times))
    return dict(path="pmch.decode, 100 PRB 64QAM TBS 46888, default TURBO_KERNEL",
                launches=counts["map_fused16"], decode_ms=min(times) * 1e3)


def sync_stream(dev, gen, n_sf: int, lead: int, cfo: float, nbr_shift: int,
                noise: bool = True):
    """The UE's input: ``n_sf`` subframes of cell SYNC_CELL_ID at 100 PRB from
    ``enb_dl.assemble_subframe`` (64QAM PDSCH on every PRB, CRS, PSS/SSS,
    PCFICH, the MIB in subframe 0 of each frame), after ``lead`` samples;
    the neighbour SYNC_NBR_ID (CRS and PSS/SSS only, SYNC_NBR_DB weaker,
    ``nbr_shift`` samples later); a CFO of ``cfo`` subcarriers on both and
    AWGN at SNR_DB.  Returns (stream (1, n), the stream less the serving
    cell (the neighbour and the noise), clean serving samples (n_sf,
    sf_len), the serving grids (n_sf, 14, nre), the MIB bits)."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import enb_dl, grid, pdsch

    cell = grid.CellConfig(nof_prb=100, cell_id=SYNC_CELL_ID, cfi=1)
    nbr = grid.CellConfig(nof_prb=100, cell_id=SYNC_NBR_ID, cfi=1)
    mib = torch.randint(0, 2, (1, 24), generator=gen, device=dev, dtype=torch.int8)
    grids, nbr_sf = [], []
    for k in range(n_sf):
        cfg = pdsch.PdschConfig(cell=cell, rnti=0x1234, subframe=k % 10, mod="64qam",
                                tbs=75376)
        tb = torch.randint(0, 2, (1, cfg.tbs), generator=gen, device=dev, dtype=torch.int8)
        grids.append(enb_dl.assemble_subframe(cfg, tb, mib_bits=mib, frame_idx=k // 10)[0])
        ncfg = pdsch.PdschConfig(cell=nbr, rnti=1, subframe=k % 10, mod="qpsk", tbs=16)
        g = pdsch.add_crs(ncfg, torch.zeros((1, 14, nbr.nre), dtype=torch.complex64,
                                            device=dev))
        nbr_sf.append(enb_dl.subframe_to_samples(nbr, enb_dl.put_sync_signals(nbr, g, k % 10)))
    grids = torch.stack(grids)
    clean = enb_dl.subframe_to_samples(cell, grids)  # (n_sf, sf_len)
    sf_len = clean.shape[-1]
    n = lead + n_sf * sf_len + 2 * sf_len
    x = torch.zeros(n, dtype=torch.complex64, device=dev)
    x[lead:lead + n_sf * sf_len] = clean.reshape(-1)
    nb = torch.cat(nbr_sf, dim=-1)[0] * 10 ** (-SYNC_NBR_DB / 20)
    x[lead + nbr_shift:lead + nbr_shift + nb.shape[-1]] += nb[:n - lead - nbr_shift]
    ph = 2 * np.pi * cfo * torch.arange(n, device=dev, dtype=torch.float64) / 2048
    ramp = torch.polar(torch.ones_like(ph), ph).to(torch.complex64)
    serving = torch.zeros_like(x)
    serving[lead:lead + n_sf * sf_len] = clean.reshape(-1)
    x = x * ramp
    if noise:
        x = awgn.awgn(x, awgn.snr_to_noise_var(SNR_DB, device=dev), generator=gen)
    return x[None], (x - serving * ramp)[None], clean, grids, mib


def evm_db(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """EVM of got against want after the least-squares complex gain, in dB,
    and that gain's magnitude."""
    g = torch.sum(got * want.conj()) / torch.sum(want.abs() ** 2)
    e = torch.sum((got - g * want).abs() ** 2) / torch.sum((g * want).abs() ** 2)
    return 10 * float(torch.log10(e)), float(g.abs())


def sync_path(dev, gen, card: str) -> None:
    """The UE around the downlink at 100 PRB: UeSync FIND → TRACK over a
    SYNC_SF-subframe stream with a neighbour, the MIB, CRS measurements, the
    neighbour search, FDD/TDD detection, resampling to 23.04 Msps and back,
    AGC and CFR, every check against the values put in."""
    from srsran_4g_tpu_torch.models import enb_dl, grid, meas, sync, tdd, ue_sync
    from srsran_4g_tpu_torch.ops import agc, cfr, ofdm, resampling
    from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig, _symbol_offsets

    ocfg = OfdmConfig(nof_prb=100)
    sf_len, n = ocfg.sf_len, ocfg.symbol_sz
    lead = int(torch.randint(0, SYNC_LEAD_MAX + 1, (1,), generator=gen, device=dev))
    cfo = float((2 * torch.rand(1, generator=gen, device=dev) - 1) * DL_CFO)
    nbr_shift = int(torch.randint(sf_len // 8, sf_len, (1,), generator=gen, device=dev))
    t0 = time.perf_counter()
    x, rest, clean, grids, mib = sync_stream(dev, gen, SYNC_SF, lead, cfo, nbr_shift)
    torch.cuda.synchronize()
    log(f"sync path: {SYNC_SF} subframes of cell {SYNC_CELL_ID} at 100 PRB after a lead of "
        f"{lead}, neighbour {SYNC_NBR_ID} {SYNC_NBR_DB} dB weaker {nbr_shift} samples later, CFO "
        f"{cfo:+.5f} subcarrier, {SNR_DB} dB; made in {time.perf_counter() - t0:.2f} s")

    # ---- FIND, the MIB, TRACK --------------------------------------------------
    us = ue_sync.UeSync(nof_prb=100)
    t0 = time.perf_counter()
    found = us.zerocopy(x[0, :2 * sf_len])
    find_s = time.perf_counter() - t0
    start = int(found["offset"]) - int(_symbol_offsets(ocfg)[6])
    checks = {"FIND in sync": found["in_sync"], "cell id": found.get("cell_id") == SYNC_CELL_ID,
              "subframe start exact": start == lead, "subframe 0": us.s.sf_idx == 0}
    mib_out = ue_sync.decode_mib(found["cell_id"], found["sf_samples"][None])
    checks["MIB crc_ok"] = bool(mib_out["crc_ok"].all())
    checks["MIB bits"] = torch.equal(mib_out["mib"], mib)
    track_s, lost = [], 0
    outs = []
    for k in range(SYNC_SF):
        chunk = x[0, start + k * sf_len:start + (k + 1) * sf_len]
        t0 = time.perf_counter()
        o = us.zerocopy(chunk)
        track_s.append(time.perf_counter() - t0)
        lost += not (o["in_sync"] and o["state"] == ue_sync.TRACK)
        outs.append(o)
    cfo_err = abs(us.s.cfo_hz_acc - cfo)
    checks.update({"TRACK in sync on every subframe": lost == 0,
                   f"{SYNC_SF // 10} frames tracked": us.s.frames_tracked == SYNC_SF // 10,
                   f"|CFO error| < {SYNC_CFO_TOL}": cfo_err < SYNC_CFO_TOL})
    log(f"[{card}] UE sync: FIND {find_s * 1e3:.2f} ms; TRACK per subframe best "
        f"{min(track_s) * 1e3:.3f} ms, median {float(np.median(track_s)) * 1e3:.3f} ms, "
        f"subframes 0/5 (PSS checked) median "
        f"{float(np.median(track_s[::5])) * 1e3:.3f} ms, host clock; CFO estimate "
        f"{us.s.cfo_hz_acc:+.5f} (error {cfo_err:.2e} subcarrier)")

    # ---- measurements on a tracked subframe 0 -----------------------------------
    # the SINR put in: the serving CRS at 0 dB against what the rest of the
    # stream (the neighbour and the noise) puts on the same REs
    cell = grid.CellConfig(nof_prb=100, cell_id=SYNC_CELL_ID, cfi=1)
    m = meas.measure_cell(ofdm.demodulate(ocfg, outs[10]["sf_samples"][None]), cell, 0)
    ls, ks = grid.crs_pattern(cell, 0)
    g_rest = ofdm.demodulate(ocfg, rest[:, start + 10 * sf_len:start + 11 * sf_len])
    sinr_db = -10 * float(torch.log10((g_rest[0, torch.as_tensor(ls, device=dev)[:, None],
                                              torch.as_tensor(ks, device=dev)].abs() ** 2)
                                      .mean()))
    rsrp_db = 10 * float(torch.log10(m["rsrp"][0]))
    snr_db, resid_hz = float(m["snr_db"][0]), float(m["cfo_hz"][0])
    cfo_meas_hz = us.s.cfo_hz_acc * 15e3 + resid_hz
    checks.update({f"|RSRP| < {SYNC_RSRP_TOL_DB} dB": abs(rsrp_db) < SYNC_RSRP_TOL_DB,
                   f"SNR within {SYNC_SNR_TOL_DB} dB of the SINR put in":
                   abs(snr_db - sinr_db) < SYNC_SNR_TOL_DB,
                   f"|CFO| within {SYNC_CFO_HZ_TOL} Hz": abs(cfo_meas_hz - cfo * 15e3)
                   < SYNC_CFO_HZ_TOL})
    log(f"sync path: measure_cell RSRP {rsrp_db:+.3f} dB (sent 0 dB), SNR {snr_db:.2f} dB "
        f"(the SINR put in on the CRS REs {sinr_db:.2f} dB: AWGN at {SNR_DB} dB and the "
        f"neighbour), CFO {cfo_meas_hz:+.1f} Hz (sent {cfo * 15e3:+.1f} Hz; residual after "
        f"tracking {resid_hz:+.1f} Hz), RSRQ {float(m['rsrq_db'][0]):.2f} dB")
    t0 = time.perf_counter()
    cells = meas.find_neighbour_cells(x[:, start:start + SYNC_SF * sf_len], 100,
                                      serving_cell_id=SYNC_CELL_ID)
    torch.cuda.synchronize()
    nbr_s = time.perf_counter() - t0
    ids = [c["cell_id"] for c in cells]
    checks["neighbour found"] = SYNC_NBR_ID in ids
    checks["serving excluded"] = SYNC_CELL_ID not in ids
    log(f"[{card}] find_neighbour_cells on the {SYNC_SF} subframes: {nbr_s * 1e3:.2f} ms; "
        f"found (cell, peak/RMS) {[(c['cell_id'], round(c['peak_ratio'], 2)) for c in cells]} "
        f"(the JAX package's threshold 2.0 also passes N_ID_2 hypotheses of noise)")

    # ---- FDD / TDD -----------------------------------------------------------------
    cap = x[:, :2 * sf_len]
    f = sync.find_pss(cap, n)
    fdd = tdd.detect_frame_type(cap, f["offset"], f["n_id_2"], ocfg)
    tdd_cell = grid.CellConfig(nof_prb=100, cell_id=SYNC_CELL_ID, cfi=1)
    tdd_x = torch.cat([enb_dl.subframe_to_samples(tdd_cell, enb_dl.put_sync_signals_tdd(
        tdd_cell, torch.zeros((1, 14, 1200), dtype=torch.complex64, device=dev), sf))
        for sf in range(3)], dim=-1)
    tdd_x = tdd_x + (torch.randn(tdd_x.shape, generator=gen, device=dev,
                                 dtype=torch.complex64) * 10 ** (-SNR_DB / 20))
    ft = sync.find_pss(tdd_x, n)
    tdd_res = tdd.detect_frame_type(tdd_x, ft["offset"], ft["n_id_2"], ocfg)
    checks.update({
        "FDD stream: FDD": int(fdd.frame_type[0]) == 0,
        "FDD stream: cell id": int(3 * fdd.n_id_1[0] + f["n_id_2"][0]) == SYNC_CELL_ID,
        "TDD stream: TDD": int(tdd_res.frame_type[0]) == 1,
        "TDD stream: cell id": int(3 * tdd_res.n_id_1[0] + ft["n_id_2"][0]) == SYNC_CELL_ID,
        "TDD stream: PSS offset": int(ft["offset"][0]) == tdd.pss_to_sf_start(ocfg, "tdd")})

    # ---- resampling 30.72 -> 23.04 Msps and back ---------------------------------
    r15 = OfdmConfig(nof_prb=100, custom_symbol_sz=1536)
    flat = clean.reshape(1, -1)
    t0 = time.perf_counter()
    poly = resampling.resample_polyphase(flat, 0.75)
    fft34 = resampling.resample_fft(flat, 3, 4)
    back = resampling.resample_fft(fft34, 4, 3)
    torch.cuda.synchronize()
    rs_s = time.perf_counter() - t0
    evm = {}
    for name, y, cfg_r in (("polyphase 3/4", poly, r15), ("FFT 3/4", fft34, r15),
                           ("FFT 3/4 and back", back, ocfg)):
        g_rx = ofdm.demodulate(cfg_r, y[0, :SYNC_SF * cfg_r.sf_len].reshape(SYNC_SF, -1))
        evm[name] = evm_db(g_rx, grids)
    x23 = resampling.resample_polyphase(x, 0.75)
    f23 = sync.find_pss(x23[:, :2 * r15.sf_len], 1536)
    res23 = tdd.detect_frame_type(x23, f23["offset"], f23["n_id_2"], r15)
    checks.update({
        f"polyphase EVM < {SYNC_EVM_POLY_DB} dB": evm["polyphase 3/4"][0] < SYNC_EVM_POLY_DB,
        f"FFT EVM < {SYNC_EVM_FFT_DB} dB": max(evm["FFT 3/4"][0], evm["FFT 3/4 and back"][0])
        < SYNC_EVM_FFT_DB,
        "23.04 Msps: cell id": int(3 * res23.n_id_1[0] + f23["n_id_2"][0]) == SYNC_CELL_ID,
        "23.04 Msps: FDD": int(res23.frame_type[0]) == 0})
    log(f"[{card}] resampling {SYNC_SF} subframes (polyphase 3/4, FFT 3/4, FFT 4/3): "
        f"{rs_s * 1e3:.2f} ms host clock; in-band EVM against the sent grids (dB, |gain|): "
        + ", ".join(f"{k} {v[0]:.2f} ({v[1]:.4f})" for k, v in evm.items())
        + f"; the 23.04 Msps stream searched at symbol_sz 1536: cell "
        f"{int(3 * res23.n_id_1[0] + f23['n_id_2'][0])}, frame type "
        f"{'TDD' if int(res23.frame_type[0]) else 'FDD'}")

    # ---- AGC from -20 dB, then CFR on the eNB's symbols -------------------------
    acfg = agc.AgcConfig()
    frames = x[0, lead:lead + SYNC_SF * sf_len].reshape(SYNC_SF // 10, 10 * sf_len)
    frames = frames * (acfg.target * 10 ** (-20 / 20) / float(frames.abs().max()))
    gain = torch.zeros(1, device=dev)
    gains, peaks = [], []
    for i in range(AGC_FRAMES):
        y, gain = agc.agc_step(acfg, frames[i % frames.shape[0]][None], gain)
        gains.append(float(gain[0]))
        peaks.append(float(y.abs().max()))
    last = gains[-5:]
    out_db = 20 * np.log10(peaks[-1] / acfg.target)
    checks.update({f"AGC gain within {AGC_TOL_DB} dB of +20": abs(gains[-1] - 20) < AGC_TOL_DB,
                   f"AGC settled (last 5 within {AGC_TOL_DB} dB)":
                   max(last) - min(last) < AGC_TOL_DB})
    log(f"sync path: AGC from -20 dB over {AGC_FRAMES} frames: gain (dB) "
        f"{', '.join(f'{g:.2f}' for g in gains)}; last output peak {out_db:+.2f} dB against "
        f"the target")
    offs = torch.as_tensor(_symbol_offsets(ocfg), device=dev)
    bodies = clean[:, offs[:, None] + torch.arange(n, device=dev)].reshape(-1, n)
    ccfg = cfr.CfrConfig(symbol_sz=n, nof_re=1200)
    t0 = time.perf_counter()
    clipped = cfr.cfr_apply(ccfg, bodies)
    torch.cuda.synchronize()
    cfr_s = time.perf_counter() - t0
    papr_in, papr_out = cfr.papr_db(bodies), cfr.papr_db(clipped)
    drop = float((papr_in - papr_out).mean())
    bins = torch.as_tensor(ofdm._sc_to_bin(ocfg), device=dev)
    cfr_evm = evm_db(torch.fft.fft(clipped)[:, bins], torch.fft.fft(bodies)[:, bins])
    checks.update({f"PAPR drop > {CFR_DROP_DB} dB": drop > CFR_DROP_DB,
                   f"CFR in-band EVM < {CFR_EVM_DB} dB": cfr_evm[0] < CFR_EVM_DB})
    log(f"[{card}] CFR on {bodies.shape[0]} symbols: {cfr_s * 1e3:.2f} ms; PAPR mean "
        f"{float(papr_in.mean()):.2f} -> {float(papr_out.mean()):.2f} dB (max "
        f"{float(papr_in.max()):.2f} -> {float(papr_out.max()):.2f}), mean drop {drop:.2f} dB; "
        f"in-band EVM {cfr_evm[0]:.2f} dB")
    if not all(checks.values()):
        raise AssertionError(f"sync path: {checks}")
    log(f"sync path: every check passed ({', '.join(checks)})")

    # ---- device time of the tracking loop --------------------------------------------
    def track_frame():
        t = ue_sync.UeSync(nof_prb=100, state=ue_sync.UeSyncState(
            state=ue_sync.TRACK, cell_id=SYNC_CELL_ID, cfo_hz_acc=us.s.cfo_hz_acc))
        for k in range(10):
            t.zerocopy(x[0, start + k * sf_len:start + (k + 1) * sf_len])

    profile_window(track_frame, card, "UE sync TRACK over 10 subframes",
                   sum(sorted(track_s)[:10]))


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        sys.exit(2)

    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import grid, pdsch
    from srsran_4g_tpu_torch.ops.cuda import build
    from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm

    torch.backends.cuda.matmul.allow_tf32 = False  # CRC matmuls: plain f32
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    log(card)
    log(f"SM clock max {smi('clocks.max.sm')}, {torch.cuda.get_device_properties(0).multi_processor_count} "
        f"SMs; op rates assume {SM_COUNT} SMs at {CLOCK_HZ / 1e9} GHz, per SM and clock "
        f"{ADD_PER_SM_CLOCK} adds, {MAX_PER_SM_CLOCK} maxes, {DISPATCH_PER_SM_CLOCK} dispatched")
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
    n_bench = BATCH * grp.count * (grp.K // 208)
    geos = {"map_fused16": tm.fused16_geometry(n_bench, 208),
            "turbo_map": tm.windowed_geometry(n_bench, 208, 32, 1),
            "map_windowed16": tm.windowed_geometry(n_bench, 208, 32, 1, metric_bytes=16),
            "map_v3": tm.windowed_geometry(n_bench, 208, 32, 2),
            "map_fused_r2": tm.fused_geometry(n_bench, 208, 2),
            "map_fused_r4": tm.fused_geometry(n_bench, 208, 4)}
    for route, geo in geos.items():
        log(f"{route} at the bench shape: {geo}")
    usage = {route: build.kernel_usage(libs[source[:-3]].with_suffix(".log").read_text(),
                                       *kernel_symbol(route, radix, geos.get(route)))
             for route, (_, radix, source, _, _) in ROUTES.items()}
    for route, u in usage.items():
        log(f"{route} kernel at the bench shape: {u}")
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
    best = time_paths(cfg, rx, bits, card)
    path_device_ms = {}
    for kernel in ("bf16", "v7", "v8"):  # the redesigned kernels' decodes
        os.environ["TURBO_KERNEL"] = kernel
        log(f"[{card}] TURBO_KERNEL={kernel} decode, profiled:")
        prof = profile_decode(cfg, rx, best[kernel], card,
                              turbo="fused_kernel" if kernel != "bf16" else "windowed_kernel")
        path_device_ms[kernel] = dict(zip(("decode_device_ms", "kernel_device_ms"), prof or ()))
    os.environ.pop("TURBO_KERNEL", None)
    mimo_lane(dev, gen, card)
    default_route = mcs23_path(dev, gen, card, kern)
    dl_path(dev, gen, card)
    probe_kernels = probes_phase(card)
    control_path(dev, gen, card)
    new_paths = {"ul_path": (ul_path(dev, gen, card), UL_CBS, UL_K, UL_L),
                 "mbsfn_path": (mbsfn_path(dev, gen, card), PMCH_CBS, PMCH_K, PMCH_L)}
    sync_path(dev, gen, card)
    fused16_paths = {}
    for key, (entry, cbs, k_cb, l_win) in new_paths.items():
        nbytes, adds, maxes = work("map_fused16", BATCH * cbs, k_cb, l_win, 32)
        bound_ms, bound_by = bound(nbytes, adds, maxes, "bf16")
        r = kern[key]
        log(f"[{card}] map_fused16 on the {key} at B={BATCH * cbs} K={k_cb} L={l_win} T=32: "
            f"{entry['launches']} launches a decode, {r['ms']:.4f} ms against a bound of "
            f"{bound_ms:.4f} ms ({bound_by}); plain {r['plain_ms']:.2f} ms")
        fused16_paths[key] = dict(
            entry, shapes=dict(blocks=BATCH * cbs, K=k_cb, L=l_win, T=32,
                               lanes=BATCH * cbs * (k_cb // l_win)),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)

    b, k, l, t = BATCH * grp.count, grp.K, 208, 32
    kernels = []
    for route, (wrapper, _, source, line, path) in ROUTES.items():
        nbytes, adds, maxes = work(wrapper, b, k, l, t)
        kind = "bf16" if wrapper in BF16_WRAPPERS else "f32"
        bound_ms, bound_by = bound(nbytes, adds, maxes, kind)
        log(f"{route} bound at B={b} K={k} L={l} T={t}: {nbytes} bytes, {adds} adds + "
            f"{maxes} maxes ({kind}; {op_ms(adds, maxes, kind):.4f} ms) "
            f"-> {bound_ms:.4f} ms ({bound_by}); kernel {kern[route]['ms']:.4f} ms")
        kernels.append(dict(
            name=route, route="cuda", source=f"srsran_4g_tpu_torch/csrc/{source}",
            replaces=f"srsran_4g_tpu/ops/pallas/turbo_map.py:{line}",
            path=f"TURBO_KERNEL={path}",
            shapes=dict(blocks=b, K=k, L=l, T=t, lanes=b * (k // l)),
            launches=paths[path][wrapper], max_abs_err=kern[route]["max_abs_err"],
            ms=kern[route]["ms"], plain_ms=kern[route]["plain_ms"], bound_ms=bound_ms,
            bound_by=bound_by, bytes=nbytes, library_ms=None,
            geometry=geos[route]._asdict() if route in geos else dict(threads=128, smem_bytes=0),
            **usage[route],
            **({"vs_turbo_map_max_abs_err": kern[route]["vs_turbo_map"]}
               if "vs_turbo_map" in kern[route] else {}),
            **({"default_route": default_route} if route == "turbo_map" else {}),
            **(fused16_paths if route == "map_fused16" else {}),
            **path_device_ms.get(path, {})))
    print(json.dumps({"kernels": kernels + probe_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
