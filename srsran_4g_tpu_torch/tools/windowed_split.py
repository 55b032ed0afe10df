"""``map_windowed`` and ``map_v3`` on the card beside variants of their
kernel and, with ``--parent DIR``, the kernels they replaced.

``csrc/turbo_windowed.cu`` is built once for each distinct set of
``WINDOWED_*`` switches (``nvcc -D``) and each variant launched with its own
geometry (``variant_geometry``: ``windowed_geometry``'s checkpoint stride c
and tile, and the ring's bytes):

- ``every1``, ``every2``, ``every8``: checkpoints every 1, 2 or 8 positions
  (the kernel: the geometry's choice, 4 at the bench shape; map_v3 takes no
  8);
- ``tile16``: 16 lanes a block (the kernel: 32);
- ``ring16``, ``ring32``: a gamma ring of 16 or 32 rows a chain (the
  kernel: 8), also with c = 8 (``ring16_every8``);
- ``loads_only``: every ring fill, shared-memory access and LLR store, with
  one add a step and a position in place of the trellis arithmetic;
- ``compute_only``: the arithmetic and the stores, the ring never filled.

``--parent DIR`` names an unpacked tree of commit 59cf7ec, whose
``csrc/turbo_map.cu`` (``map_windowed``: one thread a lane, every body
alpha stored in device memory), ``csrc/turbo_v3.cu`` (``map_v3``) and
``csrc/turbo_fused16.cu`` (``map_fused16``) are built and timed beside this
tree's kernels; another tree is refused.  The default-route decode at 100
PRB MCS 23 (``decode_in_turn``), whose half-iterations run
``map_windowed``, then runs with either tree's kernel in the decoder's
place, in turn, its host time and its device time (torch.profiler) taken
for each.

At the 20 MHz bench shape (B = 1,664 blocks of K = 5,824, L = 208, T = 32)
every variant whose outputs are LLRs, and the parent's kernels, must equal
this tree's kernel exactly.  Each is timed alone after an L2 flush, all in
turn (forward, then backward).  Prints each build's registers and spills
(``ptxas -v``).

    python -m srsran_4g_tpu_torch.tools.windowed_split [--parent DIR]
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.ops import turbo
from srsran_4g_tpu_torch.ops.cuda import build
from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm
from srsran_4g_tpu_torch.tools import event_ms

B, K, L, T = 1664, 5824, 208, 32
MCS23_TBS = 51024  # 100 PRB, MCS 23: 9 code blocks of K = 5,696, L = 178
VARIANT_DIR = build.BUILD_DIR / "windowed_split"
# name -> (its WINDOWED_* switches, windowed_geometry's every/lanes)
VARIANTS = {
    "every1": ({}, {"every": 1}),
    "every2": ({}, {"every": 2}),
    "every8": ({}, {"every": 8}),
    "tile16": ({}, {"lanes": 16}),
    "ring16": ({"WINDOWED_STAGES": 16}, {}),
    "ring32": ({"WINDOWED_STAGES": 32}, {}),
    "ring16_every8": ({"WINDOWED_STAGES": 16}, {"every": 8}),
    "loads_only": ({"WINDOWED_LOADS_ONLY": 1}, {}),
    "compute_only": ({"WINDOWED_COMPUTE_ONLY": 1}, {}),
}
NOT_LLRS = ("loads_only", "compute_only")
# wrapper -> (C entry, chains a thread)
ENTRIES = {"map_windowed": ("turbo_map_windowed", 1), "map_v3": ("turbo_map_v3", 2)}


def variant_flags(name: str) -> list[str]:
    return [f"-D{key}={value}" for key, value in VARIANTS[name][0].items()]


def applies(name: str, wrapper: str) -> bool:
    """map_v3 holds two segments in registers and takes no c above 4."""
    return not (wrapper == "map_v3" and VARIANTS[name][1].get("every", 4) > 4)


def variant_geometry(name: str, wrapper: str, n: int, l_win: int,
                     t_train: int) -> tm.WindowedGeometry:
    """A variant's launch: ``windowed_geometry`` with the variant's every or
    lanes, and the shared bytes of its ring."""
    defines, force = VARIANTS[name]
    geo = tm.windowed_geometry(n, l_win, t_train, ENTRIES[wrapper][1], **force)
    stages = defines.get("WINDOWED_STAGES", tm.WINDOWED_STAGES)
    return geo._replace(smem_bytes=tm.windowed_smem(l_win, geo.lanes, geo.every, stages))


def build_name(name: str) -> str | None:
    """The name of the build a variant runs, one for each set of switches
    (None: the kernel's own)."""
    defines = VARIANTS[name][0]
    return "_".join(f"{k[9:].lower()}{v}" for k, v in sorted(defines.items())) or None


def library(name: str) -> Path:
    """The build a variant runs."""
    if build_name(name):
        return VARIANT_DIR / f"lib{build_name(name)}.so"
    return build.build(["turbo_windowed"])["turbo_windowed"]


def _nvcc(src: Path, lib: Path, flags=()) -> subprocess.Popen:
    return subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(lib),
                             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _bind(lib: Path, symbol: str, n_ptr: int, n_int: int):
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _call(fn, what: str, *args) -> None:
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    ints = [a for a in args if not isinstance(a, torch.Tensor)]
    err = fn(*(x.data_ptr() for x in tensors), *ints, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def variant_entry(name: str, wrapper: str, n: int):
    """A variant of ``wrapper``'s kernel under the wrapper's contract, at N
    lanes and the bench window."""
    symbol, _ = ENTRIES[wrapper]
    fn = _bind(library(name), symbol, 5, 8)
    geo = variant_geometry(name, wrapper, n, L, T)

    def call(gs, gp, a0, b0, t, l, nof_b, nof_w):
        out = gs.new_empty((l, gs.shape[1]))
        _call(fn, f"{wrapper} {name}", gs, gp, a0, b0, out, gs.shape[1], t, l, nof_b, nof_w,
              geo.lanes, geo.every, geo.smem_bytes)
        return out

    return call


def parent_sources(parent: str) -> dict[str, Path]:
    """The parent tree's sources of the three kernels this one is timed
    against."""
    csrc = Path(parent) / "srsran_4g_tpu_torch" / "csrc"
    srcs = {name: csrc / f"{name}.cu" for name in ("turbo_map", "turbo_v3", "turbo_fused16")}
    if not all(p.exists() for p in srcs.values()) or "FUSED16_OPT_IN" not in srcs[
            "turbo_fused16"].read_text():
        raise ValueError(f"--parent {parent}: not a tree of commit 59cf7ec (its csrc/ "
                         f"holds turbo_map.cu, turbo_v3.cu and turbo_fused16.cu with "
                         f"FUSED16_OPT_IN)")
    return srcs


def parent_entries(libs: dict[str, Path]) -> dict:
    """The parent's kernels under the wrapper contracts of its tree:
    map_windowed and map_v3 with an (L, 8, N) f32 store in device memory,
    allocated on every call; map_fused16 at 32 lanes a block."""
    fns = {"map_windowed": _bind(libs["turbo_map"], "turbo_map_windowed", 6, 5),
           "map_v3": _bind(libs["turbo_v3"], "turbo_map_v3", 6, 5),
           "map_fused16": _bind(libs["turbo_fused16"], "turbo_map_fused16", 5, 7)}

    def stored(wrapper):
        def call(gs, gp, a0, b0, t, l, nof_b, nof_w):
            n = gs.shape[1]
            out, store = gs.new_empty((l, n)), gs.new_empty((l, 8, n))
            _call(fns[wrapper], f"the parent's {wrapper}", gs, gp, a0, b0, store, out, n, t, l,
                  nof_b, nof_w)
            return out
        return call

    def fused16(gs, gp, a0, b0, t, l, nof_b, nof_w):
        n = gs.shape[1]
        out = gs.new_empty((l, n))
        _call(fns["map_fused16"], "the parent's map_fused16", gs, gp, a0, b0, out, n, t, l,
              nof_b, nof_w, 32, 32 * (32 * -(-l // 8) + 256))
        return out

    return {"map_windowed": stored("map_windowed"), "map_v3": stored("map_v3"),
            "map_fused16": fused16}


def inputs(device=None, seed: int = 0):
    """The bench shape's half-iteration inputs from random gammas (N(0, 3²))."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lsa, lp = (torch.as_tensor((rng.standard_normal((B, K)) * 3).astype(np.float32), device=dev)
               for _ in range(2))
    ts, tp = (torch.as_tensor(rng.standard_normal((B, 3)).astype(np.float32), device=dev)
              for _ in range(2))
    return turbo._windowed_inputs(lsa, lp, ts, tp, L, T)[:4] + (T, L, B, K // L)


def device_ms(fn, reps: int = 3) -> tuple[float, float]:
    """Device time of ``fn()`` from torch.profiler, ms per call: all kernels,
    and those named *windowed_kernel* (either tree's map_windowed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    windowed = sum(e.self_device_time_total for e in kernels
                   if "windowed_kernel" in e.key) / 1e3 / reps
    return busy, windowed


def decode_in_turn(parent_fn, rounds: int = 4) -> dict:
    """The default-route decode at 100 PRB, 64QAM, MCS 23 (TBS 51,024: 9 code
    blocks of K = 5,696, whose window L = 178 sends every half-iteration to
    ``map_windowed``; 128 subframes, AWGN at 30 dB, n_iter 4) with this
    tree's ``map_windowed`` and ``parent_fn`` in the decoder's place in turn
    (kernel, parent, parent, kernel, ...), each decode exact.  Returns
    {"host_ms": {who: [ms]}, "device_ms": {who: (all, windowed)},
    "launches": {who: per decode}}."""
    import os

    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import grid, pdsch

    os.environ.pop("TURBO_KERNEL", None)
    cfg = pdsch.PdschConfig(cell=grid.CellConfig(nof_prb=100, cell_id=123, cfi=1),
                            rnti=0x1234, subframe=4, mod="64qam", tbs=MCS23_TBS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bits = torch.randint(0, 2, (128, cfg.tbs), generator=gen, device="cuda", dtype=torch.int8)
    rx = awgn.awgn(pdsch.add_crs(cfg, pdsch.encode(cfg, bits)), awgn.snr_to_noise_var(30.0),
                   generator=gen)
    calls = collections.Counter()

    def counted(who, fn):
        def call(*args):
            calls[who] += 1
            return fn(*args)
        return call

    fns = {"kernel": counted("kernel", tm.map_windowed), "parent": counted("parent", parent_fn)}
    kernel_fn = tm.map_windowed
    res = {"host_ms": {who: [] for who in fns}, "device_ms": {}, "launches": {}}

    def decode():
        out = pdsch.decode(cfg, rx, n_iter=4)
        torch.cuda.synchronize()
        return out

    try:
        for turn in (("kernel", "parent"), ("parent", "kernel")) * (rounds // 2 + 1):
            for who in turn:
                tm.map_windowed = fns[who]
                torch.cuda.synchronize()
                before = calls[who]
                t0 = time.perf_counter()
                out = decode()
                res["host_ms"][who].append((time.perf_counter() - t0) * 1e3)
                res["launches"][who] = calls[who] - before
                if not (bool(out["crc_ok"].all()) and torch.equal(out["bits"], bits)):
                    raise AssertionError(f"MCS 23 decode with the {who}'s map_windowed: "
                                         f"not exact")
        for who in ("kernel", "parent", "parent", "kernel"):
            tm.map_windowed = fns[who]
            res["device_ms"].setdefault(who, []).append(device_ms(decode))
    finally:
        tm.map_windowed = kernel_fn
    if not all(res["launches"].values()):
        raise AssertionError(f"the MCS 23 decode ran no map_windowed: {res['launches']}")
    res["host_ms"] = {who: t[1:] for who, t in res["host_ms"].items()}  # the first warms up
    return res


def measure(parent: str | None = None) -> dict:
    """Build, check, time and print; returns {"ms": {name: [ms]}, "usage":
    {build: {kernel: registers and spills}}} and, with ``parent``,
    {"decode": decode_in_turn's}."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "turbo_windowed.cu"
    procs = {build_name(name): _nvcc(src, library(name), variant_flags(name))
             for name in VARIANTS if build_name(name)}
    psrc = parent_sources(parent) if parent else {}
    for name, path in psrc.items():
        procs[f"parent_{name}"] = _nvcc(path, VARIANT_DIR / f"libparent_{name}.so")
    kernel_lib = build.build(["turbo_windowed"])["turbo_windowed"]
    logs = {"kernel": kernel_lib.with_suffix(".log").read_text()}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
    usage = {name: build.ptxas_usage(text) for name, text in logs.items()}
    from srsran_4g_tpu_torch.tools.fused16_split import sass_counts

    for function in ("windowed_kernelILi4E", "v3_kernelILi4E"):
        counts = sass_counts(kernel_lib, function)
        print(f"  SASS of {function}: {sum(counts.values())} instructions; "
              + ", ".join(f"{op} {k}" for op, k in counts.most_common(12)))
    for name, kernels in usage.items():
        print(f"  {name}: " + "; ".join(
            f"{k.split('_GLOBAL__N_')[-1][:40]} {u.get('registers')} registers, "
            f"{u.get('spill_stores', 0) + u.get('spill_loads', 0)} B spilled"
            for k, u in kernels.items()))

    args = inputs()
    n = args[0].shape[1]
    fns, shape = {}, {}
    for wrapper in ENTRIES:
        fns[f"{wrapper}"] = (lambda f: lambda: f(*args))(getattr(tm, wrapper))
        geo = tm.windowed_geometry(n, L, T, ENTRIES[wrapper][1])
        shape[wrapper] = f"{geo.lanes} lanes, c={geo.every}, {geo.smem_bytes} B"
        for name in VARIANTS:
            if applies(name, wrapper):
                key = f"{wrapper} {name}"
                fns[key] = (lambda f: lambda: f(*args))(variant_entry(name, wrapper, n))
                g = variant_geometry(name, wrapper, n, L, T)
                shape[key] = f"{g.lanes} lanes, c={g.every}, {g.smem_bytes} B"
    fns["map_fused16"] = lambda: tm.map_fused16(*args)
    geo16 = tm.fused16_geometry(n, L)
    shape["map_fused16"] = f"{geo16.lanes} lanes, {geo16.smem_bytes} B"
    if parent:
        libs = {name: VARIANT_DIR / f"libparent_{name}.so" for name in psrc}
        for wrapper, fn in parent_entries(libs).items():
            fns[f"parent {wrapper}"] = (lambda f: lambda: f(*args))(fn)
            shape[f"parent {wrapper}"] = ("32 lanes, stores in shared memory"
                                          if wrapper == "map_fused16"
                                          else "stores in device memory")
    want = tm.map_windowed(*args)
    want16 = tm.map_fused16(*args)
    for name, fn in fns.items():
        ref = want16 if name.endswith("map_fused16") else want
        if not any(name.endswith(v) for v in NOT_LLRS) and not torch.equal(fn(), ref):
            raise AssertionError(f"{name}: LLRs differ from the kernel's at the bench shape")
    ms = {name: [] for name in fns}
    for turn in (list(fns), list(fns)[::-1]):
        for name in turn:
            ms[name].append(event_ms(fns[name], iters=20, warmup=2))
    print(f"at B={B} K={K} L={L} T={T} (N={n}); each timed alone after an L2 flush, in "
          f"turn; LLRs equal to the kernel's but for {', '.join(NOT_LLRS)}:")
    for name, t in ms.items():
        print(f"  {name:26s} {shape[name]:36s} {', '.join(f'{x:.4f}' for x in t)} ms")
    res = {"ms": ms, "usage": usage}
    if parent:
        res["decode"] = decode_in_turn(parent_entries(libs)["map_windowed"])
        d = res["decode"]
        print("default-route decode of 128 subframes at 100 PRB MCS 23 (TBS 51024), "
              "30 dB, n_iter 4, in turn:")
        for who, t in d["host_ms"].items():
            dev = ", ".join(f"{a:.3f} ({w:.4f})" for a, w in d["device_ms"][who])
            print(f"  {who:8s} map_windowed launches {d['launches'][who]}; host ms best "
                  f"{min(t):.2f} ({', '.join(f'{x:.2f}' for x in t)}); device ms (of it "
                  f"map_windowed) {dev}")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", help="an unpacked tree of commit 59cf7ec")
    measure(ap.parse_args().parent)


if __name__ == "__main__":
    main()
