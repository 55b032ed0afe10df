"""``map_windowed``, ``map_v3`` and ``map_windowed16`` on the card beside
variants of their kernel and, with ``--parent DIR``, the kernels of the
parent tree.

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

``--parent DIR`` names an unpacked tree of commit 43eea58, whose
``csrc/turbo_map.cu`` holds the ``map_windowed16`` kernel this one replaced
(one thread a lane, every body alpha stored in device memory) and whose
``csrc/turbo_windowed.cu`` holds ``map_windowed`` and ``map_v3`` before
their kernel took bf16 metrics too; those are built and timed beside this
tree's kernels; another tree is refused.  The SISO decode of 128 subframes
under ``TURBO_KERNEL=bf16`` (``decode_in_turn``), whose half-iterations run
``map_windowed16``, then runs with either tree's kernel in the decoder's
place, in turn, its host time and its device time (torch.profiler) taken
for each.

At the 20 MHz bench shape (B = 1,664 blocks of K = 5,824, L = 208, T = 32)
every variant whose outputs are LLRs, and the parent's kernels, must equal
this tree's kernel exactly.  Each is timed alone after an L2 flush, all in
turn (forward, then backward).  Prints each build's registers and spills
(``ptxas -v``) and the SASS opcode counts (``cuobjdump``) of the kernels at
the bench geometry and of the parent's ``map_windowed16``.

    python -m srsran_4g_tpu_torch.tools.windowed_split [--parent DIR]
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
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
SISO_TBS = 75376  # 100 PRB, 64QAM: 13 code blocks of K = 5,824
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
# wrapper -> (C entry, chains a thread, bytes of a metric)
ENTRIES = {"map_windowed": ("turbo_map_windowed", 1, 32), "map_v3": ("turbo_map_v3", 2, 32),
           "map_windowed16": ("turbo_map_windowed16", 1, 16)}


def variant_flags(name: str) -> list[str]:
    return [f"-D{key}={value}" for key, value in VARIANTS[name][0].items()]


def applies(name: str, wrapper: str) -> bool:
    """map_v3 holds two segments in registers and takes no c above 4."""
    return not (wrapper == "map_v3" and VARIANTS[name][1].get("every", 4) > 4)


def geometry(wrapper: str, n: int, l_win: int, t_train: int, **force) -> tm.WindowedGeometry:
    """The wrapper's own launch geometry (``force``: every or lanes)."""
    _, chains, metric_bytes = ENTRIES[wrapper]
    return tm.windowed_geometry(n, l_win, t_train, chains, metric_bytes=metric_bytes, **force)


def variant_geometry(name: str, wrapper: str, n: int, l_win: int,
                     t_train: int) -> tm.WindowedGeometry:
    """A variant's launch: ``windowed_geometry`` with the variant's every or
    lanes, and the shared bytes of its ring."""
    defines, force = VARIANTS[name]
    geo = geometry(wrapper, n, l_win, t_train, **force)
    stages = defines.get("WINDOWED_STAGES", tm.WINDOWED_STAGES)
    return geo._replace(smem_bytes=tm.windowed_smem(l_win, geo.lanes, geo.every, stages,
                                                    metric_bytes=ENTRIES[wrapper][2]))


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


def nvcc(src: Path, lib: Path, flags=()) -> subprocess.Popen:
    """Start one nvcc build of ``src`` into ``lib`` (the package's flags)."""
    return subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(lib),
                             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def bind(lib: Path, symbol: str, n_ptr: int, n_int: int):
    """A C entry of ``lib``: n_ptr pointers, n_int ints, then the stream."""
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(fn, what: str, *args) -> None:
    """Launch ``fn`` on the current stream with the tensors' pointers and
    the ints of ``args``, in their order; raise on a CUDA error."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    ints = [a for a in args if not isinstance(a, torch.Tensor)]
    err = fn(*(x.data_ptr() for x in tensors), *ints, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def variant_entry(name: str, wrapper: str, n: int):
    """A variant of ``wrapper``'s kernel under the wrapper's contract, at N
    lanes and the bench window."""
    symbol = ENTRIES[wrapper][0]
    fn = bind(library(name), symbol, 5, 8)
    geo = variant_geometry(name, wrapper, n, L, T)

    def run(gs, gp, a0, b0, t, l, nof_b, nof_w):
        out = gs.new_empty((l, gs.shape[1]))
        call(fn, f"{wrapper} {name}", gs, gp, a0, b0, out, gs.shape[1], t, l, nof_b, nof_w,
             geo.lanes, geo.every, geo.smem_bytes)
        return out

    return run


def parent_sources(parent: str) -> dict[str, Path]:
    """The parent tree's sources of the kernels this tree's are timed
    against."""
    csrc = Path(parent) / "srsran_4g_tpu_torch" / "csrc"
    srcs = {name: csrc / f"{name}.cu" for name in ("turbo_map", "turbo_windowed")}
    if not all(p.exists() for p in srcs.values()) or "turbo_map_windowed16" in srcs[
            "turbo_windowed"].read_text():
        raise ValueError(f"--parent {parent}: not a tree of commit 43eea58 (its csrc/ "
                         f"holds turbo_map.cu, and turbo_windowed.cu without bf16)")
    return srcs


def parent_entries(libs: dict[str, Path]) -> dict:
    """The parent's kernels under the wrapper contracts of its tree:
    map_windowed16 with an (L, 8, N) bf16 store in device memory, allocated
    on every call; map_windowed and map_v3 at this tree's f32 geometry."""
    fn16 = bind(libs["turbo_map"], "turbo_map_windowed16", 6, 5)

    def windowed16(gs, gp, a0, b0, t, l, nof_b, nof_w):
        n = gs.shape[1]
        out, store = gs.new_empty((l, n)), gs.new_empty((l, 8, n), dtype=torch.bfloat16)
        call(fn16, "the parent's map_windowed16", gs, gp, a0, b0, store, out, n, t, l, nof_b,
             nof_w)
        return out

    def f32(wrapper):
        fn = bind(libs["turbo_windowed"], ENTRIES[wrapper][0], 5, 8)

        def run(gs, gp, a0, b0, t, l, nof_b, nof_w):
            n = gs.shape[1]
            geo = geometry(wrapper, n, l, t)
            out = gs.new_empty((l, n))
            call(fn, f"the parent's {wrapper}", gs, gp, a0, b0, out, n, t, l, nof_b, nof_w,
                 geo.lanes, geo.every, geo.smem_bytes)
            return out
        return run

    return {"map_windowed16": windowed16, "map_windowed": f32("map_windowed"),
            "map_v3": f32("map_v3")}


def inputs(device=None, seed: int = 0):
    """The bench shape's half-iteration inputs from random gammas (N(0, 3²))."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lsa, lp = (torch.as_tensor((rng.standard_normal((B, K)) * 3).astype(np.float32), device=dev)
               for _ in range(2))
    ts, tp = (torch.as_tensor(rng.standard_normal((B, 3)).astype(np.float32), device=dev)
              for _ in range(2))
    return turbo._windowed_inputs(lsa, lp, ts, tp, L, T)[:4] + (T, L, B, K // L)


def device_ms(fn, name: str, reps: int = 3) -> tuple[float, float]:
    """Device time of ``fn()`` from torch.profiler, ms per call: all kernels,
    and those whose name holds ``name``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    named = sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3 / reps
    return busy, named


def decode_in_turn(wrapper: str, turbo_kernel: str, parent_fn, kernel_name: str,
                   rounds: int = 4) -> dict:
    """The SISO decode at 20 MHz (100 PRB, 64QAM, TBS 75,376: 13 code blocks
    of K = 5,824; 128 subframes, AWGN at 30 dB, n_iter 4) under
    ``TURBO_KERNEL=turbo_kernel``, with this tree's ``wrapper`` and
    ``parent_fn`` in the decoder's place in turn (kernel, parent, parent,
    kernel, ...), each decode exact.  Returns {"host_ms": {who: [ms]},
    "device_ms": {who: [(all, kernels named kernel_name)]}, "launches":
    {who: per decode}}."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import grid, pdsch

    os.environ["TURBO_KERNEL"] = turbo_kernel
    cfg = pdsch.PdschConfig(cell=grid.CellConfig(nof_prb=100, cell_id=123, cfi=1),
                            rnti=0x1234, subframe=4, mod="64qam", tbs=SISO_TBS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bits = torch.randint(0, 2, (128, cfg.tbs), generator=gen, device="cuda", dtype=torch.int8)
    rx = awgn.awgn(pdsch.add_crs(cfg, pdsch.encode(cfg, bits)), awgn.snr_to_noise_var(30.0),
                   generator=gen)
    calls = collections.Counter()

    def counted(who, fn):
        def run(*args, **kw):
            calls[who] += 1
            return fn(*args, **kw)
        return run

    kernel_fn = getattr(tm, wrapper)
    fns = {"kernel": counted("kernel", kernel_fn), "parent": counted("parent", parent_fn)}
    res = {"host_ms": {who: [] for who in fns}, "device_ms": {}, "launches": {}}

    def decode():
        out = pdsch.decode(cfg, rx, n_iter=4)
        torch.cuda.synchronize()
        return out

    try:
        for turn in (("kernel", "parent"), ("parent", "kernel")) * (rounds // 2 + 1):
            for who in turn:
                setattr(tm, wrapper, fns[who])
                torch.cuda.synchronize()
                before = calls[who]
                t0 = time.perf_counter()
                out = decode()
                res["host_ms"][who].append((time.perf_counter() - t0) * 1e3)
                res["launches"][who] = calls[who] - before
                if not (bool(out["crc_ok"].all()) and torch.equal(out["bits"], bits)):
                    raise AssertionError(f"TURBO_KERNEL={turbo_kernel} decode with the "
                                         f"{who}'s {wrapper}: not exact")
        for who in ("kernel", "parent", "parent", "kernel"):
            setattr(tm, wrapper, fns[who])
            res["device_ms"].setdefault(who, []).append(device_ms(decode, kernel_name))
    finally:
        setattr(tm, wrapper, kernel_fn)
        os.environ.pop("TURBO_KERNEL", None)
    if not all(res["launches"].values()):
        raise AssertionError(f"the TURBO_KERNEL={turbo_kernel} decode ran no {wrapper}: "
                             f"{res['launches']}")
    res["host_ms"] = {who: t[1:] for who, t in res["host_ms"].items()}  # the first warms up
    return res


def print_decode(title: str, wrapper: str, d: dict) -> None:
    print(title)
    for who, t in d["host_ms"].items():
        dev = ", ".join(f"{a:.3f} ({w:.4f})" for a, w in d["device_ms"][who])
        print(f"  {who:8s} {wrapper} calls {d['launches'][who]}; host ms best {min(t):.2f} "
              f"({', '.join(f'{x:.2f}' for x in t)}); device ms (of it {wrapper}) {dev}")


def print_usage(usage: dict) -> None:
    for name, kernels in usage.items():
        print(f"  {name}: " + "; ".join(
            f"{k.split('_GLOBAL__N_')[-1][:48]} {u.get('registers')} registers, "
            f"{u.get('spill_stores', 0) + u.get('spill_loads', 0)} B spilled"
            for k, u in kernels.items()))


def print_sass(lib: Path, *patterns: str) -> collections.Counter:
    from srsran_4g_tpu_torch.tools.fused16_split import sass_counts

    counts = sass_counts(lib, *patterns)
    local = sum(k for op, k in counts.items() if op.startswith(("LDL", "STL")))
    print(f"  SASS of {'/'.join(patterns)}: {sum(counts.values())} instructions, "
          f"{local} to local memory; " + ", ".join(f"{op} {k}" for op, k in counts.most_common()))
    return counts


def time_in_turn(fns: dict, shape: dict, title: str) -> dict[str, list[float]]:
    """Each of ``fns`` timed alone after an L2 flush, all in turn, forward
    then backward; prints and returns {name: [ms, ms]}."""
    ms = {name: [] for name in fns}
    for turn in (list(fns), list(fns)[::-1]):
        for name in turn:
            ms[name].append(event_ms(fns[name], iters=20, warmup=2))
    print(title)
    for name, t in ms.items():
        print(f"  {name:30s} {shape[name]:36s} {', '.join(f'{x:.4f}' for x in t)} ms")
    return ms


def measure(parent: str | None = None) -> dict:
    """Build, check, time and print; returns {"ms": {name: [ms]}, "usage":
    {build: {kernel: registers and spills}}, "sass": {kernel: Counter}} and,
    with ``parent``, {"decode": decode_in_turn's}."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "turbo_windowed.cu"
    procs = {build_name(name): nvcc(src, library(name), variant_flags(name))
             for name in VARIANTS if build_name(name)}
    psrc = parent_sources(parent) if parent else {}
    for name, path in psrc.items():
        procs[f"parent_{name}"] = nvcc(path, VARIANT_DIR / f"libparent_{name}.so")
    kernel_lib = build.build(["turbo_windowed"])["turbo_windowed"]
    logs = {"kernel": kernel_lib.with_suffix(".log").read_text()}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
    usage = {name: build.ptxas_usage(text) for name, text in logs.items()}
    print_usage(usage)

    args = inputs()
    n = args[0].shape[1]
    sass = {}
    for wrapper in ENTRIES:
        geo = geometry(wrapper, n, L, T)
        pieces = ((f"v3_kernelILi{geo.every}E",) if wrapper == "map_v3" else
                  (f"windowed_kernelILi{geo.every}E", "B16" if wrapper.endswith("16") else "F32"))
        sass[wrapper] = print_sass(kernel_lib, *pieces)
    if parent:
        sass["parent map_windowed16"] = print_sass(VARIANT_DIR / "libparent_turbo_map.so",
                                                   "map_windowed_kernel")
    fns, shape = {}, {}
    for wrapper in ENTRIES:
        fns[wrapper] = (lambda f: lambda: f(*args))(getattr(tm, wrapper))
        geo = geometry(wrapper, n, L, T)
        shape[wrapper] = f"{geo.lanes} lanes, c={geo.every}, {geo.smem_bytes} B"
        for name in VARIANTS:
            if applies(name, wrapper):
                key = f"{wrapper} {name}"
                fns[key] = (lambda f: lambda: f(*args))(variant_entry(name, wrapper, n))
                g = variant_geometry(name, wrapper, n, L, T)
                shape[key] = f"{g.lanes} lanes, c={g.every}, {g.smem_bytes} B"
    if parent:
        libs = {name: VARIANT_DIR / f"libparent_{name}.so" for name in psrc}
        for wrapper, fn in parent_entries(libs).items():
            fns[f"parent {wrapper}"] = (lambda f: lambda: f(*args))(fn)
            shape[f"parent {wrapper}"] = ("stores in device memory" if wrapper.endswith("16")
                                          else shape[wrapper])
    want = {"map_windowed": tm.map_windowed(*args), "map_windowed16": tm.map_windowed16(*args)}
    want["map_v3"] = want["map_windowed"]
    for name, fn in fns.items():
        wrapper = next(w for w in ENTRIES if w in name.split())
        if not any(name.endswith(v) for v in NOT_LLRS) and not torch.equal(fn(), want[wrapper]):
            raise AssertionError(f"{name}: LLRs differ from the kernel's at the bench shape")
    ms = time_in_turn(fns, shape, f"at B={B} K={K} L={L} T={T} (N={n}); each timed alone "
                      f"after an L2 flush, in turn; LLRs equal to the kernel's but for "
                      f"{', '.join(NOT_LLRS)}:")
    res = {"ms": ms, "usage": usage, "sass": sass}
    if parent:
        res["decode"] = decode_in_turn("map_windowed16", "bf16",
                                       parent_entries(libs)["map_windowed16"], "windowed_kernel")
        print_decode("SISO decode of 128 subframes at 100 PRB 64QAM (TBS 75376), 30 dB, "
                     "n_iter 4, TURBO_KERNEL=bf16, in turn:", "map_windowed16", res["decode"])
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", help="an unpacked tree of commit 43eea58")
    measure(ap.parse_args().parent)


if __name__ == "__main__":
    main()
