"""``map_windowed``, ``map_v3`` and ``map_windowed16`` on the card beside
variants of their kernel.

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

At the 20 MHz bench shape (B = 1,664 blocks of K = 5,824, L = 208, T = 32)
every variant whose outputs are LLRs must equal this tree's kernel
exactly.  Each is timed alone after an L2 flush, all in turn (forward, then
backward), beside each kernel's bound (``tools/turbo_kernel_bench``).
Prints each build's registers and spills (``ptxas -v``) and the SASS opcode
counts (``cuobjdump``) of the kernels at the bench geometry.

    python -m srsran_4g_tpu_torch.tools.windowed_split
"""

from __future__ import annotations

import collections
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.ops import turbo
from srsran_4g_tpu_torch.ops.cuda import build
from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm
from srsran_4g_tpu_torch.tools import event_ms, turbo_kernel_bench

B, K, L, T = 1664, 5824, 208, 32
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


def inputs(device=None, seed: int = 0):
    """The bench shape's half-iteration inputs from random gammas (N(0, 3²))."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lsa, lp = (torch.as_tensor((rng.standard_normal((B, K)) * 3).astype(np.float32), device=dev)
               for _ in range(2))
    ts, tp = (torch.as_tensor(rng.standard_normal((B, 3)).astype(np.float32), device=dev)
              for _ in range(2))
    return turbo._windowed_inputs(lsa, lp, ts, tp, L, T)[:4] + (T, L, B, K // L)


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


def measure() -> dict:
    """Build, check, time and print; returns {"ms": {name: [ms]}, "usage":
    {build: {kernel: registers and spills}}, "sass": {kernel: Counter},
    "bound_ms": {wrapper: its bound at the bench shape}}."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "turbo_windowed.cu"
    procs = {build_name(name): nvcc(src, library(name), variant_flags(name))
             for name in VARIANTS if build_name(name)}
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
    fns, shape, bounds = {}, {}, {}
    for wrapper in ENTRIES:
        fns[wrapper] = (lambda f: lambda: f(*args))(getattr(tm, wrapper))
        geo = geometry(wrapper, n, L, T)
        route = "turbo_map" if wrapper == "map_windowed" else wrapper
        bounds[wrapper] = turbo_kernel_bench.route_bound((route,), B, K, L, T)[0]
        shape[wrapper] = (f"{geo.lanes} lanes, c={geo.every}, {geo.smem_bytes} B, "
                          f"bound {bounds[wrapper]:.4f} ms")
        for name in VARIANTS:
            if applies(name, wrapper):
                key = f"{wrapper} {name}"
                fns[key] = (lambda f: lambda: f(*args))(variant_entry(name, wrapper, n))
                g = variant_geometry(name, wrapper, n, L, T)
                shape[key] = f"{g.lanes} lanes, c={g.every}, {g.smem_bytes} B"
    want = {"map_windowed": tm.map_windowed(*args), "map_windowed16": tm.map_windowed16(*args)}
    want["map_v3"] = want["map_windowed"]
    for name, fn in fns.items():
        wrapper = next(w for w in ENTRIES if w in name.split())
        if not any(name.endswith(v) for v in NOT_LLRS) and not torch.equal(fn(), want[wrapper]):
            raise AssertionError(f"{name}: LLRs differ from the kernel's at the bench shape")
    ms = time_in_turn(fns, shape, f"at B={B} K={K} L={L} T={T} (N={n}); each timed alone "
                      f"after an L2 flush, in turn; LLRs equal to the kernel's but for "
                      f"{', '.join(NOT_LLRS)}:")
    return {"ms": ms, "usage": usage, "sass": sass, "bound_ms": bounds}


def main() -> None:
    measure()


if __name__ == "__main__":
    main()
