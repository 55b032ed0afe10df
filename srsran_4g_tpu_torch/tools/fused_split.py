"""``map_fused`` (radix 2 and 4) on the card beside variants of its kernel
and, with ``--parent DIR``, the kernel it replaced.

``csrc/turbo_fused.cu`` is built once for each distinct set of ``FUSED_*``
switches (``nvcc -D``) and each variant launched with its own geometry
(``variant_geometry``: ``fused_geometry``'s checkpoint stride c and tile,
and the ring's bytes):

- ``every1``, ``every2``, ``every4``: a checkpoint every row pair (every
  phase-1 metric stored), every other pair or every 4 pairs (the kernel: 4
  at radix 2, 2 at radix 4);
- ``tile16``: 16 lanes a block (the kernel: 32), the alpha and beta threads
  of a block in one warp;
- ``ring8``, ``ring16``: a ring of 8 or 16 row pairs a chain (the kernel: 4);
- ``blocks7``, ``blocks8``: the registers capped for 7 or 8 blocks an SM
  (the kernel: 6, which its 30,720 B of shared memory a block would allow
  up to 7);
- ``loads_only``: every ring fill, shared-memory access and LLR store, with
  two adds a pair in place of the trellis arithmetic;
- ``compute_only``: the arithmetic and the stores, the ring never filled.

``--parent DIR`` names an unpacked tree of commit 43eea58, whose
``csrc/turbo_fused.cu`` holds the kernel this one replaced (one thread a
lane, its phase-1 stores in device memory); another tree is refused.  It
is timed beside this tree's, and the SISO decode of 128 subframes under
``TURBO_KERNEL=v7`` and ``v8`` runs with either tree's kernel in the
decoder's place, in turn, its host time and device time (torch.profiler)
taken for each.

At the 20 MHz bench shape (B = 1,664 blocks of K = 5,824, L = 208, T = 32)
every variant whose outputs are LLRs, and the parent's kernel, must equal
this tree's kernel exactly, at both radices.  Each is timed alone after an
L2 flush, all in turn (forward, then backward).  Prints each build's
registers and spills (``ptxas -v``) and the SASS opcode counts
(``cuobjdump``) of the kernel and of the parent's.

    python -m srsran_4g_tpu_torch.tools.fused_split [--parent DIR]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from srsran_4g_tpu_torch.ops.cuda import build
from srsran_4g_tpu_torch.ops.cuda import turbo_map as tm
from srsran_4g_tpu_torch.tools import windowed_split as ws

L, T = ws.L, ws.T
VARIANT_DIR = build.BUILD_DIR / "fused_split"
# name -> (its FUSED_* switches, fused_geometry's every/lanes)
VARIANTS = {
    "every1": ({}, {"every": 1}),
    "every2": ({}, {"every": 2}),
    "every4": ({}, {"every": 4}),
    "tile16": ({}, {"lanes": 16}),
    "ring8": ({"FUSED_STAGES": 8}, {}),
    "ring16": ({"FUSED_STAGES": 16}, {}),
    "blocks7": ({"FUSED_MIN_BLOCKS": 7}, {}),
    "blocks8": ({"FUSED_MIN_BLOCKS": 8}, {}),
    "loads_only": ({"FUSED_LOADS_ONLY": 1}, {}),
    "compute_only": ({"FUSED_COMPUTE_ONLY": 1}, {}),
}
NOT_LLRS = ("loads_only", "compute_only")
RADICES = (2, 4)


def variant_flags(name: str) -> list[str]:
    return [f"-D{key}={value}" for key, value in VARIANTS[name][0].items()]


def variant_geometry(name: str, n: int, l_win: int, radix: int) -> tm.WindowedGeometry:
    """A variant's launch: ``fused_geometry`` with the variant's every or
    lanes, and the shared bytes of its ring."""
    defines, force = VARIANTS[name]
    geo = tm.fused_geometry(n, l_win, radix, **force)
    stages = defines.get("FUSED_STAGES", tm.FUSED_STAGES)
    return geo._replace(smem_bytes=tm.fused_smem(l_win, geo.lanes, geo.every, stages))


def build_name(name: str) -> str | None:
    """The name of the build a variant runs, one for each set of switches
    (None: the kernel's own)."""
    defines = VARIANTS[name][0]
    return "_".join(f"{k[6:].lower()}{v}" for k, v in sorted(defines.items())) or None


def library(name: str) -> Path:
    """The build a variant runs."""
    if build_name(name):
        return VARIANT_DIR / f"lib{build_name(name)}.so"
    return build.build(["turbo_fused"])["turbo_fused"]


def variant_entry(name: str, n: int, radix: int):
    """A variant of the kernel under ``map_fused``'s contract, at N lanes,
    the bench window and ``radix``."""
    fn = ws.bind(library(name), "turbo_map_fused", 5, 9)
    geo = variant_geometry(name, n, L, radix)

    def run(gs, gp, a0, b0, t, l, nof_b, nof_w):
        out = gs.new_empty((l, gs.shape[1]))
        ws.call(fn, f"map_fused {name}", gs, gp, a0, b0, out, gs.shape[1], t, l, nof_b, nof_w,
                radix, geo.lanes, geo.every, geo.smem_bytes)
        return out

    return run


def parent_source(parent: str) -> Path:
    src = Path(parent) / "srsran_4g_tpu_torch" / "csrc" / "turbo_fused.cu"
    if not src.exists() or "astore, bstore" not in src.read_text():
        raise ValueError(f"--parent {parent}: not a tree of commit 43eea58 (its "
                         f"turbo_fused.cu keeps its stores in device memory)")
    return src


def parent_entry(lib: Path):
    """The parent's kernel under the wrapper contract of its tree: two
    (L/4, 8, N) f32 stores in device memory, allocated on every call."""
    fn = ws.bind(lib, "turbo_map_fused", 7, 6)

    def run(gs, gp, a0, b0, t, l, nof_b, nof_w, radix):
        n = gs.shape[1]
        out = gs.new_empty((l, n))
        stores = [gs.new_empty((l // 4, 8, n)) for _ in range(2)]
        ws.call(fn, "the parent's map_fused", gs, gp, a0, b0, *stores, out, n, t, l, nof_b,
                nof_w, radix)
        return out

    return run


def measure(parent: str | None = None) -> dict:
    """Build, check, time and print; returns {"ms": {name: [ms]}, "usage":
    {build: {kernel: registers and spills}}, "sass": {kernel: Counter}} and,
    with ``parent``, {"decode": {TURBO_KERNEL: decode_in_turn's}}."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "turbo_fused.cu"
    procs = {build_name(name): ws.nvcc(src, library(name), variant_flags(name))
             for name in VARIANTS if build_name(name)}
    if parent:
        procs["parent"] = ws.nvcc(parent_source(parent), VARIANT_DIR / "libparent.so")
    kernel_lib = build.build(["turbo_fused"])["turbo_fused"]
    logs = {"kernel": kernel_lib.with_suffix(".log").read_text()}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
    usage = {name: build.ptxas_usage(text) for name, text in logs.items()}
    ws.print_usage(usage)

    args = ws.inputs()
    n = args[0].shape[1]
    geo = {r: tm.fused_geometry(n, L, r) for r in RADICES}
    sass = {f"r{r}": ws.print_sass(kernel_lib, f"fused_kernelILi{geo[r].every}ELi{r}E")
            for r in RADICES}
    if parent:
        for r in RADICES:
            sass[f"parent r{r}"] = ws.print_sass(VARIANT_DIR / "libparent.so",
                                                 f"fused_kernelILi{r}Ef")
    fns, shape = {}, {}
    for r in RADICES:
        fns[f"r{r}"] = (lambda r: lambda: tm.map_fused(*args, radix=r))(r)
        shape[f"r{r}"] = f"{geo[r].lanes} lanes, c={geo[r].every}, {geo[r].smem_bytes} B"
        for name in VARIANTS:
            fns[f"r{r} {name}"] = (lambda f: lambda: f(*args))(variant_entry(name, n, r))
            g = variant_geometry(name, n, L, r)
            shape[f"r{r} {name}"] = f"{g.lanes} lanes, c={g.every}, {g.smem_bytes} B"
        if parent:
            fns[f"r{r} parent"] = (lambda f, r: lambda: f(*args, r))(
                parent_entry(VARIANT_DIR / "libparent.so"), r)
            shape[f"r{r} parent"] = "stores in device memory"
    want = {r: tm.map_fused(*args, radix=r) for r in RADICES}
    for name, fn in fns.items():
        if not any(name.endswith(v) for v in NOT_LLRS) and not torch.equal(
                fn(), want[int(name[1])]):
            raise AssertionError(f"{name}: LLRs differ from the kernel's at the bench shape")
    ms = ws.time_in_turn(fns, shape, f"map_fused at B={ws.B} K={ws.K} L={L} T={T} (N={n}); "
                         f"each timed alone after an L2 flush, in turn; LLRs equal to the "
                         f"kernel's but for {', '.join(NOT_LLRS)}:")
    res = {"ms": ms, "usage": usage, "sass": sass}
    if parent:
        res["decode"] = {}
        for kernel, r in (("v7", 2), ("v8", 4)):
            d = ws.decode_in_turn("map_fused", kernel, parent_entry(VARIANT_DIR / "libparent.so"),
                                  "fused_kernel")
            res["decode"][kernel] = d
            ws.print_decode(f"SISO decode of 128 subframes at 100 PRB 64QAM (TBS 75376), 30 dB, "
                            f"n_iter 4, TURBO_KERNEL={kernel}, in turn:", "map_fused", d)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", help="an unpacked tree of commit 43eea58")
    measure(ap.parse_args().parent)


if __name__ == "__main__":
    main()
