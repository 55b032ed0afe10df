"""``map_fused16`` on the card beside build-time variants of its kernel and,
with ``--parent DIR``, the kernel it replaced.

Builds ``csrc/turbo_fused16.cu`` once for each variant of ``VARIANTS``,
with that variant's ``FUSED16_*`` switches (``nvcc -D``), each launched with
its own launch geometry (``variant_geometry``):

- ``loads_only``: every ring fill, shared-memory read and LLR store of the
  kernel, with one bf16 add per step in place of the trellis arithmetic;
- ``compute_only``: the arithmetic and the LLR stores, with the ring never
  filled (the steps run on whatever the ring holds);
- ``coop_fill``: each warp fills its ring slot with one 16-byte
  ``cp.async`` a thread (8 threads a gamma row) in place of four 4-byte ones
  a thread; it holds only where N % 4 == 0 and no tile is ragged, as at the
  bench shape;
- ``ring2``, ``ring4``: a gamma ring of 2 or 4 row pairs (the kernel: 8);
- ``full_stores``: every phase-1 metric stored (the kernel stores every
  other and recomputes the one between);
- ``tile64``, ``tile128``: 64 or 128 lanes a block (the kernel: 32);
- ``ring4_full_tile64``: the three together, the design first planned.

``--parent DIR`` names an unpacked tree of commit edc98d6, whose
``csrc/turbo_fused.cu`` holds the kernel that this one replaced (its stores
in device memory; the C entry ``turbo_map_fused16`` with 7 pointers and 5
ints); another tree is refused.  That kernel is timed beside the others,
and the SISO v9 decode (``decode_in_turn``) runs with either kernel in the
decoder's place, in turn.

At the 20 MHz bench shape (B = 1,664 blocks of K = 5,824, L = 208, T = 32)
every variant whose outputs are LLRs, and the parent's kernel, must equal
the kernel exactly.  Each is timed alone after an L2 flush, all in turn
(forward, then backward).  Prints each build's registers and spills
(``ptxas -v``) and the SASS opcode counts (``cuobjdump``) of the kernel and
of the parent's.

    python -m srsran_4g_tpu_torch.tools.fused16_split [--parent DIR]
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import shutil
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
VARIANT_DIR = build.BUILD_DIR / "fused16_split"
# name -> its FUSED16_* switches
VARIANTS = {
    "loads_only": {"FUSED16_LOADS_ONLY": 1},
    "compute_only": {"FUSED16_COMPUTE_ONLY": 1},
    "coop_fill": {"FUSED16_COOP_FILL": 1},
    "ring2": {"FUSED16_STAGES": 2},
    "ring4": {"FUSED16_STAGES": 4},
    "full_stores": {"FUSED16_EVERY": 1},
    "tile64": {"FUSED16_TILE": 64},
    "tile128": {"FUSED16_TILE": 128},
    "ring4_full_tile64": {"FUSED16_STAGES": 4, "FUSED16_EVERY": 1, "FUSED16_TILE": 64},
}
NOT_LLRS = ("loads_only", "compute_only")


def variant_flags(name: str) -> list[str]:
    return [f"-D{key}={value}" for key, value in VARIANTS[name].items()]


def variant_geometry(name: str, l_win: int) -> tuple[int, int]:
    """(lanes a block, dynamic shared-memory bytes) of a variant, as
    ``turbo_map.fused16_geometry`` gives them for the kernel."""
    d = VARIANTS[name]
    tile = d.get("FUSED16_TILE", tm.fused16_geometry(1, l_win).lanes)
    every = d.get("FUSED16_EVERY", 2)
    stages = d.get("FUSED16_STAGES", tm.FUSED16_STAGES)
    return tile, tile * (2 * 16 * -(-(l_win // 4) // every) + 2 * 16 * stages)


def _nvcc(src: Path, lib: Path, flags=()) -> subprocess.Popen:
    return subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(lib),
                             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _entry(lib: Path, name: str):
    fn = ctypes.CDLL(str(lib)).turbo_map_fused16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(gs, gp, a0, b0, t, l, nof_b, nof_w):
        n = gs.shape[1]
        tile, smem = variant_geometry(name, l)
        out = gs.new_empty((l, n))
        err = fn(*(x.data_ptr() for x in (gs, gp, a0, b0, out)), n, t, l, nof_b, nof_w,
                 tile, smem, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out

    return call


def _parent_entry(lib: Path):
    """The parent's kernel under the wrapper contract of its tree: two
    (L/4, 8, N) bf16 stores in device memory, allocated on every call."""
    fn = ctypes.CDLL(str(lib)).turbo_map_fused16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(gs, gp, a0, b0, t, l, nof_b, nof_w):
        n = gs.shape[1]
        out = gs.new_empty((l, n))
        stores = [gs.new_empty((l // 4, 8, n), dtype=torch.bfloat16) for _ in range(2)]
        err = fn(*(x.data_ptr() for x in (gs, gp, a0, b0, *stores, out)), n, t, l, nof_b,
                 nof_w, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent's turbo_map_fused16: CUDA error {err}")
        return out

    return call


def parent_source(parent: str) -> Path:
    src = Path(parent) / "srsran_4g_tpu_torch" / "csrc" / "turbo_fused.cu"
    if not src.exists() or "fused_kernel<2, __nv_bfloat16, true>" not in src.read_text():
        raise ValueError(f"--parent {parent}: not a tree of commit edc98d6 (its "
                         f"turbo_fused.cu holds no bf16 map_fused16 kernel)")
    return src


def inputs(device=None, seed: int = 0):
    """The bench shape's half-iteration inputs from random gammas (N(0, 3²))."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lsa, lp = (torch.as_tensor((rng.standard_normal((B, K)) * 3).astype(np.float32), device=dev)
               for _ in range(2))
    ts, tp = (torch.as_tensor(rng.standard_normal((B, 3)).astype(np.float32), device=dev)
              for _ in range(2))
    return turbo._windowed_inputs(lsa, lp, ts, tp, L, T)[:4] + (T, L, B, K // L)


def sass_counts(lib: Path, *patterns: str) -> collections.Counter:
    """Opcode counts of the SASS of the kernels in ``lib`` whose mangled
    name holds every one of ``patterns``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    counts, inside = collections.Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = all(p in line for p in patterns)
        elif inside and (m := re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                                       line)):
            counts[m.group(1)] += 1
    return counts


def decode_in_turn(parent_fn, rounds: int = 4) -> dict[str, list[float]]:
    """Host ms of the SISO v9 decode at 20 MHz (100 PRB, 64QAM, TBS 75376:
    13 code blocks of K = 5,824; 128 subframes, AWGN at 30 dB, n_iter 4),
    with this tree's ``map_fused16`` and ``parent_fn`` in the decoder's place
    in turn (kernel, parent, parent, kernel, ...), each decode exact."""
    from srsran_4g_tpu_torch.channel import awgn
    from srsran_4g_tpu_torch.models import grid, pdsch

    cfg = pdsch.PdschConfig(cell=grid.CellConfig(nof_prb=100, cell_id=123, cfi=1),
                            rnti=0x1234, subframe=4, mod="64qam", tbs=75376)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bits = torch.randint(0, 2, (128, cfg.tbs), generator=gen, device="cuda", dtype=torch.int8)
    rx = awgn.awgn(pdsch.add_crs(cfg, pdsch.encode(cfg, bits)), awgn.snr_to_noise_var(30.0),
                   generator=gen)
    calls = collections.Counter()

    def parent(*args):
        calls["parent"] += 1
        return parent_fn(*args)

    fns = {"kernel": tm.map_fused16, "parent": parent}
    ms = {who: [] for who in fns}
    before = tm.launches["map_fused16"]
    try:
        for turn in (("kernel", "parent"), ("parent", "kernel")) * (rounds // 2 + 1):
            for who in turn:
                tm.map_fused16 = fns[who]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = pdsch.decode(cfg, rx, n_iter=4)
                torch.cuda.synchronize()
                ms[who].append((time.perf_counter() - t0) * 1e3)
                if not (bool(out["crc_ok"].all()) and torch.equal(out["bits"], bits)):
                    raise AssertionError(f"SISO v9 decode with the {who}'s map_fused16: not exact")
    finally:
        tm.map_fused16 = fns["kernel"]
    if not (calls["parent"] and tm.launches["map_fused16"] > before):
        raise AssertionError("the decode did not run through map_fused16 (TURBO_KERNEL=v9)")
    return {who: t[1:] for who, t in ms.items()}  # the first of each warms up


def measure(parent: str | None = None) -> dict:
    """Build, check, time and print; returns {"ms": {name: [ms]}, "sass":
    {name: Counter}} and, with ``parent``, {"decode_ms": {who: [ms]}}."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "turbo_fused16.cu"
    procs = {name: _nvcc(src, VARIANT_DIR / f"lib{name}.so", variant_flags(name))
             for name in VARIANTS}
    if parent:
        procs["parent"] = _nvcc(parent_source(parent), VARIANT_DIR / "libparent.so")
    kernel_lib = build.build(["turbo_fused16"])["turbo_fused16"]
    logs = {"kernel": kernel_lib.with_suffix(".log").read_text()}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
    for name, text in logs.items():
        print(f"  {name}: " + "; ".join(line.replace("ptxas info", "").strip(" :")
                                        for line in text.splitlines()
                                        if "registers" in line or "spill" in line))
    args = inputs()
    fns = {"kernel": lambda: tm.map_fused16(*args)}
    for name in VARIANTS:
        fns[name] = (lambda f: lambda: f(*args))(_entry(VARIANT_DIR / f"lib{name}.so", name))
    if parent:
        fns["parent"] = (lambda f: lambda: f(*args))(_parent_entry(VARIANT_DIR / "libparent.so"))
    want = fns["kernel"]()
    for name, fn in fns.items():
        if name not in NOT_LLRS and not torch.equal(fn(), want):
            raise AssertionError(f"{name}: LLRs differ from the kernel's at the bench shape")
    ms = {name: [] for name in fns}
    for turn in (list(fns), list(fns)[::-1]):
        for name in turn:
            ms[name].append(event_ms(fns[name], iters=20, warmup=2))
    n = args[0].shape[1]
    print(f"map_fused16 at B={B} K={K} L={L} T={T} (N={n}); each timed alone after an "
          f"L2 flush, in turn; LLRs equal to the kernel's but for {', '.join(NOT_LLRS)}:")
    geo = tm.fused16_geometry(n, L)
    shape = {"kernel": f"{geo.lanes} lanes, {geo.smem_bytes} B shared a block",
             "parent": "128 lanes a block, stores in device memory",
             **{name: "{} lanes, {} B shared a block".format(*variant_geometry(name, L))
                for name in VARIANTS}}
    for name, t in ms.items():
        print(f"  {name:18s} {shape[name]:45s} {', '.join(f'{x:.4f}' for x in t)} ms")
    sass = {"kernel": sass_counts(kernel_lib, "fused16_kernel")}
    if parent:
        sass["parent"] = sass_counts(VARIANT_DIR / "libparent.so", "fused_kernelILi2E13__nv_bfloat16")
    for name, counts in sass.items():
        print(f"  SASS of the {name}: {sum(counts.values())} instructions; "
              + ", ".join(f"{op} {n}" for op, n in counts.most_common(8)))
    res = {"ms": ms, "sass": sass}
    if parent:
        res["decode_ms"] = decode_in_turn(_parent_entry(VARIANT_DIR / "libparent.so"))
        print("SISO v9 decode of 128 subframes (host clock, ms, in turn):")
        for who, t in res["decode_ms"].items():
            print(f"  {who:18s} best {min(t):.2f} ({', '.join(f'{x:.2f}' for x in t)})")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", help="an unpacked tree of commit edc98d6")
    measure(ap.parse_args().parent)


if __name__ == "__main__":
    main()
