"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so``
under the checkout, at first use; the hash of the source and of the shared
headers (``csrc/*.cuh``) names the file, so an edited source is rebuilt,
and nvcc's output (with ``-Xptxas -v``'s register and spill report) is kept
beside it as ``.log``.  Several sources
build in parallel (one ``nvcc`` process each, all started together).  No
fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: list[str]) -> dict[str, Path]:
    """Compile every named source not yet built, all ``nvcc``s at once."""
    paths = {name: library_path(name) for name in names}
    todo = [name for name, path in paths.items() if not path.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            paths[name].with_suffix(".log").write_text(log)
            os.replace(tmp, paths[name])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library."""
    return ctypes.CDLL(str(build([name])[name]))


def ptxas_usage(log: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of each kernel in an ``-Xptxas -v`` log,
    by mangled name: {name: {"registers": r, "spill_stores": s,
    "spill_loads": l}}."""
    usage, fn = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            fn = m.group(1)
            usage[fn] = {}
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            usage[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            usage[fn]["registers"] = int(m.group(1))
    return usage


def kernel_usage(log: str, pattern: str) -> dict[str, int]:
    """``ptxas_usage`` of the one kernel whose mangled name holds
    ``pattern``; raises if none or several do."""
    found = [u for name, u in ptxas_usage(log).items() if pattern in name]
    if len(found) != 1:
        raise ValueError(f"{len(found)} kernels match {pattern!r} in the build log")
    return found[0]
