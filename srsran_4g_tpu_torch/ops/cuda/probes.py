"""Hopper micro-benchmark kernels of the max-log-MAP ACS recursion and of a
launch: the port's counterparts of the TPU probes ``tools/turbo_probe2.py``,
``turbo_probe3.py``, ``turbo_probe6.py`` and ``turbo_probe7.py``.

Each wrapper launches its kernel (``csrc/probe_acs.cu``,
``csrc/probe_launch.cu``) on CUDA tensors and runs its plain torch version
(``*_ref``, the same arithmetic in the same order) on CPU tensors only; there
is no fallback from one to the other.  The port's one launch counter,
``turbo_map.launches[name]``, counts the kernel launches of each
probe kernel (names in ``KERNELS``).

- ``probe2``: the radix-4 alpha sweep of ``turbo_probe2.py`` in twelve
  bodies (``PROBE2_VARIANTS``) that keep or drop its gamma loads, ACS
  arithmetic and alpha stores; output row 0 only, as the TPU body writes it.
  ``astore`` keeps its alpha store in shared memory, a ring a lane, as the
  TPU body kept it in VMEM; ``probe2_geometry`` gives each body's launch.
- ``probe_empty``: ``turbo_probe3.py``'s empty kernel (row 0 of the first
  input to row 0 of the output) at a chosen block size and dynamic
  shared-memory request.
- ``probe6_full``, ``probe6_skel``, ``probe6_bf16``: ``turbo_probe6.py``'s
  radix-4 alpha+beta pair, its serial skeleton, and the pair in bf16 with two
  lane groups packed in ``__nv_bfloat162``.
- ``probe7``: ``turbo_probe7.py``'s radix-2 op mix, f32 one lane a thread or
  bf16 two lanes a thread.

The bf16 plain versions compute in torch bf16, which rounds every op as the
kernels' ``__hadd2``/``__hsub2`` do, so they agree exactly.  ``work`` gives
the bytes and operations each kernel's output needs, for its bound.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from srsran_4g_tpu_torch.ops.cuda.turbo_map import _launch
from srsran_4g_tpu_torch.ops.turbo import _trellis

PROBE2_VARIANTS = ("full", "fixedrow", "block8", "loadsonly", "acsonly", "unroll4",
                   "astore", "empty", "load1", "addchain", "addpar", "load1x")
KERNELS = (tuple(f"probe2_{v}" for v in PROBE2_VARIANTS)
           + ("probe3_empty", "probe6_full", "probe6_skel", "probe6_bf16",
              "probe7_f32", "probe7_bf16"))

# TPU function each kernel replaces, file:line of its pallas_call
REPLACES = dict({f"probe2_{v}": "tools/turbo_probe2.py:40" for v in PROBE2_VARIANTS},
                probe3_empty="tools/turbo_probe3.py:26",
                probe6_full="tools/turbo_probe6.py:111",
                probe6_skel="tools/turbo_probe6.py:144",
                probe6_bf16="tools/turbo_probe6.py:231",
                probe7_f32="tools/turbo_probe7.py:66",
                probe7_bf16="tools/turbo_probe7.py:66")
# probe7's wiring (turbo_probe7.py A_SRC, A_CMB): state s takes the max of
# a[A_SRC[s][k]] + combo A_CMB[s][k], combos (none, g0, g1, g0 + g1)
A_SRC = ((0, 4), (4, 0), (1, 5), (5, 1), (2, 6), (6, 2), (3, 7), (7, 3))
A_CMB = ((0, 3), (3, 0), (3, 0), (0, 3), (1, 2), (2, 1), (2, 1), (1, 2))


# --- tables ------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _fill_tables() -> tuple[np.ndarray, np.ndarray]:
    """turbo_probe2's radix-4 tables (``_tables_r4`` a_pred, a_c): for target
    state s the j-th two-step predecessor found (p ascending, then u1, u2)
    and the path's gamma coefficients (u1, p1, u2, p2)."""
    t = _trellis()
    ns, par = t["ns"], t["par"]
    pred, coef = np.zeros((8, 4), np.int64), np.zeros((8, 4, 4), np.int64)
    fill = np.zeros(8, np.int64)
    for p in range(8):
        for u1 in (0, 1):
            m = ns[p, u1]
            for u2 in (0, 1):
                s = ns[m, u2]
                pred[s, fill[s]] = p
                coef[s, fill[s]] = (u1, par[p, u1], u2, par[m, u2])
                fill[s] += 1
    return pred, coef


@functools.lru_cache(maxsize=1)
def _path_tables() -> tuple[np.ndarray, ...]:
    """turbo_probe6's path-labelled tables, j = 2·u1 + u2: alpha's two-step
    predecessor and beta's two-step successor of each state, and the index
    k = 2·p1 + p2 of the path's parity bits."""
    t = _trellis()
    ns, par = t["ns"], t["par"]
    pred, nxt = np.zeros((8, 4), np.int64), np.zeros((8, 4), np.int64)
    pk, nk = np.zeros((8, 4), np.int64), np.zeros((8, 4), np.int64)
    for p in range(8):
        for j in range(4):
            u1, u2 = j >> 1, j & 1
            m = ns[p, u1]
            s = ns[m, u2]
            k = 2 * par[p, u1] + par[m, u2]
            pred[s, j], pk[s, j] = p, k
            nxt[p, j], nk[p, j] = s, k
    return pred, pk, nxt, nk


# --- plain versions -----------------------------------------------------------


def _probe2_acs(a, g0s, g0p, g1s, g1p):
    """turbo_probe2's alpha_r4 on a (8, N): candidates alpha[pred] + the
    left-to-right sum of the path's gamma terms, max, minus the max state."""
    pred, coef = _fill_tables()
    rows = (g0s, g0p, g1s, g1p)
    terms = {}
    for c in {tuple(int(x) for x in cs) for cs in coef.reshape(-1, 4)}:
        present = [r for bit, r in zip(c, rows) if bit]
        t = present[0] if present else torch.zeros_like(g0s)
        for r in present[1:]:
            t = t + r
        terms[c] = t
    term = torch.stack([torch.stack([terms[tuple(int(x) for x in coef[s, j])]
                                     for j in range(4)]) for s in range(8)])
    c = a[torch.as_tensor(pred, device=a.device)] + term  # (8, 4, N)
    new = c.amax(dim=1)
    return new - new.amax(dim=0, keepdim=True)


def probe2_ref(variant: str, gs, gp, a0, n_steps: int, out_rows: int,
               store_rows: int) -> torch.Tensor:
    """Plain version of ``probe2``: (out_rows, N), row 0 defined."""
    del store_rows  # the store changes no output
    a = a0.clone()
    if variant in ("full", "astore"):
        for i in range(n_steps):
            a = _probe2_acs(a, gs[2 * i], gp[2 * i], gs[2 * i + 1], gp[2 * i + 1])
    elif variant == "fixedrow":
        for _ in range(n_steps):
            a = _probe2_acs(a, gs[0], gp[0], gs[1], gp[1])
    elif variant in ("block8", "unroll4"):
        for j in range(n_steps // 4):
            for u in range(4):
                r = 8 * j + 2 * u
                a = _probe2_acs(a, gs[r], gp[r], gs[r + 1], gp[r + 1])
    elif variant == "loadsonly":
        acc = a[0]
        for i in range(n_steps):
            acc = acc + gs[2 * i] + gp[2 * i] + gs[2 * i + 1] + gp[2 * i + 1]
        a = acc[None]
    elif variant == "acsonly":
        for _ in range(n_steps):
            a = _probe2_acs(a, gs[0], gs[0], gs[0], gs[0])
    elif variant == "empty":
        a = gs[0:1]
    elif variant == "load1":
        acc = a[0]
        for i in range(n_steps):
            acc = acc + gs[2 * i]
        a = acc[None]
    elif variant in ("addchain", "addpar"):
        for _ in range(n_steps):
            for _ in range(8 if variant == "addchain" else 2):
                a = a + gs[0]
    elif variant == "load1x":
        for i in range(n_steps):
            a = a + gs[2 * i]
    else:
        raise ValueError(f"unknown probe2 variant {variant!r}")
    out = gs.new_zeros((out_rows, gs.shape[1]))
    out[0] = a[0]
    return out


def probe_empty_ref(inputs, out_rows: int) -> torch.Tensor:
    """Plain version of ``probe_empty``: (out_rows, N), row 0 = inputs[0]'s."""
    out = inputs[0].new_zeros((out_rows, inputs[0].shape[1]))
    out[0] = inputs[0][0]
    return out


def _probe6_acs(x, g0s, g0p, g1s, g1p, beta: bool, norm_group0: bool = False):
    """turbo_probe6's alpha_r4 / beta_r4 on x (..., 8, L) with gamma rows
    (..., L): candidate j of state s is (x[pred] + p-row k) + u-row j, max,
    minus state 0 (for make_bf16, whose lane groups are x's leading
    dimension, minus group 0's state 0 in both groups)."""
    pred, pk, nxt, nk = _path_tables()
    idx, k = (nxt, nk) if beta else (pred, pk)
    dev = x.device
    zero = torch.zeros_like(g0s)
    prow = torch.stack([zero, g1p, g0p, g0p + g1p], dim=-2)  # (..., 4, L)
    urow = torch.stack([zero, g1s, g0s, g0s + g1s], dim=-2)
    c = (x[..., torch.as_tensor(idx, device=dev), :]
         + prow[..., torch.as_tensor(k, device=dev), :])  # (..., 8, 4, L)
    c = c + urow[..., None, :, :]
    new = torch.maximum(torch.maximum(c[..., 0, :], c[..., 1, :]),
                        torch.maximum(c[..., 2, :], c[..., 3, :]))
    z = new[..., 0:1, :]
    return new - (z[0:1] if norm_group0 else z)


def probe6_full_ref(g2s, g2p, a0, b0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``probe6_full``: g2s, g2p (S, 2, N); a0, b0 (8, N)."""
    a, b = a0, b0
    steps = g2s.shape[0]
    for i in range(steps):
        a = _probe6_acs(a, g2s[i, 0], g2p[i, 0], g2s[i, 1], g2p[i, 1], beta=False)
        r = steps - 1 - i
        b = _probe6_acs(b, g2s[r, 0], g2p[r, 0], g2s[r, 1], g2p[r, 1], beta=True)
    return a, b


def probe6_bf16_ref(g2s, g2p, a0, b0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``probe6_bf16``: g2s, g2p (S, 2, 2, H) bf16
    [step][row][group][lane]; a0, b0 (16, H) bf16, rows 8g + s."""
    h = a0.shape[1]
    a, b = a0.view(2, 8, h), b0.view(2, 8, h)
    steps = g2s.shape[0]
    for i in range(steps):
        r = steps - 1 - i
        a = _probe6_acs(a, g2s[i, 0], g2p[i, 0], g2s[i, 1], g2p[i, 1], beta=False,
                        norm_group0=True)
        b = _probe6_acs(b, g2s[r, 0], g2p[r, 0], g2s[r, 1], g2p[r, 1], beta=True,
                        norm_group0=True)
    return a.reshape(16, h), b.reshape(16, h)


def probe6_skel_ref(a0, b0, steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``probe6_skel``: candidate j is x[pred] + j."""
    pred, _, nxt, _ = _path_tables()
    dev = a0.device
    jcol = torch.arange(4, dtype=a0.dtype, device=dev)[None, :, None]
    out = []
    for x, idx in ((a0, pred), (b0, nxt)):
        idx = torch.as_tensor(idx, device=dev)
        for _ in range(steps):
            c = x[idx] + jcol
            new = torch.maximum(torch.maximum(c[:, 0], c[:, 1]),
                                torch.maximum(c[:, 2], c[:, 3]))
            x = new - new[0:1]
        out.append(x)
    return out[0], out[1]


def probe7_ref(g, a0, iters: int) -> torch.Tensor:
    """Plain version of ``probe7``: g (2, n), a0 (8, n) of f32 or bf16."""
    dev = a0.device
    combos = torch.stack([torch.zeros_like(g[0]), g[0], g[1], g[0] + g[1]])
    src = torch.as_tensor(A_SRC, device=dev)
    cmb = combos[torch.as_tensor(A_CMB, device=dev)]  # (8, 2, n)
    a = a0
    for _ in range(iters):
        for _ in range(2):
            c = a[src] + cmb
            a = torch.maximum(c[:, 0], c[:, 1])
        a = a - a[0:1]
    return a


# --- wrappers -------------------------------------------------------------------


def _check(name: str, tensors, dtype, shapes) -> bool:
    """Raise on inputs the kernel does not take; True for CUDA tensors."""
    for x, shape in zip(tensors, shapes):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: an input has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
    if any(x.dtype != dtype for x in tensors):
        raise TypeError(f"{name} takes {dtype} tensors")
    device = tensors[0].device
    if any(x.device != device for x in tensors):
        raise ValueError(f"{name} inputs lie on different devices")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU, not {device}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    return True


# the H100's largest dynamic shared memory a block may ask for (227 KB):
# more than half an SM's 228 KB, so one block per SM
ONE_BLOCK_PER_SM_SMEM = 232448
# an H100 SM: its shared memory (228 KB, of which each resident block
# reserves 1 KB), threads and blocks; the SM count of the H100 SXM
SM_SMEM, BLOCK_RESERVED_SMEM, SM_THREADS, SM_BLOCKS, SMS = 233472, 1024, 2048, 32, 132
# probe2's blocks (the launch bounds of csrc/probe_acs.cu's kernels, which
# its entry checks): the ten bodies of probe2_kernel, full's (one warp) and
# astore's largest; astore's gamma stages (kP2StoreDepth + 1 there), a
# float4 a lane each, which the entry checks the shared bytes against
PROBE2_THREADS, PROBE2_FULL_LANES, PROBE2_MAX_LANES = 128, 32, 256
PROBE2_STORE_STAGES = 13


class Probe2Geometry(NamedTuple):
    lanes: int       # lanes a tile and a block, one thread each
    smem_bytes: int  # dynamic shared memory a block: astore's gamma stages and ring
    tiles: int       # ceil(N / lanes), the last one ragged
    blocks: int      # the grid: block b takes tiles b, b + blocks, ...
    per_sm: int      # blocks an SM holds at once (shared memory, threads, blocks)
    rounds: int      # the most tiles a block takes


def probe2_geometry(variant: str, n: int, store_rows: int, sms: int = SMS) -> Probe2Geometry:
    """``probe2``'s launch of body ``variant`` on n lanes over ``sms`` SMs.
    ``astore`` keeps a ring of ``store_rows`` rows of 8 f32 a lane (32 B a
    row) and its gamma stages (16 B a lane and stage,
    ``PROBE2_STORE_STAGES``) in shared memory, so a block holds at most
    232,448 / (32 · store_rows + 208) lanes (256 at most), and one SM as
    many such blocks as its 228 KB hold.  It runs one block on each of
    them, all resident, block b taking tiles b, b + blocks, ...; its tiles
    are as wide as they must be for the fewest rounds, and no wider, so that
    the rounds come out even (110 lanes at the probe's 86,528 lanes and 56
    rows: 787 tiles on 132 blocks, one an SM, 6 rounds).  Raises
    ``ValueError`` when one lane does not fit a block (store_rows > 7,257):
    there is no device-memory store to fall back to.  The other bodies run a
    block a tile: ``full`` tiles of one warp (2,704 at the probe's shape: 20
    or 21 an SM, where 128-lane blocks put 6 on 16 SMs against a mean of
    5.12), the rest of 128 lanes.  ``per_sm`` counts shared memory,
    threads and the block limit, not registers (``full``'s launch bounds
    keep 21 of its blocks an SM, one round at the probe's shape)."""
    if n < 0 or store_rows < 1 or sms < 1:
        raise ValueError(f"probe2_geometry: n={n}, store_rows={store_rows}, sms={sms}")

    def per_sm(lanes: int, smem: int) -> int:
        warps = -(-lanes // 32)
        by_smem = SM_SMEM // (smem + BLOCK_RESERVED_SMEM) if smem else SM_BLOCKS
        return min(by_smem, SM_THREADS // (32 * warps), SM_BLOCKS)

    if variant == "astore":
        per_lane = 32 * store_rows + 16 * PROBE2_STORE_STAGES
        if per_lane > ONE_BLOCK_PER_SM_SMEM:
            raise ValueError(f"probe2 astore: a ring of {store_rows} rows takes "
                             f"{per_lane} B a lane with its gamma stages, above a "
                             f"block's {ONE_BLOCK_PER_SM_SMEM} B of shared memory")
        widest = min(PROBE2_MAX_LANES, ONE_BLOCK_PER_SM_SMEM // per_lane)
        k = per_sm(widest, widest * per_lane)
        rounds = max(1, -(-(-(-n // widest)) // (sms * k)))
        lanes = max(1, -(-n // (sms * k * rounds)))
        smem = lanes * per_lane
    elif variant in PROBE2_VARIANTS:
        lanes, smem = (PROBE2_FULL_LANES if variant == "full" else PROBE2_THREADS), 0
    else:
        raise ValueError(f"unknown probe2 variant {variant!r}")
    tiles = -(-n // lanes)
    k = per_sm(lanes, smem)
    blocks = max(1, min(tiles, sms * k) if variant == "astore" else tiles)
    return Probe2Geometry(lanes, smem, tiles, blocks, k, -(-tiles // blocks))


# each probe2 body's last launch on the card: {variant: Probe2Geometry}
probe2_launched: dict[str, Probe2Geometry] = {}


def probe2(variant: str, gs, gp, a0, n_steps: int, out_rows: int,
           store_rows: int) -> torch.Tensor:
    """turbo_probe2's body ``variant`` over gs, gp (rows, N) f32 (the probe
    passes one array as both) and a0 (8, N) f32 → (out_rows, N), of which
    only row 0 is written.  n_steps radix-4 steps read rows 0..2·n_steps-1;
    ``astore`` stores alpha before each step into row i % store_rows of a
    ring a lane in shared memory, which nothing reads.  On the card the
    launch is ``probe2_geometry``'s (which raises where a ring does not
    fit), kept in ``probe2_launched``; the plain version takes any ring."""
    if variant not in PROBE2_VARIANTS:
        raise ValueError(f"unknown probe2 variant {variant!r}")
    rows, n = gs.shape
    if rows < max(2 * n_steps, 2) or n_steps < 0 or out_rows < 1 or store_rows < 1:
        raise ValueError(f"probe2: {rows} gamma rows, {n_steps} steps, "
                         f"{out_rows} output rows, {store_rows} store rows")
    args = (variant, gs, gp, a0, n_steps, out_rows, store_rows)
    if not _check("probe2", (gs, gp, a0), torch.float32, ((rows, n), (rows, n), (8, n))):
        return probe2_ref(*args)
    sms = torch.cuda.get_device_properties(gs.device).multi_processor_count
    geo = probe2_geometry(variant, n, store_rows, sms)  # raises where a ring cannot fit
    out = gs.new_empty((out_rows, n))
    _launch(f"probe2_{variant}", "probe_acs", "probe2", 4, 7, gs, gp, a0, out, n, n_steps,
            store_rows, PROBE2_VARIANTS.index(variant), geo.lanes, geo.smem_bytes,
            geo.blocks)
    probe2_launched[variant] = geo
    return out


def probe_empty(inputs, out_rows: int, threads: int = 1024,
                smem: int = 0) -> torch.Tensor:
    """turbo_probe3's empty kernel: inputs, one or two (rows, N) f32 (only
    the first is read) → (out_rows, N), of which row 0 = inputs[0][0].
    ``threads`` a block, ``smem`` bytes of dynamic shared memory a block."""
    if len(inputs) not in (1, 2) or out_rows < 1:
        raise ValueError("probe_empty takes one or two inputs and out_rows >= 1")
    n = inputs[0].shape[1]
    if not _check("probe_empty", inputs, torch.float32,
                  [(x.shape[0], n) for x in inputs]):
        return probe_empty_ref(inputs, out_rows)
    out = inputs[0].new_empty((out_rows, n))
    _launch("probe3_empty", "probe_launch", "probe_empty", 3, 3, inputs[0], inputs[-1],
            out, n, threads, smem)
    return out


def probe6_full(g2s, g2p, a0, b0) -> tuple[torch.Tensor, torch.Tensor]:
    """turbo_probe6's make_full: g2s, g2p (S, 2, N) f32 ([step][row 2i or
    2i+1][lane]), a0, b0 (8, N) f32 → alpha, beta after S steps (8, N)."""
    steps, _, n = g2s.shape
    if not _check("probe6_full", (g2s, g2p, a0, b0), torch.float32,
                  ((steps, 2, n), (steps, 2, n), (8, n), (8, n))):
        return probe6_full_ref(g2s, g2p, a0, b0)
    aout, bout = a0.new_empty((8, n)), b0.new_empty((8, n))
    _launch("probe6_full", "probe_acs", "probe6_full", 6, 2, g2s, g2p, a0, b0, aout,
            bout, n, steps)
    return aout, bout


def probe6_bf16(g2s, g2p, a0, b0) -> tuple[torch.Tensor, torch.Tensor]:
    """turbo_probe6's make_bf16: g2s, g2p (S, 2, 2, H) bf16 ([step][row][lane
    group][lane]), a0, b0 (16, H) bf16 (row 8·group + state) → (16, H) ×2;
    one thread per lane pair, both groups in one ``__nv_bfloat162``."""
    steps, _, _, h = g2s.shape
    if not _check("probe6_bf16", (g2s, g2p, a0, b0), torch.bfloat16,
                  ((steps, 2, 2, h), (steps, 2, 2, h), (16, h), (16, h))):
        return probe6_bf16_ref(g2s, g2p, a0, b0)
    aout, bout = a0.new_empty((16, h)), b0.new_empty((16, h))
    _launch("probe6_bf16", "probe_acs", "probe6_bf16", 6, 2, g2s, g2p, a0, b0, aout,
            bout, h, steps)
    return aout, bout


def probe6_skel(a0, b0, steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """turbo_probe6's make_skel: a0, b0 (8, N) f32 → (8, N) ×2 after
    ``steps`` gamma-free radix-4 steps."""
    n = a0.shape[1]
    if steps < 0:
        raise ValueError("probe6_skel: steps >= 0")
    if not _check("probe6_skel", (a0, b0), torch.float32, ((8, n), (8, n))):
        return probe6_skel_ref(a0, b0, steps)
    aout, bout = a0.new_empty((8, n)), b0.new_empty((8, n))
    _launch("probe6_skel", "probe_acs", "probe6_skel", 4, 2, a0, b0, aout, bout, n,
            steps)
    return aout, bout


def probe7(g, a0, iters: int) -> torch.Tensor:
    """turbo_probe7's body: g (2, n), a0 (8, n), both f32 (one lane a
    thread) or both bf16 (n even; two lanes a thread) → (8, n) after
    ``iters`` iterations of two radix-2 steps and a normalisation."""
    n = a0.shape[1]
    if iters < 0:
        raise ValueError("probe7: iters >= 0")
    dtype = a0.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("probe7 takes float32 or bfloat16 tensors")
    if dtype == torch.bfloat16 and n % 2:
        raise ValueError("probe7 in bf16 takes an even lane count")
    if not _check("probe7", (g, a0), dtype, ((2, n), (8, n))):
        return probe7_ref(g, a0, iters)
    out = a0.new_empty((8, n))
    if dtype == torch.float32:
        _launch("probe7_f32", "probe_acs", "probe7_f32", 3, 2, g, a0, out, n, iters)
    else:
        _launch("probe7_bf16", "probe_acs", "probe7_bf16", 3, 2, g, a0, out, n // 2, iters)
    return out


# --- the work each kernel's output needs ------------------------------------


@functools.lru_cache(maxsize=1)
def _acs_ops() -> dict[str, tuple[int, int]]:
    """(adds, maxes) per lane of one radix-4 step of each body.  Adds: the
    path's gamma terms and the metric, and the normalising subtracts (8 a
    chain).  Maxes: 24 over the candidates a chain, and probe 2's 7 to find
    the largest state (probe 6 subtracts state 0 instead).  Probe 6 counts
    its alpha and beta chains together.  probe2_fixed: probe 2's fixedrow
    and acsonly, whose gamma rows do not change from step to step, so the
    path sums are computed once and a step needs only the add to the
    metric.  Probe 7's wiring makes states s and s ^ 1 equal after every
    step (A_SRC and A_CMB of the pair are the same candidates in swapped
    order), so its output needs 6 adds + 4 maxes a step and 4 subtracts an
    iteration, half of the 12 + 8 and 8 written; nvcc computes each pair
    once, and folds the loop-invariant sums as well."""
    _, coef = _fill_tables()
    _, pk, _, nk = _path_tables()
    # a path with c present gamma terms: c - 1 adds to sum them, 1 to add them
    fill_adds = int(coef.sum())
    with_terms = int((coef.sum(axis=-1) > 0).sum())
    # p3 and u3, then a p-row add where k > 0 and a u-row add where j > 0
    pair_adds = 2 * (2 + 3 * 8) + int((pk != 0).sum() + (nk != 0).sum())
    return dict(probe2=(fill_adds + 8, 24 + 7), probe2_fixed=(with_terms + 8, 24 + 7),
                probe6=(pair_adds + 2 * 8, 2 * 24), skel=(2 * (32 + 8), 2 * 24),
                probe7=(2 * 6 + 4, 2 * 4))


def work(name: str, n: int, n_steps: int = 0,
         iters: int = 0) -> tuple[int, int, int, str]:
    """(bytes, adds, maxes, operation type) that the output of kernel
    ``name`` needs on n lanes (elements, for the bf16 kernels): each input
    row it reads once, each output row it writes once (probe 2 writes row 0
    only; its astore scratch is no output), and the adds (subtracts
    included) and maxes that output needs (probe 2: those of row 0; nvcc
    may drop the rest, as it does for addchain's seven other states).  The
    type is "f32", or "bf16x2" for the packed kernels."""
    ops = _acs_ops()
    if name.startswith("probe2_"):
        v = name[len("probe2_"):]
        steps = 4 * (n_steps // 4) if v in ("block8", "unroll4") else n_steps
        if v == "fixedrow":
            rows = 2
        elif v in ("acsonly", "empty", "addchain", "addpar"):
            rows = 1
        elif v in ("load1", "load1x"):
            rows = steps
        else:
            rows = 2 * steps  # gs and gp are one array: each row read once
        a0_rows = 0 if v == "empty" else 8 if _runs_acs(v) else 1
        adds, maxes = ops["probe2_fixed"] if v in ("fixedrow", "acsonly") else ops[
            "probe2"] if _runs_acs(v) else ({
                "loadsonly": 4, "empty": 0, "load1": 1, "addchain": 8, "addpar": 2,
                "load1x": 1}[v], 0)
        return 4 * n * (rows + a0_rows + 1), n * steps * adds, n * steps * maxes, "f32"
    if name == "probe3_empty":
        return 8 * n, 0, 0, "f32"
    if name in ("probe6_full", "probe6_bf16"):
        size = 4 if name == "probe6_full" else 2
        adds, maxes = ops["probe6"]
        return (size * n * (2 * 2 * n_steps + 4 * 8), n * n_steps * adds,
                n * n_steps * maxes, "f32" if name == "probe6_full" else "bf16x2")
    if name == "probe6_skel":
        adds, maxes = ops["skel"]
        return 4 * n * 4 * 8, n * n_steps * adds, n * n_steps * maxes, "f32"
    if name in ("probe7_f32", "probe7_bf16"):
        size = 4 if name == "probe7_f32" else 2
        adds, maxes = ops["probe7"]
        # + 1: g0 + g1, once
        return size * n * (2 + 8 + 8), n * (iters * adds + 1), n * iters * maxes, (
            "f32" if name == "probe7_f32" else "bf16x2")
    raise ValueError(f"unknown probe kernel {name!r}")


def _runs_acs(variant: str) -> bool:
    """True for the probe 2 bodies that run the radix-4 ACS."""
    return variant in ("full", "fixedrow", "block8", "acsonly", "unroll4", "astore")
