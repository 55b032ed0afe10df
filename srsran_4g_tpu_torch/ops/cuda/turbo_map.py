"""Hopper kernels: the windowed max-log-MAP (BCJR) half-iteration.

Port counterpart of ``srsran_4g_tpu/ops/pallas/turbo_map.py``.  The TPU
kernels there compute one function in several dataflows and two metric
types; the port has a CUDA kernel for each, with a plain torch version of the
same arithmetic:

- ``map_windowed`` (``csrc/turbo_windowed.cu``): the radix-2 f32
  single-chain function, for ``map_windowed_pallas_r4`` (v4) and the f32
  body of ``map_windowed_pallas`` (v1, and every route's odd-L/T shapes:
  the default route sends its L % 4 == 2 windows here); any L and T.  The
  two chains of a lane meet in the middle, one thread each, and read each
  other's checkpoints from shared memory (launch geometry from
  ``windowed_geometry``).
- ``map_v3`` (same file): the same function with one thread running both
  chains of its lane, ``map_windowed_pallas``'s ``_make_kernel_v3``
  (``TURBO_KERNEL=v3``).
- ``map_windowed16`` (same file): the same dataflow with bf16 metrics (the
  v1 body at bf16, ``TURBO_KERNEL=bf16``); any L and T.
- ``map_fused`` (``csrc/turbo_fused.cu``): the fused two-phase dataflow in
  f32, for ``map_windowed_pallas_v7`` (radix 2) and its ``radix4=True``
  form v8 (radix 4); one thread per chain, its phase-1 metrics checkpointed
  in shared memory (launch geometry from ``fused_geometry``).
- ``map_fused16`` (``csrc/turbo_fused16.cu``): v7's radix-2 dataflow at
  bf16 with normalisation in training, ``map_windowed_pallas_v9`` (the
  default), its half-depth stores in shared memory and one thread per chain
  (launch geometry from ``fused16_geometry``).
- ``sweep`` (``csrc/turbo_sweep.cu``) then ``emit`` (``csrc/turbo_emit.cu``):
  the interleaved recursions storing the even-position metrics, then a fully
  parallel emission, for ``map_windowed_pallas_v5`` (radix 4) +
  ``emit_llr_pallas`` and ``map_windowed_pallas_v6`` (radix 2).

``ops/turbo.kernel_route`` picks among them from ``TURBO_KERNEL`` as the JAX
package does.  The source note in each .cu file says what bounds the kernel
on the H100 and what its design does about that.

The bf16 plain versions compute in torch bf16, which rounds every op to
bf16 as XLA does, in the TPU kernels' order of operations, so they, the bf16
kernels and the Pallas calls agree exactly.

Every wrapper launches its kernel on a CUDA tensor and runs its plain version
(``*_ref``) only on a CPU tensor; there is no fallback from one to the other.
``launches[<wrapper>]`` counts kernel launches: ``_launch`` adds one for
each launch of every wrapper of the port (``probes.py``'s too), and nothing
else does.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from srsran_4g_tpu_torch.ops.turbo import (
    _alpha_step, _beta_step, _llr_from_metrics, _r4_tables, _step_tables)


# --- the single-chain half-iteration (turbo_windowed.cu) --------------------


def _single_chain(gs_ext, gp_ext, a_init, b_init, t_train, l_win, nof_b,
                  nof_w, llr):
    """The v1 dataflow in the dtype of its inputs: alpha through training and
    body into a full-depth store, then beta with ``llr`` per position."""
    n = gs_ext.shape[1]
    m_a, m_b = _train_masks(n, nof_b, nof_w, gs_ext.device)
    alpha = a_init.t()  # (N, 8)
    for r in range(t_train):
        alpha = torch.where(m_a, _alpha_step(alpha, gs_ext[r], gp_ext[r]), alpha)
    alphas = [alpha]
    for r in range(t_train, t_train + l_win - 1):
        alphas.append(_alpha_step(alphas[-1], gs_ext[r], gp_ext[r]))
    beta = b_init.t()
    for r in range(l_win + 2 * t_train - 1, l_win + t_train - 1, -1):
        beta = torch.where(m_b, _beta_step(beta, gs_ext[r], gp_ext[r]), beta)
    out = gs_ext.new_empty((l_win, n))
    for pos in range(l_win - 1, -1, -1):
        r = t_train + pos
        out[pos] = llr(alphas[pos], beta, gs_ext[r], gp_ext[r])
        if pos:
            beta = _beta_step(beta, gs_ext[r], gp_ext[r])
    return out


def _llr_ab(alpha, beta_next, g_sys, g_par):
    """The LLR in the JAX v1 kernel's order: (alpha + beta) + parity term."""
    t = _step_tables(alpha.device, alpha.dtype)
    gp = g_par[..., None]
    m0 = (alpha + beta_next[..., t["ns0"]] + t["p0"] * gp).amax(dim=-1)
    m1 = (alpha + beta_next[..., t["ns1"]] + t["p1"] * gp).amax(dim=-1)
    return m1 + g_sys - m0


def _bf16(*tensors):
    return tuple(x.to(torch.bfloat16) for x in tensors)


def map_windowed_ref(gs_ext, gp_ext, a_init, b_init, t_train: int, l_win: int,
                     nof_b: int, nof_w: int) -> torch.Tensor:
    """Plain torch version of ``map_windowed``, same contract (see the .cu
    file).  gs_ext/gp_ext (L+2T, N), a_init/b_init (8, N) float32 → LLRs
    (L, N)."""
    return _single_chain(gs_ext, gp_ext, a_init, b_init, t_train, l_win, nof_b,
                         nof_w, _llr_from_metrics)


def map_windowed16_ref(gs_ext, gp_ext, a_init, b_init, t_train: int,
                       l_win: int, nof_b: int, nof_w: int) -> torch.Tensor:
    """Plain torch version of ``map_windowed16``: the v1 dataflow with the
    inputs rounded to bf16 and every op in bf16 (``_make_kernel(dtype=bf16)``),
    LLRs bf16 widened to float32."""
    return _single_chain(*_bf16(gs_ext, gp_ext, a_init, b_init), t_train, l_win,
                         nof_b, nof_w, _llr_ab).float()


# v3 changes only which lanes share a thread, not any lane's arithmetic: its
# plain version is the single chain's.
map_v3_ref = map_windowed_ref


def map_windowed(gs_ext: torch.Tensor, gp_ext: torch.Tensor,
                 a_init: torch.Tensor, b_init: torch.Tensor, t_train: int,
                 l_win: int, nof_b: int, nof_w: int) -> torch.Tensor:
    """One windowed max-log-MAP half-iteration → LLRs (L, N) float32.

    gs_ext/gp_ext: (L+2T, N) float32 gamma rows, lane = window·B + block;
    a_init/b_init: (8, N) float32.  CUDA tensors go to the kernel, CPU
    tensors to ``map_windowed_ref``.
    """
    args = (gs_ext, gp_ext, a_init, b_init, t_train, l_win, nof_b, nof_w)
    if not _check_windowed("map_windowed", *args):
        return map_windowed_ref(*args)
    return _launch_windowed("map_windowed", "turbo_map_windowed", 1, *args)


def map_windowed16(gs_ext: torch.Tensor, gp_ext: torch.Tensor,
                   a_init: torch.Tensor, b_init: torch.Tensor, t_train: int,
                   l_win: int, nof_b: int, nof_w: int) -> torch.Tensor:
    """``map_windowed`` with bf16 metrics (``TURBO_KERNEL=bf16``): the same
    float32 inputs, rounded to bf16 in the kernel → LLRs (L, N) float32
    holding bf16 values.  CUDA tensors go to the kernel, CPU tensors to
    ``map_windowed16_ref``."""
    args = (gs_ext, gp_ext, a_init, b_init, t_train, l_win, nof_b, nof_w)
    if not _check_windowed("map_windowed16", *args):
        return map_windowed16_ref(*args)
    return _launch_windowed("map_windowed16", "turbo_map_windowed16", 1, *args,
                            metric_bytes=16)


def map_v3(gs_ext: torch.Tensor, gp_ext: torch.Tensor, a_init: torch.Tensor,
           b_init: torch.Tensor, t_train: int, l_win: int, nof_b: int,
           nof_w: int) -> torch.Tensor:
    """``map_windowed``'s function with one thread running both chains of
    its lane (``TURBO_KERNEL=v3``) → LLRs (L, N) float32, equal to
    ``map_windowed``'s.  CUDA tensors go to the kernel, CPU tensors to
    ``map_v3_ref``."""
    args = (gs_ext, gp_ext, a_init, b_init, t_train, l_win, nof_b, nof_w)
    if not _check_windowed("map_v3", *args):
        return map_v3_ref(*args)
    return _launch_windowed("map_v3", "turbo_map_v3", 2, *args)


def _launch_windowed(kernel, symbol, chains, gs_ext, gp_ext, a_init, b_init, t_train,
                     l_win, nof_b, nof_w, metric_bytes=32):
    n = gs_ext.shape[1]
    geo = windowed_geometry(n, l_win, t_train, chains, metric_bytes=metric_bytes)
    out = gs_ext.new_empty((l_win, n))
    _launch(kernel, "turbo_windowed", symbol, 5, 8, gs_ext, gp_ext, a_init, b_init, out, n,
            t_train, l_win, nof_b, nof_w, geo.lanes, geo.every, geo.smem_bytes)
    return out


MAX_SMEM = 232448      # the shared memory an H100 block may opt into
WINDOWED_STAGES = 8    # kStages of csrc/turbo_windowed.cu: gamma rows a chain
# checkpoint strides c the geometry tries for each tile, in order: one thread
# a chain (map_windowed) holds a segment of c metrics in registers, one
# thread for both chains (map_v3) two segments, so v3 stops at 4
WINDOWED_EVERY = {1: (4, 8), 2: (4,)}
WINDOWED_TILES = (32, 16, 8, 4, 2, 1)


class WindowedGeometry(NamedTuple):
    lanes: int       # lanes per tile (one block)
    threads: int     # 2 * lanes (map_windowed) or lanes (map_v3)
    every: int       # checkpoint stride c
    smem_bytes: int  # dynamic shared memory per block
    grid: int        # blocks: ceil(N / lanes), the last one ragged


def windowed_smem(l_win: int, lanes: int, every: int, stages: int = WINDOWED_STAGES,
                  metric_bytes: int = 32) -> int:
    """Bytes of shared memory a block of ``lanes`` lanes takes at window L
    and checkpoint stride c: per lane ``metric_bytes`` (32 for f32 metrics,
    16 for bf16) for each checkpoint of either chain (ceil(h/c) of alpha and
    ceil((L-h)/c) of beta, h = ceil(L/2)) and two rings of ``stages`` rows of
    (gs, gp)."""
    h = -(-l_win // 2)
    checkpoints = -(-h // every) + -(-(l_win - h) // every)
    return lanes * (metric_bytes * checkpoints + 2 * stages * 8)


def windowed_geometry(n: int, l_win: int, t_train: int, chains_per_thread: int = 1,
                      every: int | None = None, lanes: int | None = None,
                      metric_bytes: int = 32) -> WindowedGeometry:
    """``map_windowed``'s (``chains_per_thread=1``), ``map_v3``'s (2) or,
    with ``metric_bytes=16``, ``map_windowed16``'s launch at N lanes, window
    L and training T: the widest tile of WINDOWED_TILES, and for it the first
    stride of WINDOWED_EVERY, whose block fits MAX_SMEM.  ``every`` or
    ``lanes`` force the stride or the tile (the tests and
    tools/windowed_split.py).  T does not change the geometry: a ring holds
    WINDOWED_STAGES rows whatever T is."""
    if chains_per_thread not in (1, 2) or metric_bytes not in (16, 32) or (
            chains_per_thread == 2 and metric_bytes == 16):
        raise ValueError(f"no kernel takes {chains_per_thread} chain(s) a thread with "
                         f"{metric_bytes}-byte metrics")
    if l_win < 1 or t_train < 0 or n < 1:
        raise ValueError(f"no launch at N={n}, L={l_win}, T={t_train}")
    everys = WINDOWED_EVERY[chains_per_thread] if every is None else (every,)
    if not set(everys) <= {1, 2, 4, 8} or (chains_per_thread == 2 and 8 in everys):
        raise ValueError(f"checkpoint stride {every} is not taken with "
                         f"{chains_per_thread} chain(s) a thread")
    for tile in (WINDOWED_TILES if lanes is None else (lanes,)):
        for c in everys:
            smem = windowed_smem(l_win, tile, c, metric_bytes=metric_bytes)
            if smem <= MAX_SMEM:
                return WindowedGeometry(tile, 2 * tile // chains_per_thread, c, smem,
                                        -(-n // tile))
    raise ValueError(f"no tile of {lanes or WINDOWED_TILES} lanes fits L={l_win} at "
                     f"stride {everys} in {MAX_SMEM} B")


# --- plain steps of the paired dataflows (trellis.cuh) ----------------------
# Metrics are (N, 8).  Gamma terms are added in the order of the JAX
# states-as-registers kernels; a 0/1 coefficient times a gamma adds ±0, which
# leaves a sum unchanged, so each expression below equals the kernel's.


def _astep2(a, gs, gp):
    """Radix-2 alpha step, unnormalised (_make_kernel_v6 astep)."""
    t = _step_tables(a.device, a.dtype)
    gs, gp = gs[:, None], gp[:, None]
    return torch.maximum(a[:, t["pred0"]] + (t["u0"] * gs + t["q0"] * gp),
                         a[:, t["pred1"]] + (t["u1"] * gs + t["q1"] * gp))


def _bstep2(b, gs, gp):
    """Radix-2 beta step, beta_{k+1} → beta_k, unnormalised."""
    t = _step_tables(b.device, b.dtype)
    gs, gp = gs[:, None], gp[:, None]
    return torch.maximum(b[:, t["ns0"]] + t["p0"] * gp,
                         b[:, t["ns1"]] + (gs + t["p1"] * gp))


def _step4(x, g, alpha: bool, grouped: bool):
    """Radix-4 step over the row pair g = (gs0, gp0, gs1, gp1), unnormalised:
    alpha(2i) → alpha(2i+2), or beta(2i+2) → beta(2i).  ``grouped`` adds the
    input and parity terms as one sum (v7/v8); otherwise parity, then input
    (v5)."""
    r = _r4_tables(x.device)
    idx, c1, c2 = ((r["pred"], r["ap1"], r["ap2"]) if alpha
                   else (r["next"], r["bp1"], r["bp2"]))
    g0s, g0p, g1s, g1p = (v[:, None] for v in g)
    cands = []
    for j in range(4):
        u_row = r["u1"][j] * g0s + r["u2"][j] * g1s
        p_row = c1[:, j] * g0p + c2[:, j] * g1p
        xj = x[:, idx[:, j]]
        cands.append(xj + (u_row + p_row) if grouped else xj + p_row + u_row)
    return torch.maximum(torch.maximum(cands[0], cands[1]),
                         torch.maximum(cands[2], cands[3]))


def _norm0(x):
    return x - x[:, :1]


def _advance_a(a, g, radix: int, fused: bool):
    """Alpha over one row pair under the sweep (v5/v6) or the fused (v7/v8)
    schedule; only radix 4 differs between them."""
    if radix == 4:
        n = _step4(a, g, alpha=True, grouped=fused)
        return n if fused else _norm0(n)
    return _astep2(_astep2(a, g[0], g[1]), g[2], g[3])


def _advance_b(b, g, radix: int, fused: bool):
    if radix == 4:
        n = _step4(b, g, alpha=False, grouped=fused)
        return n if fused else _norm0(n)
    return _bstep2(_bstep2(b, g[2], g[3]), g[0], g[1])


def _emit2(a, b1, gs, gp):
    """LLR at k from alpha_k and beta_{k+1}, the fused kernels' emission."""
    t = _step_tables(a.device, a.dtype)
    gp_ = gp[:, None]
    m1 = (a + (b1[:, t["ns1"]] + t["p1"] * gp_)).amax(dim=-1)
    m0 = (a + (b1[:, t["ns0"]] + t["p0"] * gp_)).amax(dim=-1)
    return m1 + gs - m0


def _pair(gs_ext, gp_ext, row: int):
    return gs_ext[row], gp_ext[row], gs_ext[row + 1], gp_ext[row + 1]


def _train_masks(n: int, nof_b: int, nof_w: int, device):
    """Lanes whose alpha (not window 0) / beta (not the last window) train."""
    lane = torch.arange(n, device=device)
    return (lane >= nof_b)[:, None], (lane < (nof_w - 1) * nof_b)[:, None]


def _train(gs_ext, gp_ext, a_init, b_init, t_train, l_win, nof_b, nof_w,
           radix, fused, train_norm=False):
    """Both chains through their training rows, frozen on boundary windows;
    ``train_norm`` subtracts state 0 after every pair (v9)."""
    m_a, m_b = _train_masks(gs_ext.shape[1], nof_b, nof_w, gs_ext.device)
    s_all = l_win + 2 * t_train
    a, b = a_init.t(), b_init.t()
    for i in range(t_train // 2):
        na = _advance_a(a, _pair(gs_ext, gp_ext, 2 * i), radix, fused)
        nb = _advance_b(b, _pair(gs_ext, gp_ext, s_all - 2 - 2 * i), radix, fused)
        if train_norm:
            na, nb = _norm0(na), _norm0(nb)
        a, b = torch.where(m_a, na, a), torch.where(m_b, nb, b)
    return a, b


# --- the fused two-phase half-iteration (turbo_fused.cu) --------------------


def map_fused_ref(gs_ext, gp_ext, a_init, b_init, t_train: int, l_win: int,
                  nof_b: int, nof_w: int, radix: int,
                  train_norm: bool = False) -> torch.Tensor:
    """Plain torch version of ``map_fused`` (``_make_kernel_v7``), same
    contract, in the dtype of its inputs.  → LLRs (L, N)."""
    n = gs_ext.shape[1]
    l2 = l_win // 2
    h = l2 // 2
    a, b = _train(gs_ext, gp_ext, a_init, b_init, t_train, l_win, nof_b, nof_w,
                  radix, fused=True, train_norm=train_norm)
    astore, bstore = [], []
    for j in range(h):  # phase 1: alpha(2j), beta(L-2j)
        astore.append(a)
        bstore.append(b)
        a = _norm0(_advance_a(a, _pair(gs_ext, gp_ext, t_train + 2 * j), radix, True))
        b = _norm0(_advance_b(b, _pair(gs_ext, gp_ext, t_train + l_win - 2 - 2 * j),
                              radix, True))
    out = gs_ext.new_empty((l_win, n))
    for j in range(h, l2):  # phase 2: four LLRs per iteration
        ga = _pair(gs_ext, gp_ext, t_train + 2 * j)
        bsl = bstore[l2 - 1 - j]  # beta(2j+2)
        out[2 * j] = _emit2(a, _bstep2(bsl, ga[2], ga[3]), ga[0], ga[1])
        ao = _astep2(a, ga[0], ga[1])
        out[2 * j + 1] = _emit2(ao, bsl, ga[2], ga[3])
        e = l_win - 2 * j - 2
        gb = _pair(gs_ext, gp_ext, t_train + e)
        asl = astore[l2 - 1 - j]  # alpha(e)
        b1b = _bstep2(b, gb[2], gb[3])
        out[e] = _emit2(asl, b1b, gb[0], gb[1])
        out[e + 1] = _emit2(_astep2(asl, gb[0], gb[1]), b, gb[2], gb[3])
        if radix == 4:
            a, b = _advance_a(a, ga, 4, True), _advance_b(b, gb, 4, True)
        else:
            a, b = _astep2(ao, ga[2], ga[3]), _bstep2(b1b, gb[0], gb[1])
        a, b = _norm0(a), _norm0(b)
    return out


def map_fused(gs_ext: torch.Tensor, gp_ext: torch.Tensor, a_init: torch.Tensor,
              b_init: torch.Tensor, t_train: int, l_win: int, nof_b: int,
              nof_w: int, radix: int) -> torch.Tensor:
    """One windowed max-log-MAP half-iteration in the fused two-phase
    dataflow (v7 at radix 2, v8 at radix 4) → LLRs (L, N) float32.

    Takes ``map_windowed``'s inputs; needs L % 4 == 0 and T even.  CUDA
    tensors go to the kernel, CPU tensors to ``map_fused_ref``.
    """
    args = (gs_ext, gp_ext, a_init, b_init, t_train, l_win, nof_b, nof_w)
    _check_radix("map_fused", radix)
    _check_fused_shape("map_fused", l_win, t_train)
    if not _check_windowed("map_fused", *args):
        return map_fused_ref(*args, radix)
    n = gs_ext.shape[1]
    geo = fused_geometry(n, l_win, radix)
    out = gs_ext.new_empty((l_win, n))
    _launch("map_fused", "turbo_fused", "turbo_map_fused", 5, 9, gs_ext, gp_ext, a_init,
            b_init, out, n, t_train, l_win, nof_b, nof_w, radix, geo.lanes, geo.every,
            geo.smem_bytes)
    return out


FUSED_STAGES = 4      # kStages of csrc/turbo_fused.cu: row pairs a chain
# radix -> the checkpoint strides c (row pairs) map_fused's geometry tries, in
# order: radix 4 rebuilds with its costlier two-step, and is faster at c = 2
# (4 blocks an SM) than at c = 4 (6); radix 2 the reverse (PERF.md, map_fused)
FUSED_EVERY = {2: (4,), 4: (2, 4)}


def fused_smem(l_win: int, lanes: int, every: int, stages: int = FUSED_STAGES) -> int:
    """Bytes of shared memory a ``map_fused`` block of ``lanes`` lanes takes
    at window L (L % 4 == 0) and checkpoint stride c pairs: per lane 32 B for
    each of the ceil(L/(4c)) checkpoints of either chain and two rings of
    ``stages`` row pairs of 16 B."""
    return lanes * (2 * 32 * -(-(l_win // 4) // every) + 2 * stages * 16)


def fused_geometry(n: int, l_win: int, radix: int, every: int | None = None,
                   lanes: int | None = None) -> WindowedGeometry:
    """``map_fused``'s launch at N lanes, window L (L % 4 == 0) and radix:
    the widest tile of WINDOWED_TILES, and for it the first stride of
    FUSED_EVERY[radix], whose block fits MAX_SMEM (at c = 4: 32 lanes up to
    L = 1,776, 16 up to 3,600, 8 up to 7,232).  ``every`` or ``lanes`` force
    the stride or the tile (the tests and tools/fused_split.py)."""
    if l_win <= 0 or l_win % 4 or n < 1:
        raise ValueError(f"map_fused has no launch at N={n}, L={l_win}")
    _check_radix("map_fused", radix)
    everys = FUSED_EVERY[radix] if every is None else (every,)
    if not set(everys) <= {1, 2, 4}:
        raise ValueError(f"map_fused takes checkpoint strides 1, 2 or 4, not {every}")
    for tile in (WINDOWED_TILES if lanes is None else (lanes,)):
        for c in everys:
            smem = fused_smem(l_win, tile, c)
            if smem <= MAX_SMEM:
                return WindowedGeometry(tile, 2 * tile, c, smem, -(-n // tile))
    raise ValueError(f"no tile of {lanes or WINDOWED_TILES} lanes fits L={l_win} at "
                     f"stride {everys} in {MAX_SMEM} B")


def map_fused16_ref(gs_ext, gp_ext, a_init, b_init, t_train: int, l_win: int,
                    nof_b: int, nof_w: int) -> torch.Tensor:
    """Plain torch version of ``map_fused16`` (``map_windowed_pallas_v9``):
    the radix-2 fused dataflow on inputs rounded to bf16, every op in bf16,
    state 0 subtracted after every training pair too; LLRs widened to
    float32."""
    return map_fused_ref(*_bf16(gs_ext, gp_ext, a_init, b_init), t_train, l_win,
                         nof_b, nof_w, radix=2, train_norm=True).float()


def map_fused16(gs_ext: torch.Tensor, gp_ext: torch.Tensor,
                a_init: torch.Tensor, b_init: torch.Tensor, t_train: int,
                l_win: int, nof_b: int, nof_w: int) -> torch.Tensor:
    """v9: the radix-2 fused half-iteration with bf16 metrics and stores →
    LLRs (L, N) float32 holding bf16 values.

    Takes ``map_windowed``'s float32 inputs (rounded to bf16 in the kernel);
    needs L % 4 == 0 and T even.  CUDA tensors go to the kernel, CPU tensors
    to ``map_fused16_ref``.
    """
    args = (gs_ext, gp_ext, a_init, b_init, t_train, l_win, nof_b, nof_w)
    _check_fused_shape("map_fused16", l_win, t_train)
    if not _check_windowed("map_fused16", *args):
        return map_fused16_ref(*args)
    n = gs_ext.shape[1]
    geo = fused16_geometry(n, l_win)
    out = gs_ext.new_empty((l_win, n))
    _launch("map_fused16", "turbo_fused16", "turbo_map_fused16", 5, 7, gs_ext, gp_ext,
            a_init, b_init, out, n, t_train, l_win, nof_b, nof_w, geo.lanes,
            geo.smem_bytes)
    return out


FUSED16_TILES = (32, 16, 8)  # the tiles (kTile) csrc/turbo_fused16.cu takes
FUSED16_STAGES = 8  # kStages of csrc/turbo_fused16.cu: the gamma ring's depth


class Fused16Geometry(NamedTuple):
    lanes: int       # lanes per tile (one block; threads = 2 * lanes)
    threads: int
    smem_bytes: int  # dynamic shared memory per block
    grid: int        # blocks: ceil(N / lanes), the last one ragged


def fused16_geometry(n: int, l_win: int) -> Fused16Geometry:
    """``map_fused16``'s launch at N lanes and window L (L % 4 == 0): the
    widest tile of FUSED16_TILES whose block fits MAX_SMEM; per lane
    32·ceil(L/8) bytes of bf16 stores (each chain stores every other of its
    L/4 phase-1 metrics, 8 bf16 each) and 256 bytes of gamma ring (two
    chains, FUSED16_STAGES row pairs of 4 floats).  32 lanes up to L = 1,752,
    8 at the full K = 6,144."""
    if l_win <= 0 or l_win % 4:
        raise ValueError(f"map_fused16 needs L % 4 == 0, not L={l_win}")
    per_lane = 32 * -(-l_win // 8) + 2 * FUSED16_STAGES * 4 * 4
    tile = next((t for t in FUSED16_TILES if t * per_lane <= MAX_SMEM), None)
    if tile is None:
        raise ValueError(f"map_fused16 takes L up to 7,200, not L={l_win}")
    return Fused16Geometry(tile, 2 * tile, tile * per_lane, -(-n // tile))


# --- the split sweep / emission half-iteration (turbo_sweep/emit.cu) -------


def sweep_ref(gs_ext, gp_ext, a_init, b_init, t_train: int, l_win: int,
              nof_b: int, nof_w: int, radix: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of ``sweep`` (``_make_kernel_v5`` at radix 4,
    ``_make_kernel_v6`` at radix 2), same contract."""
    n = gs_ext.shape[1]
    l2 = l_win // 2
    a, b = _train(gs_ext, gp_ext, a_init, b_init, t_train, l_win, nof_b, nof_w,
                  radix, fused=False)
    astore = gs_ext.new_empty((l2, 8, n))
    bstore = gs_ext.new_empty((l2, 8, n))
    for j in range(l2):
        astore[j] = a.t()
        bstore[l2 - 1 - j] = b.t()
        a = _advance_a(a, _pair(gs_ext, gp_ext, t_train + 2 * j), radix, False)
        b = _advance_b(b, _pair(gs_ext, gp_ext, t_train + l_win - 2 - 2 * j),
                       radix, False)
        if radix == 2:
            a, b = _norm0(a), _norm0(b)
    return astore, bstore


def sweep(gs_ext: torch.Tensor, gp_ext: torch.Tensor, a_init: torch.Tensor,
          b_init: torch.Tensor, t_train: int, l_win: int, nof_b: int,
          nof_w: int, radix: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The alpha and beta recursions of one half-iteration, interleaved, with
    the v5 (radix 4) or v6 (radix 2) schedule → (astore, bstore), each
    (L/2, 8, N) float32: alpha at k_rel = 2i, beta at k_rel = 2i+2.

    Takes ``map_windowed``'s inputs; needs L and T even.  CUDA tensors go to
    the kernel, CPU tensors to ``sweep_ref``.
    """
    args = (gs_ext, gp_ext, a_init, b_init, t_train, l_win, nof_b, nof_w)
    _check_radix("sweep", radix)
    if l_win % 2 or t_train % 2:
        raise ValueError(f"sweep needs L and T even, not L={l_win}, T={t_train}")
    if not _check_windowed("sweep", *args):
        return sweep_ref(*args, radix)
    n = gs_ext.shape[1]
    astore = gs_ext.new_empty((l_win // 2, 8, n))
    bstore = gs_ext.new_empty((l_win // 2, 8, n))
    _launch("sweep", "turbo_sweep", "turbo_sweep", 6, 6, gs_ext, gp_ext, a_init, b_init,
            astore, bstore, n, t_train, l_win, nof_b, nof_w, radix)
    return astore, bstore


def emit_ref(g2s, g2p, astore, bstore) -> torch.Tensor:
    """Plain torch version of ``emit`` (``_make_emit_kernel``), same contract,
    all position pairs at once."""
    t = _step_tables(astore.device, astore.dtype)
    ae, be = astore.transpose(1, 2), bstore.transpose(1, 2)  # (L/2, N, 8)
    ges, gos = g2s[:, 0, :, None], g2s[:, 1, :, None]
    gep, gop = g2p[:, 0, :, None], g2p[:, 1, :, None]
    ao = torch.maximum(ae[..., t["pred0"]] + t["u0"] * ges + t["q0"] * gep,
                       ae[..., t["pred1"]] + t["u1"] * ges + t["q1"] * gep)
    bo = torch.maximum(be[..., t["ns0"]] + t["p0"] * gop,
                       be[..., t["ns1"]] + gos + t["p1"] * gop)

    def llr(a, b1, gs, gp):
        m1 = (a + b1[..., t["ns1"]] + t["p1"] * gp).amax(dim=-1)
        m0 = (a + b1[..., t["ns0"]] + t["p0"] * gp).amax(dim=-1)
        return m1 + gs[..., 0] - m0

    return torch.stack([llr(ae, bo, ges, gep), llr(ao, be, gos, gop)], dim=1)


def emit(g2s: torch.Tensor, g2p: torch.Tensor, astore: torch.Tensor,
         bstore: torch.Tensor) -> torch.Tensor:
    """LLRs from ``sweep``'s stores → (L/2, 2, N) float32 (reshapes to
    (L, N)).

    g2s/g2p: (L/2, 2, N) float32 body gamma rows (``gs_ext[T:T+L]`` viewed in
    pairs); astore/bstore: (L/2, 8, N) float32.  CUDA tensors go to the
    kernel, CPU tensors to ``emit_ref``.
    """
    l2, two, n = g2s.shape
    if two != 2:
        raise ValueError(f"g2s has shape {tuple(g2s.shape)}, expected (L/2, 2, N)")
    for name, x, shape in (("g2p", g2p, (l2, 2, n)), ("astore", astore, (l2, 8, n)),
                           ("bstore", bstore, (l2, 8, n))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not _check_tensors("emit", (g2s, g2p, astore, bstore)):
        return emit_ref(g2s, g2p, astore, bstore)
    out = g2s.new_empty((l2, 2, n))
    _launch("emit", "turbo_emit", "turbo_emit", 5, 2, g2s, g2p, astore, bstore, out, n,
            l2)
    return out


# --- input checks and launches ----------------------------------------------


def _check_fused_shape(name: str, l_win: int, t_train: int) -> None:
    if l_win % 4 or t_train % 2:
        raise ValueError(f"{name} needs L % 4 == 0 and T even, not L={l_win}, "
                         f"T={t_train}")


def _check_radix(name: str, radix: int) -> None:
    if radix not in (2, 4):
        raise ValueError(f"{name} takes radix 2 or 4, not {radix}")


def _check_windowed(name, gs_ext, gp_ext, a_init, b_init, t_train, l_win,
                    nof_b, nof_w) -> bool:
    """Raise on inputs the half-iteration kernels do not take; True for CUDA
    tensors (launch the kernel), False for CPU tensors (the plain version)."""
    rows, n = gs_ext.shape
    if rows != l_win + 2 * t_train or n != nof_b * nof_w:
        raise ValueError(f"gamma rows {tuple(gs_ext.shape)} do not match "
                         f"L={l_win}, T={t_train}, B={nof_b}, W={nof_w}")
    for arg, x, shape in (("gp_ext", gp_ext, (rows, n)), ("a_init", a_init, (8, n)),
                          ("b_init", b_init, (8, n))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{arg} has shape {tuple(x.shape)}, expected {shape}")
    return _check_tensors(name, (gs_ext, gp_ext, a_init, b_init))


def _check_tensors(name: str, tensors) -> bool:
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError(f"{name} takes float32 tensors")
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


@functools.lru_cache(maxsize=None)
def _kernel(source: str, symbol: str, n_ptr: int, n_int: int):
    """The C entry ``symbol`` of ``csrc/<source>.cu``: n_ptr pointers, n_int
    ints, then the stream; returns a CUDA error code."""
    from srsran_4g_tpu_torch.ops.cuda.build import load

    fn = getattr(load(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


launches: collections.Counter = collections.Counter()


def _launch(kernel: str, source: str, symbol: str, n_ptr: int, n_int: int,
            *args) -> None:
    """Launch on the current stream of the first tensor's device; raise if
    the launch was refused, else count it under ``launches[kernel]``."""
    fn = _kernel(source, symbol, n_ptr, n_int)
    tensors, ints = args[:n_ptr], args[n_ptr:]
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(x.data_ptr() for x in tensors), *ints, stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    launches[kernel] += 1
