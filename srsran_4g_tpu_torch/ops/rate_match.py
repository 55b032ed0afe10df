"""Turbo rate matching / dematching with HARQ soft-combining, TS 36.212 §5.1.4.1.

Port counterpart of ``srsran_4g_tpu/ops/rate_match.py``.  The sub-block
interleaving, bit collection and bit selection fold into one host-built
index vector per (K, rv, E, Ncb) that maps each transmitted position to a
flat index into the (3, K+4) d-streams.  Encoding is one gather;
dematching is one ``index_add`` into the (3, K+4) soft-buffer, which is the
HARQ combining (repetitions and retransmissions accumulate).

When E exceeds the circular buffer the indices repeat; on CUDA
``index_add`` sums the repeats with atomics in no fixed order, so the
combined LLRs agree with the JAX package to float rounding, not bit for bit.

The convolutionally-coded channels (PBCH, PDCCH; TS 36.212 §5.1.4.2) have
their own gather (``conv_rm_indices``) and a dematching that sums repeats in
transmit order, bit for bit as JAX does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srsran_4g_tpu_torch.utils.constants import RM_PERM_CC, RM_PERM_TC

_NCOLS = 32


@functools.lru_cache(maxsize=1024)
def _w_to_d_index(k: int, n_filler: int = 0) -> np.ndarray:
    """Map circular-buffer position → flat index into d (3, K+4), -1 = NULL.

    The §5.1.4.1.1 sub-block interleavers and §5.1.4.1.2 bit collection for
    stream length D = K+4.  Filler bits (the first ``n_filler`` positions of
    the systematic and parity-1 streams) are further NULLs.
    """
    d = k + 4
    rows = (d + _NCOLS - 1) // _NCOLS
    kp = rows * _NCOLS
    nd = kp - d  # dummy NULLs prepended

    y = np.full(kp, -1, dtype=np.int64)
    y[nd:] = np.arange(d)
    y01 = y.copy()
    if n_filler:
        y01[nd:nd + n_filler] = -1  # fillers NULL in streams 0 and 1 only

    # streams 0/1: write row-major into R x 32, permute columns, read col-major
    v01 = y01.reshape(rows, _NCOLS)[:, RM_PERM_TC].T.reshape(-1)
    # stream 2: v2[i] = y[pi(i)], pi(i) = (P[i // R] + 32*(i % R) + 1) % Kp
    idx = np.arange(kp)
    v2 = y[(RM_PERM_TC[idx // rows] + _NCOLS * (idx % rows) + 1) % kp]

    # bit collection: w = [v0 | interlace(v1, v2)]
    w = np.empty(3 * kp, dtype=np.int64)
    w[:kp] = v01
    w[kp::2] = np.where(v01 >= 0, d + v01, -1)
    w[kp + 1::2] = np.where(v2 >= 0, 2 * d + v2, -1)
    return w


def _rv_start(k: int, rv: int, ncb: int) -> int:
    rows = (k + 4 + _NCOLS - 1) // _NCOLS
    return rows * (2 * ((ncb + 8 * rows - 1) // (8 * rows)) * rv + 2)


@functools.lru_cache(maxsize=4096)
def rm_indices(
    k: int, rv: int, e: int, ncb: int | None = None, n_filler: int = 0
) -> np.ndarray:
    """Gather indices (E,) into the flat d (3*(K+4),) for one transmission."""
    w = _w_to_d_index(k, n_filler)
    if ncb is None:
        ncb = w.shape[0]
    k0 = _rv_start(k, rv, ncb)
    ring = (k0 + np.arange(ncb)) % ncb
    valid = ring[w[ring] >= 0]  # non-NULL positions in ring order from k0
    reps = -(-e // valid.shape[0])
    return w[np.tile(valid, reps)[:e]]


@functools.lru_cache(maxsize=4096)
def _rm_indices_t(k: int, rv: int, e: int, n_filler: int,
                  device: torch.device) -> torch.Tensor:
    return torch.as_tensor(rm_indices(k, rv, e, n_filler=n_filler),
                           device=device)


def rate_match(
    d: torch.Tensor, k: int, rv: int, e: int, n_filler: int = 0
) -> torch.Tensor:
    """d (B, 3, K+4) bits → (B, E) rate-matched bits."""
    g = _rm_indices_t(k, rv, e, n_filler, d.device)
    return d.reshape(d.shape[:-2] + (3 * (k + 4),))[..., g]


def rate_dematch(
    e_llr: torch.Tensor,
    k: int,
    rv: int,
    softbuffer: torch.Tensor | None = None,
    n_filler: int = 0,
) -> torch.Tensor:
    """Soft-combine received LLRs into the d-stream soft-buffer.

    Args:
      e_llr: (B, E) float32 LLRs of one transmission.
      softbuffer: (B, 3, K+4) accumulated LLRs from earlier transmissions
        (HARQ), or None for a fresh buffer.  It is not modified.

    Returns:
      (B, 3, K+4) combined LLRs, the input of ``ops.turbo.turbo_decode``.
    """
    g = _rm_indices_t(k, rv, e_llr.shape[-1], n_filler, e_llr.device)
    batch = e_llr.shape[:-1]
    if softbuffer is None:
        flat = torch.zeros(batch + (3 * (k + 4),), dtype=torch.float32,
                           device=e_llr.device)
    else:
        flat = softbuffer.reshape(batch + (3 * (k + 4),)).to(torch.float32)
    flat = flat.index_add(-1, g, e_llr.to(torch.float32))
    return flat.reshape(batch + (3, k + 4))


# --- convolutionally-coded channels (TS 36.212 §5.1.4.2) ----------------------


@functools.lru_cache(maxsize=1024)
def conv_rm_indices(n: int, e: int) -> np.ndarray:
    """Rate-matching gather for convolutionally-coded channels (reference
    rm_conv.c): indices (E,) into the flat (3*N,) d-streams."""
    rows = (n + _NCOLS - 1) // _NCOLS
    kp = rows * _NCOLS
    y = np.full(kp, -1, dtype=np.int64)
    y[kp - n:] = np.arange(n)
    v = y.reshape(rows, _NCOLS)[:, RM_PERM_CC].T.reshape(-1)
    w = np.concatenate([np.where(v >= 0, s * n + v, -1) for s in range(3)])
    valid = w[w >= 0]
    reps = (e + valid.shape[0] - 1) // valid.shape[0]
    return np.tile(valid, reps)[:e]


def conv_rate_match(d: torch.Tensor, e: int) -> torch.Tensor:
    """d (B, 3, N) bits → (B, E)."""
    n = d.shape[-1]
    g = torch.as_tensor(conv_rm_indices(n, e), device=d.device)
    return d.reshape(d.shape[:-2] + (3 * n,))[..., g]


def conv_rate_dematch(e_llr: torch.Tensor, n: int) -> torch.Tensor:
    """(B, E) LLRs → (B, 3, N) combined d-stream LLRs.

    Where E exceeds 3N the gather repeats (PDCCH at L=8 sends each of 3·44
    bits about 4 times).  JAX's scatter-add sums the repeats in transmit
    order; here the E positions are cut into passes over the 3N distinct
    indices and the passes are added in that order, so the sums are the
    same in every bit and no atomics are involved."""
    e = e_llr.shape[-1]
    period = 3 * n
    idx = torch.as_tensor(conv_rm_indices(n, min(e, period)), device=e_llr.device)
    x = e_llr.to(torch.float32)
    acc = x[..., :min(e, period)]
    for start in range(period, e, period):
        part = x[..., start:start + period]
        acc = torch.cat([acc[..., :part.shape[-1]] + part, acc[..., part.shape[-1]:]], dim=-1)
    flat = torch.zeros(x.shape[:-1] + (period,), dtype=torch.float32, device=x.device)
    flat[..., idx] = acc
    return flat.reshape(x.shape[:-1] + (3, n))
