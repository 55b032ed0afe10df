"""NR polar code: construction, encoder, SC decoder, TS 38.212 §5.3.1.

Port counterpart of ``srsran_4g_tpu/ops/polar.py``:

- encoder: the generator F^{⊗n} butterfly, log2(N) XOR stages over (B, N);
- construction: the NR universal reliability sequence (mother-code tables,
  utils/polar_tables.npz, copied from the JAX package) → frozen set for
  (K, N);
- decoder: batched successive cancellation as the SC tree.  JAX runs one
  ``fori_loop`` step per decoded bit and recomputes the whole top-down path
  each time; here every node's f (min-sum) and g updates run once, the
  partial sums are passed up as ±1 (``1 - 2x``), and subtrees that carry no
  information bit are skipped (their decisions are 0).  Each node's LLR is
  the same expression of the same inputs as in JAX, so the decided u vector
  is the same bit for bit.  Rate-1 nodes are not shortcut: punctured
  positions enter as LLR 0, and a hard-decision shortcut can break such
  ties differently.  The whole batch advances through the tree together, a
  few kernels a node.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch


@functools.lru_cache(maxsize=1)
def _tables():
    path = os.path.join(os.path.dirname(__file__), "..", "utils", "polar_tables.npz")
    with np.load(os.path.abspath(path)) as f:
        return {k: f[k] for k in f.files}


@functools.lru_cache(maxsize=64)
def frozen_mask(k: int, n_log: int) -> np.ndarray:
    """(N,) bool — True where the bit is frozen (not information)."""
    n = 1 << n_log
    mother = _tables()[f"mother_{n_log}"]
    mask = np.ones(n, dtype=bool)
    mask[mother[n - k:]] = False  # most reliable K positions carry info
    return mask


@functools.lru_cache(maxsize=64)
def _index_t(idx: tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def encode(u: torch.Tensor) -> torch.Tensor:
    """Polar transform x = u · F^{⊗n} (natural bit order): (..., N) → int8."""
    n = u.shape[-1]
    x = u.to(torch.int32)
    stage = 1
    while stage < n:
        xr = x.reshape(x.shape[:-1] + (n // (2 * stage), 2, stage))
        x = torch.stack([xr[..., 0, :] ^ xr[..., 1, :], xr[..., 1, :]], dim=-2).reshape(x.shape)
        stage *= 2
    return x.to(torch.int8)


def encode_info(bits: torch.Tensor, n_log: int) -> torch.Tensor:
    """Place K info bits into the reliable positions and encode."""
    info = _index_t(tuple(np.nonzero(~frozen_mask(bits.shape[-1], n_log))[0].tolist()),
                    bits.device)
    u = bits.new_zeros(bits.shape[:-1] + (1 << n_log,), dtype=torch.int32)
    u[..., info] = bits.to(torch.int32)
    return encode(u)


def fold(llrs: torch.Tensor, n: int) -> torch.Tensor:
    """Undo repetition rate matching: (..., E) LLRs, where transmitted bit j
    carries codeword position j mod n, → (..., n) sums.  JAX writes this as
    ``zeros.at[..., arange(E) % n].add(llrs)``, a scatter with repeated
    indices; ``index_add`` on CUDA sums repeats with atomics in no fixed
    order, so here the E positions are cut into passes of n distinct
    positions, added one pass at a time in transmit order onto zeros: the
    same sums in every bit on the CPU and the card."""
    acc = llrs.new_zeros(llrs.shape[:-1] + (n,), dtype=torch.float32)
    x = llrs.to(torch.float32)
    for s in range(0, x.shape[-1], n):
        part = x[..., s:s + n]
        w = part.shape[-1]
        acc = part + acc if w == n else torch.cat([acc[..., :w] + part, acc[..., w:]], dim=-1)
    return acc


def _f(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Check-node combine (min-sum): sign(a)·sign(b)·min(|a|, |b|).  The sign
    of a·b is that product's sign (IEEE keeps it through underflow and
    overflow); where a or b is 0 the magnitude is 0."""
    return torch.copysign(torch.minimum(a.abs(), b.abs()), a * b)


def decode_masked(llrs: torch.Tensor, mask_np) -> torch.Tensor:
    """Batched SC decode with an explicit frozen mask; returns the full
    decided u vector (B, N) int32 — used by the 38.212-exact layer
    (ops/polar_3gpp.py), whose frozen sets depend on (K, E)."""
    return _sc_decode(llrs, np.asarray(mask_np, dtype=bool))


def decode(llrs: torch.Tensor, k: int, n_log: int) -> torch.Tensor:
    """Batched successive-cancellation decode.

    Args:
      llrs: (B, N) float32, positive ⇒ bit 1 (framework convention).
    Returns:
      (B, K) int8 info bits.
    """
    mask = frozen_mask(k, n_log)
    u = _sc_decode(llrs, mask)
    return u[:, _index_t(tuple(np.nonzero(~mask)[0].tolist()), llrs.device)].to(torch.int8)


def _sc_decode(llrs: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """The SC tree over (B, N) LLRs (internal sign: positive ⇒ bit 0)."""
    decided: dict[int, torch.Tensor] = {}

    def node(l: torch.Tensor, start: int) -> torch.Tensor | None:
        """Decode the subtree whose LLRs are l (B, size) and whose first bit
        is u[start]; return its partial sums as 1 - 2x, or None if all 0."""
        size = l.shape[-1]
        if mask[start:start + size].all():
            return None
        if size == 1:
            bit = l < 0
            decided[start] = bit[:, 0]
            return torch.where(bit, -1.0, 1.0)
        half = size // 2
        a, b = l[:, :half], l[:, half:]
        left = node(_f(a, b), start)
        right = node(b + a if left is None else b + left * a, start + half)
        if right is None:
            right = torch.ones_like(a)
        return torch.cat([right if left is None else left * right, right], dim=-1)

    node(-llrs.to(torch.float32), 0)
    u = torch.zeros((llrs.shape[0], mask.shape[0]), dtype=torch.int32, device=llrs.device)
    if decided:
        pos = tuple(sorted(decided))
        u[:, _index_t(pos, llrs.device)] = torch.stack(
            [decided[p] for p in pos], dim=-1).to(torch.int32)
    return u
