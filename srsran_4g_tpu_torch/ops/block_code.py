"""Short linear block codes for UCI: (20, A) and (32, O) Reed-Muller.

Port counterpart of ``srsran_4g_tpu/ops/block_code.py`` (TS 36.212
§5.2.3.3 and §5.2.2.6.4; the reference's `lib/src/phy/fec/block/block.c`).
Basis matrices are spec tables (``utils/uci_tables.npz``, copied from the
JAX package).

Decoding is brute-force maximum likelihood: correlate the LLRs against all
2^A codewords (one (B, N) × (N, 2^A) product, as the JAX package computes
it outside any Pallas kernel), then the first maximum.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

_NPZ = os.path.join(os.path.dirname(__file__), "..", "utils", "uci_tables.npz")


@functools.lru_cache(maxsize=1)
def _tables():
    with np.load(os.path.abspath(_NPZ)) as z:
        return {k: z[k] for k in z.files}


def _basis(n: int) -> np.ndarray:
    return _tables()["rm20_basis" if n == 20 else "rm32_basis"]


@functools.lru_cache(maxsize=64)
def codebook(n: int, a: int) -> np.ndarray:
    """(2^A, N) all codewords as ±1 floats (+1 ⇔ bit 0)."""
    basis = _basis(n)[:, :a]  # (N, A)
    words = np.arange(1 << a)
    msgs = ((words[:, None] >> np.arange(a)) & 1).astype(np.int64)  # (2^A, A)
    cw = (msgs @ basis.T) % 2
    return (1.0 - 2.0 * cw).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _codebook_t(n: int, a: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(codebook(n, a), device=device)


@functools.lru_cache(maxsize=64)
def _basis_t(n: int, a: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_basis(n)[:, :a].T.astype(np.float32), device=device)


def encode(bits: torch.Tensor, n: int) -> torch.Tensor:
    """(B, A) info bits → (B, N) coded bits (A ≤ 13 for N=20, ≤ 11 for 32)."""
    acc = torch.matmul(bits.to(torch.float32), _basis_t(n, bits.shape[-1], bits.device))
    return (acc.to(torch.int32) & 1).to(torch.int8)


def decode(llrs: torch.Tensor, n: int, a: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ML decode (B, N) LLRs (positive ⇒ bit 1) → ((B, A) bits, (B,) metric)."""
    cb = _codebook_t(n, a, llrs.device)  # (2^A, N), +1 ⇔ bit 0
    corr = torch.matmul(-llrs.to(torch.float32), cb.T)
    best = torch.argmax(corr, dim=-1)  # the first maximum, as jnp.argmax
    bits = ((best[:, None] >> torch.arange(a, device=llrs.device)) & 1).to(torch.int8)
    return bits, corr.amax(dim=-1)
