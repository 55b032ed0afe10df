"""Gold (pseudo-random) sequence generation, TS 36.211 §7.2.

Port counterpart of ``srsran_4g_tpu/ops/sequence.py``: the cached host
tables (``gold_sequence_np``) and the on-device generator from a tensor of
seeds (``gold_sequence``).

    x1(n+31) = x1(n+3) + x1(n)                      (mod 2)
    x2(n+31) = x2(n+3) + x2(n+2) + x2(n+1) + x2(n)  (mod 2)
    c(n)     = x1(n + Nc) + x2(n + Nc),  Nc = 1600

The Nc fast-forward of x2 is a linear map of the seed over GF(2), so the
advanced state is the XOR of 31 precomputed basis states; bits are then
produced 28 at a time from the 31-bit register states.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.utils.constants import GOLD_SEQ_NC

_MASK31 = (1 << 31) - 1
_PAR_BITS = 28  # max parallel step: 31 - (max shift 3)


def _step_x1_par(state: int) -> int:
    """Advance the x1 register by 28 positions (bit i of state = x1(n+i))."""
    new = ((state >> 3) ^ state) & ((1 << _PAR_BITS) - 1)
    return ((state >> _PAR_BITS) | (new << 3)) & _MASK31


def _step_x2_par(state: int) -> int:
    new = ((state >> 3) ^ (state >> 2) ^ (state >> 1) ^ state) & ((1 << _PAR_BITS) - 1)
    return ((state >> _PAR_BITS) | (new << 3)) & _MASK31


def _step_x1_single(state: int) -> int:
    b = ((state >> 3) ^ state) & 1
    return ((state >> 1) | (b << 30)) & _MASK31


def _step_x2_single(state: int) -> int:
    b = ((state >> 3) ^ (state >> 2) ^ (state >> 1) ^ state) & 1
    return ((state >> 1) | (b << 30)) & _MASK31


@functools.lru_cache(maxsize=1)
def _x1_state_after_nc() -> int:
    s = 1
    for _ in range(GOLD_SEQ_NC):
        s = _step_x1_single(s)
    return s


@functools.lru_cache(maxsize=1)
def _x2_basis_after_nc() -> np.ndarray:
    """x2 state after Nc steps for each single-bit seed (GF(2) basis)."""
    basis = np.zeros(31, dtype=np.uint32)
    for i in range(31):
        s = 1 << i
        for _ in range(GOLD_SEQ_NC):
            s = _step_x2_single(s)
        basis[i] = s
    return basis


def x2_init_after_nc(c_init: int) -> int:
    """x2 register state at n = Nc for a given seed."""
    basis = _x2_basis_after_nc()
    s = 0
    for i in range(31):
        if (c_init >> i) & 1:
            s ^= int(basis[i])
    return s


@functools.lru_cache(maxsize=4096)
def gold_sequence_np(c_init: int, length: int) -> np.ndarray:
    """Gold sequence bits c(0..length-1) as a uint8 ndarray (host, cached)."""
    s1 = _x1_state_after_nc()
    s2 = x2_init_after_nc(c_init)
    nchunks = (length + _PAR_BITS - 1) // _PAR_BITS
    out = np.empty(nchunks * _PAR_BITS, dtype=np.uint8)
    mask = (1 << _PAR_BITS) - 1
    shifts = np.arange(_PAR_BITS, dtype=np.uint32)
    for i in range(nchunks):
        c = (s1 ^ s2) & mask
        out[i * _PAR_BITS:(i + 1) * _PAR_BITS] = ((c >> shifts) & 1).astype(np.uint8)
        s1 = _step_x1_par(s1)
        s2 = _step_x2_par(s2)
    return out[:length]


# --- device path ------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _x2_bit_basis(length: int) -> tuple[np.ndarray, np.ndarray]:
    """(x1 bits (length,), x2 bits (31, length)) at n >= Nc: the x1 part is
    the same for every seed, and the x2 part is linear in the seed over
    GF(2), so c(n) for seed s is x1 XOR (the XOR of the rows of the basis
    that the bits of s select)."""
    x1 = gold_sequence_np(0, length)
    basis = np.stack([gold_sequence_np(1 << i, length) ^ x1 for i in range(31)])
    return x1, basis


@functools.lru_cache(maxsize=64)
def _x2_bit_basis_t(length: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    x1, basis = _x2_bit_basis(length)
    return (torch.as_tensor(x1.astype(np.int64), device=device),
            torch.as_tensor(basis.astype(np.float32), device=device))


def gold_sequence(c_init, length: int,
                  device: torch.device | str | None = None) -> torch.Tensor:
    """Gold sequence bits from seeds on the device (the JAX package's
    in-graph ``gold_sequence``).

    Args:
      c_init: int or a tensor of seeds (...,), 31-bit values; a tensor is
        used on its device, an int goes to ``device`` (default CUDA).
      length: sequence length.

    Returns:
      uint8 bits of shape ``c_init.shape + (length,)``.  The seed bits are
      taken from int64, so no sign extension reaches bit 30; the GF(2)
      combination is one float32 product of 0/1 values (sums <= 31, exact)
      and its parity.
    """
    if not isinstance(c_init, torch.Tensor):
        c_init = torch.tensor(c_init, device=resolve_device(device))
    seeds = c_init.to(torch.int64)
    x1, basis = _x2_bit_basis_t(length, seeds.device)
    seed_bits = (seeds[..., None] >> torch.arange(31, device=seeds.device)) & 1
    x2 = torch.matmul(seed_bits.to(torch.float32), basis).to(torch.int64)
    return ((x2 ^ x1) & 1).to(torch.uint8)
