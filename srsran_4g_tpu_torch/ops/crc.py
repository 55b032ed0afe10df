"""CRC attachment/checking as GF(2) linear algebra, TS 36.212 §5.1.1.

Port counterpart of ``srsran_4g_tpu/ops/crc.py``.  A zero-initialised CRC is
a linear function of the message bits over GF(2):

    crc(m) = m @ G  (mod 2)

where row i of G is the CRC of a unit impulse at bit position i.  G is built
once per (message length, polynomial) on the host; the device side is one
float32 matmul and a parity reduction.  ``torch.matmul`` has no integer
path on CUDA, so the product stays float32: the operands are 0/1 (exact in
f32 and in TF32) and the accumulation is f32, exact up to 2^24 terms — far
above the largest LTE transport block (~392k bits).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srsran_4g_tpu_torch.utils.constants import CRC_POLYS


@functools.lru_cache(maxsize=64)
def _unit_crcs(n_bits: int, poly_key: str) -> np.ndarray:
    """CRC remainder of x^(order + j) mod g for j = 0..n_bits-1, as
    (n_bits, order) uint8, LSB of the remainder in column 0."""
    poly, order = CRC_POLYS[poly_key]
    out = np.empty((n_bits, order), dtype=np.uint8)
    rem = 1 << order
    if rem >> order:
        rem ^= poly
    shifts = np.arange(order)
    for j in range(n_bits):
        out[j] = (rem >> shifts) & 1
        rem <<= 1
        if rem >> order:
            rem ^= poly
    return out


@functools.lru_cache(maxsize=64)
def crc_matrix(n_bits: int, poly_key: str) -> np.ndarray:
    """G matrix (n_bits, order) uint8: crc(m) = m @ G mod 2, MSB-first bits.

    m[0] is the first (highest-order) message bit; column c is the CRC bit
    of weight 2^(order-1-c), i.e. the CRC is appended MSB-first as well.
    """
    return _unit_crcs(n_bits, poly_key)[::-1, ::-1].copy()


@functools.lru_cache(maxsize=64)
def _crc_matrix_t(n_bits: int, poly_key: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(crc_matrix(n_bits, poly_key), dtype=torch.float32,
                           device=device)


def crc_np(bits: np.ndarray, poly_key: str) -> np.ndarray:
    """Host CRC of MSB-first bit array (..., N) → (..., order) parity bits."""
    g = crc_matrix(bits.shape[-1], poly_key).astype(np.int64)
    return (bits.astype(np.int64) @ g) % 2


def crc_attach_np(bits: np.ndarray, poly_key: str) -> np.ndarray:
    """bits (..., N) with their CRC appended, (..., N + order), in bits' dtype."""
    return np.concatenate([bits, crc_np(bits, poly_key).astype(bits.dtype)], axis=-1)


def _remainder(bits: torch.Tensor, poly_key: str) -> torch.Tensor:
    g = _crc_matrix_t(bits.shape[-1], poly_key, bits.device)
    acc = torch.matmul(bits.to(torch.float32), g)
    return acc.to(torch.int32) & 1


def crc_compute(bits: torch.Tensor, poly_key: str) -> torch.Tensor:
    """CRC of bits (..., N) 0/1 → (..., order) int8 parity bits."""
    return _remainder(bits, poly_key).to(torch.int8)


def crc_check(bits_with_crc: torch.Tensor, poly_key: str) -> torch.Tensor:
    """Check a trailing CRC; bool (...,), True = CRC OK (the CRC of the
    whole message including its parity is zero)."""
    return (_remainder(bits_with_crc, poly_key) == 0).all(dim=-1)
