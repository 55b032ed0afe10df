"""Bit packing and unpacking (host and device).

Port counterpart of ``srsran_4g_tpu/utils/bits.py`` (the reference's
`lib/src/phy/utils/bit.c`).  Bits are MSB-first within bytes and words, the
reference's convention for transport blocks.
"""

from __future__ import annotations

import numpy as np
import torch


def unpack_bytes_np(data: np.ndarray, n_bits: int | None = None) -> np.ndarray:
    bits = np.unpackbits(data.astype(np.uint8), axis=-1)
    if n_bits is not None:
        bits = bits[..., :n_bits]
    return bits


def pack_bytes_np(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits.astype(np.uint8), axis=-1)


def pack_bits_to_u32(bits: torch.Tensor) -> torch.Tensor:
    """(..., N) bits → (..., N/32) words, MSB-first per word.  torch has no
    uint32 arithmetic on every device, so the words are int64 holding the
    uint32 values."""
    n = bits.shape[-1]
    if n % 32:
        raise ValueError(f"pack_bits_to_u32 takes a multiple of 32 bits, not {n}")
    b = bits.reshape(bits.shape[:-1] + (n // 32, 32)).to(torch.int64)
    shifts = torch.arange(31, -1, -1, device=bits.device)
    return (b << shifts).sum(dim=-1)
