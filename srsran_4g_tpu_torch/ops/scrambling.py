"""Scrambling / descrambling, TS 36.211 §6.3.1.

Port counterpart of ``srsran_4g_tpu/ops/scrambling.py``: XOR for bits, sign
flip for LLRs.  The sequence comes from ``ops/sequence.py``.
"""

from __future__ import annotations

import torch


def pdsch_cinit(rnti: int, codeword: int, subframe: int, cell_id: int) -> int:
    """c_init for PDSCH scrambling (TS 36.211 §6.3.1): n_s = 2·subframe."""
    return (rnti << 14) + (codeword << 13) + (subframe << 9) + cell_id


def pbch_cinit(cell_id: int) -> int:
    """c_init for PBCH scrambling (TS 36.211 §6.6.1)."""
    return cell_id


def pcfich_cinit(subframe: int, cell_id: int) -> int:
    """c_init for PCFICH scrambling (TS 36.211 §6.7.1)."""
    return (subframe + 1) * (2 * cell_id + 1) * (1 << 9) + cell_id


def pdcch_cinit(subframe: int, cell_id: int) -> int:
    """c_init for PDCCH scrambling (TS 36.211 §6.8.2): n_s = 2·subframe."""
    return (subframe << 9) + cell_id


def scramble_bits(bits: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """bits, seq: (..., N) 0/1 → XOR, int8."""
    return torch.bitwise_xor(bits.to(torch.int8), seq.to(torch.int8))


def descramble_llrs(llrs: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """Flip the LLR sign where the scrambling bit is 1 (positive LLR ⇒ bit 1).

    The sequence is cast to float before ``1 - 2c``: on a uint8 tensor the
    subtraction would wrap to 255.
    """
    sign = 1.0 - 2.0 * seq.to(torch.float32)
    return llrs * sign
