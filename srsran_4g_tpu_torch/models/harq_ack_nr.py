"""NR HARQ-ACK codebooks (TS 38.213 §9.1).

Counterpart of `lib/src/phy/phch/harq_ack.c` (NR): the type-1
(semi-static) codebook — a fixed-size bitmap over all configured
(slot, TB) candidate positions, NACK-filled where nothing was
scheduled — and the type-2 (dynamic) codebook ordered by DAI with
modulo-4 wraparound recovery.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class AckBit:
    slot: int
    tb: int = 0
    ack: bool = False


def type1_codebook(occasions: list[tuple[int, int]],
                   acks: dict[tuple[int, int], bool]) -> list[int]:
    """Semi-static: one bit per configured (slot, tb) candidate, NACK
    (0) when nothing was received there."""
    return [1 if acks.get(occ, False) else 0 for occ in sorted(occasions)]


def type2_codebook(received: list[tuple[int, bool]]) -> list[int]:
    """Dynamic: received = [(dai, ack)] in reception order; the DAI
    counts scheduled PDSCHs mod 4, so gaps (missed DCIs) are detected
    and filled with NACK."""
    out: list[int] = []
    expected = 1
    for dai, ack in received:
        # fill missed assignments (DAI jumped ahead, mod-4)
        gap = (dai - expected) % 4
        out.extend([0] * gap)
        out.append(1 if ack else 0)
        expected = (dai % 4) + 1
    return out


def multiplex_with_sr(ack_bits: list[int], sr: bool) -> list[int]:
    """HARQ-ACK + SR multiplexing on PUCCH (38.213 9.2.5)."""
    return ack_bits + [1 if sr else 0]
