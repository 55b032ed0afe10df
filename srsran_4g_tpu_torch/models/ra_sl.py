"""Sidelink resource allocation (TS 36.213 §8.1.1 / §14.1.1).

Counterpart of the reference's `lib/src/phy/phch/ra_sl.c`: UL-type-0 RIV
for the PSSCH PRB allocation, PSCCH resource index → the two (PRB,
subframe) transmission opportunities inside a PSCCH period, and the
time-resource-pattern (TRP) subframe bitmaps gating PSSCH transmissions.
The N_TRP_{6,7,8} bitmap tables are 36.213 Table 14.1.1.1.1-1..3 spec
data (utils/trp_tables.npz).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from srsran_4g_tpu_torch.models.ra import riv_decode, riv_encode  # shared RIV

_NPZ = os.path.join(os.path.dirname(__file__), "..", "utils",
                    "trp_tables.npz")


@functools.lru_cache(maxsize=1)
def _trp_tables():
    with np.load(os.path.abspath(_NPZ)) as z:
        return {6: z["trp6"], 7: z["trp7"], 8: z["trp8"]}


def available_pool_prb(prb_num: int, prb_start: int, prb_end: int) -> int:
    """M: usable PRBs of the PSCCH pool (`ra_sl.c:29`)."""
    if prb_num * 2 <= prb_end - prb_start + 1:
        return prb_num * 2
    return prb_num * 2 - 1


def pscch_resources(prb_num: int, prb_start: int, prb_end: int,
                    sf_bitmap: np.ndarray, n_pscch: int
                    ) -> tuple[tuple[int, int], tuple[int, int]]:
    """PSCCH resource index n_pscch → ((prb_a, prb_b), (sf_a, sf_b)):
    the two transmission opportunities (36.213 14.2.1.1; `ra_sl.c:38`)."""
    m = available_pool_prb(prb_num, prb_start, prb_end)
    sf_idx = np.nonzero(np.asarray(sf_bitmap) == 1)[0]
    l = len(sf_idx)
    if l < 2:
        raise ValueError("PSCCH subframe bitmap needs >= 2 subframes")
    n = n_pscch % (l * m // 2)
    a1, b1 = n // l, n % l
    a2 = a1 + m // 2
    b2 = (n + 1 + (a1 % (l - 1))) % l
    return ((a1 + prb_start, a2 + prb_end + 1 - m),
            (int(sf_idx[b1]), int(sf_idx[b2])))


def trp_bitmap(trp_len: int, trp_idx: int) -> np.ndarray:
    """N_TRP bitmap row (k_TRP-ordered spec table)."""
    return _trp_tables()[trp_len][trp_idx]


def pssch_allowed_sf(pssch_sf_idx: int, trp_idx: int,
                     trp_len: int = 8) -> bool:
    """Is this PSSCH pool subframe enabled by the TRP? (`ra_sl.c:107`)."""
    tab = _trp_tables()[trp_len]
    return bool(tab[trp_idx][pssch_sf_idx % trp_len])


def trp_idx_from_k(trp_len: int, k_trp: int, occasion: int = 0) -> int:
    """First (or occasion-th) TRP index with exactly k_TRP set bits
    (`ra_sl.c srsran_sci_generate_trp_idx`)."""
    tab = _trp_tables()[trp_len]
    hits = np.nonzero(tab.sum(axis=1) == k_trp)[0]
    if len(hits) == 0:
        raise ValueError(f"no TRP with k={k_trp}")
    return int(hits[occasion % len(hits)])
