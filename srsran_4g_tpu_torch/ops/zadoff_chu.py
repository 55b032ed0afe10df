"""Zadoff-Chu sequences (PSS, PRACH preambles, UL DMRS).

Port counterpart of ``srsran_4g_tpu/ops/zadoff_chu.py`` (the reference's
`lib/src/phy/common/zc_sequence.c` and the PSS generation in
`lib/src/phy/sync/pss.c`).  Host tables (numpy), built once per root.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=256)
def zadoff_chu(root: int, length: int, shift: int = 0) -> np.ndarray:
    """x_u(n) = exp(-jπ u n(n+1+2·shift) / N) for odd-length N."""
    n = np.arange(length)
    return np.exp(-1j * np.pi * root * n * (n + 1 + 2 * shift) / length).astype(
        np.complex64
    )


_PSS_ROOTS = {0: 25, 1: 29, 2: 34}


@functools.lru_cache(maxsize=8)
def pss_sequence(n_id_2: int) -> np.ndarray:
    """62-element PSS (TS 36.211 §6.11.1.1): ZC-63 with the center punctured."""
    u = _PSS_ROOTS[n_id_2]
    n = np.arange(31)
    first = np.exp(-1j * np.pi * u * n * (n + 1) / 63)
    n2 = np.arange(31, 62)
    second = np.exp(-1j * np.pi * u * (n2 + 1) * (n2 + 2) / 63)
    return np.concatenate([first, second]).astype(np.complex64)
