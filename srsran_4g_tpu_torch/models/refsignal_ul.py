"""UL demodulation reference signals (PUSCH/PUCCH DMRS, SRS base),
TS 36.211 §5.5.

Port counterpart of ``srsran_4g_tpu/models/refsignal_ul.py``, a copy of
that JAX-free module (the reference's `lib/src/phy/ch_estimation/refsignal_ul.c`
and `lib/src/phy/common/zc_sequence.c`).  Base sequences r̄_{u,v}: cyclic
extension of a prime-length Zadoff-Chu for allocations ≥ 3 PRB, the
TS 36.211 Table 5.5.1.2-1/-2 φ sequences for 1-2 PRB (spec data in
utils/ul_dmrs_tables.npz).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from srsran_4g_tpu_torch.ops.sequence import gold_sequence_np
from srsran_4g_tpu_torch.utils.constants import NRE

_NPZ = os.path.join(os.path.dirname(__file__), "..", "utils", "ul_dmrs_tables.npz")


@functools.lru_cache(maxsize=1)
def _phi():
    with np.load(os.path.abspath(_NPZ)) as z:
        return {k: z[k] for k in z.files}


def _largest_prime_below(n: int) -> int:
    def is_prime(x):
        if x < 2:
            return False
        for d in range(2, int(x**0.5) + 1):
            if x % d == 0:
                return False
        return True

    p = n - 1
    while not is_prime(p):
        p -= 1
    return p


@functools.lru_cache(maxsize=512)
def base_sequence(u: int, v: int, m_sc: int) -> np.ndarray:
    """r̄_{u,v}(n), length m_sc (m_sc = 12·nof_prb), unit modulus."""
    if m_sc == NRE:
        phi = _phi()["phi_12"][u]
        return np.exp(1j * phi * np.pi / 4).astype(np.complex64)
    if m_sc == 2 * NRE:
        phi = _phi()["phi_24"][u]
        return np.exp(1j * phi * np.pi / 4).astype(np.complex64)
    nzc = _largest_prime_below(m_sc)
    q_bar = nzc * (u + 1) / 31.0
    q = int(np.floor(q_bar + 0.5)) + v * (1 if (2 * q_bar) % 2 < 1 else -1)
    # x_q ZC of prime length, cyclically extended
    m = np.arange(nzc)
    xq = np.exp(-1j * np.pi * q * m * (m + 1) / nzc)
    n = np.arange(m_sc)
    return xq[n % nzc].astype(np.complex64)


def group_hopping_pattern(cell_id: int, delta_ss: int = 0, enabled: bool = False):
    """f_gh(ns) + f_ss → sequence group u per slot (§5.5.1.3)."""
    f_ss = (cell_id + delta_ss) % 30
    if not enabled:
        return np.full(20, f_ss, dtype=np.int64)
    c = gold_sequence_np(cell_id // 30, 160)
    u = np.zeros(20, dtype=np.int64)
    for ns in range(20):
        f_gh = sum(int(c[8 * ns + i]) << i for i in range(8)) % 30
        u[ns] = (f_gh + f_ss) % 30
    return u


@functools.lru_cache(maxsize=512)
def pusch_dmrs(
    cell_id: int, nof_prb_alloc: int, slot: int,
    cyclic_shift: int = 0, delta_ss: int = 0,
) -> np.ndarray:
    """PUSCH DMRS sequence for one slot, length 12·nof_prb_alloc.

    r^(λ)(n) = e^{jαn} · r̄_{u,v}(n) with α = 2π·n_cs/12 (§5.5.2.1.1).
    Simplified n_cs: static cyclic shift only (no n_PN hopping) — matching
    the reference's behaviour with cshift dynamic bits 0 and hopping off.
    """
    m_sc = nof_prb_alloc * NRE
    u = int(group_hopping_pattern(cell_id, delta_ss)[slot])
    r = base_sequence(u, 0, m_sc)
    alpha = 2 * np.pi * cyclic_shift / 12.0
    n = np.arange(m_sc)
    return (r * np.exp(1j * alpha * n)).astype(np.complex64)
