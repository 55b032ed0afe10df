"""NR resource allocation: MCS tables + TBS determination (TS 38.214).

Counterpart of `lib/src/phy/phch/ra_nr.c` (srsran_ra_nr_tbs,
srsran_ra_nr_mcs_to_qm_r): MCS index table 1 (38.214 Table 5.1.3.1-1),
the N_info quantisation procedure of 38.214 5.1.3.2, and the TBS table
for N_info <= 3824 (Table 5.1.3.2-1).
"""

from __future__ import annotations

import math

# 38.214 Table 5.1.3.1-1: MCS index -> (Qm, R*1024)
MCS_TABLE_1 = [
    (2, 120), (2, 157), (2, 193), (2, 251), (2, 308), (2, 379), (2, 449),
    (2, 526), (2, 602), (2, 679), (4, 340), (4, 378), (4, 434), (4, 490),
    (4, 553), (4, 616), (4, 658), (6, 438), (6, 466), (6, 517), (6, 567),
    (6, 616), (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (6, 910),
    (6, 948),
]

# 38.214 Table 5.1.3.2-1: TBS for N_info <= 3824
TBS_TABLE = [
    24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 136, 144,
    152, 160, 168, 176, 184, 192, 208, 224, 240, 256, 272, 288, 304, 320,
    336, 352, 368, 384, 408, 432, 456, 480, 504, 528, 552, 576, 608, 640,
    672, 704, 736, 768, 808, 848, 888, 928, 984, 1032, 1064, 1128, 1160,
    1192, 1224, 1256, 1288, 1320, 1352, 1416, 1480, 1544, 1608, 1672,
    1736, 1800, 1864, 1928, 2024, 2088, 2152, 2216, 2280, 2408, 2472,
    2536, 2600, 2664, 2728, 2792, 2856, 2976, 3104, 3240, 3368, 3496,
    3624, 3752, 3824,
]


def mcs_to_qm_r(mcs: int) -> tuple[int, float]:
    qm, r1024 = MCS_TABLE_1[mcs]
    return qm, r1024 / 1024.0


def nof_re_per_prb(nof_symb: int = 12, nof_dmrs_re: int = 12,
                   overhead: int = 0) -> int:
    """N'_RE per PRB, capped at 156 (38.214 5.1.3.2 step 1)."""
    n = 12 * nof_symb - nof_dmrs_re - overhead
    return min(156, n)


def tbs(nof_prb: int, mcs: int, nof_symb: int = 12, nof_dmrs_re: int = 12,
        n_layers: int = 1, overhead: int = 0) -> int:
    """38.214 5.1.3.2 TBS determination."""
    qm, r = mcs_to_qm_r(mcs)
    n_re = nof_re_per_prb(nof_symb, nof_dmrs_re, overhead) * nof_prb
    n_info = n_re * r * qm * n_layers
    if n_info <= 3824:
        n = max(3, int(math.log2(n_info)) - 6)
        np_info = max(24, (1 << n) * (int(n_info) >> n))
        for t in TBS_TABLE:
            if t >= np_info:
                return t
        return TBS_TABLE[-1]
    n = int(math.log2(n_info - 24)) - 5
    np_info = max(3840, (1 << n) * round((n_info - 24) / (1 << n)))
    if r <= 0.25:
        c = math.ceil((np_info + 24) / 3816)
        return 8 * c * math.ceil((np_info + 24) / (8 * c)) - 24
    if np_info > 8424:
        c = math.ceil((np_info + 24) / 8424)
        return 8 * c * math.ceil((np_info + 24) / (8 * c)) - 24
    return 8 * math.ceil((np_info + 24) / 8) - 24


def dl_tbs(mcs: int, nof_prb: int) -> int:
    """Convenience: PDSCH mapping type A, type-1 DMRS 2 symbols."""
    return tbs(nof_prb, mcs, nof_symb=11, nof_dmrs_re=12)


def sliv_encode(n: int, s: int, l: int) -> int:
    """NR start-and-length indicator (38.214 §5.1.2.1; `common/sliv.c:37`)."""
    if (l - 1) <= n // 2:
        return n * (l - 1) + s
    return n * (n - l + 1) + (n - 1 - s)


def sliv_decode(n: int, v: int) -> tuple[int, int]:
    """SLIV → (S, L) (`common/sliv.c:24`)."""
    low, high = v % n, v // n
    if high + 1 + low <= n:
        return low, high + 1
    return n - 1 - low, n - high + 1
