"""DL/UL resource allocation: MCS → modulation/TBS, RIV allocations.

Port counterpart of ``srsran_4g_tpu/models/ra.py`` (the reference's
`lib/src/phy/phch/{ra.c,ra_dl.c,ra_ul.c}` and its `tbs_tables.h`), a copy.
The TBS matrix and MCS→I_TBS mappings are 3GPP TS 36.213 tables
7.1.7.2.1-1 / 7.1.7.1-1 / 8.6.1-1, in the port's own copy of the table file,
``srsran_4g_tpu_torch/utils/tbs_tables.npz`` (pure specification data).
"""

from __future__ import annotations

import functools
import os

import numpy as np

_NPZ = os.path.join(os.path.dirname(__file__), "..", "utils", "tbs_tables.npz")


@functools.lru_cache(maxsize=1)
def _tables():
    with np.load(os.path.abspath(_NPZ)) as z:
        return {k: z[k] for k in z.files}


# DL modulation per MCS (TS 36.213 Table 7.1.7.1-1 / -1A)
def dl_mcs_to_mod(mcs: int, use_256qam: bool = False) -> str:
    if use_256qam:
        if mcs <= 4:
            return "qpsk"
        if mcs <= 10:
            return "16qam"
        if mcs <= 19:
            return "64qam"
        return "256qam"
    if mcs <= 9:
        return "qpsk"
    if mcs <= 16:
        return "16qam"
    return "64qam"


def dl_mcs_to_itbs(mcs: int, use_256qam: bool = False) -> int:
    t = _tables()
    key = "dl_mcs_to_itbs_256" if use_256qam else "dl_mcs_to_itbs"
    return int(t[key][mcs])


def ul_mcs_to_mod(mcs: int) -> str:
    if mcs <= 10:
        return "qpsk"
    if mcs <= 20:
        return "16qam"
    return "64qam"


def ul_mcs_to_itbs(mcs: int) -> int:
    return int(_tables()["ul_mcs_to_itbs"][mcs])


def tbs_from_itbs(itbs: int, n_prb: int) -> int:
    """TS 36.213 Table 7.1.7.2.1-1."""
    assert 1 <= n_prb <= 110
    return int(_tables()["tbs"][itbs, n_prb - 1])


def dl_tbs(mcs: int, n_prb: int, use_256qam: bool = False) -> int:
    return tbs_from_itbs(dl_mcs_to_itbs(mcs, use_256qam), n_prb)


# --- type-2 (contiguous) allocations: RIV encoding, TS 36.213 §7.1.6.3 -----


def riv_encode(n_rb: int, l_crbs: int, rb_start: int) -> int:
    if (l_crbs - 1) <= n_rb // 2:
        return n_rb * (l_crbs - 1) + rb_start
    return n_rb * (n_rb - l_crbs + 1) + (n_rb - 1 - rb_start)


def riv_decode(n_rb: int, riv: int) -> tuple[int, int]:
    """→ (l_crbs, rb_start)."""
    l_crbs = riv // n_rb + 1
    rb_start = riv % n_rb
    if l_crbs + rb_start > n_rb:  # invalid ⇒ the flipped encoding was used
        l_crbs = n_rb - l_crbs + 2
        rb_start = n_rb - 1 - rb_start
    return l_crbs, rb_start


def type0_alloc_to_prbs(bitmap: int, n_rb: int) -> tuple[int, ...]:
    """Resource allocation type 0: RBG bitmap → PRB tuple (§7.1.6.1)."""
    p = rbg_size(n_rb)
    n_rbg = -(-n_rb // p)
    prbs = []
    for g in range(n_rbg):
        if (bitmap >> (n_rbg - 1 - g)) & 1:
            prbs.extend(range(g * p, min((g + 1) * p, n_rb)))
    return tuple(prbs)


def rbg_size(n_rb: int) -> int:
    if n_rb <= 10:
        return 1
    if n_rb <= 26:
        return 2
    if n_rb <= 63:
        return 3
    return 4


# -- distributed (type 2) VRB geometry, 36.211 §6.2.3.2 / 36.213 §7.1.6.3 --
# (reference: lib/src/phy/phch/ra.c srsran_ra_type2_{ngap,n_rb_step,n_vrb_dl})

def type2_ngap(n_rb: int, ngap_is_1: bool = True) -> int:
    """N_gap, 36.211 Table 6.2.3.2-1."""
    if n_rb <= 10:
        return n_rb // 2
    if n_rb == 11:
        return 4
    if n_rb <= 19:
        return 8
    if n_rb <= 26:
        return 12
    if n_rb <= 44:
        return 18
    if n_rb <= 49:
        return 27
    if n_rb <= 63:
        return 27 if ngap_is_1 else 9
    if n_rb <= 79:
        return 32 if ngap_is_1 else 16
    return 48 if ngap_is_1 else 16


def type2_n_rb_step(n_rb: int) -> int:
    """N_RB_step, 36.213 Table 7.1.6.3-1."""
    return 2 if n_rb < 50 else 4


def type2_n_vrb_dl(n_rb: int, ngap_is_1: bool = True) -> int:
    """N_VRB_DL for distributed allocation, 36.211 §6.2.3.2."""
    ngap = type2_ngap(n_rb, ngap_is_1)
    if ngap_is_1:
        return 2 * min(ngap, n_rb - ngap)
    return (n_rb // ngap) * 2 * ngap


def prbs_to_rbg_bitmap(prbs, n_rb: int) -> int:
    """Inverse of type0_alloc_to_prbs: PRB set (whole RBGs) → RBG bitmap."""
    p = rbg_size(n_rb)
    n_rbg = -(-n_rb // p)
    s = set(prbs)
    bitmap = 0
    for g in range(n_rbg):
        blk = range(g * p, min((g + 1) * p, n_rb))
        if all(q in s for q in blk):
            bitmap |= 1 << (n_rbg - 1 - g)
    assert set(type0_alloc_to_prbs(bitmap, n_rb)) == s, \
        "PRB set is not RBG-aligned"
    return bitmap


# 36.213 Table 7.1.7.2.3-1: TBS for DCI format 1C (QPSK always; the MCS
# field IS the row index) — reference ra_dl.c:37 tbs_format1c_table
TBS_FORMAT1C = (
    40, 56, 72, 120, 136, 144, 176, 208, 224, 256, 280,
    296, 328, 336, 392, 488, 552, 600, 632, 696, 776, 840,
    904, 1000, 1064, 1128, 1224, 1288, 1384, 1480, 1608, 1736)


def dl_tbs_1c(i_tbs: int) -> int:
    return TBS_FORMAT1C[i_tbs]
