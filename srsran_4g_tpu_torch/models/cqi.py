"""CQI reporting: SNR→CQI mapping and report pack/unpack.

Port counterpart of ``srsran_4g_tpu/models/cqi.py``, a copy of that
JAX-free module (the reference's `lib/src/phy/phch/cqi.c`: wideband /
UE-selected / aperiodic report formats and the SNR-to-CQI table used by
`srsran_cqi_from_snr`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# SNR thresholds (dB) for CQI 1..15 — the reference's empirical table
# (cqi.c:735 cqi_to_snr_table).
_SNR_TO_CQI = np.array(
    [1.95, 4, 6, 8, 10, 11.95, 14.05, 16, 17.9, 20.9, 22.5, 24.75, 25.5,
     27.30, 29]
)


def cqi_from_snr(snr_db) -> np.ndarray:
    """Highest CQI whose threshold the SNR exceeds (0 if below CQI 1)."""
    snr = np.asarray(snr_db, dtype=np.float64)
    return np.sum(snr[..., None] >= _SNR_TO_CQI, axis=-1).astype(np.int64)


# CQI index → (modulation, code rate x1024), TS 36.213 Table 7.2.3-1
CQI_TO_MOD_RATE = {
    1: ("qpsk", 78), 2: ("qpsk", 120), 3: ("qpsk", 193), 4: ("qpsk", 308),
    5: ("qpsk", 449), 6: ("qpsk", 602), 7: ("16qam", 378), 8: ("16qam", 490),
    9: ("16qam", 616), 10: ("64qam", 466), 11: ("64qam", 567),
    12: ("64qam", 666), 13: ("64qam", 772), 14: ("64qam", 873),
    15: ("64qam", 948),
}


@dataclass(frozen=True)
class CqiReport:
    wideband_cqi: int
    subband_cqi: int | None = None  # UE-selected subband differential
    subband_label: int = 0
    rank: int = 1


def pack_wideband(report: CqiReport, pmi_present: bool = False,
                  pmi: int = 0, n_tx: int = 2) -> np.ndarray:
    """Wideband periodic report bits (cqi.c cqi_format2_wideband_pack)."""
    bits = [(report.wideband_cqi >> (3 - i)) & 1 for i in range(4)]
    if pmi_present:
        npmi = 2 if n_tx == 2 else 4
        bits += [(pmi >> (npmi - 1 - i)) & 1 for i in range(npmi)]
    return np.asarray(bits, dtype=np.int8)


def unpack_wideband(bits, pmi_present: bool = False, n_tx: int = 2):
    b = np.asarray(bits).astype(np.int64)
    cqi = int("".join(map(str, b[:4])), 2)
    pmi = None
    if pmi_present:
        npmi = 2 if n_tx == 2 else 4
        pmi = int("".join(map(str, b[4:4 + npmi])), 2)
    return cqi, pmi
