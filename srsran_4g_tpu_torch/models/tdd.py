"""LTE TDD (frame structure type 2), TS 36.211 §4.2 / TS 36.213 §10.

Port counterpart of ``srsran_4g_tpu/models/tdd.py`` (the reference's TDD
support in `lib/src/phy/common/phy_common.c`, `lib/src/phy/phch/harq_ack.c`
and `sync.c`'s frame-type detection).  The tables are host numpy constants;
the per-subframe type selects which path runs and never enters a tensor.
The frame-type detector correlates the SSS at both position hypotheses
(FDD and TDD) in the same pass.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.models import sync
from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig, _symbol_offsets

# --- UL/DL configurations (TS 36.211 Table 4.2-2) ----------------------------
# 'D' downlink, 'U' uplink, 'S' special (DwPTS | GP | UpPTS)
UL_DL_CONFIGS = (
    "DSUUUDSUUU",  # 0
    "DSUUDDSUUD",  # 1
    "DSUDDDSUDD",  # 2
    "DSUUUDDDDD",  # 3
    "DSUUDDDDDD",  # 4
    "DSUDDDDDDD",  # 5
    "DSUUUDSUUD",  # 6
)

# Special-subframe configurations (Table 4.2-1, normal CP): DwPTS length in
# OFDM symbols; UpPTS is 1 symbol for configs 0-4 and 2 for configs 5-8.
DWPTS_SYMS = (3, 9, 10, 11, 12, 3, 9, 10, 11)
UPPTS_SYMS = (1, 1, 1, 1, 1, 2, 2, 2, 2)
N_SYMS_SF = 14  # normal CP


def sf_type(ul_dl_config: int, subframe: int) -> str:
    """'D' / 'U' / 'S' for (config, subframe) — srsran_sfidx_tdd_type."""
    return UL_DL_CONFIGS[ul_dl_config][subframe % 10]


def dl_symbol_mask(ul_dl_config: int, ssf_config: int, subframe: int) -> np.ndarray:
    """(14,) bool: symbols usable for DL transmission in this subframe
    (all for 'D', DwPTS only for 'S', none for 'U')."""
    t = sf_type(ul_dl_config, subframe)
    m = np.zeros(N_SYMS_SF, dtype=bool)
    if t == "D":
        m[:] = True
    elif t == "S":
        m[:DWPTS_SYMS[ssf_config]] = True
    return m


# --- HARQ-ACK downlink association sets (TS 36.213 Table 10.1.3.1-1) ---------
# For UL subframe n, the DL subframes {n-k : k in K} are acknowledged in n.
DL_ASSOC_SETS: tuple[dict[int, tuple[int, ...]], ...] = (
    {2: (6,), 4: (4,), 7: (6,), 9: (4,)},                       # config 0
    {2: (7, 6), 3: (4,), 7: (7, 6), 8: (4,)},                   # config 1
    {2: (8, 7, 4, 6), 7: (8, 7, 4, 6)},                         # config 2
    {2: (7, 6, 11), 3: (6, 5), 4: (5, 4)},                      # config 3
    {2: (12, 8, 7, 11), 3: (6, 5, 4, 7)},                       # config 4
    {2: (13, 12, 9, 8, 7, 5, 4, 11, 6)},                        # config 5
    {2: (7,), 3: (7,), 4: (5,), 7: (7,), 8: (7,)},              # config 6
)

# PUSCH scheduling timing (TS 36.213 Table 8-2): an UL grant received in DL
# subframe n schedules PUSCH in n+k (config 0's UL-index field aside).
UL_GRANT_K: tuple[dict[int, int], ...] = (
    {0: 4, 1: 6, 5: 4, 6: 6},                                   # config 0
    {1: 6, 4: 4, 6: 6, 9: 4},                                   # config 1
    {3: 4, 8: 4},                                               # config 2
    {0: 4, 8: 4, 9: 4},                                         # config 3
    {8: 4, 9: 4},                                               # config 4
    {8: 4},                                                     # config 5
    {0: 7, 1: 7, 5: 7, 6: 7, 9: 5},                             # config 6
)


def ack_subframe_for_dl(ul_dl_config: int, dl_subframe: int) -> int:
    """UL subframe index where the HARQ-ACK for a PDSCH in `dl_subframe` is
    reported."""
    for n_ul, ks in DL_ASSOC_SETS[ul_dl_config].items():
        for k in ks:
            if (n_ul - k) % 10 == dl_subframe % 10:
                return n_ul
    raise ValueError(f"subframe {dl_subframe} is not DL in config {ul_dl_config}")


def bundle_acks(acks: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """ACK/NACK bundling (TS 36.213 §10.1.3.2.1): logical AND across the
    association set.  acks/valid: (..., M) int/bool; positions with
    valid=0 (no PDSCH received there) are transparent.

    Returns (...,) int8 bundled bit (1 = ACK)."""
    v = valid.to(torch.bool)
    a = torch.where(v, acks.to(torch.bool), True)
    return (a.all(dim=-1) & v.any(dim=-1)).to(torch.int8)


def multiplex_acks(acks: torch.Tensor, valid: torch.Tensor, m: int) -> torch.Tensor:
    """ACK/NACK multiplexing payload (§10.1.3.2.2 simplified to the o_ack ≤ 4
    bit vector): one bit per association-set position, NACK where nothing was
    received.  Returns (..., m) int8."""
    return (acks.to(torch.bool) & valid.to(torch.bool)).to(torch.int8)[..., :m]


# --- frame-type detection and TDD sync geometry -------------------------------

def pss_sss_distance(cfg: OfdmConfig, frame_type: str) -> int:
    """Samples from SSS body start to PSS body start.

    FDD: SSS is the symbol immediately before PSS (subframe symbols 5, 6).
    TDD: SSS is the last symbol of sf0/5, PSS is symbol 2 of sf1/6."""
    offs = _symbol_offsets(cfg)
    if frame_type == "fdd":
        return int(offs[6] - offs[5])
    return int(cfg.sf_len + offs[2] - offs[13])


def pss_to_sf_start(cfg: OfdmConfig, frame_type: str) -> int:
    """Samples from the start of the subframe containing SSS (sf0/5) to the
    PSS body start."""
    offs = _symbol_offsets(cfg)
    if frame_type == "fdd":
        return int(offs[6])
    return int(cfg.sf_len + offs[2])


def extract_center62(samples: torch.Tensor, body_start: torch.Tensor,
                     cfg: OfdmConfig) -> torch.Tensor:
    """FFT one OFDM symbol body at `body_start` (B,) and return the 62 centre
    subcarriers (DC excluded), ordered low→high frequency; the FFT is scaled
    by 1/sqrt(N) (float32, as the JAX package computes it)."""
    n = cfg.symbol_sz
    idx = body_start[..., None] + torch.arange(n, device=samples.device)
    idx = idx.clamp(0, samples.shape[-1] - n)
    sym = torch.gather(samples, -1, idx)
    f = torch.fft.fft(sym, dim=-1) / float(np.sqrt(np.float32(n), dtype=np.float32))
    bins = np.concatenate([np.arange(n - 31, n), np.arange(1, 32)])
    return f[..., torch.as_tensor(bins, device=samples.device)].to(torch.complex64)


@dataclass(frozen=True)
class FrameTypeResult:
    frame_type: torch.Tensor   # (B,) 0 = FDD, 1 = TDD
    n_id_1: torch.Tensor
    phase: torch.Tensor        # 0 → PSS in sf0(/1), 1 → sf5(/6)
    metric: torch.Tensor


def detect_frame_type(samples: torch.Tensor, pss_offset: torch.Tensor,
                      n_id_2: torch.Tensor, cfg: OfdmConfig) -> FrameTypeResult:
    """Try both SSS position hypotheses (sync.c frame-type detection): the
    stronger SSS correlation decides FDD vs TDD and yields (N_ID_1,
    half-frame phase) in the same pass."""
    pss_re = extract_center62(samples, pss_offset, cfg)
    h_pss = pss_re * sync.pss_freq_refs(samples.device)[n_id_2].conj()
    inv = h_pss.conj() / torch.clamp(h_pss.abs() ** 2, min=1e-9)

    results = []
    sel = n_id_2[..., None]
    for ft in ("fdd", "tdd"):
        sss_eq = extract_center62(samples, pss_offset - pss_sss_distance(cfg, ft), cfg) * inv
        outs = [sync.sss_detect(sss_eq, i) for i in range(3)]

        def pick(vals):
            return torch.gather(torch.stack(vals, -1), -1, sel)[..., 0]

        results.append((pick([o["n_id_1"] for o in outs]), pick([o["phase"] for o in outs]),
                        pick([o["corr"].amax(dim=-1) for o in outs])))

    m_fdd, m_tdd = results[0][2], results[1][2]
    is_tdd = m_tdd > m_fdd
    return FrameTypeResult(
        frame_type=is_tdd.to(torch.int32),
        n_id_1=torch.where(is_tdd, results[1][0], results[0][0]),
        phase=torch.where(is_tdd, results[1][1], results[0][1]),
        metric=torch.maximum(m_fdd, m_tdd),
    )


def ack_delay(ul_dl_config: int, dl_subframe: int) -> int:
    """HARQ-ACK delay k: a PDSCH in DL subframe n is acknowledged in UL
    subframe n+k (the association-set inverse, Table 10.1.3.1-1)."""
    for n_ul, ks in DL_ASSOC_SETS[ul_dl_config].items():
        for k in ks:
            if (n_ul - k) % 10 == dl_subframe:
                return k
    raise ValueError((ul_dl_config, dl_subframe))


def ul_grant_delay(ul_dl_config: int, dl_subframe: int) -> int | None:
    """PUSCH delay k for an UL grant sent in DL subframe n (Table 8-2); None
    when n carries no UL grants in this configuration."""
    return UL_GRANT_K[ul_dl_config].get(dl_subframe)


def phich_delay(ul_dl_config: int, ul_subframe: int) -> int:
    """PHICH delay for a PUSCH in UL subframe n: the next D/S subframe at
    least 4 TTIs later."""
    for k in range(4, 14):
        if sf_type(ul_dl_config, (ul_subframe + k) % 10) in ("D", "S"):
            return k
    raise ValueError((ul_dl_config, ul_subframe))
