"""LTE UCI on PUSCH: CQI/RI/HARQ-ACK multiplexed with UL-SCH data.

Port counterpart of ``srsran_4g_tpu/models/uci.py`` (the reference's
`lib/src/phy/phch/uci.c` Q' sizing, (32,O) short-CQI block code,
CRC8+convolutional long-CQI coding, ACK/RI coded-symbol generation, and the
UL-SCH channel-interleaver multiplexing of `lib/src/phy/phch/sch.c`, per
TS 36.212 §5.2.2.6-5.2.2.8 and §5.2.4).

The multiplexing structure is one host-precomputed bijective gather
``out[p] = src[perm[p]]`` over the flattened (symbols × Qm) bit grid plus an
ACK puncture index vector: encode is one gather and one scatter, and demux
is the inverse gather (``src = llrs[:, argsort(perm)]``).  ACK/RI use
repetition (1 bit) / cyclic simplex (2 bits) codes decoded by correlation
against their codewords; long CQI is Viterbi-decoded by
``convcode.viterbi_decode`` (the port's Python loop; the JAX package runs a
``lax.scan``, no Pallas kernel).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.ops import block_code, convcode, crc as crc_ops
from srsran_4g_tpu_torch.ops import rate_match as rm
from srsran_4g_tpu_torch.ops.cbsegm import cbsegm

RI_COLS = (1, 4, 7, 10)   # columns (data SC-FDMA symbols) for RI, normal CP
ACK_COLS = (2, 3, 8, 9)   # columns punctured by HARQ-ACK (next to DMRS)
N_DATA_SYMS = 12
_CQI_LONG_MIN = 12        # O >= 12 ⇒ CRC8 + tail-biting convolutional code


@dataclass(frozen=True)
class UciCfg:
    """UCI payload sizes and beta offsets (TS 36.213 Table 8.6.3-1..3)."""

    o_cqi: int = 0
    o_ack: int = 0   # 0, 1 or 2 HARQ-ACK bits
    o_ri: int = 0    # 0, 1 or 2 RI bits
    beta_cqi: float = 2.0
    beta_ack: float = 2.0
    beta_ri: float = 2.0


@dataclass(frozen=True, eq=False)
class UciPlan:
    """Static multiplexing plan for one (tbs, allocation, UciCfg); compared
    and hashed by identity (``uci_plan`` caches one per key), so that device
    tables can be cached per plan."""

    cfg: UciCfg
    qm: int
    m_sc: int
    q_prime_cqi: int   # CQI coded symbols
    q_prime_ack: int
    q_prime_ri: int
    g_data: int        # UL-SCH coded bits (excludes CQI and RI, incl. ACK
                       # positions — ACK punctures data after the fact)
    perm: np.ndarray       # (H*Qm,) out[p] = src[perm[p]]
    ack_pos: np.ndarray    # (Q'_ack*Qm,) bit positions in out punctured by ACK

    @property
    def q_cqi(self) -> int:
        return self.q_prime_cqi * self.qm

    @property
    def q_ri(self) -> int:
        return self.q_prime_ri * self.qm

    @property
    def q_ack(self) -> int:
        return self.q_prime_ack * self.qm


def _k_total(tbs: int) -> int:
    s = cbsegm(tbs)
    return s.C1 * s.K1 + s.C2 * s.K2


@functools.lru_cache(maxsize=256)
def uci_plan(tbs: int, m_sc: int, qm: int, cfg: UciCfg) -> UciPlan:
    """Compute Q' sizes (uci.c Q_prime_cqi / Q_prime_ri_ack) and the
    interleaver permutation (sch.c ulsch_interleave)."""
    n_symb = N_DATA_SYMS
    h_syms = m_sc * n_symb
    k_tot = _k_total(tbs)

    def q_prime_ack_ri(o: int, beta: float) -> int:
        if o == 0:
            return 0
        x = math.ceil(o * m_sc * n_symb * beta / k_tot)
        return min(x, 4 * m_sc)

    q_ri = q_prime_ack_ri(cfg.o_ri, cfg.beta_ri)
    q_ack = q_prime_ack_ri(cfg.o_ack, cfg.beta_ack)

    q_cqi = 0
    if cfg.o_cqi:
        l_crc = 8 if cfg.o_cqi >= _CQI_LONG_MIN else 0
        x = math.ceil((cfg.o_cqi + l_crc) * m_sc * n_symb * cfg.beta_cqi / k_tot)
        q_cqi = min(x, h_syms - q_ri)

    g_data = (h_syms - q_cqi - q_ri) * qm
    if g_data <= 0:
        raise ValueError("UCI leaves no room for UL-SCH data")

    rp, c = m_sc, n_symb  # interleaver rows of Qm-bit symbols; 12 columns
    # RI reservation: symbol i at column RI_COLS[i%4], row rp-1-(i//4)
    i = np.arange(q_ri)
    ri_idx = np.full((rp, c), -1, dtype=np.int64)
    ri_idx[rp - 1 - i // 4, np.asarray(RI_COLS)[i % 4]] = i
    # CQI+data fill the remaining cells row-major
    free = ri_idx < 0
    cell = np.full((rp, c), -1, dtype=np.int64)
    cell[free] = np.arange(int(free.sum()))
    n_cqidata = int(free.sum())
    assert n_cqidata == h_syms - q_ri

    # output is read column-major (per SC-FDMA symbol); src layout is
    # [cqi_enc | data | ri_enc] in coded-symbol units
    src_sym = np.where(free, cell, n_cqidata + ri_idx).T.reshape(-1)  # (c*rp,)
    perm = (src_sym[:, None] * qm + np.arange(qm)).reshape(-1)

    i = np.arange(q_ack)
    out_sym = np.asarray(ACK_COLS)[i % 4] * rp + rp - 1 - i // 4
    ack_pos = (out_sym[:, None] * qm + np.arange(qm)).reshape(-1).astype(np.int64)

    return UciPlan(cfg=cfg, qm=qm, m_sc=m_sc, q_prime_cqi=q_cqi,
                   q_prime_ack=q_ack, q_prime_ri=q_ri, g_data=g_data,
                   perm=perm, ack_pos=ack_pos)


@functools.lru_cache(maxsize=64)
def _plan_tables(plan: UciPlan, device: torch.device) -> dict[str, torch.Tensor]:
    return dict(perm=torch.as_tensor(plan.perm, device=device),
                inv_perm=torch.as_tensor(np.argsort(plan.perm), device=device),
                ack_pos=torch.as_tensor(plan.ack_pos, device=device))


# --- small-payload codes -----------------------------------------------------

@functools.lru_cache(maxsize=64)
def _simplex_codebook(o: int, nbits: int) -> np.ndarray:
    """Cyclic repetition (o=1) / simplex [o0,o1,o0^o1] (o=2) codewords:
    (2^o, nbits) in {0,1}."""
    if o == 1:
        base = np.array([[0], [1]], dtype=np.int8)
    elif o == 2:
        base = np.array([[b0, b1, b0 ^ b1] for b0 in (0, 1) for b1 in (0, 1)],
                        dtype=np.int8)
    else:
        raise ValueError("ACK/RI payloads are 1 or 2 bits")
    reps = -(-nbits // base.shape[1])
    return np.tile(base, (1, reps))[:, :nbits]


@functools.lru_cache(maxsize=64)
def _simplex_codebook_t(o: int, nbits: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_simplex_codebook(o, nbits), device=device)


def encode_ack_ri(bits: torch.Tensor, nbits: int) -> torch.Tensor:
    """(B, O) ACK or RI bits → (B, nbits) coded bits (uci.c encode_ri_ack)."""
    o = bits.shape[-1]
    word = torch.sum(bits.to(torch.int64)
                     * (1 << torch.arange(o, device=bits.device)), dim=-1)
    return _simplex_codebook_t(o, nbits, bits.device)[word]


def decode_ack_ri(llrs: torch.Tensor, o: int) -> torch.Tensor:
    """(B, nbits) LLRs (positive ⇒ 1) → (B, O) ML decision."""
    cb = _simplex_codebook_t(o, llrs.shape[-1], llrs.device).to(torch.float32)
    corr = torch.matmul(llrs.to(torch.float32), (2.0 * cb - 1.0).T)
    best = torch.argmax(corr, dim=-1)
    return ((best[..., None] >> torch.arange(o, device=llrs.device)) & 1).to(torch.int8)


def encode_cqi(cqi_bits: torch.Tensor, q_bits: int) -> torch.Tensor:
    """(B, O) CQI bits → (B, q_bits): (32,O) block code cyclically repeated
    for O ≤ 11 (uci.c encode_cqi_short), CRC8 + tail-biting convolutional +
    rate matching for O ≥ 12 (encode_cqi_long)."""
    o = cqi_bits.shape[-1]
    if o < _CQI_LONG_MIN:
        cw = block_code.encode(cqi_bits, 32)  # (B, 32)
        reps = -(-q_bits // 32)
        return cw.repeat(1, reps)[:, :q_bits]
    with_crc = torch.cat([cqi_bits.to(torch.int8), crc_ops.crc_compute(cqi_bits, "8")], dim=-1)
    return rm.conv_rate_match(convcode.conv_encode(with_crc), q_bits)


def decode_cqi(llrs: torch.Tensor, o: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, q_bits) LLRs → ((B, O) bits, (B,) ok).  Short CQI folds the cyclic
    repetitions onto 32 positions then ML-decodes; long CQI Viterbi-decodes
    and checks CRC8."""
    q_bits = llrs.shape[-1]
    if o < _CQI_LONG_MIN:
        reps = -(-q_bits // 32)
        pad = torch.cat([llrs.to(torch.float32),
                         llrs.new_zeros((llrs.shape[0], reps * 32 - q_bits))], dim=-1)
        folded = torch.sum(pad.reshape(llrs.shape[0], reps, 32), dim=1)
        bits, metric = block_code.decode(folded, 32, o)
        return bits, metric > 0
    d = rm.conv_rate_dematch(llrs.to(torch.float32), o + 8)
    dec = convcode.viterbi_decode(d, tail_biting=True)  # (B, O+8)
    return dec[:, :o], crc_ops.crc_check(dec, "8")


# --- multiplexing ------------------------------------------------------------

def mux(plan: UciPlan, data_bits: torch.Tensor,
        cqi_bits: torch.Tensor | None = None,
        ack_bits: torch.Tensor | None = None,
        ri_bits: torch.Tensor | None = None) -> torch.Tensor:
    """UL-SCH coded bits (B, G_data) + UCI payloads → (B, H*Qm) channel bits
    in final (column-major / time-first) order, ACK punctured in."""
    tab = _plan_tables(plan, data_bits.device)
    parts = []
    if plan.q_cqi:
        assert cqi_bits is not None
        parts.append(encode_cqi(cqi_bits, plan.q_cqi))
    parts.append(data_bits.to(torch.int8))
    if plan.q_ri:
        assert ri_bits is not None
        parts.append(encode_ack_ri(ri_bits, plan.q_ri))
    out = torch.cat(parts, dim=-1)[:, tab["perm"]]
    if plan.q_ack:
        assert ack_bits is not None
        out[:, tab["ack_pos"]] = encode_ack_ri(ack_bits, plan.q_ack)
    return out


def demux(plan: UciPlan, llrs: torch.Tensor) -> dict:
    """(B, H*Qm) descrambled LLRs → dict with data_llrs (B, G_data) (ACK
    positions zeroed as erasures), and decoded ack / ri / cqi payloads."""
    tab = _plan_tables(plan, llrs.device)
    out: dict = {}
    if plan.q_ack:
        out["ack_bits"] = decode_ack_ri(llrs[:, tab["ack_pos"]], plan.cfg.o_ack)
        llrs = llrs.clone()
        llrs[:, tab["ack_pos"]] = 0.0
    src = llrs[:, tab["inv_perm"]]
    ofs = 0
    if plan.q_cqi:
        out["cqi_bits"], out["cqi_ok"] = decode_cqi(src[:, :plan.q_cqi], plan.cfg.o_cqi)
        ofs = plan.q_cqi
    out["data_llrs"] = src[:, ofs:ofs + plan.g_data]
    if plan.q_ri:
        ri_llr = src[:, ofs + plan.g_data:ofs + plan.g_data + plan.q_ri]
        out["ri_bits"] = decode_ack_ri(ri_llr, plan.cfg.o_ri)
    return out
