"""38.212-exact polar coding for NR DCI (PDCCH), on top of ops/polar.py.

Port counterpart of ``srsran_4g_tpu/ops/polar_3gpp.py``: N selection per
38.212 §5.3.1, the frozen set from the universal reliability sequence with
the rate-matching pre-frozen bits, sub-block interleaving with puncturing,
shortening or repetition and its soft inverse, the DCI input interleaver
I_IL, the DCI CRC24C over 24 prepended ones with the RNTI on the last 16
CRC bits (38.212 §7.3.2), and the PDCCH scrambling c_init (38.211 §7.3.2.3).
The index sets are host numpy, cached; the device side is gathers, the CRC
matmul and the SC tree of ``ops/polar``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srsran_4g_tpu_torch.ops import crc as crc_ops
from srsran_4g_tpu_torch.ops import polar, sequence

K_MAX_IL = 164

# TS 38.212 Table 5.3.1.1-1 interleaving pattern (3GPP standard table)
_IL_PATTERN = np.asarray([
    0, 2, 4, 7, 9, 14, 19, 20, 24, 25, 26, 28, 31, 34, 42, 45, 49, 50, 51,
    53, 54, 56, 58, 59, 61, 62, 65, 66, 67, 69, 70, 71, 72, 76, 77, 81, 82,
    83, 87, 88, 89, 91, 93, 95, 98, 101, 104, 106, 108, 110, 111, 113, 115,
    118, 119, 120, 122, 123, 126, 127, 129, 132, 134, 138, 139, 140, 1, 3,
    5, 8, 10, 15, 21, 27, 29, 32, 35, 43, 46, 52, 55, 57, 60, 63, 68, 73,
    78, 84, 90, 92, 94, 96, 99, 102, 105, 107, 109, 112, 114, 116, 121,
    124, 128, 130, 133, 135, 141, 6, 11, 16, 22, 30, 33, 36, 44, 47, 64,
    74, 79, 85, 97, 100, 103, 117, 125, 131, 136, 142, 12, 17, 23, 37, 48,
    75, 80, 86, 137, 143, 13, 18, 38, 144, 39, 145, 40, 146, 41, 147, 148,
    149, 150, 151, 152, 153, 154, 155, 156, 157, 158, 159, 160, 161, 162,
    163], np.int32)


def code_params(k: int, e: int, n_max: int = 9) -> int:
    """→ n (N = 2^n) per 38.212 §5.3.1 (DCI: nPC = 0, K ≥ 36)."""
    # K here includes the 24-bit CRC; 38.212 §7.3.3 pads DCI payloads to
    # >= 12 info bits, so K >= 36 always holds for a valid DCI
    if k < 36:
        raise ValueError(f"polar DCI K={k} below the 38.212 minimum (12+24)")
    n_e = max(5, (e - 1).bit_length())
    n1 = n_e - 1 if (8 * e <= 9 * (1 << (n_e - 1)) and 16 * k < 9 * e) else n_e
    n2 = max(1, (k - 1).bit_length()) + 3
    return max(min(n1, n2, n_max), 5)


@functools.lru_cache(maxsize=64)
def dci_sets(k: int, e: int, n_max: int = 9):
    """→ (n, K_set sorted (reliable info positions), frozen mask (N,))
    with the rate-matching pre-frozen bits (srsran_polar_code_get /
    38.212 §5.4.1.1)."""
    n = code_params(k, e, n_max)
    big_n = 1 << n
    tabs = polar._tables()
    mother = np.asarray(tabs[f"mother_{n}"], np.int64)
    blk = np.asarray(tabs[f"blk_interleaver_{n}"], np.int64)
    f_pre = np.zeros(0, np.int64)
    t = -1
    if e < big_n:
        if 16 * k <= 7 * e:       # puncturing
            n_th = 3 * big_n // 4
            t = (n_th - (e >> 1) - 1) if e >= n_th else (9 * big_n // 16 - (e >> 2))
            f_pre = blk[: big_n - e]
        else:                     # shortening
            f_pre = blk[e:]
    pre = set(f_pre.tolist())
    # reliability order with pre-frozen (and <= T) positions removed
    usable = [p for p in mother.tolist() if p > t and p not in pre]
    k_set = np.asarray(sorted(usable[-k:]), np.int64)
    mask = np.ones(big_n, bool)
    mask[k_set] = False
    return n, k_set, mask


def _il_perm(k: int) -> np.ndarray:
    """pi(k) for the DCI input interleaver at size k."""
    sel = _IL_PATTERN[_IL_PATTERN >= K_MAX_IL - k] - (K_MAX_IL - k)
    return sel.astype(np.int64)


@functools.lru_cache(maxsize=64)
def _tables_t(a: int, e: int, rnti: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Per (payload size, E, RNTI): the I_IL permutation and its inverse, the
    info positions and the RNTI's CRC mask."""
    k = a + 24
    _, k_set, _ = dci_sets(k, e)
    perm = _il_perm(k)
    rmask = np.zeros(24, np.int8)
    rmask[8:] = [(rnti >> (15 - i)) & 1 for i in range(16)]
    return {name: torch.as_tensor(v, device=device) for name, v in dict(
        il=perm, il_inv=np.argsort(perm), k_set=k_set, rnti_mask=rmask[None]).items()}


@functools.lru_cache(maxsize=16)
def _blk_t(n_log: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The sub-block interleaver of size 2^n_log and its inverse."""
    blk = np.asarray(polar._tables()[f"blk_interleaver_{n_log}"], np.int64)
    return torch.as_tensor(blk, device=device), torch.as_tensor(np.argsort(blk), device=device)


def rm_tx(d: torch.Tensor, e: int, k: int) -> torch.Tensor:
    """(B, N) encoded bits → (B, E) rate-matched bits."""
    big_n = d.shape[-1]
    y = d[..., _blk_t(big_n.bit_length() - 1, d.device)[0]]
    if e >= big_n:
        return torch.cat([y] * -(-e // big_n), dim=-1)[..., :e]
    if 16 * k <= 7 * e:
        return y[..., big_n - e:]     # puncture the first N-E
    return y[..., :e]                 # shorten the last N-E


def rm_rx(llr_e: torch.Tensor, n_log: int, k: int) -> torch.Tensor:
    """(B, E) LLRs → (B, N) de-rate-matched LLRs (framework convention:
    positive ⇒ bit 1; shortened bits are known 0 ⇒ large negative).
    Repetitions add pass by pass, in transmit order, as in JAX."""
    big_n = 1 << n_log
    b, e = llr_e.shape
    if e >= big_n:
        y = polar.fold(llr_e, big_n)
    elif 16 * k <= 7 * e:
        y = torch.cat([llr_e.new_zeros((b, big_n - e)), llr_e], dim=-1)
    else:
        y = torch.cat([llr_e, llr_e.new_full((b, big_n - e), -1e9)], dim=-1)
    return y[:, _blk_t(n_log, llr_e.device)[1]]


def _masked_crc(payload: torch.Tensor, t: dict[str, torch.Tensor]) -> torch.Tensor:
    """CRC24C of 24 ones + payload, its last 16 bits XOR the RNTI: (B, 24)."""
    ones = payload.new_ones((payload.shape[0], 24), dtype=torch.int8)
    crc = crc_ops.crc_compute(torch.cat([ones, payload.to(torch.int8)], dim=-1), "24C")
    return torch.bitwise_xor(crc, t["rnti_mask"])


def dci_encode(payload: torch.Tensor, e: int, rnti: int) -> torch.Tensor:
    """DCI payload bits (B, A) → rate-matched coded bits (B, E) int8
    (38.212 §7.3: ones-prepended CRC24C, RNTI on the last 16 CRC bits,
    I_IL input interleaving)."""
    b, a = payload.shape
    t = _tables_t(a, e, rnti, payload.device)
    c = torch.cat([payload.to(torch.int8), _masked_crc(payload, t)], dim=-1)[:, t["il"]]
    u = payload.new_zeros((b, 1 << dci_sets(a + 24, e)[0]), dtype=torch.int32)
    u[:, t["k_set"]] = c.to(torch.int32)
    return rm_tx(polar.encode(u), e, a + 24)


def dci_decode(llr_e: torch.Tensor, a: int, rnti: int) -> dict:
    """(B, E) LLRs (positive ⇒ bit 1) → dict(bits (B, A) int32, crc_ok (B,))."""
    k = a + 24
    e = llr_e.shape[-1]
    n, _, mask = dci_sets(k, e)
    t = _tables_t(a, e, rnti, llr_e.device)
    u = polar.decode_masked(rm_rx(llr_e, n, k), mask)
    c = u[:, t["k_set"]][:, t["il_inv"]]
    payload, crc_rx = c[:, :a], c[:, a:]
    ok = (_masked_crc(payload, t) == crc_rx.to(torch.int8)).all(dim=-1)
    return dict(bits=payload, crc_ok=ok)


def pdcch_scramble_seq(e: int, pci: int, rnti: int = 0) -> np.ndarray:
    """38.211 §7.3.2.3: c_init = (n_RNTI·2^16 + n_ID) mod 2^31
    (n_RNTI = 0 except UE-specific config)."""
    return sequence.gold_sequence_np(((rnti << 16) + pci) % (1 << 31), e)
