"""PDCCH: downlink control channel with DCI blind decoding, TS 36.211 §6.8 /
36.212 §5.3.3.

Port counterpart of ``srsran_4g_tpu/models/pdcch.py`` (the reference's
`lib/src/phy/phch/pdcch.c`).  DCI payload → CRC16 XOR-masked with the RNTI
→ tail-biting conv 1/3 → rate match to 72·L bits (L CCEs, 1 CCE = 9 REGs =
36 REs) → subframe scrambling → QPSK → quadruplet interleaving over the
control REGs (``models/regs.py``) → grid.

Blind decoding takes every search-space candidate of the whole batch at
once: one gather of all candidates' REs, one equalise, demodulate and
descramble pass, one conv dematching per aggregation level, and ONE batched
Viterbi over (batch × candidates); the CRC/RNTI checks are one matmul.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srsran_4g_tpu_torch.models import equalizer, mimo, regs
from srsran_4g_tpu_torch.models import grid as G
from srsran_4g_tpu_torch.ops import convcode, modem, rate_match, scrambling
from srsran_4g_tpu_torch.ops.crc import crc_compute
from srsran_4g_tpu_torch.ops.sequence import gold_sequence_np

CCE_BITS = 72  # 9 REGs · 4 REs · 2 bits


def _rnti_mask(rnti: int) -> np.ndarray:
    return ((rnti >> np.arange(15, -1, -1)) & 1).astype(np.int8)


def _masked_crc(payload: torch.Tensor, rnti: int) -> torch.Tensor:
    mask = torch.as_tensor(_rnti_mask(rnti), device=payload.device)
    return torch.bitwise_xor(crc_compute(payload, "16"), mask)


@functools.lru_cache(maxsize=64)
def _scramble_seq(cell: G.CellConfig, cfi: int, subframe: int, ng: float) -> np.ndarray:
    n_regs = regs.pdcch_regs(cell, cfi, ng).shape[0]
    return gold_sequence_np(scrambling.pdcch_cinit(subframe, cell.cell_id), n_regs * 8)


@functools.lru_cache(maxsize=64)
def cce_re_indices(cell: G.CellConfig, cfi: int, ng: float = 1.0) -> np.ndarray:
    """(n_cce, 36) flat RE indices of each CCE after quadruplet
    interleaving: CCE c's quadruplet q lies on REG π(9c + q)."""
    reg_res = regs.pdcch_regs(cell, cfi, ng)  # (n_regs, 4)
    order = regs.pdcch_interleave_order(cell, cfi, ng)
    n_cce = reg_res.shape[0] // 9
    return reg_res[order[:n_cce * 9]].reshape(n_cce, 36)


def search_space_candidates(cell: G.CellConfig, cfi: int, rnti: int, subframe: int,
                            ng: float = 1.0) -> list[tuple[int, int]]:
    """(L, cce_start) candidates: the common space (L = 4, 8) and the
    UE-specific space (TS 36.213 §9.1.1, the Yk hash), without repeats."""
    n_cce = cce_re_indices(cell, cfi, ng).shape[0]
    cands: list[tuple[int, int]] = []
    # common search space: 4 candidates at L=4, 2 at L=8, CCEs 0..15
    for l, m_max in ((4, 4), (8, 2)):
        for m in range(m_max):
            if m * l + l <= n_cce:
                cands.append((l, m * l))
    y = rnti if rnti else 1
    for _ in range(subframe + 1):
        y = (39827 * y) % 65537
    for l, m_max in ((1, 6), (2, 6), (4, 2), (8, 2)):
        if n_cce // l == 0:
            continue
        for m in range(m_max):
            start = l * ((y + m) % (n_cce // l))
            if start + l <= n_cce and (l, start) not in cands:
                cands.append((l, start))
    return cands


def encode_dci(cell: G.CellConfig, dci_bits: torch.Tensor, rnti: int,
               l_agg: int) -> torch.Tensor:
    """DCI payload (B, A) → rate-matched bits (B, 72·L), before scrambling."""
    del cell  # the code does not depend on the cell
    a = torch.cat([dci_bits.to(torch.int8), _masked_crc(dci_bits, rnti)], dim=-1)
    return rate_match.conv_rate_match(convcode.conv_encode(a), CCE_BITS * l_agg)


def put_dci(cell: G.CellConfig, cfi: int, subframe: int, grid_tx: torch.Tensor,
            dci_bits: torch.Tensor, rnti: int, l_agg: int, cce_start: int,
            ng: float = 1.0) -> torch.Tensor:
    """Encode one DCI and scatter it onto its CCEs of the TX grid (a new
    grid is returned)."""
    n_cce = cce_re_indices(cell, cfi, ng).shape[0]
    if cce_start + l_agg > n_cce:
        raise ValueError(f"CCEs {cce_start}..{cce_start + l_agg - 1} exceed the "
                         f"{n_cce} of the control region")
    e = encode_dci(cell, dci_bits, rnti, l_agg)
    bit0 = CCE_BITS * cce_start  # CCE c starts at bit 72·c of the PDCCH sequence
    seq = torch.as_tensor(_scramble_seq(cell, cfi, subframe, ng)[bit0:bit0 + e.shape[-1]],
                          device=e.device)
    syms = modem.modulate("qpsk", scrambling.scramble_bits(e, seq))  # (B, 36·L)
    idx = cce_re_indices(cell, cfi, ng)[cce_start:cce_start + l_agg].reshape(-1)
    return mimo.scatter_ctrl_syms(grid_tx, idx, syms)


@functools.lru_cache(maxsize=256)
def _candidate_layout(cell: G.CellConfig, cfi: int, subframe: int, ng: float,
                      candidates: tuple[tuple[int, int], ...]):
    """The concatenated RE indices and scrambling bits of all candidates, and
    per aggregation level the candidates' positions and their LLR columns
    (m, 72·L) in the concatenation."""
    cce = cce_re_indices(cell, cfi, ng)
    seq = _scramble_seq(cell, cfi, subframe, ng)
    re_idx, bits, cols, start = [], [], {}, 0
    for c, (l_agg, cce_start) in enumerate(candidates):
        re_idx.append(cce[cce_start:cce_start + l_agg].reshape(-1))
        bits.append(seq[CCE_BITS * cce_start:CCE_BITS * (cce_start + l_agg)])
        cols.setdefault(l_agg, []).append((c, start + np.arange(CCE_BITS * l_agg)))
        start += CCE_BITS * l_agg
    groups = {l: (np.array([c for c, _ in v]), np.stack([x for _, x in v]))
              for l, v in cols.items()}
    return np.concatenate(re_idx), np.concatenate(bits), groups


def blind_decode(cell: G.CellConfig, cfi: int, subframe: int, rx_grid: torch.Tensor,
                 h: torch.Tensor, noise_var, rnti: int, dci_len: int, ng: float = 1.0,
                 candidates: list[tuple[int, int]] | None = None,
                 h1: torch.Tensor | None = None) -> dict:
    """Blind-search all candidates for a DCI of the given payload length.

    With ``h1`` (port-1 estimates) each candidate's REs are SFBC-combined
    (2-port TX diversity, pdcch.c via predecoding_diversity).

    Returns dict(found (B,), dci (B, A), candidate (B,) index of the first
    candidate whose CRC matches the RNTI, ok_per_candidate (B, C),
    payload_per_candidate (B, C, A)).  All candidates decode as one Viterbi
    batch.
    """
    if candidates is None:
        candidates = search_space_candidates(cell, cfi, rnti, subframe, ng)
    dev = rx_grid.device
    b, n_cand, n = rx_grid.shape[0], len(candidates), dci_len + 16
    re_idx, seq, groups = _candidate_layout(cell, cfi, subframe, ng,
                                            tuple(map(tuple, candidates)))
    idx = torch.as_tensor(re_idx, device=dev)
    y = rx_grid.reshape(b, -1)[:, idx]
    h_re = h.reshape(b, -1)[:, idx]
    if h1 is not None:
        x, eff_nv = equalizer.alamouti_decode_2x1(y, h_re, h1.reshape(b, -1)[:, idx],
                                                  noise_var)
    else:
        x, eff_nv = equalizer.equalize_single(y, h_re, noise_var)
    llr = scrambling.descramble_llrs(modem.demodulate_soft("qpsk", x, eff_nv),
                                     torch.as_tensor(seq, device=dev))
    d_llr = torch.empty((b, n_cand, 3, n), dtype=torch.float32, device=dev)
    for pos, cols in groups.values():  # one dematching per aggregation level
        e = llr[:, torch.as_tensor(cols, device=dev)]  # (B, m, 72·L)
        d_llr[:, torch.as_tensor(pos, device=dev)] = rate_match.conv_rate_dematch(e, n)
    bits = convcode.viterbi_decode(d_llr.reshape(b * n_cand, 3, n)).reshape(b, n_cand, n)

    payload, crc_rx = bits[..., :dci_len], bits[..., dci_len:]
    ok = (_masked_crc(payload, rnti) == crc_rx).all(dim=-1)  # (B, C)
    cand_idx = torch.argmax(ok.to(torch.int8), dim=-1)
    dci = payload.gather(1, cand_idx[:, None, None].expand(b, 1, dci_len))[:, 0]
    return dict(found=ok.any(dim=-1), dci=dci, candidate=cand_idx,
                ok_per_candidate=ok, payload_per_candidate=payload)
