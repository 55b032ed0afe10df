"""NR PDCCH: polar-coded DCI over a CORESET with blind search.

Port counterpart of ``srsran_4g_tpu/models/pdcch_nr.py`` (the reference's
`lib/src/phy/phch/pdcch_nr.c` + `dmrs_pdcch.c`): CORESET REG/CCE structure
(6 REGs of 1 PRB x 1 symbol per CCE, non-interleaved mapping), per-REG DMRS
on subcarriers {1,5,9}, DCI CRC24C scrambled by RNTI, polar encoding (N=512
max, E = 108*L bits at aggregation level L), QPSK — and the UE-side blind
decoder over all aggregation levels and candidates.

Where the port differs in form (the bits are the same):
- JAX decodes the candidates one at a time in a Python loop: one polar SC
  decode each, 4 + 2 + 1 at 24 PRB, 45 + 22 + 11 at 273 PRB.  Here the
  candidates of one aggregation level (they share E, N and K) are gathered
  into one (B*S, N) batch and decoded by one ``polar.decode``: the rows are
  independent, so each decides the same bits.  The selection keeps JAX's
  rule: the first candidate whose CRC passes, levels in ascending order,
  start CCEs ascending within a level.
- The de-repetition (E = 108*L LLRs onto N positions; at L = 1, 108 onto
  64, so indices repeat) is ``polar.fold``: passes of distinct positions
  added in transmit order, the same sums on the CPU and the card, where
  ``index_add`` would sum the repeats with atomics in no fixed order.
- The DMRS bits are cast to float before ``1 - 2c`` (numpy's uint8 wraps).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.models.pdsch import _on_device
from srsran_4g_tpu_torch.ops import crc as crc_ops
from srsran_4g_tpu_torch.ops import modem, polar, sequence

NRE = 12
REG_DATA_RE = 9          # 12 - 3 DMRS
CCE_BITS = 6 * REG_DATA_RE * 2   # 108 coded bits per CCE (QPSK)


@dataclass(frozen=True)
class CoresetConfig:
    nof_prb: int = 24      # CORESET bandwidth (6 REGs -> 4 CCEs at 1 symbol)
    duration: int = 1      # symbols (1 supported)
    pci: int = 1
    slot: int = 0
    start_sym: int = 0

    @property
    def nof_cce(self) -> int:
        return self.nof_prb // 6


def _dmrs_seq(cfg: CoresetConfig) -> np.ndarray:
    """38.211 7.4.1.3: PDCCH DMRS over the CORESET symbol."""
    cinit = ((1 << 17) * (14 * cfg.slot + cfg.start_sym + 1)
             * (2 * cfg.pci + 1) + 2 * cfg.pci) % (1 << 31)
    n = 3 * cfg.nof_prb
    c = sequence.gold_sequence_np(cinit, 2 * n).astype(np.float32)
    r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)
    return r.astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _re_maps(nof_prb: int):
    """(data_k, dmrs_k) subcarrier indices within the CORESET symbol."""
    dmrs = np.asarray([p * NRE + o for p in range(nof_prb)
                       for o in (1, 5, 9)], np.int32)
    all_k = np.arange(nof_prb * NRE, dtype=np.int32)
    data = np.setdiff1d(all_k, dmrs)
    return data, dmrs


@functools.lru_cache(maxsize=32)
def _tables(cfg: CoresetConfig, device: torch.device) -> dict[str, torch.Tensor]:
    data_k, dmrs_k = _re_maps(cfg.nof_prb)
    return dict(data=torch.as_tensor(data_k.astype(np.int64), device=device),
                dmrs_k=torch.as_tensor(dmrs_k.astype(np.int64), device=device),
                dmrs=torch.as_tensor(_dmrs_seq(cfg), device=device))


def _polar_nlog(e_bits: int, k: int) -> int:
    """N selection (38.212 5.3.1 simplified: smallest N >= max(K, E/2),
    capped at 512)."""
    n = 32
    while n < max(k, e_bits // 2) and n < 512:
        n *= 2
    return int(np.log2(n))


@functools.lru_cache(maxsize=64)
def _rnti_mask(rnti: int, device: torch.device) -> torch.Tensor:
    mask = np.zeros(24, np.int8)
    for i in range(16):
        mask[8 + i] = (rnti >> (15 - i)) & 1
    return torch.as_tensor(mask, device=device)


@functools.lru_cache(maxsize=64)
def _candidates(nof_cce: int, agg: int, device: torch.device) -> torch.Tensor:
    """(S, E) indices into the LLRs of the CORESET: row s is the candidate
    starting at CCE s*agg."""
    starts = np.arange(0, nof_cce - agg + 1, agg)
    idx = starts[:, None] * CCE_BITS + np.arange(CCE_BITS * agg)[None, :]
    return torch.as_tensor(idx, device=device)


def encode(cfg: CoresetConfig, dci_bits, rnti: int, aggregation: int = 4,
           start_cce: int = 0, device: torch.device | str | None = None) -> torch.Tensor:
    """DCI payload bits (A,) -> (1, nof_prb*12) CORESET symbol values.  A
    tensor keeps its device; other input goes to ``device`` (default CUDA)."""
    payload = _on_device(dci_bits, device).to(torch.int8)[None]
    dev = payload.device
    a = payload.shape[-1]
    crc = torch.bitwise_xor(crc_ops.crc_compute(payload, "24C"), _rnti_mask(rnti, dev)[None])
    k = a + 24
    e = CCE_BITS * aggregation
    n_log = _polar_nlog(e, k)
    cw = polar.encode_info(torch.cat([payload, crc], -1), n_log)
    n = 1 << n_log
    eb = cw[:, torch.arange(e, device=dev) % n]
    syms = modem.modulate("qpsk", eb)  # (1, e/2)

    t = _tables(cfg, dev)
    grid = torch.zeros((1, cfg.nof_prb * NRE), dtype=torch.complex64, device=dev)
    # CCEs occupy contiguous PRBs (non-interleaved): 9 data RE per REG
    lo = start_cce * 6 * REG_DATA_RE
    grid[:, t["data"][lo:lo + e // 2]] = syms
    grid[:, t["dmrs_k"]] = t["dmrs"]
    return grid


def blind_decode(cfg: CoresetConfig, rx_sym: torch.Tensor, rnti: int,
                 dci_len: int, aggregations=(1, 2, 4)) -> dict:
    """UE-side search over aggregation levels and candidate positions.

    rx_sym: (B, nof_prb*12) received CORESET symbol.  Returns the first
    candidate whose RNTI-scrambled CRC checks: dict(found (B,),
    bits (B, dci_len), agg (B,)).
    """
    b = rx_sym.shape[0]
    dev = rx_sym.device
    t = _tables(cfg, dev)
    h_ls = rx_sym[:, t["dmrs_k"]] * t["dmrs"].conj()
    h = h_ls.mean(dim=-1, keepdim=True)   # flat estimate per burst
    nv = (h_ls - h).abs().square().mean(dim=-1, keepdim=True) + 1e-9
    y = rx_sym[:, t["data"]]
    h2 = h.abs().square()
    x = y * h.conj() / (h2 + nv)
    llr_all = modem.demodulate_soft("qpsk", x, nv / (h2 + 1e-9))  # (B, 2*len(data_k))

    mask = _rnti_mask(rnti, dev)
    k = dci_len + 24

    found = torch.zeros(b, dtype=torch.bool, device=dev)
    best_bits = torch.zeros((b, dci_len), dtype=torch.int8, device=dev)
    best_agg = torch.zeros(b, dtype=torch.int32, device=dev)
    for agg in aggregations:
        e = CCE_BITS * agg
        n_log = _polar_nlog(e, k)
        idx = _candidates(cfg.nof_cce, agg, dev)            # (S, E)
        s = idx.shape[0]
        if s == 0:
            continue
        llr = llr_all[:, idx].reshape(b * s, e)
        dec = polar.decode(polar.fold(llr, 1 << n_log), k, n_log)  # (B*S, K)
        crc_in = torch.cat([dec[:, :dci_len], torch.bitwise_xor(dec[:, dci_len:], mask)], -1)
        ok = crc_ops.crc_check(crc_in, "24C").reshape(b, s)
        first = torch.argmax(ok.to(torch.int32), dim=-1)    # the first passing start
        hit = ok.any(dim=-1)
        bits = dec.reshape(b, s, k)[torch.arange(b, device=dev), first, :dci_len]
        new = hit & ~found
        best_bits = torch.where(new[:, None], bits, best_bits)
        best_agg = torch.where(new, agg, best_agg)
        found = found | hit
    return dict(found=found, bits=best_bits, agg=best_agg)
