"""NR PDSCH: LDPC transport chain over a slot grid with DMRS chest.

Port counterpart of ``srsran_4g_tpu/models/pdsch_nr.py``: scrambling
(38.211 7.3.1.1), modulation, RE mapping around type-1 DMRS, and on receive
DMRS-based LS estimation with frequency smoothing and time interpolation,
MMSE equalization, soft demod and LDPC decode with HARQ soft combining.
Batched over slots: (B, 14, nre) grids.  RE maps, scrambling sequences and
interpolation weights are host-built once per config and cached as device
tensors.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.models import equalizer, grid_nr, sch_nr
from srsran_4g_tpu_torch.models.pdsch import _on_device
from srsran_4g_tpu_torch.ops import modem, scrambling, sequence
from srsran_4g_tpu_torch.utils.constants import BITS_PER_SYMBOL

DMRS_SYMS = (2, 11)


@dataclass(frozen=True)
class PdschNrConfig:
    carrier: grid_nr.NrCarrierConfig
    rnti: int
    slot: int
    mod: str
    tbs: int
    rv: int = 0
    start_sym: int = 1
    nof_syms: int = 13
    # type-1 frequency allocation (DCI 1_0/0_0 RIV); None = full carrier.
    # DMRS stays carrier-wide (one UE per slot direction in this model).
    rb_start: int = 0
    nof_rb: int | None = None

    @functools.cached_property
    def re_indices(self) -> np.ndarray:
        return grid_nr.data_re_indices_type1(
            self.carrier, DMRS_SYMS, self.start_sym, self.nof_syms,
            rb_start=self.rb_start, nof_rb=self.nof_rb)

    @property
    def nof_re(self) -> int:
        return int(self.re_indices.shape[0])

    @property
    def qm(self) -> int:
        return BITS_PER_SYMBOL[self.mod]

    @property
    def g_bits(self) -> int:
        return self.nof_re * self.qm

    @functools.cached_property
    def seg(self) -> sch_nr.NrSegm:
        return sch_nr.nr_segment(self.tbs, self.g_bits, self.qm, self.rv)

    @functools.cached_property
    def scramble_seq(self) -> np.ndarray:
        # 38.211 7.3.1.1: c_init = rnti*2^15 + q*2^14 + n_ID
        cinit = (self.rnti << 15) + self.carrier.pci
        return sequence.gold_sequence_np(cinit % (1 << 31), self.g_bits)


@functools.lru_cache(maxsize=16)
def _interp(nof_prb: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Linear interpolation from the DMRS comb to every subcarrier: (left
    comb index, right comb index, right weight), each (12*nof_prb,)."""
    comb_k = grid_nr.dmrs_re_indices_type1(nof_prb).astype(np.float32)
    full_k = np.arange(nof_prb * grid_nr.NRE, dtype=np.float32)
    ri = np.clip(np.searchsorted(comb_k, full_k), 1, len(comb_k) - 1)
    li = ri - 1
    w = ((full_k - comb_k[li]) / np.maximum(comb_k[ri] - comb_k[li], 1e-9)).astype(np.float32)
    return li, ri, w


@functools.lru_cache(maxsize=64)
def _tables(cfg: PdschNrConfig, device: torch.device) -> dict[str, torch.Tensor]:
    li, ri, w = _interp(cfg.carrier.nof_prb)
    t = ((np.arange(grid_nr.NSYMB, dtype=np.float32) - DMRS_SYMS[0])
         / (DMRS_SYMS[1] - DMRS_SYMS[0]))
    return dict(re_idx=torch.as_tensor(cfg.re_indices.astype(np.int64), device=device),
                seq=torch.as_tensor(cfg.scramble_seq, device=device),
                li=torch.as_tensor(li, device=device), ri=torch.as_tensor(ri, device=device),
                w=torch.as_tensor(w, device=device),
                t=torch.as_tensor(np.clip(t, 0.0, 1.0)[None, :, None], device=device))


def encode(cfg: PdschNrConfig, tb_bits: torch.Tensor | np.ndarray,
           device: torch.device | str | None = None) -> torch.Tensor:
    """(B, tbs) -> (B, 14, nre) complex64 slot grid with PDSCH + DMRS.  A
    tensor input stays on its device; other inputs go to ``device``
    (default CUDA)."""
    bits = _on_device(tb_bits, device)
    tab = _tables(cfg, bits.device)
    b = bits.shape[0]
    cw = sch_nr.encode(cfg.seg, bits)
    syms = modem.modulate(cfg.mod, scrambling.scramble_bits(cw, tab["seq"]))
    flat = torch.zeros((b, grid_nr.NSYMB * cfg.carrier.nre), dtype=torch.complex64,
                       device=bits.device)
    flat[:, tab["re_idx"]] = syms
    syms_t, ks, r = grid_nr.dmrs_type1_t(cfg.carrier, cfg.slot, DMRS_SYMS, bits.device)
    grid = flat.reshape(b, grid_nr.NSYMB, cfg.carrier.nre)
    grid[:, syms_t[:, None], ks[None, :]] = r
    return grid


def estimate(cfg: PdschNrConfig, rx_grid: torch.Tensor) -> dict:
    """DMRS LS estimate + smoothing + time interpolation (dmrs_sch.c):
    dict(h (B, 14, nre) complex64, noise_var (B,) float32)."""
    tab = _tables(cfg, rx_grid.device)
    syms, ks, r = grid_nr.dmrs_type1_t(cfg.carrier, cfg.slot, DMRS_SYMS, rx_grid.device)
    h_p = rx_grid[:, syms[:, None], ks[None, :]] * r.conj()  # (B, 2, 6*nof_prb) on the comb
    # frequency smoothing on the comb, edges repeated
    hp = torch.cat([h_p[..., :1], h_p, h_p[..., -1:]], dim=-1)
    h_sm = 0.25 * hp[..., :-2] + 0.5 * hp[..., 1:-1] + 0.25 * hp[..., 2:]
    noise_var = (h_p - h_sm).abs().square().mean(dim=(-1, -2)) / 0.375
    # comb -> full band (linear between comb REs), then across the slot
    # between the two DMRS symbols
    w = tab["w"]
    h_full = (1 - w) * h_sm[..., tab["li"]] + w * h_sm[..., tab["ri"]]  # (B, 2, nre)
    t = tab["t"]
    h = (1 - t) * h_full[:, 0:1, :] + t * h_full[:, 1:2, :]
    return dict(h=h.to(torch.complex64), noise_var=noise_var.to(torch.float32))


def soft_bits(cfg: PdschNrConfig, rx_grid: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """(B, 14, nre) received grid → (descrambled LLRs (B, G), the channel
    estimate of ``estimate``): equalisation and soft demodulation of the
    data REs."""
    b = rx_grid.shape[0]
    tab = _tables(cfg, rx_grid.device)
    est = estimate(cfg, rx_grid)
    idx = tab["re_idx"]
    y = rx_grid.reshape(b, -1)[:, idx]
    h = est["h"].reshape(b, -1)[:, idx]
    x, eff_nv = equalizer.equalize_single(y, h, est["noise_var"][:, None])
    llr = modem.demodulate_soft(cfg.mod, x, eff_nv).reshape(b, cfg.g_bits)
    return scrambling.descramble_llrs(llr, tab["seq"]), est


def decode(cfg: PdschNrConfig, rx_grid: torch.Tensor,
           softbuffers: dict | None = None, n_iter: int = 12) -> dict:
    """(B, 14, nre) received grid → dict(bits (B, tbs) int8, crc_ok (B,),
    softbuffers (per CB, for a HARQ retransmission), noise_var (B,))."""
    llr, est = soft_bits(cfg, rx_grid)
    bits, ok, soft = sch_nr.decode(cfg.seg, llr, softbuffers=softbuffers, n_iter=n_iter)
    return dict(bits=bits, crc_ok=ok, softbuffers=soft, noise_var=est["noise_var"])
