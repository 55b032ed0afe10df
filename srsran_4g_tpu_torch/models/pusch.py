"""PUSCH: uplink shared channel (SC-FDMA), TS 36.211 §5.3 / 36.212 §5.2.2.

Port counterpart of ``srsran_4g_tpu/models/pusch.py`` (the reference's
`lib/src/phy/phch/pusch.c`, `lib/src/phy/dft/dft_precoding.c` and
`lib/src/phy/ch_estimation/chest_ul.c`): UL-SCH coding (the DL-SCH
turbo/rate-match chain, so the decode runs the turbo kernels), the PUSCH
time-first channel interleaver or the UCI multiplexer, scrambling,
modulation, DFT transform precoding, DMRS at symbol 3 of each slot, and the
eNB-side receiver (DMRS channel estimate → MMSE → IDFT → soft demod →
UL-SCH decode).

The channel interleaver, its inverse and the DMRS are host tables built
once per config and kept on the device; the transform precoding is a
batched ``torch.fft`` over the allocated subcarriers (12·N_prb points, e.g.
1,152 at 96 PRB; cuFFT and numpy/XLA differ in the last bits).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.models import equalizer, grid as G, sch
from srsran_4g_tpu_torch.models import uci as uci_mod
from srsran_4g_tpu_torch.models.pdsch import _on_device
from srsran_4g_tpu_torch.models.refsignal_ul import pusch_dmrs
from srsran_4g_tpu_torch.ops import modem, scrambling
from srsran_4g_tpu_torch.ops.sequence import gold_sequence_np
from srsran_4g_tpu_torch.utils.constants import BITS_PER_SYMBOL, NRE

DMRS_SYM = (3, 10)  # normal CP
N_DATA_SYMS = 12


@dataclass(frozen=True)
class PuschConfig:
    cell: G.CellConfig
    rnti: int
    subframe: int
    mod: str
    tbs: int
    prb_start: int = 0
    nof_prb_alloc: int = 4
    rv: int = 0
    cyclic_shift: int = 0
    uci: uci_mod.UciCfg | None = None

    @property
    def m_sc(self) -> int:
        return self.nof_prb_alloc * NRE

    @property
    def nof_re(self) -> int:
        return self.m_sc * N_DATA_SYMS

    @property
    def qm(self) -> int:
        return BITS_PER_SYMBOL[self.mod]

    @property
    def g_bits(self) -> int:
        return self.nof_re * self.qm

    @functools.cached_property
    def uci_plan(self) -> uci_mod.UciPlan | None:
        if self.uci is None:
            return None
        return uci_mod.uci_plan(self.tbs, self.m_sc, self.qm, self.uci)

    @property
    def g_data(self) -> int:
        """UL-SCH coded bits (= g_bits unless UCI reserves symbols)."""
        return self.g_bits if self.uci_plan is None else self.uci_plan.g_data

    @functools.cached_property
    def plan(self) -> sch.DlschPlan:
        return sch.dlsch_plan(self.tbs, self.g_data, self.qm, self.rv)

    @functools.cached_property
    def scramble_seq(self) -> np.ndarray:
        cinit = scrambling.pdsch_cinit(self.rnti, 0, self.subframe, self.cell.cell_id)
        return gold_sequence_np(cinit, self.g_bits)

    @functools.cached_property
    def interleave_perm(self) -> np.ndarray:
        """Time-first channel interleaver (§5.2.2.8, data-only):
        out[i] = in[perm[i]]."""
        r = self.g_bits // (N_DATA_SYMS * self.qm)
        idx = np.arange(self.g_bits).reshape(r, N_DATA_SYMS, self.qm)
        return idx.transpose(1, 0, 2).reshape(-1)

    @functools.cached_property
    def data_symbols(self) -> np.ndarray:
        return np.asarray([l for l in range(14) if l not in DMRS_SYM])


@functools.lru_cache(maxsize=64)
def _tables(cfg: PuschConfig, device: torch.device) -> dict[str, torch.Tensor]:
    k0 = cfg.prb_start * NRE
    dmrs = np.stack([pusch_dmrs(cfg.cell.cell_id, cfg.nof_prb_alloc, 2 * cfg.subframe + slot,
                                cfg.cyclic_shift) for slot in range(len(DMRS_SYM))])
    t = (np.arange(14, dtype=np.float32) - DMRS_SYM[0]) / np.float32(DMRS_SYM[1] - DMRS_SYM[0])
    return dict(seq=torch.as_tensor(cfg.scramble_seq, device=device),
                perm=torch.as_tensor(cfg.interleave_perm, device=device),
                inv_perm=torch.as_tensor(np.argsort(cfg.interleave_perm), device=device),
                ks=torch.arange(k0, k0 + cfg.m_sc, device=device),
                data_syms=torch.as_tensor(cfg.data_symbols, device=device),
                dmrs_syms=torch.as_tensor(DMRS_SYM, device=device),
                dmrs=torch.as_tensor(dmrs, device=device),
                t=torch.as_tensor(t, device=device))


def _sqrt32(m: int) -> float:
    """sqrt(m) rounded to float32, as the JAX package computes it."""
    return float(np.sqrt(np.float32(m), dtype=np.float32))


def transform_precode(x: torch.Tensor) -> torch.Tensor:
    """DFT precoding per SC-FDMA symbol: (..., M_sc) → (..., M_sc)."""
    return (torch.fft.fft(x, dim=-1) / _sqrt32(x.shape[-1])).to(torch.complex64)


def transform_deprecode(y: torch.Tensor) -> torch.Tensor:
    return (torch.fft.ifft(y, dim=-1) * _sqrt32(y.shape[-1])).to(torch.complex64)


def encode(cfg: PuschConfig, tb_bits: torch.Tensor | np.ndarray,
           cqi_bits: torch.Tensor | None = None,
           ack_bits: torch.Tensor | None = None,
           ri_bits: torch.Tensor | None = None,
           device: torch.device | str | None = None) -> torch.Tensor:
    """TB bits (B, tbs) → UL subframe grid (B, 14, nre) with PUSCH+DMRS.

    With ``cfg.uci`` set, CQI/RI coded symbols are multiplexed with the
    UL-SCH data and HARQ-ACK punctures it (sch.c ulsch_interleave).  A
    tensor ``tb_bits`` stays on its device; other inputs go to ``device``
    (default CUDA), the UCI payloads to the TB's device."""
    bits = _on_device(tb_bits, device)
    dev = bits.device
    tab = _tables(cfg, dev)
    cw = sch.dlsch_encode(cfg.plan, bits)  # UL-SCH shares the FEC chain
    if cfg.uci_plan is not None:
        def on(x):
            return None if x is None else torch.as_tensor(x, device=dev)
        inter = uci_mod.mux(cfg.uci_plan, cw, cqi_bits=on(cqi_bits), ack_bits=on(ack_bits),
                            ri_bits=on(ri_bits))
    else:
        inter = cw[..., tab["perm"]]
    syms = modem.modulate(cfg.mod, scrambling.scramble_bits(inter, tab["seq"]))
    b = bits.shape[0]
    freq = transform_precode(syms.reshape(b, N_DATA_SYMS, cfg.m_sc))
    grid_tx = torch.zeros((b, cfg.cell.nsymb, cfg.cell.nre), dtype=torch.complex64, device=dev)
    ks = tab["ks"]
    grid_tx[:, tab["data_syms"][:, None], ks] = freq
    grid_tx[:, tab["dmrs_syms"][:, None], ks] = tab["dmrs"]
    return grid_tx


def estimate_ul(cfg: PuschConfig, rx_grid: torch.Tensor) -> dict:
    """DMRS-based UL channel estimate over the allocation (chest_ul.c)."""
    tab = _tables(cfg, rx_grid.device)
    h_ls = rx_grid[:, tab["dmrs_syms"][:, None], tab["ks"]] * tab["dmrs"].conj()  # (B, 2, M)
    # light freq smoothing
    hp = torch.cat([h_ls[..., :1], h_ls, h_ls[..., -1:]], dim=-1)  # edge padding
    h_sm = 0.25 * hp[..., :-2] + 0.5 * hp[..., 1:-1] + 0.25 * hp[..., 2:]
    noise_var = torch.mean((h_ls - h_sm).abs() ** 2, dim=(-1, -2)) / 0.375
    # linear time interpolation between the two DMRS symbols
    w1 = tab["t"][None, :, None]
    h = (1 - w1) * h_sm[:, 0:1, :] + w1 * h_sm[:, 1:2, :]  # (B, 14, M_sc)
    return dict(h=h.to(torch.complex64), noise_var=noise_var.to(torch.float32))


def decode(cfg: PuschConfig, rx_grid: torch.Tensor, softbuffers: dict | None = None,
           n_iter: int = 5) -> dict:
    """eNB-side PUSCH receiver (enb_ul.c srsran_enb_ul_get_pusch), on the
    grid's device."""
    tab = _tables(cfg, rx_grid.device)
    est = estimate_ul(cfg, rx_grid)
    b = rx_grid.shape[0]
    y = rx_grid[:, tab["data_syms"][:, None], tab["ks"]]  # (B, 12, M)
    h = est["h"][:, tab["data_syms"]]
    x_f, eff_nv = equalizer.equalize_single(y, h, est["noise_var"][:, None, None])
    x_t = transform_deprecode(x_f)
    # post-IDFT noise is the average over the DFT block
    nv_t = torch.mean(eff_nv, dim=-1, keepdim=True)
    llr = modem.demodulate_soft(cfg.mod, x_t, nv_t).reshape(b, cfg.g_bits)
    llr = scrambling.descramble_llrs(llr, tab["seq"])
    extra: dict = {}
    if cfg.uci_plan is not None:
        extra = uci_mod.demux(cfg.uci_plan, llr)
        deinter = extra.pop("data_llrs")
    else:
        deinter = llr[:, tab["inv_perm"]]  # the inverse of out[i] = in[perm[i]]
    bits, ok, soft = sch.dlsch_decode(cfg.plan, deinter, softbuffers=softbuffers,
                                      n_iter=n_iter)
    return dict(bits=bits, crc_ok=ok, softbuffers=soft, **extra, **est)
