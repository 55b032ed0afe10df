"""PDSCH spatial multiplexing: TM3 (open-loop CDD) / TM4 (closed-loop) 2×2
with two codewords.

Port counterpart of ``srsran_4g_tpu/models/pdsch_mimo.py`` (the reference's
pdsch.c at rank 2 with precoding.c and the dual-codeword
srsran_dlsch_decode2, sch.c:580):

  encode: per-codeword DL-SCH → scramble(q) → modulate → layer map →
          codebook/CDD precode → per-port RE map (add CRS with
          ``pdsch.add_crs(cfg.cw[0], …)``)
  decode: per (rx, port) CRS chest → effective channel H·W (TM4) or
          H·W·D(i)·U (TM3, per-RE cycling) → batched 2×2 MMSE →
          per-codeword soft demod/descramble → DL-SCH decode

When both codewords share one transport format they decode as one DL-SCH
call at twice the batch, so the turbo kernels see both codewords' blocks in
one launch.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.models import chest as chest_mod
from srsran_4g_tpu_torch.models import grid as G
from srsran_4g_tpu_torch.models import mimo, pdsch, sch
from srsran_4g_tpu_torch.ops import modem, scrambling


@dataclass(frozen=True)
class PdschMimoConfig:
    cell: G.CellConfig  # nof_ports must be 2
    rnti: int
    subframe: int
    mod0: str
    tbs0: int
    mod1: str
    tbs1: int
    tm: str = "tm4"  # "tm3" (CDD) | "tm4" (codebook)
    pmi: int = 0     # TM4 rank-2 codebook index (0..2)
    rv0: int = 0
    rv1: int = 0
    prb_alloc: tuple[int, ...] | None = None

    @functools.cached_property
    def cw(self) -> tuple[pdsch.PdschConfig, pdsch.PdschConfig]:
        return tuple(
            pdsch.PdschConfig(cell=self.cell, rnti=self.rnti, subframe=self.subframe,
                              mod=mod, tbs=tbs, rv=rv, prb_alloc=self.prb_alloc,
                              codeword=q)
            for q, (mod, tbs, rv) in enumerate(((self.mod0, self.tbs0, self.rv0),
                                                (self.mod1, self.tbs1, self.rv1))))


def _modulated_cw(cfg: pdsch.PdschConfig, tb_bits: torch.Tensor) -> torch.Tensor:
    seq = pdsch._tables(cfg, tb_bits.device)["seq"]
    cw = sch.dlsch_encode(cfg.plan, tb_bits)
    return modem.modulate(cfg.mod, scrambling.scramble_bits(cw, seq))  # (B, nof_re)


def encode(cfg: PdschMimoConfig, tb0: torch.Tensor | np.ndarray,
           tb1: torch.Tensor | np.ndarray,
           device: torch.device | str | None = None) -> torch.Tensor:
    """Two TBs (B, tbs0), (B, tbs1) → (B, 2, nsymb, nre) complex64 port grids
    (no CRS; use ``pdsch.add_crs(cfg.cw[0], …)``).  Tensor inputs stay on
    their device; other inputs go to ``device`` (default CUDA)."""
    if cfg.cell.nof_ports != 2:
        raise ValueError(f"2x2 spatial multiplexing needs 2 ports, not "
                         f"{cfg.cell.nof_ports}")
    c0, c1 = cfg.cw
    tb0 = pdsch._on_device(tb0, device)
    tb1 = pdsch._on_device(tb1, tb0.device)
    layers = mimo.layer_map([_modulated_cw(c0, tb0), _modulated_cw(c1, tb1)], 2)
    ports = (mimo.cdd_precode_2x2(layers) if cfg.tm == "tm3"
             else mimo.precode_2x2(layers, cfg.pmi))
    b = ports.shape[0]
    flat = torch.zeros((b, 2, cfg.cell.nsymb * cfg.cell.nre), dtype=torch.complex64,
                       device=tb0.device)
    flat[:, :, pdsch._tables(c0, tb0.device)["re_idx"]] = ports
    return flat.reshape(b, 2, cfg.cell.nsymb, cfg.cell.nre)


def _effective_channel(cfg: PdschMimoConfig, h: torch.Tensor) -> torch.Tensor:
    """(B, rx2, tx2, S) physical channel → (B, rx2, layer2, S) effective
    channel including the TX precoding."""
    if cfg.tm == "tm4":
        w = mimo._c64(mimo._CODEBOOK_2TX_R2[cfg.pmi], h.device)
        return torch.einsum("brts,tl->brls", h, w)
    # TM3: W0 · D(i) · U with D(i) = diag(1, e^{-jπ i}) per RE counter i
    d1 = mimo.cdd_phase(h.shape[-1], h.device)
    u = mimo._c64(np.array([[1, 1], [1, -1]]) / math.sqrt(2), h.device)
    w0 = mimo._c64(mimo._CODEBOOK_2TX_R2[0], h.device)
    wdi = torch.stack([  # W(i) = W0 · D(i) · U, (tx, layer, S)
        torch.stack([w0[t, 0] * u[0, l] + w0[t, 1] * d1 * u[1, l] for l in range(2)])
        for t in range(2)])
    return torch.einsum("brts,tls->brls", h, wdi)


def decode(cfg: PdschMimoConfig, rx_grids: torch.Tensor,
           h: torch.Tensor | None = None,
           noise_var: torch.Tensor | float | None = None,
           n_iter: int = 5) -> dict:
    """Decode both codewords from 2 RX antennas, on the grids' device.

    Args:
      rx_grids: (B, 2, nsymb, nre) received grids (2 RX antennas).
      h: optional (B, 2rx, 2tx, nsymb, nre); estimated from the per-port CRS
        on each antenna when absent (noise_var then the mean of the four
        estimates).

    Returns dict(bits0, bits1, crc_ok0, crc_ok1, h, noise_var).
    """
    c0, c1 = cfg.cw
    b = rx_grids.shape[0]
    dev = rx_grids.device
    if h is None or noise_var is None:
        ccfg = chest_mod.ChestConfig(cell=cfg.cell)
        ests = [[chest_mod.estimate(ccfg, rx_grids[:, r], cfg.subframe, port=p)
                 for p in range(2)] for r in range(2)]
        if h is None:
            h = torch.stack([torch.stack([e["h"] for e in row], dim=1) for row in ests],
                            dim=1)  # (B, rx, tx, nsymb, nre)
        if noise_var is None:
            nvs = [e["noise_var"] for row in ests for e in row]
            noise_var = sum(nvs) / len(nvs)

    idx = pdsch._tables(c0, dev)["re_idx"]
    y = rx_grids.reshape(b, 2, -1)[..., idx]        # (B, 2, S)
    h_eff = _effective_channel(cfg, h.reshape(b, 2, 2, -1)[..., idx])
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=dev)
    if nv.ndim == 1:  # per-batch estimate -> broadcast over REs
        nv = nv[:, None]
    xh, env = mimo.mmse_detect_2x2(y, h_eff, nv)
    llrs = [scrambling.descramble_llrs(
                modem.demodulate_soft(cfg_q.mod, xh[:, q], env[:, q]).reshape(b, cfg_q.g_bits),
                pdsch._tables(cfg_q, dev)["seq"])
            for q, cfg_q in enumerate((c0, c1))]
    out: dict = dict(h=h, noise_var=noise_var)
    if c0.plan == c1.plan:
        # one transport format: one DL-SCH decode at twice the batch, so the
        # turbo kernels run both codewords' blocks in one launch
        bits, ok, _ = sch.dlsch_decode(c0.plan, torch.cat(llrs, dim=0), n_iter=n_iter)
        out.update(bits0=bits[:b], bits1=bits[b:], crc_ok0=ok[:b], crc_ok1=ok[b:])
        return out
    for q, (cfg_q, llr) in enumerate(zip((c0, c1), llrs)):
        bits, ok, _ = sch.dlsch_decode(cfg_q.plan, llr, n_iter=n_iter)
        out[f"bits{q}"], out[f"crc_ok{q}"] = bits, ok
    return out
