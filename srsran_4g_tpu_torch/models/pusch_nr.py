"""NR PUSCH (CP-OFDM) — LDPC UL-SCH over a slot grid with type-1 DMRS.

Port counterpart of ``srsran_4g_tpu/models/pusch_nr.py`` (the reference's
`lib/src/phy/phch/pusch_nr.c`, gNB side in `gnb_ul.c`): for the CP-OFDM
waveform the PUSCH chain is the PDSCH chain with the UL scrambling identity
and DMRS.

UCI on PUSCH (38.212 §6.3.2, counterpart of `phch/uci_nr.c` + `pusch_nr.c`
UCI multiplexing): HARQ-ACK and CSI ride the PUSCH allocation.  CSI is
rate-matched (UL-SCH data skips its REs); ACK punctures data REs near the
first DMRS symbol, so a missed DL grant cannot desync the data rate
matching (the reason the spec punctures).  ``_uci_plan`` is JAX's host plan,
unchanged; its index vectors are cached on the device per config.  The UCI
codes are ``pucch_nr.uci_encode`` / ``uci_decode``, whose de-repetition sums
in a fixed order on the CPU and the card.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.models import grid_nr, pdsch_nr, sch_nr
from srsran_4g_tpu_torch.models.pdsch import _on_device
from srsran_4g_tpu_torch.models.pdsch_nr import DMRS_SYMS
from srsran_4g_tpu_torch.models.pucch_nr import uci_decode, uci_encode
from srsran_4g_tpu_torch.ops import modem, scrambling


@dataclass(frozen=True)
class PuschNrConfig(pdsch_nr.PdschNrConfig):
    """Same geometry as PDSCH-NR; scrambling uses the UL identity
    (38.211 6.3.1.1 c_init = rnti*2^15 + n_ID)."""


def encode(cfg: PuschNrConfig, tb_bits, device: torch.device | str | None = None
           ) -> torch.Tensor:
    return pdsch_nr.encode(cfg, tb_bits, device=device)


def decode(cfg: PuschNrConfig, rx_grid: torch.Tensor,
           softbuffers: dict | None = None, n_iter: int = 12) -> dict:
    """gNB-side receiver (gnb_ul.c -> pusch_nr.c decode)."""
    return pdsch_nr.decode(cfg, rx_grid, softbuffers=softbuffers, n_iter=n_iter)


# --------------------------------------------------------------------------
# UCI on PUSCH


@dataclass(frozen=True)
class NrUciCfg:
    o_ack: int = 0
    o_csi: int = 0
    beta_ack: float = 2.0   # beta-offset (38.213 table 9.3-1 value)
    beta_csi: float = 2.0
    alpha: float = 0.5      # scaling cap (38.212 6.3.2.4)


@dataclass(frozen=True)
class PuschNrUciConfig(PuschNrConfig):
    uci: NrUciCfg | None = None


@functools.lru_cache(maxsize=128)
def _uci_plan(cfg: "PuschNrUciConfig"):
    """Static bit-position plan: (e_ack, e_csi, ack_bit_idx, csi_bit_idx,
    data_bit_idx) — all indices into the (g_bits,) codeword."""
    u = cfg.uci
    qm = cfg.qm
    nre = cfg.nof_re
    r_data = cfg.tbs / cfg.g_bits

    def e_of(o: int, beta: float) -> int:
        if o == 0:
            return 0
        l_crc = 0 if o <= 11 else 11
        e = qm * math.ceil((o + l_crc) * beta / (r_data * qm))
        cap = qm * max(1, int(u.alpha * nre))
        return max(qm, min(e, cap))

    e_ack = e_of(u.o_ack, u.beta_ack)
    e_csi = e_of(u.o_csi, u.beta_csi)
    nre_sym = cfg.carrier.nre
    data_syms = [l for l in range(cfg.start_sym, cfg.start_sym + cfg.nof_syms)
                 if l not in DMRS_SYMS]
    # ACK REs: from the first data symbol after the first DMRS symbol,
    # evenly strided across each symbol (38.212 6.2.7 distribution idea)
    ack_re: list[int] = []
    sym_i = next(i for i, l in enumerate(data_syms) if l > DMRS_SYMS[0])
    remaining = e_ack // qm
    while remaining > 0:
        take = min(remaining, nre_sym)
        stride = nre_sym // take
        ack_re.extend(sym_i * nre_sym + k * stride for k in range(take))
        remaining -= take
        sym_i += 1
    ack_re_arr = np.asarray(sorted(ack_re), np.int64)
    ack_set = set(ack_re)
    # CSI REs: first free REs in mapping order, skipping ACK positions
    csi_re: list[int] = []
    need = e_csi // qm
    i = 0
    while len(csi_re) < need:
        if i not in ack_set:
            csi_re.append(i)
        i += 1
    csi_re_arr = np.asarray(csi_re, np.int64)
    csi_set = set(csi_re)
    data_re = np.asarray([k for k in range(nre) if k not in csi_set],
                         np.int64)

    def bit_idx(re_arr: np.ndarray) -> np.ndarray:
        return (re_arr[:, None] * qm + np.arange(qm)).reshape(-1)

    return (e_ack, e_csi, bit_idx(ack_re_arr), bit_idx(csi_re_arr),
            bit_idx(data_re))


@functools.lru_cache(maxsize=128)
def _uci_tables(cfg: PuschNrUciConfig, device: torch.device) -> dict:
    e_ack, e_csi, ack_idx, csi_idx, data_idx = _uci_plan(cfg)
    return dict(e_ack=e_ack, e_csi=e_csi,
                ack=torch.as_tensor(ack_idx, device=device),
                csi=torch.as_tensor(csi_idx, device=device),
                data=torch.as_tensor(data_idx, device=device),
                seg=sch_nr.nr_segment(cfg.tbs, cfg.g_bits - e_csi, cfg.qm, cfg.rv))


def encode_uci(cfg: PuschNrUciConfig, tb_bits, ack_bits=None, csi_bits=None,
               device: torch.device | str | None = None) -> torch.Tensor:
    """(B, tbs) + optional ACK/CSI -> slot grid with UCI multiplexed.  A
    tensor keeps its device; other input goes to ``device`` (default CUDA)."""
    if cfg.uci is None:
        return encode(cfg, tb_bits, device=device)
    tb_bits = _on_device(tb_bits, device)
    dev = tb_bits.device
    p = _uci_tables(cfg, dev)
    tab = pdsch_nr._tables(cfg, dev)
    b = tb_bits.shape[0]
    full = torch.zeros((b, cfg.g_bits), dtype=torch.int8, device=dev)
    full[:, p["data"]] = sch_nr.encode(p["seg"], tb_bits)
    if p["e_csi"]:
        full[:, p["csi"]] = uci_encode(torch.as_tensor(csi_bits, device=dev), p["e_csi"])
    if p["e_ack"]:
        full[:, p["ack"]] = uci_encode(torch.as_tensor(ack_bits, device=dev), p["e_ack"])
    syms = modem.modulate(cfg.mod, scrambling.scramble_bits(full, tab["seq"]))
    flat = torch.zeros((b, grid_nr.NSYMB * cfg.carrier.nre), dtype=torch.complex64, device=dev)
    flat[:, tab["re_idx"]] = syms
    grid = flat.reshape(b, grid_nr.NSYMB, cfg.carrier.nre)
    return grid_nr.put_dmrs_type1(grid, cfg.carrier, cfg.slot, DMRS_SYMS)


def decode_uci(cfg: PuschNrUciConfig, rx_grid: torch.Tensor, n_iter: int = 12) -> dict:
    """-> dict(bits, crc_ok, ack_bits?, csi_bits?) (gnb_ul.c UCI path)."""
    if cfg.uci is None:
        return decode(cfg, rx_grid)
    p = _uci_tables(cfg, rx_grid.device)
    llr, _ = pdsch_nr.soft_bits(cfg, rx_grid)
    out: dict = {}
    if p["e_ack"]:
        out["ack_bits"], _ = uci_decode(llr[:, p["ack"]], cfg.uci.o_ack)
        llr = llr.index_fill(1, p["ack"], 0.0)  # punctured for data
    if p["e_csi"]:
        out["csi_bits"], _ = uci_decode(llr[:, p["csi"]], cfg.uci.o_csi)
    bits, ok, _ = sch_nr.decode(p["seg"], llr[:, p["data"]], n_iter=n_iter)
    out.update(bits=bits, crc_ok=ok)
    return out
