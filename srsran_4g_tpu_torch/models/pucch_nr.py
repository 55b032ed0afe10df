"""NR PUCCH formats 0, 1, 2 (TS 38.211 6.3.2) + UCI coding glue.

Port counterpart of ``srsran_4g_tpu/models/pucch_nr.py`` (the reference's
`lib/src/phy/phch/pucch_nr.c`): format 0 (sequence selection by cyclic
shift), format 1 (base sequence x modulated UCI symbol with time-domain OCC
spreading), format 2 (coded UCI, QPSK, with DMRS every 3rd subcarrier), the
gNB-side detectors, and the UCI coding of 38.212 6.3.1 (repetition for
A <= 2, RM(32, A) for 3..11, CRC11 + polar above).

The length-12 low-PAPR base sequences use the 38.211 Table 5.2.2.2-2 phi
values (same table as `lib/src/phy/common/zc_sequence.c`
zc_sequence_nr_phi_M_sc_12).

Where the port differs in form (the bits are the same):
- ``uci_decode`` undoes the repetition (JAX: a reshape-sum for A <= 11, a
  scatter-add with repeated indices for the polar code) with
  ``polar.fold``: passes of distinct positions added in transmit order, so
  the sums are the same on the CPU and the card, with no atomics;
- sequences, OCC rows, RE maps, DMRS and scrambling sequences are numpy
  tables built once and cached on the device per config; the Gold bits are
  cast to float before ``1 - 2c`` (numpy's uint8 would wrap).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.ops import block_code, modem, polar, sequence
from srsran_4g_tpu_torch.ops import crc as crc_ops

NRE = 12

# TS 38.211 Table 5.2.2.2-2 (phi / 4 units of pi)
_PHI_12 = np.array([
    [-3, 1, -3, -3, -3, 3, -3, -1, 1, 1, 1, -3],
    [-3, 3, 1, -3, 1, 3, -1, -1, 1, 3, 3, 3],
    [-3, 3, 3, 1, -3, 3, -1, 1, 3, -3, 3, -3],
    [-3, -3, -1, 3, 3, 3, -3, 3, -3, 1, -1, -3],
    [-3, -1, -1, 1, 3, 1, 1, -1, 1, -1, -3, 1],
    [-3, -3, 3, 1, -3, -3, -3, -1, 3, -1, 1, 3],
    [1, -1, 3, -1, -1, -1, -3, -1, 1, 1, 1, -3],
    [-1, -3, 3, -1, -3, -3, -3, -1, 1, -1, 1, -3],
    [-3, -1, 3, 1, -3, -1, -3, 3, 1, 3, 3, 1],
    [-3, -1, -1, -3, -3, -1, -3, 3, 1, 3, -1, -3],
    [-3, 3, -3, 3, 3, -3, -1, -1, 3, 3, 1, -3],
    [-3, -1, -3, -1, -1, -3, 3, 3, -1, -1, 1, -3],
    [-3, -1, 3, -3, -3, -1, -3, 1, -1, -3, 3, 3],
    [-3, 1, -1, -1, 3, 3, -3, -1, -1, -3, -1, -3],
    [1, 3, -3, 1, 3, 3, 3, 1, -1, 1, -1, 3],
    [-3, 1, 3, -1, -1, -3, -3, -1, -1, 3, 1, -3],
    [-1, -1, -1, -1, 1, -3, -1, 3, 3, -1, -3, 1],
    [-1, 1, 1, -1, 1, 3, 3, -1, -1, -3, 1, -3],
    [-3, 1, 3, 3, -1, -1, -3, 3, 3, -3, 3, -3],
    [-3, -3, 3, -3, -1, 3, 3, 3, -1, -3, 1, -3],
    [3, 1, 3, 1, 3, -3, -1, 1, 3, 1, -1, -3],
    [-3, 3, 1, 3, -3, 1, 1, 1, 1, 3, -3, 3],
    [-3, 3, 3, 3, -1, -3, -3, -1, -3, 1, 3, -3],
    [3, -1, -3, 3, -3, -1, 3, 3, 3, -3, -1, -3],
    [-3, -1, 1, -3, 1, 3, 3, 3, -1, -3, 3, 3],
    [-3, 3, 1, -1, 3, 3, -3, 1, -1, 1, -1, 1],
    [-1, 1, 3, -3, 1, -1, 1, -1, -1, -3, 1, -1],
    [-3, -3, 3, 3, 3, -3, -1, 1, -3, 3, 1, -3],
    [1, -1, 3, 1, 1, -1, -1, -1, 1, 3, -3, 1],
    [-3, 3, -3, 3, -3, -3, 3, -1, -1, 1, 3, -3]], np.float32)


@functools.lru_cache(maxsize=64)
def base_sequence(u: int) -> np.ndarray:
    """r_u(n) = exp(j*phi(n)*pi/4), length 12 (38.211 5.2.2.2)."""
    return np.exp(1j * _PHI_12[u % 30] * np.pi / 4).astype(np.complex64)


def group_hopping_u(pci: int) -> int:
    """Neither group nor sequence hopping: u = n_ID mod 30."""
    return pci % 30


def _shifted(u: int, alpha_idx: int) -> np.ndarray:
    n = np.arange(NRE)
    return (base_sequence(u)
            * np.exp(2j * np.pi * alpha_idx * n / NRE)).astype(np.complex64)


@functools.lru_cache(maxsize=256)
def _shifted_t(u: int, alpha_idx: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_shifted(u, alpha_idx), device=device)


# --------------------------------------------------------------------------
# format 0: sequence selection (1-2 HARQ bits via cyclic shift offset)


@dataclass(frozen=True)
class PucchNrF0Config:
    pci: int
    initial_shift: int = 0
    nof_bits: int = 1     # 1 or 2


def f0_encode(cfg: PucchNrF0Config, uci: int,
              device: torch.device | str | None = None) -> torch.Tensor:
    """uci value (0..2^nof_bits-1) -> (12,) sequence on ``device`` (default
    CUDA)."""
    step = 6 if cfg.nof_bits == 1 else 3
    alpha = (cfg.initial_shift + uci * step) % NRE
    return _shifted_t(group_hopping_u(cfg.pci), alpha, resolve_device(device))


def f0_detect(cfg: PucchNrF0Config, rx: torch.Tensor) -> dict:
    """(B, 12) -> correlate against all hypotheses."""
    step = 6 if cfg.nof_bits == 1 else 3
    u = group_hopping_u(cfg.pci)
    mat = torch.stack([_shifted_t(u, (cfg.initial_shift + v * step) % NRE, rx.device)
                       for v in range(1 << cfg.nof_bits)])
    corr = (rx @ mat.conj().T).abs().square()  # (B, n_hyp)
    energy = rx.abs().square().sum(dim=-1) * NRE
    return dict(value=torch.argmax(corr, dim=-1),
                metric=corr.amax(dim=-1) / (energy + 1e-9))


# --------------------------------------------------------------------------
# format 1: BPSK/QPSK symbol on base sequence with time OCC


_OCC = {  # DFT OCC of length up to 7 (38.211 Table 6.3.2.4.1-2)
    n: np.exp(-2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)
    .astype(np.complex64)
    for n in range(1, 8)
}


@functools.lru_cache(maxsize=64)
def _occ_t(n: int, i: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_OCC[n][i], device=device)


@dataclass(frozen=True)
class PucchNrF1Config:
    pci: int
    initial_shift: int = 0
    nof_symb: int = 4      # data symbols (DMRS interleaved not modelled)
    occ_idx: int = 0
    nof_bits: int = 1


def f1_encode(cfg: PucchNrF1Config, bits: torch.Tensor) -> torch.Tensor:
    """(B, nof_bits) -> (B, nof_symb, 12)."""
    d = modem.modulate("bpsk" if cfg.nof_bits == 1 else "qpsk", bits)[:, 0]
    seq = _shifted_t(group_hopping_u(cfg.pci), cfg.initial_shift, bits.device)
    w = _occ_t(cfg.nof_symb, cfg.occ_idx, bits.device)
    return d[:, None, None] * w[None, :, None] * seq[None, None, :]


def f1_decode(cfg: PucchNrF1Config, rx: torch.Tensor) -> dict:
    """(B, nof_symb, 12) -> soft symbol + hard bits."""
    seq = _shifted_t(group_hopping_u(cfg.pci), cfg.initial_shift, rx.device)
    w = _occ_t(cfg.nof_symb, cfg.occ_idx, rx.device)
    z = (rx * w.conj()[None, :, None] * seq.conj()[None, None, :]).sum(dim=(1, 2)) \
        / (cfg.nof_symb * NRE)
    if cfg.nof_bits == 1:
        bits = (z.real < 0).to(torch.int8)[:, None]
    else:
        bits = torch.stack([z.real < 0, z.imag < 0], dim=-1).to(torch.int8)
    return dict(bits=bits, symbol=z)


# --------------------------------------------------------------------------
# UCI coding (38.212 6.3.1.2/6.3.1.4) + format 2


def _uci_polar_nlog(k: int, e: int) -> int:
    n_log = 5
    while (1 << n_log) < max(k + 1, e // 2) and n_log < 10:
        n_log += 1
    return n_log


def uci_encode(bits: torch.Tensor, e: int) -> torch.Tensor:
    """(B, A) -> (B, E).  A<=2: repetition; 3..11: RM(32,A) + repeat;
    >=12: CRC11 + polar (38.212 6.3.1.2.1 simplified)."""
    a = bits.shape[-1]
    if a <= 2:
        cw = bits.to(torch.int8)
    elif a <= 11:
        cw = block_code.encode(bits, 32)  # (B, 32)
    else:
        payload = torch.cat([bits.to(torch.int8), crc_ops.crc_compute(bits, "11")], -1)
        cw = polar.encode_info(payload, _uci_polar_nlog(a + 11, e))
    n = cw.shape[-1]
    return cw.repeat(1, -(-e // n))[:, :e].to(torch.int8)


def uci_decode(llrs: torch.Tensor, a: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, E) -> (bits (B, A), ok (B,))."""
    b, e = llrs.shape
    if a <= 2:
        acc = polar.fold(llrs[:, :(e // a) * a], a)
        return (acc > 0).to(torch.int8), torch.ones(b, dtype=torch.bool, device=llrs.device)
    if a <= 11:
        bits, _ = block_code.decode(polar.fold(llrs, 32), 32, a)
        return bits, torch.ones(b, dtype=torch.bool, device=llrs.device)
    k = a + 11
    n_log = _uci_polar_nlog(k, e)
    dec = polar.decode(polar.fold(llrs, 1 << n_log), k, n_log)
    return dec[:, :a], crc_ops.crc_check(dec, "11")


@dataclass(frozen=True)
class PucchNrF2Config:
    pci: int
    rnti: int
    nof_prb: int = 1
    nof_symb: int = 1
    nof_uci_bits: int = 4

    @property
    def e_bits(self) -> int:
        # 8 data RE per PRB (4 DMRS at k%3==1), QPSK
        return self.nof_prb * 8 * self.nof_symb * 2


def _f2_dmrs(cfg: PucchNrF2Config) -> np.ndarray:
    cinit = (cfg.rnti * (1 << 15) + cfg.pci) % (1 << 31)
    n = 4 * cfg.nof_prb * cfg.nof_symb
    c = sequence.gold_sequence_np(cinit, 2 * n).astype(np.float32)
    return (((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)) \
        .astype(np.complex64)


@functools.lru_cache(maxsize=64)
def _f2_tables(cfg: PucchNrF2Config, device: torch.device) -> dict[str, torch.Tensor]:
    k_all = np.arange(NRE * cfg.nof_prb)
    scr = sequence.gold_sequence_np((cfg.rnti * (1 << 15) + cfg.pci) % (1 << 31), cfg.e_bits)
    return dict(dmrs_k=torch.as_tensor(k_all[k_all % 3 == 1], device=device),
                data_k=torch.as_tensor(k_all[k_all % 3 != 1], device=device),
                dmrs=torch.as_tensor(_f2_dmrs(cfg).reshape(cfg.nof_symb, -1), device=device),
                scr=torch.as_tensor(scr.astype(np.int8), device=device),
                scr_sign=torch.as_tensor(1.0 - 2.0 * scr.astype(np.float32), device=device))


def f2_encode(cfg: PucchNrF2Config, uci_bits: torch.Tensor) -> torch.Tensor:
    """(B, A) -> (B, nof_symb, 12*nof_prb)."""
    b = uci_bits.shape[0]
    t = _f2_tables(cfg, uci_bits.device)
    # scramble (c_init = rnti*2^15 + n_ID)
    cw = torch.bitwise_xor(uci_encode(uci_bits, cfg.e_bits), t["scr"])
    syms = modem.modulate("qpsk", cw).reshape(b, cfg.nof_symb, -1)
    out = torch.zeros((b, cfg.nof_symb, NRE * cfg.nof_prb), dtype=torch.complex64,
                      device=uci_bits.device)
    out[:, :, t["data_k"]] = syms
    out[:, :, t["dmrs_k"]] = t["dmrs"][None]
    return out


def f2_decode(cfg: PucchNrF2Config, rx: torch.Tensor) -> dict:
    b = rx.shape[0]
    t = _f2_tables(cfg, rx.device)
    h_ls = rx[:, :, t["dmrs_k"]] * t["dmrs"].conj()[None]
    h = h_ls.mean(dim=(-1, -2), keepdim=True)
    nv = (h_ls - h).abs().square().mean(dim=(-1, -2), keepdim=True) + 1e-9
    y = rx[:, :, t["data_k"]]
    h2 = h.abs().square()
    x = y * h.conj() / (h2 + nv)
    llr = modem.demodulate_soft("qpsk", x, nv / (h2 + 1e-9)).reshape(b, cfg.e_bits)
    bits, ok = uci_decode(llr * t["scr_sign"], cfg.nof_uci_bits)
    return dict(bits=bits, ok=ok)
