"""PUCCH: uplink control channel, formats 1/1a/1b, 2/2a/2b and 3 (36.211 §5.4).

Port counterpart of ``srsran_4g_tpu/models/pucch.py`` (the reference's
`lib/src/phy/phch/pucch.c` + `pucch_proc.c`).

Format 1x: one BPSK/QPSK symbol spread over length-12 cyclic-shifted base
sequences (the shift hops per symbol via the cell PRNG) and a length-4
orthogonal cover across the 4 data SC-FDMA symbols of each slot (DMRS on the
middle 3 symbols with a DFT-3 cover).  Format 2: RM(20, A)-coded CQI,
scrambled then QPSK on 10 symbols with per-symbol cyclic shifts (DMRS on
symbols 1, 5); 2a/2b also modulate the second DMRS symbol of each slot with
1-2 HARQ-ACK bits.  Format 3: (32, O) block code cyclically extended to 48
bits, QPSK, block-spread over the 5 data symbols per slot with a length-5
DFT cover and per-symbol cell cyclic rotation, DFT-12 precoded.

The JAX package builds the spreading sequences in per-slot, per-symbol
Python loops.  Here they are host tables built once per (config, format)
and kept on the device as (slot, symbol, 12) arrays, with the symbol and
subcarrier indices of both slots; the transmitter writes and the receiver
gathers both slots at once, batched over UEs.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.models import grid as G
from srsran_4g_tpu_torch.models.refsignal_ul import base_sequence
from srsran_4g_tpu_torch.ops import block_code, modem
from srsran_4g_tpu_torch.ops.sequence import gold_sequence_np
from srsran_4g_tpu_torch.utils.constants import NRE

# normal CP symbol roles per slot
F1_DATA_SYMS = (0, 1, 5, 6)
F1_DMRS_SYMS = (2, 3, 4)
F2_DATA_SYMS = (0, 2, 3, 4, 6)
F2_DMRS_SYMS = (1, 5)
F3_DATA_SYMS = F2_DATA_SYMS  # format 3 (block-spread DFT-S-OFDM, §5.4.2A)
F3_DMRS_SYMS = F2_DMRS_SYMS
PUCCH3_NOF_BITS = 48

# orthogonal covers (TS 36.211 Table 5.4.1-2 / 5.5.2.2.1-2)
_W4 = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, -1, -1, 1]], dtype=np.complex64)
_W3 = np.exp(2j * np.pi / 3 * np.array([[0, 0, 0], [0, 1, 2], [0, 2, 1]])).astype(
    np.complex64
)
_SQRT2 = float(np.sqrt(np.float32(2.0), dtype=np.float32))


@dataclass(frozen=True)
class PucchConfig:
    cell: G.CellConfig
    subframe: int
    n_pucch: int  # resource index (n^(1) or n^(2))
    delta_shift: int = 2  # deltaPUCCH-Shift
    n_rb_2: int = 0  # nRB-CQI
    n_cs_1: int = 0  # nCS-AN
    rnti: int = 0  # C-RNTI seeding format 2/3 scrambling


@functools.lru_cache(maxsize=256)
def _ncs_cell_raw(cell_id: int, ns: int) -> np.ndarray:
    """Raw 8-bit n_cs_cell(ns, l) (§5.4): format 3 consumes the full value
    (cyclic rotation mod 12 + quadrant phase from the high bits)."""
    c = gold_sequence_np(cell_id, 8 * 7 * 20)
    bits = c[8 * 7 * ns:8 * 7 * (ns + 1)].reshape(7, 8).astype(np.int64)
    return (bits << np.arange(8)).sum(axis=1)


def _ncs_cell(cell_id: int, ns: int) -> np.ndarray:
    return _ncs_cell_raw(cell_id, ns) % 12


def _f2_scramble(cfg: PucchConfig, n: int) -> np.ndarray:
    """Format 2/3 bit scrambling (§5.4.2): c_init =
    (⌊ns/2⌋+1)(2 N_id+1)·2^16 + rnti."""
    cinit = ((cfg.subframe + 1) * (2 * cfg.cell.cell_id + 1) << 16) + cfg.rnti
    return gold_sequence_np(cinit, n)


def _f1_resource(cfg: PucchConfig, ns: int) -> tuple[int, int]:
    """(n', n_oc) for format 1 in slot ns (§5.4.1, all-format-1 PRB case)."""
    c = 3  # normal CP
    np_prime = c * NRE // cfg.delta_shift  # resources per PRB
    n1 = cfg.n_pucch
    if ns % 2 == 0:
        n_p = n1 % np_prime
    else:
        n_even = n1 % np_prime
        n_p = (c * (n_even + 1)) % (c * NRE // cfg.delta_shift + 1) - 1
        if n_p < 0:
            n_p = n_even  # degenerate small-index case
    n_oc = n_p * cfg.delta_shift // NRE
    return n_p, n_oc


def _f1_alpha(cfg: PucchConfig, ns: int, l: int, n_p: int, n_oc: int) -> float:
    ncs_cell = _ncs_cell(cfg.cell.cell_id, ns)[l]
    n_cs = (ncs_cell + (n_p * cfg.delta_shift + (n_oc % cfg.delta_shift)) % NRE) % NRE
    return 2 * np.pi * n_cs / NRE


def pucch_prb(cfg: PucchConfig, ns: int) -> int:
    """Band-edge PRB with slot hopping (§5.4.3)."""
    m = (cfg.n_pucch * cfg.delta_shift) // (3 * NRE) + cfg.n_rb_2
    if (m + ns) % 2 == 0:
        return m // 2
    return cfg.cell.nof_prb - 1 - m // 2


def pucch3_prb(cfg: PucchConfig, ns: int) -> int:
    """Band-edge PRB for format 3: m = n_pucch/5 (`pucch.c:1008`)."""
    m = cfg.n_pucch // 5
    if (m + ns) % 2 == 0:
        return m // 2
    return cfg.cell.nof_prb - 1 - m // 2


@functools.lru_cache(maxsize=512)
def _f1_slot_matrix(cfg: PucchConfig, ns: int) -> tuple[np.ndarray, np.ndarray]:
    """(data (4, 12), dmrs (3, 12)) spreading for d(0)=1 in slot ns."""
    r = base_sequence(cfg.cell.cell_id % 30, 0, NRE)
    n_p, n_oc = _f1_resource(cfg, ns)
    n = np.arange(NRE)
    data = np.zeros((4, NRE), np.complex64)
    for i, l in enumerate(F1_DATA_SYMS):
        data[i] = r * np.exp(1j * _f1_alpha(cfg, ns, l, n_p, n_oc) * n) * _W4[n_oc, i]
    dmrs = np.zeros((3, NRE), np.complex64)
    for i, l in enumerate(F1_DMRS_SYMS):
        dmrs[i] = r * np.exp(1j * _f1_alpha(cfg, ns, l, n_p, n_oc) * n) * _W3[n_oc, i]
    return data, dmrs


@functools.lru_cache(maxsize=512)
def _f2_params(cfg: PucchConfig, ns: int):
    r = base_sequence(cfg.cell.cell_id % 30, 0, NRE)
    alphas = [2 * np.pi * ((_ncs_cell(cfg.cell.cell_id, ns)[l] + cfg.n_pucch % NRE) % NRE) / NRE
              for l in range(7)]
    return r, alphas


def _f2_seq(cfg: PucchConfig, ns: int, l: int) -> np.ndarray:
    """The cyclic-shifted base sequence of format 2/3 symbol l in slot ns."""
    r, alphas = _f2_params(cfg, ns)
    return (r * np.exp(1j * alphas[l] * np.arange(NRE))).astype(np.complex64)


def _f3_spread_params(cfg: PucchConfig, slot: int):
    """(w (5,), ncs (5,), phase (5,)) for the 5 data symbols of `slot`."""
    ns = 2 * cfg.subframe + slot
    n_oc = cfg.n_pucch % 5 if slot == 0 else (3 * cfg.n_pucch) % 5
    w = np.exp(2j * np.pi * n_oc * np.arange(5) / 5).astype(np.complex64)
    ncs = _ncs_cell_raw(cfg.cell.cell_id, ns)[list(F3_DATA_SYMS)]
    phase = np.exp(1j * np.pi * (ncs // 64) / 2).astype(np.complex64)
    return w, ncs, phase


@functools.lru_cache(maxsize=256)
def _layout(cfg: PucchConfig, fmt: str, device: torch.device) -> dict[str, torch.Tensor]:
    """Both slots' tables for format "1", "2" or "3" on the device: the data
    and DMRS symbol indices (2, S), the subcarriers (2, 12), the data and
    DMRS sequences (2, S, 12), and for format 3 the cover times phase
    (2, 5) and the cyclic rotations (2, 5, 12) and their inverses."""
    data_syms, dmrs_syms = (F1_DATA_SYMS, F1_DMRS_SYMS) if fmt == "1" else (
        F2_DATA_SYMS, F2_DMRS_SYMS)
    tab: dict[str, np.ndarray] = dict(
        data_syms=np.asarray([[7 * s + l for l in data_syms] for s in (0, 1)]),
        dmrs_syms=np.asarray([[7 * s + l for l in dmrs_syms] for s in (0, 1)]))
    prb_of = pucch3_prb if fmt == "3" else pucch_prb
    tab["ks"] = np.stack([prb_of(cfg, 2 * cfg.subframe + s) * NRE + np.arange(NRE)
                          for s in (0, 1)])
    slots = [2 * cfg.subframe + s for s in (0, 1)]
    if fmt == "1":
        tab["data"] = np.stack([_f1_slot_matrix(cfg, ns)[0] for ns in slots])
        tab["dmrs"] = np.stack([_f1_slot_matrix(cfg, ns)[1] for ns in slots])
    else:
        tab["data"] = np.stack([[_f2_seq(cfg, ns, l) for l in data_syms] for ns in slots])
        tab["dmrs"] = np.stack([[_f2_seq(cfg, ns, l) for l in dmrs_syms] for ns in slots])
    if fmt == "3":
        n = np.arange(NRE)
        params = [_f3_spread_params(cfg, s) for s in (0, 1)]
        tab["cover"] = np.stack([w * phase for w, _, phase in params])
        tab["rot"] = np.stack([[(n + int(c)) % NRE for c in ncs] for _, ncs, _ in params])
        tab["inv_rot"] = np.stack([[(n - int(c)) % NRE for c in ncs] for _, ncs, _ in params])
    return {k: torch.as_tensor(v, device=device) for k, v in tab.items()}


def _gather(rx_grid: torch.Tensor, syms: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """rx_grid (B, 14, nre) at both slots' symbols and subcarriers →
    (B, 2, S, 12)."""
    return rx_grid[:, syms[:, :, None], ks[:, None, :]]


def _empty_grid(cfg: PucchConfig, b: int, device: torch.device) -> torch.Tensor:
    return torch.zeros((b, cfg.cell.nsymb, cfg.cell.nre), dtype=torch.complex64,
                       device=device)


def encode_format1(cfg: PucchConfig, bits: torch.Tensor | None,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """Format 1/1a/1b TX grid (B, 14, nre).

    bits: None (format 1 / SR: one grid on ``device``, default CUDA), (B,1)
    (1a) or (B,2) (1b), on their device.
    """
    if bits is None:
        d = torch.ones((1, 1), dtype=torch.complex64, device=resolve_device(device))
    else:
        d = modem.modulate("bpsk" if bits.shape[-1] == 1 else "qpsk", bits)
    tab = _layout(cfg, "1", d.device)
    g = _empty_grid(cfg, d.shape[0], d.device)
    g[:, tab["data_syms"][:, :, None], tab["ks"][:, None, :]] = d[:, 0, None, None, None] * tab["data"]
    g[:, tab["dmrs_syms"][:, :, None], tab["ks"][:, None, :]] = tab["dmrs"]
    return g


def decode_format1(cfg: PucchConfig, rx_grid: torch.Tensor, nof_bits: int,
                   noise_var=1e-2) -> dict:
    """Coherent format 1a/1b detection.  Returns dict(bits, metric,
    detected)."""
    tab = _layout(cfg, "1", rx_grid.device)
    h = torch.mean(_gather(rx_grid, tab["dmrs_syms"], tab["ks"]) * tab["dmrs"].conj(),
                   dim=(-1, -2))  # (B, 2)
    z = torch.sum(_gather(rx_grid, tab["data_syms"], tab["ks"]) * tab["data"].conj(),
                  dim=(-1, -2))
    zs = z * h.conj()
    z = (zs[:, 0] + zs[:, 1]) / (8 * NRE)
    if nof_bits == 1:
        llr = -z.real[..., None]  # d=+1 ⇔ bit 0 (BPSK table)
    else:
        llr = torch.stack([-z.real, -z.imag], dim=-1) * _SQRT2
    return dict(bits=(llr > 0).to(torch.int8), metric=z.abs(), detected=z.abs() > noise_var)


def _mod_ack_2ab(ack_bits: torch.Tensor) -> torch.Tensor:
    """d(10) for formats 2a/2b (Table 5.4.2-1): (B, 1|2) bits → (B,)."""
    a = ack_bits.to(torch.float32)
    if ack_bits.shape[-1] == 1:
        return (1.0 - 2.0 * a[:, 0]).to(torch.complex64)
    b0, b1 = a[:, 0], a[:, 1]
    # 00→1, 01→-j, 10→j, 11→-1
    return torch.complex((1 - b0) * (1 - b1) - b0 * b1, b0 * (1 - b1) - (1 - b0) * b1)


def encode_format2(cfg: PucchConfig, cqi_bits: torch.Tensor,
                   ack_bits: torch.Tensor | None = None) -> torch.Tensor:
    """Format 2/2a/2b: (B, A≤13) CQI bits (+ optional (B, 1|2) ACK bits
    modulating the second DMRS symbol of each slot) → TX grid, on the CQI
    bits' device."""
    dev = cqi_bits.device
    tab = _layout(cfg, "2", dev)
    scr = torch.as_tensor(_f2_scramble(cfg, 20).astype(np.int8), device=dev)
    d = modem.modulate("qpsk", block_code.encode(cqi_bits, 20) ^ scr)  # (B, 10)
    b = d.shape[0]
    g = _empty_grid(cfg, b, dev)
    ks = tab["ks"][:, None, :]
    g[:, tab["data_syms"][:, :, None], ks] = d.reshape(b, 2, 5, 1) * tab["data"]
    dmrs = tab["dmrs"].expand(b, 2, 2, NRE).clone()
    if ack_bits is not None:
        dmrs[:, :, 1] = _mod_ack_2ab(ack_bits)[:, None, None] * tab["dmrs"][:, 1]
    g[:, tab["dmrs_syms"][:, :, None], ks] = dmrs
    return g


def decode_format2(cfg: PucchConfig, rx_grid: torch.Tensor, nof_bits: int,
                   nof_ack: int = 0) -> dict:
    """Format 2/2a/2b decode.  With nof_ack > 0, the channel comes from the
    first DMRS symbol of each slot and the second one is detected as the ACK
    symbol (2a: BPSK, 2b: QPSK)."""
    dev = rx_grid.device
    tab = _layout(cfg, "2", dev)
    h_m = torch.mean(_gather(rx_grid, tab["dmrs_syms"], tab["ks"]) * tab["dmrs"].conj(),
                     dim=-1)  # (B, 2 slots, 2 DMRS)
    if nof_ack:
        h = h_m[..., 0]
        za = h_m[..., 1] * h.conj()
        z_ack = za[:, 0] + za[:, 1]
    else:
        h = (h_m[..., 0] + h_m[..., 1]) / 2
    z = torch.mean(_gather(rx_grid, tab["data_syms"], tab["ks"]) * tab["data"].conj(), dim=-1)
    syms = (z * h.conj()[..., None]
            / torch.clamp(h.abs() ** 2, min=1e-9)[..., None]).reshape(-1, 10)
    llr = modem.demodulate_soft("qpsk", syms, 0.1)
    scr = torch.as_tensor(_f2_scramble(cfg, 20).astype(np.float32), device=dev)
    bits, metric = block_code.decode(llr * (1.0 - 2.0 * scr), 20, nof_bits)
    out = dict(bits=bits, metric=metric)
    if nof_ack == 1:
        out["ack_bits"] = (z_ack.real < 0).to(torch.int8)[:, None]
    elif nof_ack == 2:
        out["ack_bits"] = torch.stack([(z_ack.imag > z_ack.real).to(torch.int8),
                                       (z_ack.imag < -z_ack.real).to(torch.int8)], dim=-1)
    return out


# --- format 3 (block-spread DFT-S-OFDM, §5.4.2A) -------------------------------

def encode_format3(cfg: PucchConfig, ack_bits: torch.Tensor) -> torch.Tensor:
    """Format 3: (B, O≤11) ACK(+SR) bits → TX grid, on the bits' device.

    (32, O) block code cyclically extended to 48 bits, scrambled, QPSK, then
    per slot: cover w(n_oc), cell cyclic rotation + quadrant phase, DFT-12
    precoding (`pucch.c encode_signal_format3`).
    """
    dev = ack_bits.device
    tab = _layout(cfg, "3", dev)
    coded32 = block_code.encode(ack_bits, 32)
    coded = torch.cat([coded32, coded32[:, :16]], dim=-1)  # 48 bits
    scr = torch.as_tensor(_f2_scramble(cfg, PUCCH3_NOF_BITS).astype(np.int8), device=dev)
    d = modem.modulate("qpsk", coded ^ scr).reshape(-1, 2, NRE)  # (B, slot, 12)
    b = d.shape[0]
    rot = tab["rot"]  # (2, 5, 12)
    y = tab["cover"][:, :, None] * torch.gather(
        d[:, :, None, :].expand(b, 2, 5, NRE), -1, rot.expand(b, 2, 5, NRE))
    g = _empty_grid(cfg, b, dev)
    ks = tab["ks"][:, None, :]
    g[:, tab["data_syms"][:, :, None], ks] = (torch.fft.fft(y, dim=-1)
                                              / math.sqrt(NRE)).to(torch.complex64)
    g[:, tab["dmrs_syms"][:, :, None], ks] = tab["dmrs"]
    return g


def decode_format3(cfg: PucchConfig, rx_grid: torch.Tensor, nof_bits: int) -> dict:
    """Format 3 decode: despread + IDFT + ML block decode → (B, O) bits."""
    dev = rx_grid.device
    tab = _layout(cfg, "3", dev)
    b = rx_grid.shape[0]
    h = torch.sum(torch.mean(_gather(rx_grid, tab["dmrs_syms"], tab["ks"]) * tab["dmrs"].conj(),
                             dim=-1), dim=-1) / len(F3_DMRS_SYMS)  # (B, 2)
    y = torch.fft.ifft(_gather(rx_grid, tab["data_syms"], tab["ks"]), dim=-1) * math.sqrt(NRE)
    y = torch.gather(y, -1, tab["inv_rot"].expand(b, 2, 5, NRE))
    acc = torch.sum(tab["cover"].conj()[:, :, None] * y, dim=2)  # (B, 2, 12)
    eq = acc / 5 * h.conj()[..., None] / torch.clamp(h.abs() ** 2, min=1e-9)[..., None]
    llr = modem.demodulate_soft("qpsk", eq.reshape(b, 2 * NRE), 0.1)
    scr = torch.as_tensor(_f2_scramble(cfg, PUCCH3_NOF_BITS).astype(np.float32), device=dev)
    llr = llr * (1.0 - 2.0 * scr)
    # fold the cyclic extension back onto the 32 base positions
    llr32 = torch.cat([llr[:, :16] + llr[:, 32:], llr[:, 16:32]], dim=-1)
    bits, metric = block_code.decode(llr32, 32, nof_bits)
    return dict(bits=bits, metric=metric)
