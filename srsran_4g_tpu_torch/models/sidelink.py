"""LTE sidelink: PSSS/SSSS sync, PSBCH, SCI formats 0 and 1, the TM1/2 and
TM3/4 PSCCH/PSSCH (TS 36.211 §9).

Port counterpart of ``srsran_4g_tpu/models/sidelink.py`` (the reference's
`lib/src/phy/sync/psss.c`, `ssss.c`, `lib/src/phy/phch/psbch.c`, `pscch.c`,
`pssch.c`, `sci.c`, `mib_sl.c` and `ch_estimation/chest_sl.c`): sidelink PSS
on ZC roots {26, 37}, the SSSS from the SSS m-sequences keyed by N_SL_ID, the
PSBCH carrying the MIB-SL (40 bits) or MIB-SL-V2X (48 bits) + CRC16, TBCC,
QPSK on the centre 6 PRB, SCI format 0 on a 1-PRB PSCCH (TM1/2) and format 1
on a 2-PRB PSCCH (TM3/4), and the turbo-coded PSSCH at the SCI's allocation.
The PSSCH decode runs ``sch.dlsch_decode``, so the turbo kernels.

Where the port differs in form (the bits are the same):
- ``sl_subframe_grid``, ``sl_subframe_grid_ext`` and ``sl_demodulate`` gather
  every symbol body of the subframe (or of a batch of subframes) with one
  index tensor and run one batched ``torch.fft`` on the device; JAX runs a
  numpy FFT a symbol on the host, in float64.
- ``slss_find`` correlates on the device in complex64 (JAX: numpy, float64);
  ``psbch_sync_decode`` demodulates every fine-timing hypothesis in one
  gather and one FFT.
- The equalisers gather the allocation's subcarriers of all symbols at
  once; the TM3/4 time interpolation keeps JAX's float32 weights and its
  ``(1 - w)·h_j + w·h_j+1`` form.
- Sequences, DMRS, interleaver permutations and scrambling signs are numpy
  tables built once and cached on the device; the Gold bits are cast to
  float before ``1 - 2c`` (numpy's uint8 would wrap).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.models import ra, sch
from srsran_4g_tpu_torch.models.pdsch import _on_device
from srsran_4g_tpu_torch.models.pusch import transform_deprecode, transform_precode
from srsran_4g_tpu_torch.models.refsignal_ul import base_sequence
from srsran_4g_tpu_torch.ops import convcode, crc as crc_ops, modem, rate_match, sequence
from srsran_4g_tpu_torch.ops.scrambling import scramble_bits
from ..stack.asn1 import BitReader, BitWriter

MIB_SL_LEN = 40
MIB_SL_V2X_LEN = 48   # TM3/4 SL-BCH TB (MasterInformationBlock-SL-V2X-r14)
_PSBCH_RE = 288  # 6 PRB x 4 symbols


def _t(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


@functools.lru_cache(maxsize=256)
def _sign_t(c_init: int, n: int, device: torch.device) -> torch.Tensor:
    """1 - 2c of the Gold sequence, float32 on the device."""
    return _t(1.0 - 2.0 * sequence.gold_sequence_np(c_init, n).astype(np.float32), device)


@functools.lru_cache(maxsize=256)
def _gold_t(c_init: int, n: int, device: torch.device) -> torch.Tensor:
    return _t(sequence.gold_sequence_np(c_init, n).astype(np.int8), device)


@functools.lru_cache(maxsize=4)
def psss_sequence(root: int) -> np.ndarray:
    """Length-62 ZC (same structure as PSS but roots 26/37)."""
    n = np.arange(31)
    a = np.exp(-1j * np.pi * root * n * (n + 1) / 63)
    b = np.exp(-1j * np.pi * root * (n + 31) * (n + 32) / 63)
    return np.concatenate([a, b]).astype(np.complex64)


def psss_for_id(n_sl_id: int) -> np.ndarray:
    return psss_sequence(26 if n_sl_id < 168 else 37)


@functools.lru_cache(maxsize=8)
def _psss_mats(device: torch.device) -> torch.Tensor:
    return _t(np.stack([psss_sequence(26), psss_sequence(37)]), device)


def _best(corr: torch.Tensor, rx_62: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    energy = (rx_62.abs() ** 2).sum(dim=-1, keepdim=True) * n
    m = corr / (energy + 1e-9)
    return m.argmax(dim=-1), m.amax(dim=-1)


def psss_detect(rx_62: torch.Tensor) -> dict:
    """(B, 62) centre REs -> which root (in-coverage vs out-of-coverage)."""
    corr = (rx_62.to(torch.complex64) @ _psss_mats(rx_62.device).conj().T).abs() ** 2
    idx, metric = _best(corr, rx_62, 62)
    return dict(root_idx=idx, metric=metric)


@functools.lru_cache(maxsize=512)
def ssss_sequence(n_sl_id: int) -> np.ndarray:
    """62-length SSSS built from the SSS m-sequences keyed by N_SL_ID
    (36.211 9.7.2 reuses the 36.211 6.11.2 structure)."""
    id1, id2 = n_sl_id % 168, n_sl_id // 168

    def mseq(taps):
        x = np.zeros(36, np.int64)
        x[4] = 1
        for i in range(26):
            x[i + 5] = sum(x[i + t] for t in taps) % 2
        return 1 - 2 * x[:31]

    s = mseq((0, 2))
    c = mseq((0, 3))
    z = mseq((0, 1, 2, 4))
    m0 = id1 % 31
    m1 = (m0 + id1 // 31 + 1) % 31
    n = np.arange(31)
    d_even = s[(n + m0) % 31] * c[(n + id2) % 31]
    d_odd = s[(n + m1) % 31] * c[(n + id2 + 3) % 31] * z[(n + m0 % 8) % 31]
    out = np.empty(62, np.float32)
    out[0::2] = d_even
    out[1::2] = d_odd
    return out.astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _ssss_mat(n_ids: int, device: torch.device) -> torch.Tensor:
    return _t(np.stack([ssss_sequence(i) for i in range(n_ids)]), device)


def ssss_detect(rx_62: torch.Tensor, n_ids: int = 336) -> dict:
    corr = (rx_62.to(torch.complex64) @ _ssss_mat(n_ids, rx_62.device).conj().T).abs() ** 2
    idx, metric = _best(corr, rx_62, 62)
    return dict(n_sl_id=idx, metric=metric)


# --------------------------------------------------------------------------
# PSBCH: MIB-SL (40 bits) + CRC16 + TBCC + QPSK over centre 6 PRB


@dataclass
class MibSl:
    """mib_sl.c fields (36.331 SL-BCH payload)."""
    sl_bandwidth: int = 100      # PRBs
    tdd_config: int = 0
    direct_frame_number: int = 0  # 10 bits
    direct_subframe_number: int = 0  # 4 bits
    in_coverage: bool = True

    _BW = [6, 15, 25, 50, 75, 100]

    def pack(self, v2x: bool = False) -> np.ndarray:
        """40-bit MIB-SL (TM1/2) or, with v2x=True, the 48-bit
        MasterInformationBlock-SL-V2X-r14 (TM3/4)."""
        w = BitWriter()
        w.put(self._BW.index(self.sl_bandwidth), 3)
        w.put(self.tdd_config, 3)
        w.put(self.direct_frame_number, 10)
        w.put(self.direct_subframe_number, 4)
        w.put_bool(self.in_coverage)
        w.put(0, 27 if v2x else 19)  # reserved
        bits = np.asarray(w.bits, np.int8)
        assert len(bits) == (MIB_SL_V2X_LEN if v2x else MIB_SL_LEN)
        return bits

    @classmethod
    def unpack(cls, bits: np.ndarray) -> "MibSl":
        r = BitReader(np.packbits(np.asarray(bits, np.uint8)).tobytes())
        return cls(sl_bandwidth=cls._BW[r.get(3)], tdd_config=r.get(3),
                   direct_frame_number=r.get(10),
                   direct_subframe_number=r.get(4),
                   in_coverage=r.get_bool())


def _crc_tbcc(bits: torch.Tensor, e: int) -> torch.Tensor:
    """bits + CRC16 → tail-biting conv code → rate match to e bits."""
    bits = bits.to(torch.int8)
    cw = convcode.conv_encode(torch.cat([bits, crc_ops.crc_compute(bits, "16")], dim=-1))
    return rate_match.conv_rate_match(cw, e)


def psbch_encode(n_sl_id: int, mib_bits, device: torch.device | str | None = None
                 ) -> torch.Tensor:
    """(B, 40) -> (B, 288) QPSK symbol block for the PSBCH REs.  A tensor
    keeps its device; other input goes to ``device`` (default CUDA)."""
    bits = _on_device(mib_bits, device)
    e = _crc_tbcc(bits, 2 * _PSBCH_RE)
    return modem.modulate("qpsk", scramble_bits(e, _gold_t(n_sl_id, 2 * _PSBCH_RE, bits.device)))


def _viterbi_crc(llr: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, E) LLRs → conv de-rate-match → Viterbi → (bits (B, n), CRC16 ok)."""
    bits = convcode.viterbi_decode(rate_match.conv_rate_dematch(llr, n))
    return bits, crc_ops.crc_check(bits, "16")


def psbch_decode(n_sl_id: int, syms: torch.Tensor, noise_var=0.01) -> dict:
    b = syms.shape[0]
    llr = modem.demodulate_soft("qpsk", syms, noise_var).reshape(b, 2 * _PSBCH_RE)
    llr = llr * _sign_t(n_sl_id, 2 * _PSBCH_RE, syms.device)
    bits, ok = _viterbi_crc(llr, MIB_SL_LEN + 16)
    return dict(mib=bits[..., :MIB_SL_LEN], crc_ok=ok)


# --------------------------------------------------------------------------
# SCI format 0 (sci.c): PSCCH scheduling grant


def _riv_bits(n: int) -> int:
    return math.ceil(math.log2(n * (n + 1) / 2))


@dataclass
class SciFormat0:
    freq_hopping: bool = False
    riv: int = 0            # resource block assignment
    trp: int = 0            # time resource pattern (7 bits)
    mcs: int = 0            # 5 bits
    timing_advance: int = 0  # 11 bits
    group_dst_id: int = 0   # 8 bits

    def pack(self, nof_prb: int = 100) -> np.ndarray:
        w = BitWriter()
        w.put_bool(self.freq_hopping)
        w.put(self.riv, _riv_bits(nof_prb))
        w.put(self.trp, 7)
        w.put(self.mcs, 5)
        w.put(self.timing_advance, 11)
        w.put(self.group_dst_id, 8)
        return np.asarray(w.bits, np.int8)

    @classmethod
    def unpack(cls, bits: np.ndarray, nof_prb: int = 100) -> "SciFormat0":
        r = BitReader(np.packbits(np.asarray(bits, np.uint8)).tobytes())
        return cls(freq_hopping=r.get_bool(), riv=r.get(_riv_bits(nof_prb)),
                   trp=r.get(7), mcs=r.get(5), timing_advance=r.get(11),
                   group_dst_id=r.get(8))


# --------------------------------------------------------------------------
# PSCCH / PSSCH data channels, sidelink TM1/2 normal CP (36.211 §9.3-9.4):
# DMRS on l = {3, 10}; the 12 other symbols carry data, the last one (l = 13)
# a guard, mapped in the coded stream but blanked at TX and fed zero LLRs at
# RX.  Both channels are SC-FDMA with the PUSCH time-first interleaver.

SL_DMRS_SYMS = (3, 10)
SL_DATA_SYMS = tuple(l for l in range(14) if l not in SL_DMRS_SYMS)
PSCCH_SCRAMBLING_SEED = 510  # 36.211 §9.4.1
SCI_CRC_LEN = 16


def _sl_interleave_perm(e: int, qm: int) -> np.ndarray:
    """PUSCH-style time-first interleaver over the 12 data symbols
    (`srsran_sl_ulsch_interleave`)."""
    c_mux = len(SL_DATA_SYMS)
    r = e // (c_mux * qm)
    return np.arange(e).reshape(r, c_mux, qm).transpose(1, 0, 2).reshape(-1)


def _sl34_interleave_perm(e: int, qm: int) -> np.ndarray:
    """PUSCH-style time-first interleaver over the 10 TM3/4 data symbols."""
    c_mux = len(SL34_DATA_SYMS)
    r = e // (c_mux * qm)
    return np.arange(e).reshape(r, c_mux, qm).transpose(1, 0, 2).reshape(-1)


@functools.lru_cache(maxsize=64)
def _perms_t(e: int, qm: int, tm34: bool, device: torch.device
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm, its inverse) of the time-first interleaver on the device."""
    perm = (_sl34_interleave_perm if tm34 else _sl_interleave_perm)(e, qm)
    inv = np.empty(e, np.int64)
    inv[perm] = np.arange(e)
    return _t(perm, device), _t(inv, device)


def _sl_dmrs(u: int, m_sc: int) -> np.ndarray:
    """(2, m_sc) PSCCH TM1/2 DMRS: u fixed, no cyclic shift, w = [1, 1]
    (chest_sl_pscch_gen, chest_sl.c:306-336)."""
    r = base_sequence(u, 0, m_sc).astype(np.complex64)
    return np.stack([r, r])


def _pssch12_dmrs(n_x_id: int, nof_prb: int) -> np.ndarray:
    """(2, 12·nof_prb) PSSCH TM1/2 DMRS (chest_sl_pssch_gen,
    chest_sl.c:462-544): n_cs = (N_x/2)%8, group hopping
    u[ns] = (f_gh[ns] + N_x%30) % 30 over the first two pattern slots,
    w = [1, ±1] by N_x parity."""
    m_sc = nof_prb * 12
    alpha = 2.0 * np.pi * ((n_x_id // 2) % 8) / 12.0
    rot = np.exp(1j * alpha * np.arange(m_sc))
    f_ss = n_x_id % 30
    f_gh = _sl34_group_hop(n_x_id)
    w1 = -1.0 if n_x_id % 2 else 1.0
    rows = [base_sequence(int((f_gh[ns] + f_ss) % 30), 0, m_sc) * rot
            * (w1 ** ns) for ns in range(2)]
    return np.stack(rows).astype(np.complex64)


def _sl_map(tx_syms: torch.Tensor, dmrs: np.ndarray, nre_total: int, prb_start: int,
            nof_prb: int, data_syms=SL_DATA_SYMS, dmrs_syms=SL_DMRS_SYMS) -> torch.Tensor:
    """(B, D, m_sc) data + DMRS → (B, 14, nre_total) grid slice; the last
    data symbol is blanked."""
    dev = tx_syms.device
    m_sc = nof_prb * 12
    grid = torch.zeros((tx_syms.shape[0], 14, nre_total), dtype=torch.complex64, device=dev)
    ks = torch.arange(prb_start * 12, prb_start * 12 + m_sc, device=dev)
    ls = torch.as_tensor(data_syms[:-1], device=dev)
    grid[:, ls[:, None], ks] = tx_syms[:, :-1].to(torch.complex64)
    grid[:, torch.as_tensor(dmrs_syms, device=dev)[:, None], ks] = _t(dmrs, dev)
    return grid


def _sl_equalize(rx_grid: torch.Tensor, dmrs: np.ndarray, prb_start: int, nof_prb: int,
                 noise_var: float) -> torch.Tensor:
    """LS estimate from the two DMRS symbols + MMSE → (B, 12, m_sc)
    equalized data symbols (last one zeroed)."""
    m_sc = nof_prb * 12
    g = rx_grid[..., prb_start * 12:prb_start * 12 + m_sc]
    d = _t(dmrs, rx_grid.device).conj()
    h = (g[:, SL_DMRS_SYMS[0]] * d[0] + g[:, SL_DMRS_SYMS[1]] * d[1]) / 2
    y = g[:, list(SL_DATA_SYMS[:-1])]
    eq = y * h.conj()[:, None] / (h.abs() ** 2 + noise_var)[:, None]
    return torch.cat([eq, torch.zeros_like(eq[:, :1])], dim=1)


@dataclass(frozen=True)
class PscchConfig:
    nof_prb_cell: int = 50   # SL carrier bandwidth (grid width)
    nof_prb_sl: int = 100    # bandwidth signalled inside SCI (RIV size)
    prb_start: int = 0
    nof_prb: int = 1         # TM1/2: PSCCH is one PRB

    @property
    def sci_len(self) -> int:
        return 1 + _riv_bits(self.nof_prb_sl) + 7 + 5 + 11 + 8

    @property
    def e_bits(self) -> int:
        return len(SL_DATA_SYMS) * 12 * self.nof_prb * 2  # QPSK


def pscch_encode(cfg: PscchConfig, sci_bits, device: torch.device | str | None = None
                 ) -> torch.Tensor:
    """(B, sci_len) SCI bits → (B, 14, nre) grid slice (`pscch.c:199`).  A
    tensor keeps its device; other input goes to ``device`` (default CUDA)."""
    bits = _on_device(sci_bits, device)
    dev = bits.device
    perm, _ = _perms_t(cfg.e_bits, 2, False, dev)
    e = _crc_tbcc(bits, cfg.e_bits)[..., perm]
    syms = modem.modulate("qpsk", scramble_bits(e, _gold_t(PSCCH_SCRAMBLING_SEED, cfg.e_bits,
                                                           dev)))
    syms = transform_precode(syms.reshape(bits.shape[0], len(SL_DATA_SYMS), 12 * cfg.nof_prb))
    return _sl_map(syms, _sl_dmrs(0, 12 * cfg.nof_prb), cfg.nof_prb_cell * 12,
                   cfg.prb_start, cfg.nof_prb)


def _crc_value(bits: torch.Tensor) -> torch.Tensor:
    """Decimal value of the trailing 16 CRC bits (36.211 §9.3.1 n_X_ID)."""
    w = 1 << torch.arange(SCI_CRC_LEN - 1, -1, -1, device=bits.device)
    return (bits[..., -SCI_CRC_LEN:].to(torch.int64) * w).sum(dim=-1)


def _sc_fdma_llrs(eq: torch.Tensor, mod: str, noise_var: float, guard: int) -> torch.Tensor:
    """Equalised (B, D, m_sc) → IDFT → soft demod, the last ``guard`` LLRs
    (the blanked symbol) set to 0."""
    syms = transform_deprecode(eq).reshape(eq.shape[0], -1)
    llr = modem.demodulate_soft(mod, syms, noise_var)
    llr[:, -guard:] = 0.0
    return llr


def pscch_decode(cfg: PscchConfig, rx_grid: torch.Tensor, noise_var: float = 1e-2) -> dict:
    """→ dict(bits (B, sci_len), crc_ok (B,), n_x_id (B,))."""
    dev = rx_grid.device
    eq = _sl_equalize(rx_grid, _sl_dmrs(0, 12 * cfg.nof_prb), cfg.prb_start, cfg.nof_prb,
                      noise_var)
    llr = _sc_fdma_llrs(eq, "qpsk", noise_var, 24 * cfg.nof_prb)
    llr = llr * _sign_t(PSCCH_SCRAMBLING_SEED, cfg.e_bits, dev)
    llr = llr[..., _perms_t(cfg.e_bits, 2, False, dev)[1]]
    bits, ok = _viterbi_crc(llr, cfg.sci_len + SCI_CRC_LEN)
    return dict(bits=bits[..., :cfg.sci_len], crc_ok=ok, n_x_id=_crc_value(bits))


def sci0_n_x_id(sci_bits: np.ndarray) -> int:
    """TX-side n_X_ID: decimal value of the SCI CRC bits."""
    crc = crc_ops.crc_compute(torch.as_tensor(np.asarray(sci_bits), dtype=torch.int8)[None],
                              "16")[0].numpy()
    return int(sum(int(b) << (SCI_CRC_LEN - 1 - i) for i, b in enumerate(crc)))


@dataclass(frozen=True)
class PsschConfig:
    tbs: int
    nof_prb_cell: int = 50
    prb_start: int = 1
    nof_prb: int = 4
    mod: str = "qpsk"
    n_x_id: int = 0
    sf_idx: int = 0
    rv: int = 0

    @property
    def qm(self) -> int:
        return {"qpsk": 2, "16qam": 4}[self.mod]

    @property
    def g_bits(self) -> int:
        return len(SL_DATA_SYMS) * 12 * self.nof_prb * self.qm

    @property
    def plan(self):
        return sch.dlsch_plan(self.tbs, self.g_bits, self.qm, self.rv)

    @property
    def scramble_seq(self) -> np.ndarray:
        # pssch.c:352: c_init = n_X_ID * 2^14 + (sf_idx % 10) * 2^9 + 510
        return sequence.gold_sequence_np(self.cinit, self.g_bits)

    @property
    def cinit(self) -> int:
        return self.n_x_id * 16384 + (self.sf_idx % 10) * 512 + 510


def pssch_encode(cfg: PsschConfig, tb_bits, device: torch.device | str | None = None
                 ) -> torch.Tensor:
    """(B, tbs) SL-SCH transport block → (B, 14, nre) grid slice."""
    bits = _on_device(tb_bits, device)
    dev = bits.device
    cw = sch.dlsch_encode(cfg.plan, bits)[..., _perms_t(cfg.g_bits, cfg.qm, False, dev)[0]]
    syms = modem.modulate(cfg.mod, scramble_bits(cw, _gold_t(cfg.cinit, cfg.g_bits, dev)))
    syms = transform_precode(syms.reshape(bits.shape[0], len(SL_DATA_SYMS), 12 * cfg.nof_prb))
    return _sl_map(syms, _pssch12_dmrs(cfg.n_x_id, cfg.nof_prb), cfg.nof_prb_cell * 12,
                   cfg.prb_start, cfg.nof_prb)


def pssch_decode(cfg: PsschConfig, rx_grid: torch.Tensor, noise_var: float = 1e-2,
                 n_iter: int = 5) -> dict:
    """→ dict(bits (B, tbs), crc_ok (B,))."""
    dev = rx_grid.device
    eq = _sl_equalize(rx_grid, _pssch12_dmrs(cfg.n_x_id, cfg.nof_prb), cfg.prb_start,
                      cfg.nof_prb, noise_var)
    llr = _sc_fdma_llrs(eq, cfg.mod, noise_var, 12 * cfg.nof_prb * cfg.qm)
    llr = llr * _sign_t(cfg.cinit, cfg.g_bits, dev)
    llr = llr[..., _perms_t(cfg.g_bits, cfg.qm, False, dev)[1]]
    bits, ok, _ = sch.dlsch_decode(cfg.plan, llr, n_iter=n_iter)
    return dict(bits=bits, crc_ok=ok)


# --------------------------------------------------------------------------
# PSBCH spec-exact subframe chain (psbch.c + chest_sl.c psbch path)

PSBCH_DATA_SYMS_TM12 = (0, 4, 5, 6, 7, 8, 9)   # transmitted data symbols
PSBCH_DMRS_SYMS_TM12 = (3, 10)
PSBCH_NOF_PRB = 6
_PSBCH_NSYM = 8           # 8 coded symbols; the 8th is never transmitted

# (data_syms, dmrs_syms, nof_coded_syms) per (tm group, ext_cp) — the
# srsran_psbch_symbol_map_* tables of phy_common_sl.c:125-162.
_PSBCH_LAYOUT = {
    (12, False): (PSBCH_DATA_SYMS_TM12, PSBCH_DMRS_SYMS_TM12, 8),
    (12, True): ((3, 4, 5, 6, 7), (2, 8), 6),
    (34, False): ((0, 3, 5, 7, 8, 10), (4, 6, 9), 7),
}


def _psbch_dmrs(n_sl_id: int, n_dmrs: int = 2) -> np.ndarray:
    """(n_dmrs, 72) PSBCH DMRS (chest_sl.c:95-152: u=(N/16)%30, alpha
    from (N/2)%8, w[j] = ±1^j by N parity)."""
    m_sc = PSBCH_NOF_PRB * 12
    u = (n_sl_id // 16) % 30
    alpha = 2.0 * np.pi * ((n_sl_id // 2) % 8) / 12.0
    r = base_sequence(u, 0, m_sc) * np.exp(1j * alpha * np.arange(m_sc))
    w1 = -1.0 if n_sl_id % 2 else 1.0
    return np.stack([(w1 ** (j % 2)) * r
                     for j in range(n_dmrs)]).astype(np.complex64)


def _psbch_perm(e: int, nsym: int = _PSBCH_NSYM) -> np.ndarray:
    """sl_ulsch_interleave over the PSBCH coded symbols (Qm=2)."""
    r = e // (nsym * 2)
    return np.arange(e).reshape(r, nsym, 2).transpose(1, 0, 2).reshape(-1)


@functools.lru_cache(maxsize=32)
def _psbch_tables(n_sl_id: int, tm12: bool, ext_cp: bool, device: torch.device) -> dict:
    data_syms, dmrs_syms, ncoded = _PSBCH_LAYOUT[(12 if tm12 else 34, ext_cp)]
    e = ncoded * PSBCH_NOF_PRB * 12 * 2
    perm = _psbch_perm(e, ncoded)
    return dict(e=e, ncoded=ncoded, data=_t(np.asarray(data_syms), device),
                dmrs_l=_t(np.asarray(dmrs_syms), device),
                dmrs=_t(_psbch_dmrs(n_sl_id, len(dmrs_syms)), device),
                perm=_t(perm, device), inv=_t(np.argsort(perm), device),
                gold=_gold_t(n_sl_id, e, device), sign=_sign_t(n_sl_id, e, device))


def psbch_tx_subframe(n_sl_id: int, nof_prb: int, mib_bits, tm: int = 2,
                      ext_cp: bool = False, device: torch.device | str | None = None
                      ) -> torch.Tensor:
    """MIB-SL bits → (B, nsym, nof_prb·12) PSBCH subframe grid (nsym = 12
    for TM1/2 extended CP, else 14).  TM1/2 carry the 40-bit MIB-SL; TM3/4
    the 48-bit MIB-SL-V2X (pack with v2x=True)."""
    bits = _on_device(mib_bits, device)
    dev = bits.device
    tab = _psbch_tables(n_sl_id, tm <= 2, ext_cp, dev)
    m_sc = PSBCH_NOF_PRB * 12
    coded = _crc_tbcc(bits, tab["e"])[..., tab["perm"]]
    syms = modem.modulate("qpsk", scramble_bits(coded, tab["gold"]))
    syms = torch.fft.fft(syms.reshape(-1, tab["ncoded"], m_sc), dim=-1) / math.sqrt(m_sc)
    nre = nof_prb * 12
    k0 = nre // 2 - 36
    ks = torch.arange(k0, k0 + m_sc, device=dev)
    grid = torch.zeros((syms.shape[0], 12 if ext_cp else 14, nre), dtype=torch.complex64,
                       device=dev)
    n_data = tab["data"].shape[0]
    grid[:, tab["data"][:, None], ks] = syms[:, :n_data].to(torch.complex64)
    grid[:, tab["dmrs_l"][:, None], ks] = tab["dmrs"]
    return grid


def psbch_rx_subframe(n_sl_id: int, nof_prb: int, rx_grid: torch.Tensor,
                      noise_var: float = 1e-2, tm: int = 2, ext_cp: bool = False) -> dict:
    """PSBCH receive from a subframe grid (B, nsym, nof_prb·12): DMRS LS
    chest/equalize → IDFT precoding → QPSK LLR → descramble → deinterleave
    → conv rate dematch → Viterbi → CRC16.

    Returns dict(mib (B, 40 or 48), crc_ok (B,))."""
    tab = _psbch_tables(n_sl_id, tm <= 2, ext_cp, rx_grid.device)
    m_sc = PSBCH_NOF_PRB * 12
    k0 = nof_prb * 12 // 2 - 36
    g = rx_grid[..., k0:k0 + m_sc]
    h = (g[:, tab["dmrs_l"]] * tab["dmrs"].conj()).sum(dim=1) / tab["dmrs"].shape[0]
    x = g[:, tab["data"]] * h.conj()[:, None] / (h.abs() ** 2 + noise_var)[:, None]
    d = torch.fft.ifft(x, dim=-1) * math.sqrt(m_sc)    # IDFT precoding
    b = d.shape[0]
    llr = modem.demodulate_soft("qpsk", d.reshape(b, -1).to(torch.complex64), noise_var)
    # the never-transmitted last coded symbol gets zero LLRs
    llr = torch.cat([llr, llr.new_zeros((b, 2 * m_sc))], dim=-1)
    llr = (llr * tab["sign"])[..., tab["inv"]]
    tb_len = MIB_SL_V2X_LEN if tm >= 3 else MIB_SL_LEN
    bits, ok = _viterbi_crc(llr, tb_len + 16)
    return dict(mib=bits[..., :tb_len], crc_ok=ok)


@functools.lru_cache(maxsize=16)
def _local_t(n: int, device: torch.device) -> torch.Tensor:
    """The receive half-subcarrier de-rotation with a local phase origin at
    each symbol's body."""
    return _t(np.exp(-1j * np.pi * np.arange(n) / n).astype(np.complex64), device)


@functools.lru_cache(maxsize=32)
def _body_index(symbol_sz: int, ext_cp: bool, device: torch.device) -> torch.Tensor:
    """(nsym, symbol_sz) sample index of every symbol body of a subframe."""
    starts, pos = [], 0
    for l in range(12 if ext_cp else 14):
        if ext_cp:
            pos += symbol_sz // 4
        else:
            pos += symbol_sz * (160 if l in (0, 7) else 144) // 2048
        starts.append(pos)
        pos += symbol_sz
    return _t(np.asarray(starts)[:, None] + np.arange(symbol_sz)[None, :], device)


def _grid_from_bodies(x: torch.Tensor, nre: int, n: int) -> torch.Tensor:
    """(..., nsym, n) de-rotated bodies → FFT → (..., nsym, nre)."""
    X = torch.fft.fft(x, dim=-1) / math.sqrt(n)
    return torch.cat([X[..., -(nre // 2):], X[..., :nre // 2]], dim=-1).to(torch.complex64)


def sl_demodulate(samples: torch.Tensor, nof_prb: int) -> torch.Tensor:
    """Sidelink OFDM demodulation of one subframe (B, sf_len) → grid
    (B, 14, nre).

    36.211 SC-FDMA defines the baseband with a +7.5 kHz half-subcarrier
    offset whose phase restarts at each symbol's body, so the receive shift
    is applied per symbol with a LOCAL phase origin."""
    from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig, _symbol_offsets

    cfg = OfdmConfig(nof_prb=nof_prb)
    n = cfg.symbol_sz
    dev = samples.device
    idx = _t(_symbol_offsets(cfg)[:, None] + np.arange(n)[None, :], dev)
    return _grid_from_bodies(samples[..., idx] * _local_t(n, dev), cfg.nre, n)


def sl_subframe_grid(samples: torch.Tensor, nof_prb: int, symbol_sz: int) -> torch.Tensor:
    """Sidelink subframes → grids with the per-symbol half-subcarrier
    de-rotation (as sl_demodulate, with an explicit FFT size for the
    reference's non-standard sample rates, e.g. 768 at 50 PRB / 11.52 Msps).

    samples: (L,) one subframe → (1, 14, nof_prb·12), as JAX; or (B, L), a
    batch of subframes → (B, 14, nof_prb·12), in one gather and one FFT."""
    x = samples if samples.dim() > 1 else samples[None]
    dev = x.device
    bodies = x[..., _body_index(symbol_sz, False, dev)] * _local_t(symbol_sz, dev)
    return _grid_from_bodies(bodies, nof_prb * 12, symbol_sz)


def sl_subframe_grid_ext(samples: torch.Tensor, nof_prb: int, symbol_sz: int
                         ) -> torch.Tensor:
    """Extended-CP sidelink subframe → (1, 12, nof_prb·12): 12 symbols with
    CP = symbol_sz/4 (36.211 Table 9.1-1), same de-rotation."""
    x = samples if samples.dim() > 1 else samples[None]
    dev = x.device
    bodies = x[..., _body_index(symbol_sz, True, dev)] * _local_t(symbol_sz, dev)
    return _grid_from_bodies(bodies, nof_prb * 12, symbol_sz)


# --------------------------------------------------------------------------
# Sidelink TM3/TM4 (V2X): SCI format 1 on a 2-PRB PSCCH + PSSCH in
# subchannels (36.211 §9.3-9.8, 36.212 §5.4.3.1.2, 36.213 §14.1): 4 DMRS
# symbols at l = {2,5,8,11} (data on the other 10, l = 13 a blanked guard),
# PSCCH DMRS with a TX-chosen cyclic shift from {0,3,6,9} on base group
# u = 8, PSSCH DMRS/scrambling keyed by N_x_ID = the decimal PSCCH CRC.

SL34_DMRS_SYMS = (2, 5, 8, 11)
SL34_DATA_SYMS = (0, 1, 3, 4, 6, 7, 9, 10, 12, 13)  # 13: guard, not tx'd
PSCCH34_NOF_PRB = 2
SCI1_LEN = 32  # SRSRAN_SCI_TM34_LEN


@dataclass
class SciFormat1:
    """SCI format 1 (36.212 §5.4.3.1.2), fixed 32-bit payload."""
    priority: int = 0          # 3 bits
    resource_reserv: int = 0   # 4 bits
    riv: int = 0               # over num_sub_channel
    time_gap: int = 0          # 4 bits
    mcs: int = 0               # 5 bits
    retransmission: int = 0    # 1 bit
    transmission_format: int = 0  # 1 bit

    @staticmethod
    def riv_bits(num_sub_channel: int) -> int:
        return _riv_bits(num_sub_channel)

    def pack(self, num_sub_channel: int) -> np.ndarray:
        w = BitWriter()
        w.put(self.priority, 3)
        w.put(self.resource_reserv, 4)
        w.put(self.riv, self.riv_bits(num_sub_channel))
        w.put(self.time_gap, 4)
        w.put(self.mcs, 5)
        w.put(self.retransmission, 1)
        w.put(self.transmission_format, 1)
        bits = np.zeros(SCI1_LEN, np.int8)
        bits[:len(w.bits)] = w.bits
        return bits

    @classmethod
    def unpack(cls, bits: np.ndarray, num_sub_channel: int) -> "SciFormat1":
        r = BitReader(np.packbits(np.asarray(bits, np.uint8)).tobytes())
        return cls(priority=r.get(3), resource_reserv=r.get(4),
                   riv=r.get(cls.riv_bits(num_sub_channel)),
                   time_gap=r.get(4), mcs=r.get(5),
                   retransmission=r.get(1), transmission_format=r.get(1))


def _pscch34_dmrs(cyclic_shift: int) -> np.ndarray:
    """(24,) PSCCH TM3/4 DMRS: u = 8, α = 2π·n_cs/12, w = +1
    (chest_sl_pscch_gen, chest_sl.c:273)."""
    m_sc = PSCCH34_NOF_PRB * 12
    alpha = 2.0 * np.pi * cyclic_shift / 12.0
    r = base_sequence(8, 0, m_sc) * np.exp(1j * alpha * np.arange(m_sc))
    return r.astype(np.complex64)


def _sl34_group_hop(n_x_id: int) -> np.ndarray:
    """f_gh(i) for i in 0..39 (36.211 §10.1.4.1.3, c_init = N_x/30)."""
    c = sequence.gold_sequence_np(n_x_id // 30, 8 * 40).astype(np.int64)
    return (c.reshape(40, 8) << np.arange(8)).sum(-1)


def _pssch34_dmrs(n_x_id: int, sf_idx: int, nof_prb: int) -> np.ndarray:
    """(4, 12·nof_prb) PSSCH TM3/4 DMRS: n_cs = (N_x/2)%8,
    f_ss = (N_x/16)%30, f_gh indexed 4·(sf%10)+ns, w by N_x parity
    (chest_sl_pssch_gen, chest_sl.c:460)."""
    m_sc = nof_prb * 12
    alpha = 2.0 * np.pi * ((n_x_id // 2) % 8) / 12.0
    f_ss = (n_x_id // 16) % 30
    f_gh = _sl34_group_hop(n_x_id)
    rot = np.exp(1j * alpha * np.arange(m_sc))
    w1 = -1.0 if n_x_id % 2 else 1.0
    rows = []
    for ns in range(4):
        u = int((f_gh[4 * (sf_idx % 10) + ns] + f_ss) % 30)
        rows.append((w1 ** ns) * base_sequence(u, 0, m_sc) * rot)
    return np.stack(rows).astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _time_interp(dmrs_syms: tuple[int, ...], data_syms: tuple[int, ...]
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(j0, j1, w) of the linear time interpolation between DMRS symbols for
    each data symbol but the guard: h = (1 - w)·h_p[j0] + w·h_p[j1], the
    nearest DMRS symbol (w = 0) outside their span; w in float32 as JAX
    computes it."""
    t = np.asarray(dmrs_syms, np.float32)
    j0, j1, w = [], [], []
    for l in data_syms[:-1]:
        if len(dmrs_syms) == 1 or l <= t[0]:
            j, wl = 0, np.float32(0)
        elif l >= t[-1]:
            j, wl = len(t) - 1, np.float32(0)
        else:
            j = int(np.searchsorted(t, l) - 1)
            wl = (l - t[j]) / (t[j + 1] - t[j])
        j0.append(j)
        j1.append(min(j + 1, len(t) - 1) if wl else j)
        w.append(wl)
    return np.asarray(j0), np.asarray(j1), np.asarray(w, np.float32)


def _interp_equalize(g: torch.Tensor, dmrs: torch.Tensor, dmrs_syms, data_syms,
                    noise_var: float) -> torch.Tensor:
    """g (B, 14, m) at the allocation's subcarriers, dmrs (B or 1, D, m) →
    LS at the DMRS symbols + linear time interpolation → MMSE → (B, len(data),
    m) with the final guard symbol zeroed."""
    dev = g.device
    h_p = g[:, list(dmrs_syms)] * dmrs.conj()
    j0, j1, w = (_t(a, dev) for a in _time_interp(tuple(dmrs_syms), tuple(data_syms)))
    w = w[:, None]
    h = (1 - w) * h_p[:, j0] + w * h_p[:, j1]
    y = g[:, list(data_syms[:-1])]
    eq = y * h.conj() / (h.abs() ** 2 + noise_var)
    return torch.cat([eq, torch.zeros_like(eq[:, :1])], dim=1).to(torch.complex64)


def _sl34_equalize(rx_grid: torch.Tensor, dmrs: np.ndarray, prb_start: int, nof_prb: int,
                   noise_var: float) -> torch.Tensor:
    """LS per DMRS symbol + linear time interpolation over the slot →
    (B, 10, m_sc) equalized data symbols (the guard symbol zeroed).
    ``dmrs`` is (4, m_sc) — one row per DMRS symbol {2,5,8,11}."""
    m_sc = nof_prb * 12
    g = rx_grid[..., prb_start * 12:prb_start * 12 + m_sc]
    return _interp_equalize(g, _t(dmrs, g.device)[None], SL34_DMRS_SYMS, SL34_DATA_SYMS,
                           noise_var)


def pscch34_llrs(eq: torch.Tensor, noise_var: float) -> torch.Tensor:
    """(H, 10, 24) equalised PSCCH hypotheses → descrambled, deinterleaved
    (H, 480) LLRs."""
    dev = eq.device
    e = len(SL34_DATA_SYMS) * PSCCH34_NOF_PRB * 12 * 2
    llr = _sc_fdma_llrs(eq, "qpsk", noise_var, 2 * PSCCH34_NOF_PRB * 12)
    llr = llr * _sign_t(PSCCH_SCRAMBLING_SEED, e, dev)
    return llr[..., _perms_t(e, 2, True, dev)[1]]


def pscch34_decode(rx_grid: torch.Tensor, prb_start: int, cyclic_shift: int,
                   noise_var: float = 1e-2) -> dict:
    """TM3/4 PSCCH decode at one (subchannel, cyclic-shift) hypothesis →
    dict(bits (B, 32), crc_ok (B,), n_x_id (B,))."""
    dm = np.tile(_pscch34_dmrs(cyclic_shift)[None], (4, 1))
    eq = _sl34_equalize(rx_grid, dm, prb_start, PSCCH34_NOF_PRB, noise_var)
    bits, ok = _viterbi_crc(pscch34_llrs(eq, noise_var), SCI1_LEN + SCI_CRC_LEN)
    return dict(bits=bits[..., :SCI1_LEN], crc_ok=ok, n_x_id=_crc_value(bits))


def pssch34_decode(rx_grid: torch.Tensor, prb_start: int, nof_prb: int, n_x_id: int,
                   mcs: int, rv: int, sf_idx: int, noise_var: float = 1e-2,
                   n_iter: int = 8) -> dict:
    """TM3/4 PSSCH decode → dict(bits (B, tbs), crc_ok (B,), tbs, mod).

    TB size from the UL MCS/TBS tables (pssch.c:237), scrambling
    c_init = N_x_ID·2^14 + (sf%10)·2^9 + 510 (pssch.c:352), turbo SL-SCH
    with the 10-symbol time-first interleaver."""
    dev = rx_grid.device
    mod = ra.ul_mcs_to_mod(mcs)
    qm = {"qpsk": 2, "16qam": 4, "64qam": 6}[mod]
    tbs = ra.tbs_from_itbs(ra.ul_mcs_to_itbs(mcs), nof_prb)
    m_sc = nof_prb * 12
    g = len(SL34_DATA_SYMS) * m_sc * qm
    eq = _sl34_equalize(rx_grid, _pssch34_dmrs(n_x_id, sf_idx, nof_prb), prb_start, nof_prb,
                        noise_var)
    llr = _sc_fdma_llrs(eq, mod, noise_var, qm * m_sc)
    cinit = ((n_x_id << 14) + ((sf_idx % 10) << 9) + 510) % (1 << 31)
    llr = (llr * _sign_t(cinit, g, dev))[..., _perms_t(g, qm, True, dev)[1]]
    bits, ok, _ = sch.dlsch_decode(sch.dlsch_plan(tbs, g, qm, rv), llr, n_iter=n_iter)
    return dict(bits=bits, crc_ok=ok, tbs=tbs, mod=mod)


def pssch34_prbs(sub_channel_idx: int, riv: int, size_sub_channel: int,
                 num_sub_channel: int, start_prb: int = 0) -> tuple[int, int]:
    """PSSCH PRB range from the SCI-1 RIV (36.213 §14.1.1.4C; adjacent
    PSCCH+PSSCH pools): returns (prb_start, nof_prb) with nof_prb
    clipped to the largest DFT-precodable size."""
    l_subch, _ = ra.riv_decode(num_sub_channel, riv)
    prb_start = (sub_channel_idx * size_sub_channel + PSCCH34_NOF_PRB
                 + start_prb)
    nof = ((l_subch + sub_channel_idx) * size_sub_channel
           - prb_start + start_prb)
    while nof > 1 and not _valid_dft_prb(nof):
        nof -= 1
    return prb_start, nof


def _valid_dft_prb(n: int) -> bool:
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


@functools.lru_cache(maxsize=8)
def _psss_ref_t(root: int, symbol_sz: int, device: torch.device) -> torch.Tensor:
    """The time-domain PSSS symbol: 62 centre REs around DC, half-subcarrier
    shifted like the rest of the sidelink baseband, unit norm."""
    z = psss_sequence(root)
    X = np.zeros(symbol_sz, np.complex64)
    X[-31:] = z[:31] * np.sqrt(symbol_sz)
    X[1:32] = z[31:] * np.sqrt(symbol_sz)
    ref = np.fft.ifft(X) * np.exp(1j * np.pi * np.arange(symbol_sz) / symbol_sz)
    return _t((ref / np.linalg.norm(ref)).astype(np.complex64), device)


def slss_find(samples: torch.Tensor, nof_prb: int, symbol_sz: int, root: int = 26) -> dict:
    """SLSS time synchronisation: matched-filter the time-domain PSSS
    (symbols 1–2 of an SLSS subframe, 36.211 §9.7.1) against the raw
    capture (L,) and return the implied subframe start, the PSSS pair
    correlated at every lag through one FFT product on the device."""
    cp0 = symbol_sz * 160 // 2048
    cp = symbol_sz * 144 // 2048
    n = samples.shape[-1] - symbol_sz
    if n <= 0:
        return dict(offset=0, metric=0.0)
    ref = _psss_ref_t(root, symbol_sz, samples.device)
    m = int(2 ** np.ceil(np.log2(samples.shape[-1] + symbol_sz)))
    S = torch.fft.fft(samples.to(torch.complex64), n=m)
    R = torch.fft.fft(ref.flip(0).conj(), n=m)
    corr = torch.fft.ifft(S * R).abs()[symbol_sz - 1:symbol_sz - 1 + n]
    # PSSS is transmitted twice (symbols 1 and 2): sum the pair spaced one
    # symbol+CP apart for a sharper peak
    stride = symbol_sz + cp
    pair = corr[:-stride] + corr[stride:]
    l1 = int(pair.argmax())             # body start of symbol 1
    return dict(offset=l1 - (cp0 + symbol_sz + cp), metric=float(pair[l1]),
                corr=float(corr[l1]))


def psbch_sync_decode(samples: torch.Tensor, nof_prb: int, symbol_sz: int, n_sl_id: int,
                      tm: int = 2, noise_var: float = 1e-2) -> dict:
    """SLSS-synchronised PSBCH decode of a raw capture (L,): PSSS matched
    filter for coarse timing, then every fine-timing hypothesis over the CP
    ambiguity range demodulated (one gather, one FFT) and PSBCH-decoded as
    one batch; the first hypothesis whose CRC passes with a non-zero MIB
    wins."""
    cp0 = symbol_sz * 160 // 2048
    coarse = slss_find(samples, nof_prb, symbol_sz, 26 if n_sl_id < 168 else 37)["offset"]
    offs = [coarse + d for d in range(-8, cp0 + 24, 4)]
    offs = [o for o in offs if o >= 0] or [0]
    sf_len = 15 * symbol_sz
    pad = torch.cat([samples, samples.new_zeros(
        max(2 * symbol_sz + cp0 + 32, offs[-1] + sf_len - samples.shape[-1]))])
    idx = (torch.as_tensor(offs, device=pad.device)[:, None]
           + torch.arange(sf_len, device=pad.device))
    grids = sl_subframe_grid(pad[idx], nof_prb, symbol_sz)
    out = psbch_rx_subframe(n_sl_id, nof_prb, grids, noise_var, tm=tm)
    # reject the all-zero decode: a mistimed hypothesis yields zero LLRs
    # whose trivial all-zero codeword passes CRC (sci.c:107-116)
    ok = (out["crc_ok"] & out["mib"].bool().any(dim=-1)).cpu().numpy()
    if not ok.any():
        return dict(crc_ok=False, mib=None, offset=coarse)
    i = int(np.argmax(ok))
    return dict(crc_ok=True, mib=out["mib"][i].cpu().numpy(), offset=offs[i])
