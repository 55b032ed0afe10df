"""NB-IoT PHY: NPSS/NSSS synchronisation + NPBCH (TS 36.211 §10).

Port counterpart of ``srsran_4g_tpu/models/nbiot.py`` (the reference's
`lib/src/phy/sync/npss.c`, `nsss.c`, `lib/src/phy/phch/npbch.c`,
`ra_nbiot.c`): the length-11 Zadoff-Chu NPSS repeated over 11 symbols with a
cover code, the NSSS from a ZC-131 root indexed by cell id with Hadamard
scrambling, and the NPBCH (MIB-NB + CRC16 + tail-biting convolutional code,
QPSK on the anchor PRB).  All sequences operate on the single NB-IoT PRB:
grids are (B, 14, 12) per subframe.

Where the port differs in form (the bits are the same): ``npbch_decode``
decodes its 1- and 2-port hypotheses as one (2B) batch through one conv
de-rate-match and one Viterbi (JAX: one Viterbi each; the rows are
independent).  Sequences, RE maps and NRS pilots are numpy tables cached on
the device; the Gold bits are cast to float before ``1 - 2c``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srsran_4g_tpu_torch.models import equalizer
from srsran_4g_tpu_torch.models.pdsch import _on_device
from srsran_4g_tpu_torch.ops import convcode, crc as crc_ops, modem, rate_match, sequence
from srsran_4g_tpu_torch.utils import constants as C

NPSS_COVER = np.array([1, 1, 1, 1, -1, -1, 1, 1, 1, -1, 1], np.float32)
NPSS_SYMS = tuple(range(3, 14))  # symbols 3..13


def _t(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


@functools.lru_cache(maxsize=4)
def npss_sequence() -> np.ndarray:
    """(11, 11) NPSS: ZC root 5, length 11, with per-symbol cover code."""
    n = np.arange(11)
    zc = np.exp(-1j * np.pi * 5 * n * (n + 1) / 11)
    return (NPSS_COVER[:, None] * zc[None, :]).astype(np.complex64)


def put_npss(grid: torch.Tensor) -> torch.Tensor:
    """Insert NPSS into subframe-5 grid (B, 14, 12), subcarriers 0..10."""
    out = grid.clone()
    out[:, NPSS_SYMS[0]:NPSS_SYMS[-1] + 1, :11] = _t(npss_sequence(), grid.device)
    return out


def npss_metric(grid: torch.Tensor) -> torch.Tensor:
    """Correlation metric on an aligned (B, 14, 12) subframe."""
    seq = _t(npss_sequence(), grid.device)
    y = grid[:, NPSS_SYMS[0]:NPSS_SYMS[-1] + 1, :11]
    num = (y * seq.conj()).sum(dim=(-1, -2)).abs() ** 2
    den = (y.abs() ** 2).sum(dim=(-1, -2)) * 121 + 1e-9
    return num / den


@functools.lru_cache(maxsize=512)
def nsss_sequence(cell_id: int, frame_idx: int = 0) -> np.ndarray:
    """132-sample NSSS (36.211 10.2.7.2): ZC-131 root u with binary
    scrambling b_q and phase theta_f."""
    q = cell_id // 126
    u = cell_id % 126 + 3
    n = np.arange(132)
    np_ = n % 131
    zc = np.exp(-1j * np.pi * u * np_ * (np_ + 1) / 131)
    # b_q: length-128 Hadamard rows extended; use rows of H_128 index q
    bq = np.ones(132, np.float32)
    for bit in range(7):
        mask = ((n >> bit) & 1).astype(bool)
        if (q >> bit) & 1:
            bq[mask] *= -1
    theta = np.exp(-2j * np.pi * (33 / 132) * frame_idx * n / 4)
    return (bq * zc * theta).astype(np.complex64)


def put_nsss(grid: torch.Tensor, cell_id: int, frame_idx: int = 0) -> torch.Tensor:
    """NSSS occupies the last 11 symbols x 12 subcarriers of subframe 9."""
    out = grid.clone()
    out[:, 3:14, :] = _t(nsss_sequence(cell_id, frame_idx).reshape(11, 12), grid.device)
    return out


@functools.lru_cache(maxsize=8)
def _nsss_mat(frame_idx: int, n_cells: int, device: torch.device) -> torch.Tensor:
    return _t(np.stack([nsss_sequence(c, frame_idx) for c in range(n_cells)]), device)


def nsss_detect(grid: torch.Tensor, frame_idx: int = 0, n_cells: int = 504) -> dict:
    """Matched filter over all cell ids as one (B, 132)x(132, N) matmul."""
    y = grid[:, 3:14, :].reshape(grid.shape[0], 132).to(torch.complex64)
    corr = (y @ _nsss_mat(frame_idx, n_cells, grid.device).conj().T).abs() ** 2
    energy = (y.abs() ** 2).sum(dim=-1, keepdim=True) * 132 + 1e-9
    m = corr / energy
    return dict(cell_id=m.argmax(dim=-1), metric=m.amax(dim=-1))


# --------------------------------------------------------------------------
# NPBCH (36.211 10.2.4): MIB-NB 34 bits + CRC16, TBCC, QPSK


MIB_NB_LEN = 34
_NPBCH_RE = 100  # REs in the anchor PRB used per NPBCH subframe


NPBCH_BLOCKS = 8  # MIB-NB codeword split into 8 blocks
NPBCH_REP = 8     # each block repeated in 8 consecutive frames
NPBCH_BITS_SF = 2 * _NPBCH_RE          # 200 bits per subframe
NPBCH_TOTAL_BITS = NPBCH_BLOCKS * NPBCH_BITS_SF  # 1600


def _npbch_scramble(cell_id: int) -> np.ndarray:
    """Full 1600-bit NPBCH scrambling sequence, c_init = N_id_ncell
    (36.211 §10.2.4.1, reference sequences.c srsran_sequence_npbch)."""
    return sequence.gold_sequence_np(cell_id, NPBCH_TOTAL_BITS).astype(np.int8)


@functools.lru_cache(maxsize=32)
def _npbch_r14_phase(cell_id: int, nf: int) -> np.ndarray:
    """(100,) per-RE rotation for R14 NPBCH (36.211 §10.2.4.4): phase
    from gold-bit pairs with c_init = (Ncell+1)·((nf%8+1)^3)·512 + Ncell."""
    cinit = (cell_id + 1) * (((nf % 8) + 1) ** 3) * 512 + cell_id
    c = sequence.gold_sequence_np(cinit, NPBCH_BITS_SF)
    phase_lut = np.array([1, -1, 1j, -1j], np.complex64)
    return phase_lut[2 * c[0::2] + c[1::2]]


@functools.lru_cache(maxsize=32)
def npbch_re_indices(cell_id: int) -> np.ndarray:
    """(100,) flat RE indices (l*12+k) of NPBCH in subframe 0.

    36.211 §10.2.4.2 via reference npbch.c srsran_npbch_cp: symbols 3..13;
    symbols 3, 9, 10 carry all 12 REs, every other symbol skips the four
    reference REs at (N_id_ncell%3) + 3k."""
    out = []
    off = cell_id % 3
    for l in range(3, 14):
        if l in (3, 9, 10):
            ks = np.arange(12)
        else:
            ks = np.array([k for k in range(12) if (k % 3) != off])
        out.append(l * 12 + ks)
    idx = np.concatenate(out)
    assert idx.shape[0] == _NPBCH_RE
    return idx


def nrs_pattern(cell_id: int, port: int) -> tuple[np.ndarray, np.ndarray]:
    """NRS RE positions in one subframe: (symbols (4,), subcarriers (4, 2)).

    NRS occupy the last two symbols of each slot; v = 0/3 alternating per
    symbol (swapped for port 1), shifted by N_id_ncell % 6 (reference
    refsignal_dl_nbiot.c:37-71)."""
    syms = np.array([5, 6, 12, 13])
    vs = np.array([0, 3, 0, 3]) if port == 0 else np.array([3, 0, 3, 0])
    scs = ((vs[:, None] + cell_id % 6) % 6) + 6 * np.arange(2)[None, :]
    return syms, scs


@functools.lru_cache(maxsize=32)
def nrs_values(cell_id: int, subframe: int = 0) -> np.ndarray:
    """(4, 2) complex64 NRS pilot values for one subframe (any port —
    the sequence depends only on slot/symbol, reference
    refsignal_dl_nbiot.c:138-170)."""
    out = []
    for l_sf in (5, 6, 12, 13):
        ns = 2 * subframe + l_sf // 7
        lp = l_sf % 7
        c_init = (1024 * (7 * (ns + 1) + lp + 1) * (2 * cell_id + 1)
                  + 2 * cell_id + 1)
        seq = sequence.gold_sequence_np(c_init, 4 * C.MAX_PRB).astype(np.float32)
        m = np.arange(2) + C.MAX_PRB - 1
        re = (1.0 - 2.0 * seq[2 * m]) / np.sqrt(2)
        im = (1.0 - 2.0 * seq[2 * m + 1]) / np.sqrt(2)
        out.append((re + 1j * im).astype(np.complex64))
    return np.stack(out)


@functools.lru_cache(maxsize=64)
def _nrs_t(cell_id: int, port: int, subframe: int, device: torch.device):
    syms, scs = nrs_pattern(cell_id, port)
    return (_t(syms[:, None], device), _t(scs, device),
            _t(nrs_values(cell_id, subframe), device))


@functools.lru_cache(maxsize=1)
def _slot_weights() -> np.ndarray:
    t = (np.arange(14, dtype=np.float32) - 5.5) / 7.0
    return np.clip(t, 0.0, 1.0)


def chest_nbiot(cell_id: int, rx_grid: torch.Tensor, port: int, subframe: int = 0) -> dict:
    """LS channel estimate from the NRS of one port.

    rx_grid: (B, 14, 12). Returns dict(h (B, 14, 12), noise_var (B,)).
    Pilots are averaged per slot and linearly interpolated over symbols,
    flat in frequency (reference chest_dl_nbiot.c LS + averaging)."""
    ls, ks, pil = _nrs_t(cell_id, port, subframe, rx_grid.device)
    h_ls = rx_grid[..., ls, ks] * pil.conj()  # (B, 4, 2)
    # slot averages at symbol centres 5.5 and 12.5
    h_slot = h_ls.reshape(h_ls.shape[:-2] + (2, 4)).mean(dim=-1)
    w = _t(_slot_weights(), rx_grid.device)
    h_t = (1 - w) * h_slot[..., :1] + w * h_slot[..., 1:]
    h = h_t[..., None].expand(h_t.shape + (12,))  # flat in frequency
    mean_h = h_ls.mean(dim=(-1, -2), keepdim=True)
    noise = ((h_ls - mean_h).abs() ** 2).mean(dim=(-1, -2))
    return dict(h=h, noise_var=noise.clamp(min=1e-9))


@functools.lru_cache(maxsize=16)
def _npbch_tables(cell_id: int, device: torch.device) -> dict:
    return dict(re=_t(npbch_re_indices(cell_id), device),
                scr=_t(_npbch_scramble(cell_id), device),
                sign=_t(1.0 - 2.0 * _npbch_scramble(cell_id).astype(np.float32), device))


def _crc16_port_mask(crc: torch.Tensor, nof_ports: int) -> torch.Tensor:
    """CRC16 masked by the port count (36.212 table 5.3.1.1-1)."""
    return torch.bitwise_xor(crc.to(torch.int8), torch.ones_like(crc, dtype=torch.int8)) \
        if nof_ports == 2 else crc.to(torch.int8)


def npbch_codeword(cell_id: int, mib_bits: torch.Tensor, nof_ports: int = 1) -> torch.Tensor:
    """(B, 34) MIB-NB -> (B, 1600) scrambled rate-matched codeword."""
    bits = mib_bits.to(torch.int8)
    crc = _crc16_port_mask(crc_ops.crc_compute(bits, "16"), nof_ports)
    cw = convcode.conv_encode(torch.cat([bits, crc], dim=-1))  # (B, 3, 50) tail-biting
    e = rate_match.conv_rate_match(cw, NPBCH_TOTAL_BITS)
    return torch.bitwise_xor(e.to(torch.int8), _npbch_tables(cell_id, bits.device)["scr"])


def npbch_encode(cell_id: int, mib_bits, frame_idx: int = 0, nof_ports: int = 1,
                 is_r14: bool = False, device: torch.device | str | None = None
                 ) -> torch.Tensor:
    """(B, 34) -> (B, 14, 12) anchor-PRB grid for subframe 0 of
    ``frame_idx`` within the 64-frame NPBCH TTI (single-port path).  A tensor
    keeps its device; other input goes to ``device`` (default CUDA)."""
    bits = _on_device(mib_bits, device)
    dev = bits.device
    b = bits.shape[0]
    block = (frame_idx // NPBCH_REP) % NPBCH_BLOCKS
    e = npbch_codeword(cell_id, bits, nof_ports)
    syms = modem.modulate("qpsk", e[:, block * NPBCH_BITS_SF:(block + 1) * NPBCH_BITS_SF])
    if is_r14:
        syms = syms * _t(_npbch_r14_phase(cell_id, frame_idx), dev)
    flat = torch.zeros((b, 14 * 12), dtype=torch.complex64, device=dev)
    flat[:, _npbch_tables(cell_id, dev)["re"]] = syms
    # add NRS so the self-receive chain can estimate the channel
    grid = flat.reshape(b, 14, 12)
    ls, ks, pil = _nrs_t(cell_id, 0, 0, dev)
    grid[:, ls, ks] = pil
    return grid


def npbch_decode(cell_id: int, rx_grid: torch.Tensor, block_idx: int = 0, nf: int = 0,
                 is_r14: bool = False, noise_var=None) -> dict:
    """Decode the MIB-NB from one subframe-0 grid.

    Tries the 1- and 2-port hypotheses (single-tap / SFBC diversity,
    reference npbch.c:413-453), both in one Viterbi batch; ``block_idx``
    selects which eighth of the 1600-bit codeword this subframe carries.

    Returns dict(mib (B,34), crc_ok (B,), n_ports (B,)).
    """
    dev = rx_grid.device
    b = rx_grid.shape[0]
    tab = _npbch_tables(cell_id, dev)
    y = rx_grid.reshape(b, -1)[:, tab["re"]]
    if is_r14:
        y = y * _t(_npbch_r14_phase(cell_id, nf), dev).conj()
    ch0 = chest_nbiot(cell_id, rx_grid, 0)
    ch1 = chest_nbiot(cell_id, rx_grid, 1)
    nv = ch0["noise_var"] if noise_var is None else noise_var
    h0 = ch0["h"].reshape(b, -1)[:, tab["re"]]
    h1 = ch1["h"].reshape(b, -1)[:, tab["re"]]
    lo, hi = block_idx * NPBCH_BITS_SF, (block_idx + 1) * NPBCH_BITS_SF
    full = torch.zeros((2 * b, NPBCH_TOTAL_BITS), dtype=torch.float32, device=dev)
    for i, (x, eff_nv) in enumerate((equalizer.equalize_single(y, h0, nv),
                                     equalizer.alamouti_decode_2x1(y, h0, h1, nv))):
        full[i * b:(i + 1) * b, lo:hi] = modem.demodulate_soft("qpsk", x, eff_nv) \
            * tab["sign"][lo:hi]
    bits = convcode.viterbi_decode(rate_match.conv_rate_dematch(full, MIB_NB_LEN + 16))
    mib_out = torch.zeros((b, MIB_NB_LEN), dtype=torch.int8, device=dev)
    ok_any = torch.zeros(b, dtype=torch.bool, device=dev)
    ports_out = torch.zeros(b, dtype=torch.int32, device=dev)
    for i, n_ports in enumerate((1, 2)):
        mib = bits[i * b:(i + 1) * b, :MIB_NB_LEN]
        expect = _crc16_port_mask(crc_ops.crc_compute(mib, "16"), n_ports)
        ok = (expect == bits[i * b:(i + 1) * b, MIB_NB_LEN:]).all(dim=-1) & (mib != 0).any(-1)
        new = ok & ~ok_any
        mib_out = torch.where(new[:, None], mib, mib_out)
        ports_out = torch.where(new, n_ports, ports_out)
        ok_any = ok_any | ok
    return dict(mib=mib_out, crc_ok=ok_any, n_ports=ports_out)


def mib_nb_unpack(mib) -> dict:
    """MIB-NB field unpack (TS 36.331 §6.7.2, reference npbch.c:204-214).

    Quick field access for capture tests; the 3GPP-exact full codec is
    `stack/rrc_nbiot.MibNb`."""
    bits = np.asarray(mib.cpu() if isinstance(mib, torch.Tensor) else mib).astype(np.int64)

    def take(o, n):
        v = 0
        for i in range(n):
            v = (v << 1) | bits[o + i]
        return int(v)

    return dict(
        sfn_msb=take(0, 4) << 6,
        hfn_lsb=take(4, 2),
        sched_info_sib1=take(6, 4),
        sys_info_tag=take(10, 5),
        ac_barring=take(15, 1),
        mode=take(16, 2),
    )
