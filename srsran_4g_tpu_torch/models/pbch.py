"""PBCH: physical broadcast channel (MIB), TS 36.211 §6.6 / 36.212 §5.3.1.

Port counterpart of ``srsran_4g_tpu/models/pbch.py`` (the reference's
`lib/src/phy/phch/pbch.c`).  24-bit MIB → CRC16 masked by the antenna-port
pattern → tail-biting convolutional 1/3 → rate match to 1920 bits (normal
CP) → cell scrambling over the 40 ms TTI → QPSK → 240 REs per radio frame in
subframe 0, symbols 7-10, the central 72 subcarriers (rate-matched around
the 4-port CRS positions whatever the port count).

Decoding tries the three antenna-mask hypotheses and reports the port count,
as the reference does during cell search; soft combining over up to four
frames is a sum into the 40 ms LLR buffer.  Works at any bandwidth (the
PBCH REs are the grid's central 72 subcarriers).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srsran_4g_tpu_torch.models import equalizer, mimo
from srsran_4g_tpu_torch.models import grid as G
from srsran_4g_tpu_torch.ops import convcode, modem, rate_match, scrambling
from srsran_4g_tpu_torch.ops.crc import crc_compute
from srsran_4g_tpu_torch.ops.sequence import gold_sequence_np

E_NORM = 1920  # rate-matched bits of the 40 ms TTI, normal CP
_CRC_MASKS = {1: 0x0000, 2: 0xFFFF, 4: 0xAAAA}  # TS 36.212 Table 5.3.1.1-1


def _crc16_masked(bits: torch.Tensor, n_ports: int) -> torch.Tensor:
    mask = torch.as_tensor((_CRC_MASKS[n_ports] >> np.arange(15, -1, -1)) & 1,
                           dtype=torch.int8, device=bits.device)
    return torch.bitwise_xor(crc_compute(bits, "16"), mask)


@functools.lru_cache(maxsize=64)
def pbch_re_indices(cell: G.CellConfig) -> np.ndarray:
    """Flat (symbol·nre + sc) indices of the 240 PBCH REs of one frame."""
    nsy = cell.nsymb // 2
    mid = cell.nre // 2
    ks = np.arange(mid - 36, mid + 36)
    vshift = cell.cell_id % 6
    out = []
    for li, l in enumerate(range(nsy, nsy + 4)):
        # symbols 0, 1 of slot 1 skip the 4-port CRS comb (mod 3)
        keep = ks[(ks % 3) != (vshift % 3)] if li < 2 else ks
        out.append(l * cell.nre + keep)
    idx = np.concatenate(out)
    assert idx.shape[0] == 240
    return idx


@functools.lru_cache(maxsize=64)
def _scramble_seq(cell_id: int) -> np.ndarray:
    return gold_sequence_np(scrambling.pbch_cinit(cell_id), E_NORM)


def encode(cell: G.CellConfig, mib_bits: torch.Tensor, n_ports: int = 1) -> torch.Tensor:
    """MIB (B, 24) → the 40 ms TTI's PBCH QPSK symbols (B, 4, 240), on
    mib_bits' device."""
    a = torch.cat([mib_bits.to(torch.int8), _crc16_masked(mib_bits, n_ports)], dim=-1)
    e = rate_match.conv_rate_match(convcode.conv_encode(a), E_NORM)
    seq = torch.as_tensor(_scramble_seq(cell.cell_id), device=e.device)
    syms = modem.modulate("qpsk", scrambling.scramble_bits(e, seq))  # (B, 960)
    return syms.reshape(syms.shape[:-1] + (4, 240))


def put_into_grid(cell: G.CellConfig, grid_tx: torch.Tensor,
                  pbch_syms_frame: torch.Tensor) -> torch.Tensor:
    """Scatter one frame's 240 PBCH symbols into a subframe-0 grid
    (SFBC-mapped on a 2-port grid, which needs ``encode(n_ports=2)`` for
    the CRC mask to match)."""
    return mimo.scatter_ctrl_syms(grid_tx, pbch_re_indices(cell), pbch_syms_frame)


def decode(cell: G.CellConfig, rx_grid: torch.Tensor, h: torch.Tensor, noise_var,
           frame_idx: int = 0, llr_buffer: torch.Tensor | None = None,
           h1: torch.Tensor | None = None) -> dict:
    """Decode the MIB from one subframe-0 grid, plus the 40 ms LLR buffer of
    earlier frames if given (it is not modified).

    With ``h1`` (port-1 estimates) the PBCH REs are SFBC-combined (2-port TX
    diversity; the CRC's antenna mask confirms the hypothesis).

    Returns dict(mib (B, 24), crc_ok (B,), n_ports (B,), llr_buffer (B, 1920)).
    """
    dev = rx_grid.device
    idx = torch.as_tensor(pbch_re_indices(cell), device=dev)
    b = rx_grid.shape[0]
    y = rx_grid.reshape(b, -1)[:, idx]
    h_re = h.reshape(b, -1)[:, idx]
    if h1 is not None:
        x, eff_nv = equalizer.alamouti_decode_2x1(y, h_re, h1.reshape(b, -1)[:, idx],
                                                  noise_var)
    else:
        x, eff_nv = equalizer.equalize_single(y, h_re, noise_var)
    llr = modem.demodulate_soft("qpsk", x, eff_nv)  # (B, 480)

    sl = slice(frame_idx * 480, (frame_idx + 1) * 480)
    buf = (torch.zeros((b, E_NORM), dtype=torch.float32, device=dev)
           if llr_buffer is None else llr_buffer.clone())
    seq = torch.as_tensor(_scramble_seq(cell.cell_id)[sl], device=dev)
    buf[:, sl] = buf[:, sl] + scrambling.descramble_llrs(llr, seq)

    bits = convcode.viterbi_decode(rate_match.conv_rate_dematch(buf, 40))  # (B, 40)
    mib, crc_rx = bits[:, :24], bits[:, 24:]
    ok_any = torch.zeros(b, dtype=torch.bool, device=dev)
    ports = torch.zeros(b, dtype=torch.int32, device=dev)
    for np_hyp in (1, 2, 4):  # the three antenna-mask hypotheses
        ok = (_crc16_masked(mib, np_hyp) == crc_rx).all(dim=-1)
        ports = torch.where(ok & ~ok_any, np_hyp, ports)
        ok_any = ok_any | ok
    return dict(mib=mib, crc_ok=ok_any, n_ports=ports, llr_buffer=buf)
