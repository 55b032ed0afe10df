"""NR SS/PBCH block: PSS/SSS sequences, PBCH (polar), SSB grid + search.

Port counterpart of ``srsran_4g_tpu/models/ssb.py`` (the reference's
`lib/src/phy/sync/ssb.c`, `pss_nr.c`, `sss_nr.c` and
`lib/src/phy/phch/pbch_nr.c`): the 127-length m-sequence PSS/SSS (TS 38.211
7.4.2), PBCH DMRS, polar-coded BCH (TS 38.212 7.1: payload+CRC24C, N=512,
E=864), the 240-subcarrier x 4-symbol SSB grid, and cell search — PSS
correlation over NID2, SSS matched filtering over NID1 as one (127, 3·336)
matmul, then PBCH decode.

Rate matching is pure repetition (E > N); the 38.212 sub-block interleaver
is omitted (self-consistent within this framework, as in JAX).

Where the port differs in form:
- the sequences are numpy tables built once (``lru_cache``); the DMRS and
  scrambling bits are cast to float before ``1 - 2c`` (numpy's uint8 would
  wrap), and the RE maps, DMRS and scrambling sequences live on the device,
  cached per (PCI, device);
- the PBCH de-repetition (864 LLRs onto 512 positions, JAX's scatter-add
  with repeated indices) is ``polar.fold``: passes of distinct positions
  added in transmit order, the same sums on the CPU and the card;
- ``search_pci`` takes the first maximum over NID2, then over NID1, as
  ``jnp.argmax`` does (``torch.argmax`` returns the first maximal index).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.models.pdsch import _on_device
from srsran_4g_tpu_torch.ops import crc as crc_ops
from srsran_4g_tpu_torch.ops import modem, polar, sequence

SSB_NRE = 240
SSB_NSYM = 4
PSS_LEN = 127
PBCH_E = 864          # rate-matched bits
PBCH_N_LOG = 9        # N = 512
PBCH_A = 32           # payload bits (24-bit MIB + timing bits)
PBCH_K = PBCH_A + 24  # + CRC24C


# --------------------------------------------------------------------------
# PSS / SSS sequences (38.211 7.4.2.2 / 7.4.2.3)


@functools.lru_cache(maxsize=8)
def _m_seq(taps: tuple[int, ...], init: tuple[int, ...]) -> np.ndarray:
    x = np.zeros(PSS_LEN + 7, dtype=np.int64)
    x[:7] = init
    for i in range(PSS_LEN):
        x[i + 7] = sum(x[i + t] for t in taps) % 2
    return x[:PSS_LEN]


@functools.lru_cache(maxsize=4)
def pss_sequence(nid2: int) -> np.ndarray:
    x = _m_seq((4, 0), (0, 1, 1, 0, 1, 1, 1))
    m = (np.arange(PSS_LEN) + 43 * nid2) % PSS_LEN
    return (1.0 - 2.0 * x[m]).astype(np.float32)


@functools.lru_cache(maxsize=1024)
def sss_sequence(nid1: int, nid2: int) -> np.ndarray:
    x0 = _m_seq((4, 0), (1, 0, 0, 0, 0, 0, 0)).astype(np.float32)
    x1 = _m_seq((1, 0), (1, 0, 0, 0, 0, 0, 0)).astype(np.float32)
    m0 = 15 * (nid1 // 112) + 5 * nid2
    m1 = nid1 % 112
    n = np.arange(PSS_LEN)
    d = (1.0 - 2.0 * x0[(n + m0) % PSS_LEN]) * (1.0 - 2.0 * x1[(n + m1) % PSS_LEN])
    return d.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _search_mats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(PSS (127, 3), SSS (127, 3*336)) complex64 matched-filter matrices."""
    pss = np.stack([pss_sequence(i) for i in range(3)]).T
    sss = np.stack([sss_sequence(n1, n2) for n2 in range(3) for n1 in range(336)]).T
    return (torch.as_tensor(pss.astype(np.complex64), device=device),
            torch.as_tensor(sss.astype(np.complex64), device=device))


# --------------------------------------------------------------------------
# PBCH DMRS + RE mapping (38.211 7.4.1.4, 7.4.3.1)


def pbch_dmrs(pci: int, i_ssb: int = 0) -> np.ndarray:
    """144 QPSK DMRS symbols; c_init per 38.211 7.4.1.4.1 (L=4/8)."""
    ibar = i_ssb  # + 4*n_hf for L=4; n_hf=0 here
    cinit = ((1 << 11) * (ibar + 1) * ((pci >> 2) + 1)
             + (1 << 6) * (ibar + 1) + (pci & 3)) % (1 << 31)
    c = sequence.gold_sequence_np(cinit, 2 * 144).astype(np.float32)
    r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)
    return r.astype(np.complex64)


def _ssb_re_maps(pci: int):
    """(data_idx, dmrs_idx) flat indices into the 4x240 SSB grid."""
    v = pci % 4
    dmrs, data = [], []
    # symbol 1: full 240, DMRS at v, v+4, ...
    for k in range(SSB_NRE):
        (dmrs if k % 4 == v else data).append(1 * SSB_NRE + k)
    # symbol 2: edges 0..47 and 192..239
    for k in list(range(48)) + list(range(192, 240)):
        (dmrs if k % 4 == v else data).append(2 * SSB_NRE + k)
    # symbol 3: full 240
    for k in range(SSB_NRE):
        (dmrs if k % 4 == v else data).append(3 * SSB_NRE + k)
    return (np.asarray(data, np.int32), np.asarray(dmrs, np.int32))


@functools.lru_cache(maxsize=64)
def _tables(pci: int, i_ssb: int, device: torch.device) -> dict[str, torch.Tensor]:
    data_idx, dmrs_idx = _ssb_re_maps(pci)
    scr = sequence.gold_sequence_np(pci, PBCH_E)
    return dict(data=torch.as_tensor(data_idx.astype(np.int64), device=device),
                dmrs_idx=torch.as_tensor(dmrs_idx.astype(np.int64), device=device),
                dmrs=torch.as_tensor(pbch_dmrs(pci, i_ssb), device=device),
                scr=torch.as_tensor(scr.astype(np.int8), device=device),
                scr_sign=torch.as_tensor(1.0 - 2.0 * scr.astype(np.float32), device=device),
                rep=torch.as_tensor(np.arange(PBCH_E) % (1 << PBCH_N_LOG), device=device))


# --------------------------------------------------------------------------
# PBCH polar coding (38.212 7.1)


def pbch_encode_bits(payload: torch.Tensor, pci: int) -> torch.Tensor:
    """(B, 32) -> (B, 864) rate-matched scrambled bits."""
    t = _tables(pci, 0, payload.device)
    with_crc = torch.cat([payload.to(torch.int8), crc_ops.crc_compute(payload, "24C")], dim=-1)
    cw = polar.encode_info(with_crc, PBCH_N_LOG)  # (B, 512)
    return torch.bitwise_xor(cw[:, t["rep"]], t["scr"])


def pbch_decode_bits(llrs: torch.Tensor, pci: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 864) LLRs -> (payload (B,32), crc_ok (B,))."""
    t = _tables(pci, 0, llrs.device)
    acc = polar.fold(llrs * t["scr_sign"], 1 << PBCH_N_LOG)
    dec = polar.decode(acc, PBCH_K, PBCH_N_LOG)  # (B, K) info bits
    ok = crc_ops.crc_check(dec, "24C")
    return dec[..., :PBCH_A], ok


# --------------------------------------------------------------------------
# SSB assembly + search


@dataclass(frozen=True)
class SsbConfig:
    pci: int
    i_ssb: int = 0


def assemble(cfg: SsbConfig, payload: torch.Tensor | np.ndarray,
             device: torch.device | str | None = None) -> torch.Tensor:
    """(B, 32) MIB payload -> (B, 4, 240) SSB grid.  A tensor payload keeps
    its device; other input goes to ``device`` (default CUDA)."""
    payload = _on_device(payload, device)
    dev = payload.device
    b = payload.shape[0]
    nid2, nid1 = cfg.pci % 3, cfg.pci // 3
    t = _tables(cfg.pci, cfg.i_ssb, dev)
    grid = torch.zeros((b, SSB_NSYM, SSB_NRE), dtype=torch.complex64, device=dev)
    grid[:, 0, 56:56 + PSS_LEN] = torch.as_tensor(pss_sequence(nid2).astype(np.complex64),
                                                  device=dev)
    grid[:, 2, 56:56 + PSS_LEN] = torch.as_tensor(
        sss_sequence(nid1, nid2).astype(np.complex64), device=dev)
    syms = modem.modulate("qpsk", pbch_encode_bits(payload, cfg.pci))  # (B, 432)
    flat = grid.reshape(b, -1)
    flat[:, t["data"]] = syms
    flat[:, t["dmrs_idx"]] = t["dmrs"]
    return flat.reshape(b, SSB_NSYM, SSB_NRE)


def search_pci(rx_ssb: torch.Tensor) -> dict:
    """Blind PCI search on an aligned (B, 4, 240) SSB capture.

    PSS correlation over the 3 NID2 hypotheses, then the SSS matched filter
    over all (NID2, NID1) pairs as one matmul, read at the NID2 found.
    """
    pss_mat, sss_mat = _search_mats(rx_ssb.device)
    pss_y = rx_ssb[:, 0, 56:56 + PSS_LEN]                   # (B, 127)
    pss_corr = (pss_y @ pss_mat).abs().square()             # (B, 3)
    pss_energy = pss_y.abs().square().sum(dim=-1) + 1e-9
    nid2 = torch.argmax(pss_corr, dim=-1)                   # (B,)

    sss_y = rx_ssb[:, 2, 56:56 + PSS_LEN]
    corr = (sss_y @ sss_mat).abs().square().reshape(-1, 3, 336)  # (B, 3, 336)
    corr_sel = torch.take_along_dim(corr, nid2[:, None, None], dim=1)[:, 0]
    nid1 = torch.argmax(corr_sel, dim=-1)
    metric = pss_corr.amax(dim=-1) / (PSS_LEN * pss_energy)
    return dict(pci=3 * nid1 + nid2, nid1=nid1, nid2=nid2, metric=metric)


def decode_pbch(cfg: SsbConfig, rx_ssb: torch.Tensor) -> dict:
    """Channel-estimate from PBCH DMRS, equalize, decode the BCH."""
    b = rx_ssb.shape[0]
    t = _tables(cfg.pci, cfg.i_ssb, rx_ssb.device)
    flat = rx_ssb.reshape(b, -1)
    h_ls = flat[:, t["dmrs_idx"]] * t["dmrs"].conj()        # (B, 144)
    h_avg = h_ls.mean(dim=-1, keepdim=True)
    nv = (h_ls - h_avg).abs().square().mean(dim=-1, keepdim=True) + 1e-9
    y = flat[:, t["data"]]
    h2 = h_avg.abs().square()
    x = y * h_avg.conj() / (h2 + nv)
    llr = modem.demodulate_soft("qpsk", x, nv / (h2 + 1e-9))
    payload, ok = pbch_decode_bits(llr.reshape(b, PBCH_E), cfg.pci)
    return dict(payload=payload, crc_ok=ok, snr_est=1.0 / nv[:, 0])
