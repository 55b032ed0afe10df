"""NR SA synchronisation: SSB-based cell search + slot tracking FSM.

Port counterpart of ``srsran_4g_tpu/models/ue_sync_nr.py`` (the reference's
`lib/src/phy/ue/ue_sync_nr.c` and the SA cell-search / tracking FSM of
`srsue/src/phy/sync_sa.cc` + `slot_sync.cc`): find an SS/PBCH block in a
sample capture (PSS time correlation over the 3 NID2), extract the 4-symbol
SSB grid, run the SSS matched filter for the PCI, decode the PBCH for
MIB/timing.

The host FSM keeps scalars only; the search is batched tensor code on the
capture's device.  The three PSS references and their FFTs are built once
per (symbol size, FFT size, device).  The offset is the first maximum of the
normalised correlation over (NID2, delay), as ``jnp.argmax`` takes it: the
FFTs differ from XLA's in rounding only, and the peak stands far above its
neighbours, so the offset, which positions the SSB grid, is exact.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.models import ssb

FIND, TRACK = "FIND", "TRACK"


def _pss_refs_np(symbol_sz: int) -> np.ndarray:
    refs = []
    for nid2 in range(3):
        # PSS sits at SSB subcarriers 56..182; with the SSB centred on DC
        # (bin = k-120, DC skipped for k>=120) that is bins -64..-1, 1..63
        freq = np.zeros(symbol_sz, np.complex64)
        seq = ssb.pss_sequence(nid2)
        freq[-64:] = seq[0:64]
        freq[1:64] = seq[64:127]
        refs.append(np.fft.ifft(freq).astype(np.complex64))
    return np.stack(refs)  # (3, N)


@functools.lru_cache(maxsize=16)
def _pss_refs(symbol_sz: int, nfft: int, device: torch.device):
    """(conj FFT of the 3 references at nfft (3, nfft), their energies (3,))."""
    ref = torch.as_tensor(_pss_refs_np(symbol_sz), device=device)
    return torch.fft.fft(ref, n=nfft, dim=-1).conj(), ref.abs().square().sum(dim=-1)


def pss_time_correlate(samples: torch.Tensor, symbol_sz: int) -> dict:
    """Correlate all 3 NR PSS (127 subcarriers -> symbol_sz IFFT) against a
    (B, N) sample stream; returns peak offset/metric/nid2 per batch."""
    n = symbol_sz
    b, m = samples.shape
    nfft = 1
    while nfft < m + n:
        nfft *= 2
    r_f, e_ref = _pss_refs(n, nfft, samples.device)
    s_f = torch.fft.fft(samples, n=nfft, dim=-1)
    corr = torch.fft.ifft(s_f[:, None, :] * r_f[None], dim=-1)
    power = corr[..., : m - n + 1].abs().square()  # (B, 3, M-N+1)
    # Cauchy-Schwarz normalisation against the LOCAL window energy so the
    # metric is delay/fill-fraction independent: |<s,r>|^2/(E_win*E_ref)
    csum = torch.cumsum(samples.abs().square(), dim=-1)
    csum = torch.cat([csum.new_zeros((b, 1)), csum], dim=-1)
    e_win = csum[:, n:] - csum[:, : m - n + 1]           # (B, M-N+1)
    metric = power / (e_win[:, None, :] * e_ref[None, :, None] + 1e-9)
    flat = metric.reshape(b, -1)
    arg = torch.argmax(flat, dim=-1)
    return dict(nid2=arg // power.shape[-1], offset=arg % power.shape[-1],
                metric=flat.amax(dim=-1))


def extract_ssb_grid(samples: torch.Tensor, offset: torch.Tensor,
                     symbol_sz: int, cp_len: int) -> torch.Tensor:
    """Slice 4 SSB symbols starting at the PSS symbol body and FFT to the
    240-subcarrier SSB grid (B, 4, 240)."""
    dev = samples.device
    idx = (offset[:, None, None]
           + torch.arange(4, device=dev)[None, :, None] * (symbol_sz + cp_len)
           + torch.arange(symbol_sz, device=dev)[None, None, :])
    b = samples.shape[0]
    t = torch.gather(samples, 1, idx.reshape(b, -1)).reshape(b, 4, symbol_sz)
    f = torch.fft.fft(t, dim=-1) / np.sqrt(symbol_sz)
    # de-map the centred 240 subcarriers (negative freqs at the top)
    return torch.cat([f[..., -120:], f[..., 1:121]], dim=-1).to(torch.complex64)


def ssb_to_samples(ssb_grid: torch.Tensor, symbol_sz: int = 256,
                   cp_len: int = 18) -> torch.Tensor:
    """TX helper: (B, 4, 240) SSB grid -> (B, 4*(cp+N)) time samples,
    using the same centred subcarrier map as extract_ssb_grid."""
    b = ssb_grid.shape[0]
    freq = torch.zeros((b, 4, symbol_sz), dtype=torch.complex64, device=ssb_grid.device)
    freq[..., -120:] = ssb_grid[..., :120]
    freq[..., 1:121] = ssb_grid[..., 120:]
    t = torch.fft.ifft(freq, dim=-1) * np.sqrt(symbol_sz)
    return torch.cat([t[..., -cp_len:], t], dim=-1).reshape(b, -1)


@dataclass
class UeSyncNrState:
    state: str = FIND
    pci: int = -1
    cfo_acc: float = 0.0
    ssb_offset: int = 0
    misses: int = 0


class UeSyncNr:
    """Host FSM over the batched search (sync_sa.cc states)."""

    # Cauchy-Schwarz metric: ~0.87 at 10 dB, ~0.37 at 0 dB, ~0.04 noise
    THRESH = 0.15

    def __init__(self, symbol_sz: int = 256, cp_len: int = 18) -> None:
        self.symbol_sz = symbol_sz
        self.cp_len = cp_len
        self.s = UeSyncNrState()

    def process(self, samples: torch.Tensor) -> dict:
        """One capture (1, N) -> status; on FIND success also the SSB grid."""
        found = pss_time_correlate(samples, self.symbol_sz)
        metric = float(found["metric"][0])
        if metric < self.THRESH:
            self.s.misses += 1
            if self.s.state == TRACK and self.s.misses > 4:
                self.s.state = FIND
                self.s.pci = -1
            return dict(in_sync=False, metric=metric, state=self.s.state)
        self.s.misses = 0
        off = found["offset"]
        grid = extract_ssb_grid(samples, off, self.symbol_sz, self.cp_len)
        if self.s.state == FIND:
            self.s.pci = int(ssb.search_pci(grid)["pci"][0])
            self.s.state = TRACK
        self.s.ssb_offset = int(off[0])
        return dict(in_sync=True, state=self.s.state, pci=self.s.pci,
                    metric=metric, offset=self.s.ssb_offset, ssb_grid=grid)

    def decode_mib(self, ssb_grid: torch.Tensor) -> dict:
        return ssb.decode_pbch(ssb.SsbConfig(pci=self.s.pci), ssb_grid)
