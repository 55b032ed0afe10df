"""Cell synchronisation: PSS/SSS detection, CFO estimation/correction.

Port counterpart of ``srsran_4g_tpu/models/sync.py`` (the reference's
`lib/src/phy/sync/{pss.c,sss.c,sync.c,cfo.c}`).  PSS matched filtering is
one batched FFT-domain correlation over a whole batch of captures for each
N_ID_2 hypothesis; SSS detection is one (B, 62) × (62, 2·168) correlation
over every (N_ID_1, frame phase) hypothesis.  CFO estimators: CP-based
(cp.c) and PSS-based (pss.c cfo).  Replicas and sequences are host tables
(numpy), built once.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from srsran_4g_tpu_torch.ops.ofdm import OfdmConfig
from srsran_4g_tpu_torch.ops.zadoff_chu import pss_sequence

# --- PSS --------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def pss_time_domain(n_id_2: int, symbol_sz: int) -> np.ndarray:
    """Unit-energy time-domain PSS replica of length symbol_sz."""
    freq = np.zeros(symbol_sz, dtype=np.complex64)
    seq = pss_sequence(n_id_2)
    freq[symbol_sz - 31:] = seq[:31]
    freq[1:32] = seq[31:]
    t = np.fft.ifft(freq).astype(np.complex64)
    return (t / np.linalg.norm(t)).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _replica_spectrum(n_id_2: int, symbol_sz: int, nfft: int) -> np.ndarray:
    replica = pss_time_domain(n_id_2, symbol_sz)
    return np.fft.fft(np.conj(replica[::-1]), nfft).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _replica_spectrum_t(n_id_2: int, symbol_sz: int, nfft: int,
                        device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_replica_spectrum(n_id_2, symbol_sz, nfft), device=device)


def _nfft(n: int, symbol_sz: int) -> int:
    return int(2 ** np.ceil(np.log2(n + symbol_sz)))


def _window_energy(samples: torch.Tensor, symbol_sz: int) -> torch.Tensor:
    """Energy of samples[n : n+symbol_sz] for every n (the last symbol_sz-1
    repeat the last full window), from the difference of two float32 cumsums
    as the JAX package computes it."""
    power = torch.cumsum(samples.abs() ** 2, dim=-1)
    cs = torch.cat([torch.zeros_like(power[..., :1]), power], dim=-1)
    win = cs[..., symbol_sz:] - cs[..., :-symbol_sz]
    return torch.cat([win, win[..., -1:].expand(win.shape[:-1] + (symbol_sz - 1,))], dim=-1)


def _correlate(xf: torch.Tensor, n: int, n_id_2: int, symbol_sz: int) -> torch.Tensor:
    """|matched filter| (..., n) from the capture's spectrum xf (..., nfft)."""
    rf = _replica_spectrum_t(n_id_2, symbol_sz, xf.shape[-1], xf.device)
    corr = torch.fft.ifft(xf * rf, dim=-1)
    # full convolution index k corresponds to window start k - (symbol_sz-1)
    return corr[..., symbol_sz - 1:symbol_sz - 1 + n].abs()


def pss_correlate(samples: torch.Tensor, n_id_2: int, symbol_sz: int) -> torch.Tensor:
    """Normalised matched-filter output (..., N) via FFT convolution.

    Output index n = correlation of the replica with samples[n : n+symbol_sz]
    (peak at the PSS symbol start).
    """
    n = samples.shape[-1]
    xf = torch.fft.fft(samples, _nfft(n, symbol_sz), dim=-1)
    win = _window_energy(samples, symbol_sz)
    return _correlate(xf, n, n_id_2, symbol_sz) / torch.sqrt(torch.clamp(win, min=1e-12))


def find_pss(samples: torch.Tensor, symbol_sz: int) -> dict:
    """Search all three N_ID_2 over a capture window.

    Returns dict(n_id_2 (B,), offset (B,), peak (B,), corr (B,3,N)).  The
    capture's FFT and window energy are computed once for the three
    hypotheses.
    """
    n = samples.shape[-1]
    xf = torch.fft.fft(samples, _nfft(n, symbol_sz), dim=-1)
    norm = torch.sqrt(torch.clamp(_window_energy(samples, symbol_sz), min=1e-12))
    corr = torch.stack([_correlate(xf, n, i, symbol_sz) / norm for i in range(3)],
                       dim=-2)  # (..., 3, N)
    peak_per_id = corr.amax(dim=-1)
    off_per_id = torch.argmax(corr, dim=-1)  # the first maximum, as jnp.argmax
    n_id_2 = torch.argmax(peak_per_id, dim=-1)
    peak = torch.gather(peak_per_id, -1, n_id_2[..., None])[..., 0]
    offset = torch.gather(off_per_id, -1, n_id_2[..., None])[..., 0]
    return dict(n_id_2=n_id_2, offset=offset, peak=peak, corr=corr)


@functools.lru_cache(maxsize=8)
def _pss_replicas(symbol_sz: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.stack([pss_time_domain(i, symbol_sz) for i in range(3)]),
                           device=device)


def pss_cfo_estimate(pss_samples: torch.Tensor, n_id_2: torch.Tensor | int,
                     symbol_sz: int) -> torch.Tensor:
    """CFO from the phase between the two halves of the received PSS symbol
    (pss.c srsran_pss_cfo_compute).  Returns CFO in subcarrier units."""
    reps = _pss_replicas(symbol_sz, pss_samples.device)
    replica = reps[int(n_id_2)] if isinstance(n_id_2, (int, np.integer)) else reps[n_id_2]
    y = pss_samples * replica.conj()
    half = symbol_sz // 2
    z = torch.sum(y[..., :half].conj() * y[..., half:], dim=-1)
    return torch.angle(z) / math.pi


@functools.lru_cache(maxsize=8)
def pss_freq_refs(device: torch.device) -> torch.Tensor:
    """(3, 62) the three PSS sequences as they sit on the grid."""
    return torch.as_tensor(np.stack([pss_sequence(i) for i in range(3)]), device=device)


def pss_timing_error(pss_re: torch.Tensor, n_id_2: torch.Tensor, symbol_sz: int
                     ) -> torch.Tensor:
    """Samples by which the FFT window started before the PSS body, from the
    phase slope of the demodulated PSS across its 62 subcarriers (a port
    addition; the JAX package times by the PSS peak alone).

    A window that starts d samples early multiplies subcarrier k by
    exp(-j2π·k·d/N).  Adjacent subcarriers (on each side of DC) give d
    without ambiguity but noisily; the 31 pairs 32 subcarriers apart give it
    32 times more finely, modulo N/32 samples, and the first picks the
    period.  pss_re: (B, 62) grid REs mid-31..mid+30 (subcarriers -31..-1,
    1..31).  Returns (B,) float32, unrounded.
    """
    h = pss_re * pss_freq_refs(pss_re.device)[n_id_2].conj()
    near = (torch.sum(h[..., 1:31] * h[..., 0:30].conj(), dim=-1)
            + torch.sum(h[..., 32:62] * h[..., 31:61].conj(), dim=-1))
    far = torch.sum(h[..., 31:62] * h[..., 0:31].conj(), dim=-1)
    scale = -symbol_sz / (2 * math.pi)
    coarse, fine = torch.angle(near) * scale, torch.angle(far) * (scale / 32)
    period = symbol_sz / 32
    return fine + period * torch.round((coarse - fine) / period)


# --- CFO --------------------------------------------------------------------


def cp_cfo_estimate(cfg: OfdmConfig, samples: torch.Tensor) -> torch.Tensor:
    """CP-based CFO estimate over one subframe, in subcarrier units."""
    n = cfg.symbol_sz
    acc = torch.zeros(samples.shape[:-1], dtype=torch.complex64, device=samples.device)
    pos = 0
    for l in range(cfg.nsymb_sf):
        cp = cfg.cp_len(l % cfg.nsymb_slot)
        cp_seg = samples[..., pos:pos + cp]
        tail = samples[..., pos + n:pos + n + cp]
        acc = acc + torch.sum(cp_seg.conj() * tail, dim=-1)
        pos += cp + n
    return torch.angle(acc) / (2 * math.pi)


def cfo_correct(samples: torch.Tensor, cfo, symbol_sz: int) -> torch.Tensor:
    """Mix down by cfo (subcarrier units): x(n)·exp(-j2π·cfo·n/N).  The ramp
    is float32 arange(n)/N, as in the JAX package."""
    n = samples.shape[-1]
    dev = samples.device
    ramp = torch.arange(n, dtype=torch.float32, device=dev) / symbol_sz
    cfo = torch.as_tensor(cfo, dtype=torch.float32, device=dev)
    ph = (-2 * math.pi) * cfo[..., None] * ramp
    return samples * torch.polar(torch.ones_like(ph), ph)


# --- SSS --------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _sss_base() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The s̃, c̃, z̃ m-sequences of TS 36.211 §6.11.2.1 (length 31, ±1)."""
    def mseq(taps: list[int]) -> np.ndarray:
        x = np.zeros(31, dtype=np.int64)
        x[4] = 1
        for i in range(26):
            x[i + 5] = sum(x[i + t] for t in taps) % 2
        return 1 - 2 * x

    s = mseq([2, 0])   # x5 = x2 + x0
    c = mseq([3, 0])   # x5 = x3 + x0
    z = mseq([4, 2, 1, 0])
    return s, c, z


@functools.lru_cache(maxsize=4)
def sss_sequences() -> np.ndarray:
    """(168, 2, 62) SSS for every N_ID_1 and subframe phase (0 → sf0,
    1 → sf5), before the N_ID_2-dependent c0/c1 scrambling."""
    s, c, z = _sss_base()
    out = np.zeros((168, 2, 62), dtype=np.float32)
    n = np.arange(31)
    for nid1 in range(168):
        qp = nid1 // 30
        q = (nid1 + qp * (qp + 1) // 2) // 30
        mp = nid1 + q * (q + 1) // 2
        m0 = mp % 31
        m1 = (m0 + mp // 31 + 1) % 31
        for phase, (mm0, mm1) in enumerate(((m0, m1), (m1, m0))):
            # even: d(2n) = s_{m0}(n)·c0(n); odd: d(2n+1) = s_{m1}(n)·c1(n)·z1^{(m0)}(n),
            # c0/c1 applied per N_ID_2 at correlation time
            out[nid1, phase, 0::2] = s[(n + mm0) % 31]
            out[nid1, phase, 1::2] = s[(n + mm1) % 31] * z[(n + (mm0 % 8)) % 31]
    return out


@functools.lru_cache(maxsize=3)
def _sss_candidates(n_id_2: int) -> np.ndarray:
    """(336, 62) SSS candidates with N_ID_2's c0/c1 scrambling applied."""
    _, c, _ = _sss_base()
    n = np.arange(31)
    cand = sss_sequences().copy()
    cand[..., 0::2] *= c[(n + n_id_2) % 31].astype(np.float32)
    cand[..., 1::2] *= c[(n + n_id_2 + 3) % 31].astype(np.float32)
    return cand.reshape(336, 62)


@functools.lru_cache(maxsize=12)
def _sss_candidates_t(n_id_2: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_sss_candidates(n_id_2), device=device)


def sss_detect(sss_re: torch.Tensor, n_id_2: int) -> dict:
    """Detect N_ID_1 and frame phase from equalised SSS REs.

    Args:
      sss_re: (B, 62) equalised (or differentially coherent) SSS symbols.
      n_id_2: detected PSS index (for the c0/c1 scrambling).

    Returns dict(n_id_1 (B,), phase (B,) 0=sf0/1=sf5, corr (B, 336)).
    """
    flat = _sss_candidates_t(int(n_id_2), sss_re.device)
    corr = torch.einsum("bn,cn->bc", sss_re.real.to(torch.float32), flat)
    best = torch.argmax(corr, dim=-1)
    return dict(n_id_1=best // 2, phase=best % 2, corr=corr)


# --- fine frequency + SFO ---------------------------------------------------


def cedron_freq_estimate(x: torch.Tensor) -> torch.Tensor:
    """Cedron Dawg's exact 3-bin frequency estimator on the FFT peak
    (counterpart of `lib/src/phy/ch_estimation/cedron_freq_estimator.c`).

    x: (..., N) complex time-domain tone (+noise).  Returns the frequency in
    normalised cycles/sample (-0.5..0.5), resolved far below the bin
    spacing.
    """
    n = x.shape[-1]
    X = torch.fft.fft(x, dim=-1)
    k = torch.argmax(X.abs(), dim=-1)

    def grab(off):
        return torch.gather(X, -1, ((k + off) % n)[..., None])[..., 0]

    z1, z2, z3 = grab(-1), grab(0), grab(1)
    # f = k + real((z1 - z3) / (2 z2 - z1 - z3)) (exact for a complex tone)
    delta = ((z1 - z3) / (2.0 * z2 - z1 - z3 + 1e-12)).real
    freq = (k.to(torch.float32) + delta) / n
    return torch.where(freq > 0.5, freq - 1.0, freq)


def sfo_estimate(timing_offsets: torch.Tensor, frame_period_s: float = 0.01
                 ) -> torch.Tensor:
    """Sample-frequency-offset from the drift of per-frame timing offsets
    (sfo.c srsran_sfo_estimate): least-squares slope of offset-vs-time, in
    samples/second.

    timing_offsets: (..., T) successive PSS timing offsets in samples.
    """
    t = timing_offsets.shape[-1]
    x = torch.arange(t, dtype=torch.float32, device=timing_offsets.device) * frame_period_s
    xc = x - x.mean()
    y = timing_offsets.to(torch.float32)
    yc = y - y.mean(dim=-1, keepdim=True)
    return torch.sum(xc * yc, dim=-1) / torch.sum(xc * xc)
