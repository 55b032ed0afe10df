"""PRACH: random-access preamble generation and detection, TS 36.211 §5.7.

Port counterpart of ``srsran_4g_tpu/models/prach.py`` (the reference's
`lib/src/phy/phch/prach.c`: ZC preamble generation with logical→physical
root mapping and cyclic-shift planning, and the FFT-correlation detector
the eNB runs in its prach_worker thread pool), with ``prach_tables.npz``
copied from the JAX package.

Format 0: N_zc = 839, Δf_RA = 1.25 kHz, T_seq = 0.8 ms ⇒ the sequence
occupies 12·symbol_sz samples at the LTE sample rate, CP of
3168·(symbol_sz/2048) samples.

Detection runs in the PRACH frequency domain: one FFT of the received
window, a gather of the 839 PRACH bins, products with the conjugated root
sequences (batched over roots), one zero-padded inverse FFT back.  The JAX
package then loops over the 64 preambles in Python, each with a gather and
an argmax; here one gather of the (64, width) windows of every capture gives
all maxima and delays at once (the first maximum, as jnp.argmax).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device

_NPZ = os.path.join(os.path.dirname(__file__), "..", "utils", "prach_tables.npz")
N_ZC = 839


@functools.lru_cache(maxsize=1)
def _tables():
    with np.load(os.path.abspath(_NPZ)) as z:
        return {k: z[k] for k in z.files}


@dataclass(frozen=True)
class PrachConfig:
    symbol_sz: int  # system FFT size (128..2048)
    root_seq_index: int  # RACH_ROOT_SEQUENCE (logical index)
    zero_corr_zone: int = 1  # zeroCorrelationZoneConfig (unrestricted)
    n_prb_offset: int = 0  # prach-FreqOffset
    format: int = 0
    # NR mode (reference `prach.c` `is_nr`): the long format-0 preamble is
    # bit-identical between LTE and NR at mu=0; the flag selects the NR
    # RACH-occasion tables (prach_nr_tti_opportunity below) instead of the
    # LTE prach-ConfigIndex timing.
    is_nr: bool = False

    @property
    def n_cs(self) -> int:
        return int(_tables()["ncs_unrestricted"][self.zero_corr_zone])

    @property
    def seq_len_samples(self) -> int:
        return 12 * self.symbol_sz  # 0.8 ms at the system rate

    @property
    def cp_len(self) -> int:
        return 3168 * self.symbol_sz // 2048

    @property
    def shifts_per_root(self) -> int:
        return N_ZC // self.n_cs if self.n_cs else 1

    def preamble_plan(self) -> list[tuple[int, int]]:
        """(root u, cyclic shift) for preamble indices 0..63 (unrestricted
        sets, TS 36.211 §5.7.2)."""
        t = _tables()
        out = []
        i_root = 0
        while len(out) < 64:
            u = int(t["logical_to_root"][(self.root_seq_index + i_root) % 838])
            for v in range(self.shifts_per_root):
                out.append((u, v * self.n_cs))
                if len(out) == 64:
                    break
            i_root += 1
        return out


# ---------------------------------------------------------------------------
# NR PRACH (TS 38.211 §6.3.3): the reference reuses the same ZC-839 long
# preamble engine for NR (`prach.c` `is_nr`, `prach_tables.h:450-482`); what is
# NR-specific is the RACH occasion timing, from TS 38.211 Tables 6.3.3.2-2
# (FR1 paired spectrum) and 6.3.3.2-3 (FR1 unpaired), all long format 0 rows —
# exactly the subset the reference ships (`srsran_prach_nr_tti_opportunity_
# fr1_{paired,unpaired}`, `prach.c:308-430`).


@dataclass(frozen=True)
class PrachNrCfg:
    """One row of TS 38.211 Table 6.3.3.2-2/-3 (format-0 subset)."""

    preamble_format: int
    x: int                    # SFN period
    y: int                    # SFN offset: occasion iff sfn % x == y
    subframes: tuple[int, ...]
    starting_symbol: int = 0


# TS 38.211 Table 6.3.3.2-2 — FR1 paired spectrum, config indices 0..27.
PRACH_NR_FR1_PAIRED: tuple[PrachNrCfg, ...] = tuple(
    PrachNrCfg(0, x, y, sf, sym) for (x, y, sf, sym) in [
        (16, 1, (1,), 0), (16, 1, (4,), 0), (16, 1, (7,), 0), (16, 1, (9,), 0),
        (8, 1, (1,), 0), (8, 1, (4,), 0), (8, 1, (7,), 0), (8, 1, (9,), 0),
        (4, 1, (1,), 0), (4, 1, (4,), 0), (4, 1, (7,), 0), (4, 1, (9,), 0),
        (2, 1, (1,), 0), (2, 1, (4,), 0), (2, 1, (7,), 0), (2, 1, (9,), 0),
        (1, 0, (1,), 0), (1, 0, (4,), 0), (1, 0, (7,), 0),
        (1, 0, (1, 6), 0), (1, 0, (2, 7), 0), (1, 0, (3, 8), 0),
        (1, 0, (1, 4, 7), 0), (1, 0, (2, 5, 8), 0), (1, 0, (3, 6, 9), 0),
        (1, 0, (0, 2, 4, 6, 8), 0), (1, 0, (1, 3, 5, 7, 9), 0),
        (1, 0, (0, 1, 2, 3, 4, 5, 6, 7, 8, 9), 0),
    ]
)

# TS 38.211 Table 6.3.3.2-3 — FR1 unpaired spectrum, config indices 0..27.
PRACH_NR_FR1_UNPAIRED: tuple[PrachNrCfg, ...] = tuple(
    PrachNrCfg(0, x, y, sf, sym) for (x, y, sf, sym) in [
        (16, 1, (9,), 0), (8, 1, (9,), 0), (4, 1, (9,), 0),
        (2, 0, (9,), 0), (2, 1, (9,), 0), (2, 0, (4,), 0), (2, 1, (4,), 0),
        (1, 0, (9,), 0), (1, 0, (8,), 0), (1, 0, (7,), 0), (1, 0, (6,), 0),
        (1, 0, (5,), 0), (1, 0, (4,), 0), (1, 0, (3,), 0), (1, 0, (2,), 0),
        (1, 0, (1, 6), 0), (1, 0, (1, 6), 7), (1, 0, (4, 9), 0),
        (1, 0, (3, 8), 0), (1, 0, (2, 7), 0), (1, 0, (8, 9), 0),
        (1, 0, (4, 8, 9), 0), (1, 0, (3, 4, 9), 0), (1, 0, (7, 8, 9), 0),
        (1, 0, (3, 4, 8, 9), 0), (1, 0, (6, 7, 8, 9), 0),
        (1, 0, (1, 4, 6, 9), 0), (1, 0, (1, 3, 5, 7, 9), 0),
    ]
)


def prach_nr_cfg(config_idx: int, paired: bool = True) -> PrachNrCfg:
    table = PRACH_NR_FR1_PAIRED if paired else PRACH_NR_FR1_UNPAIRED
    if not 0 <= config_idx < len(table):
        raise ValueError(f"invalid NR PRACH config index {config_idx}")
    return table[config_idx]


def prach_nr_tti_opportunity(config_idx: int, tti: int,
                             paired: bool = True) -> bool:
    """True iff `tti` (sfn*10 + subframe) is a RACH occasion.

    Mirror of `srsran_prach_nr_tti_opportunity_fr1_{paired,unpaired}`
    (reference `prach.c:308,368`).
    """
    cfg = prach_nr_cfg(config_idx, paired)
    sfn, sf_idx = divmod(tti, 10)
    return sfn % cfg.x == cfg.y and sf_idx in cfg.subframes


def prach_nr_start_symbol(config_idx: int, paired: bool = True) -> int:
    """Mirror of `srsran_prach_nr_start_symbol` (`prach.c:407`)."""
    return prach_nr_cfg(config_idx, paired).starting_symbol


@functools.lru_cache(maxsize=64)
def _root_seq_freq(u: int) -> np.ndarray:
    """ZC root sequence — the preamble is DEFINED in the frequency domain as
    x_u(n) = exp(-jπun(n+1)/839) mapped to consecutive PRACH bins."""
    n = np.arange(N_ZC)
    return np.exp(-1j * np.pi * u * n * (n + 1) / N_ZC).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _bin0(cfg: PrachConfig) -> int:
    """First PRACH frequency bin (Δf_RA units) inside the big IFFT.

    The preamble sits in 6 PRBs starting at n_prb_offset, with the φ=7
    half-carrier guard of TS 36.211 §5.7.3.
    """
    return 12 * 12 * cfg.n_prb_offset + 7


@functools.lru_cache(maxsize=128)
def _preamble_np(cfg: PrachConfig, preamble_idx: int) -> np.ndarray:
    u, shift = cfg.preamble_plan()[preamble_idx]
    seq = _root_seq_freq(u)
    if shift:
        n = np.arange(N_ZC)
        seq = seq * np.exp(2j * np.pi * shift * n / N_ZC)
    nfft = cfg.seq_len_samples
    freq = np.zeros(nfft, dtype=np.complex64)
    b0 = _bin0(cfg)
    freq[b0:b0 + N_ZC] = seq
    t = np.fft.ifft(freq).astype(np.complex64) * np.sqrt(nfft / N_ZC)
    return np.concatenate([t[-cfg.cp_len:], t]).astype(np.complex64)


def generate(cfg: PrachConfig, preamble_idx: int,
             device: torch.device | str | None = None) -> torch.Tensor:
    """Time-domain preamble (CP + sequence) at the system sample rate, on
    ``device`` (default CUDA); the waveform is a host table, cached."""
    return torch.as_tensor(_preamble_np(cfg, preamble_idx), device=resolve_device(device))


NFFT_DETECT = 2048  # zero-padded IFFT size of the detector


@functools.lru_cache(maxsize=16)
def _detect_tables(cfg: PrachConfig, device: torch.device) -> dict[str, torch.Tensor]:
    """The conjugated roots (R, 839), each preamble's root row (64,) and its
    delay window's IFFT bins (64, width).

    A cyclic shift of +s (in ZC units) peaks at IFFT bin (N_zc − s)·scale; a
    propagation delay of τ ZC units moves the peak *up* by τ·scale, so
    preamble v owns the window starting at (N_zc − v·Ncs)·scale."""
    plan = cfg.preamble_plan()
    roots = sorted({u for u, _ in plan})
    scale = NFFT_DETECT / N_ZC
    width = max(int(np.floor(cfg.n_cs * scale)), 1) if cfg.n_cs else NFFT_DETECT
    lo = np.asarray([int(round(((N_ZC - shift) % N_ZC) * scale)) for _, shift in plan])
    return dict(
        roots=torch.as_tensor(np.stack([np.conj(_root_seq_freq(u)) for u in roots]),
                              device=device),
        root_of=torch.as_tensor([roots.index(u) for u, _ in plan], device=device),
        win=torch.as_tensor((lo[:, None] + np.arange(width)) % NFFT_DETECT, device=device))


def detect(cfg: PrachConfig, samples: torch.Tensor, threshold: float = 0.5) -> dict:
    """Detect preambles in a (B, cp+seq) capture aligned to the PRACH slot,
    on the capture's device.

    Returns dict(power (B, 64) normalised correlation peak per preamble,
    delay_samples (B, 64), detected (B, 64) bool).
    """
    tab = _detect_tables(cfg, samples.device)
    seq = samples[..., cfg.cp_len:cfg.cp_len + cfg.seq_len_samples]
    b0 = _bin0(cfg)
    y = torch.fft.fft(seq, dim=-1)[..., b0:b0 + N_ZC]  # (B, 839)
    corr_t = torch.fft.ifft(y[..., None, :] * tab["roots"], n=NFFT_DETECT, dim=-1)
    energy = torch.mean(y.abs() ** 2, dim=-1)[..., None, None] + 1e-12
    # normalise so a perfectly matched flat-channel preamble peaks at 1.0:
    # peak |IFFT|^2 = (N_ZC * a / nfft)^2 with per-bin energy a^2
    power = corr_t.abs() ** 2 * (NFFT_DETECT / N_ZC) ** 2 / energy  # (B, R, nfft)
    w = power[..., tab["root_of"][:, None], tab["win"]]  # (B, 64, width)
    p = w.amax(dim=-1)
    delay = torch.argmax(w, dim=-1).to(torch.float32) * (cfg.seq_len_samples / NFFT_DETECT)
    return dict(power=p, delay_samples=delay, detected=p > threshold)
