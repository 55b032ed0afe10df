"""CORESET#0 and Type0-PDCCH common search space (TS 38.213 §13, 38.211
§7.3.2.2 interleaved CCE-to-REG mapping), and the SIB1 PDSCH it schedules.

Port counterpart of ``srsran_4g_tpu/models/coreset0.py`` (the reference's
`srsran_coreset_zero` (phy_common_nr.c:659) +
`pdcch_nr_cce_to_reg_mapping_interleaved` (pdcch_nr.c:346)): derives the
SIB1 CORESET from the (SSB, pointA) frequency offset and a Table 13-1 index,
enumerates the Type0 CSS candidates, blind-decodes DCI 1_0 with the
38.212-exact polar chain (``ops/polar_3gpp``), and decodes the common
PDSCH through ``models/sch_nr`` (the flooded LDPC).

Where the port differs in form (the bits are the same):
- ``blind_decode_type0``: JAX walks the candidates in a Python loop, per
  CORESET symbol and per RB, with an eager demodulation each time, and
  returns at the first candidate whose CRC passes.  Here the per-RB DMRS
  estimate of the whole CORESET is one tensor op, each candidate's REs are
  gathered with index tensors built once per (CORESET, candidate list),
  and the candidates of one aggregation level (one E) are decoded in one
  batched ``polar_3gpp.dci_decode`` over every capture of the batch; the
  selection keeps JAX's rule, the first passing candidate in list order.
  ``blind_decode_type0_batch`` returns that per capture.
- ``decode_pdsch_common`` and ``nr_slot_grid`` run on a batch of slots:
  the DMRS LS estimate, its 1-2-1 smoothing, the interpolation in frequency
  and time, the -3 dB EPRE, the demodulation and descrambling are tensor
  ops; the FFT of all 14 symbols and the ``fc_hz`` phase compensation run
  on the device (JAX: numpy a symbol at a time).  The noise estimate is
  per slot (JAX's single slot: the same value).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from srsran_4g_tpu_torch.models import ra_nr, sch_nr
from srsran_4g_tpu_torch.ops import modem, polar_3gpp, sequence

NRE = 12
SSB_BW_SUBC = 240

# 38.214 Table 5.1.2.1.1-2 default PDSCH time allocation A, normal CP,
# dmrs-TypeA-Position = pos2: (mapping, S, L).  'A'/'B' per row as in
# srsran_ra_dl_nr_time_default_A (ra_dl_nr.c:68).
TIME_DEFAULT_A_POS2 = [
    ("A", 2, 12), ("A", 2, 10), ("A", 2, 9), ("A", 2, 7), ("A", 2, 5),
    ("B", 9, 4), ("B", 4, 4), ("B", 5, 7), ("B", 5, 2), ("B", 9, 2),
    ("B", 12, 2), ("A", 1, 13), ("A", 1, 6), ("A", 2, 4), ("B", 4, 7),
    ("B", 8, 4),
]

# TS 38.213 Table 13-1 ({SSB, PDCCH} SCS = {15, 15} kHz, min channel bw
# 5/10 MHz): (multiplexing pattern, CORESET PRBs, symbols, RB offset)
CORESET0_15_15 = [
    (1, 24, 2, 0), (1, 24, 2, 2), (1, 24, 2, 4),
    (1, 24, 3, 0), (1, 24, 3, 2), (1, 24, 3, 4),
    (1, 48, 1, 12), (1, 48, 1, 16),
    (1, 48, 2, 12), (1, 48, 2, 16),
    (1, 48, 3, 12), (1, 48, 3, 16),
    (1, 96, 1, 38), (1, 96, 2, 38), (1, 96, 3, 38),
    None,
]


@dataclass(frozen=True)
class Coreset0:
    nof_prb: int          # CORESET bandwidth
    duration: int         # symbols
    offset_rb: int        # first CORESET RB relative to pointA
    shift_index: int      # = PCI for CORESET#0
    # CCE-to-REG mapping: CORESET#0 is always interleaved (38.211
    # §7.3.2.2); RRC-configured CORESETs may be non-interleaved
    interleaved: bool = True


def coreset_zero(pci: int, ssb_pointa_offset_hz: float, idx: int,
                 scs_hz: float = 15e3) -> Coreset0:
    """38.213 §13 CORESET#0 derivation (srsran_coreset_zero)."""
    entry = CORESET0_15_15[idx]
    if entry is None:
        raise ValueError(f"reserved CORESET0 index {idx}")
    _, nof_prb, duration, table_offset = entry
    off = ssb_pointa_offset_hz
    half_ssb = scs_hz * (SSB_BW_SUBC / 2)
    off = off - half_ssb if off > half_ssb else 0.0
    ssb_rb = int(off // (NRE * scs_hz))
    offset_rb = max(0, ssb_rb - table_offset)
    return Coreset0(nof_prb=nof_prb, duration=duration,
                    offset_rb=offset_rb, shift_index=pci)


def interleaved_candidate_rbs(cs: Coreset0, ncce: int, l_agg: int) -> list[int]:
    """CORESET-relative RBs of a PDCCH candidate under the 38.211 §7.3.2.2
    mapping (interleaved: bundle L=6, R=2, n_shift = PCI, as CORESET#0;
    non-interleaved: f(x) = x), ascending.  The candidate occupies these
    RBs on every CORESET symbol."""
    n_reg = cs.duration * cs.nof_prb
    big_l, big_r = 6, 2
    big_c = n_reg // (big_l * big_r)
    rbs: set[int] = set()
    for j in range(ncce, ncce + l_agg):
        x = (6 * j) // big_l
        if cs.interleaved:
            r, c = x % big_r, x // big_r
            i = (r * big_c + c + cs.shift_index) % (n_reg // big_l)
        else:
            i = x
        rb0 = (i * big_l) // cs.duration
        rb1 = ((i + 1) * big_l) // cs.duration
        rbs.update(range(rb0, rb1))
    return sorted(rbs)


def type0_candidates(nof_cce: int) -> list[tuple[int, int]]:
    """(L, ncce) Type0 CSS candidates (38.213 Table 10.1-1: up to 4/2/1
    at L = 4/8/16)."""
    out = []
    for l_agg, m_max in ((4, 4), (8, 2), (16, 1)):
        for m in range(m_max):
            if (m + 1) * l_agg <= nof_cce:
                out.append((l_agg, m * l_agg))
    return out


def css_candidates(nof_cce: int) -> list[tuple[int, int]]:
    """(L, ncce) common-search-space candidates, largest L first: Y=0,
    M = min(nof_cce/L, 8) per level (38.213 §10.1;
    srsran_pdcch_nr_locations_coreset / max_candidates_coreset,
    pdcch_nr.c:133)."""
    out = []
    for l_agg in (16, 8, 4, 2, 1):
        if l_agg > nof_cce:
            continue
        m_max = min(nof_cce // l_agg, 8)
        for m in range(m_max):
            ncce = l_agg * ((m * nof_cce // (l_agg * m_max))
                            % (nof_cce // l_agg))
            out.append((l_agg, ncce))
    return out


def _pdcch_dmrs(pci: int, slot: int, sym: int, nof_prb: int) -> np.ndarray:
    """(3·nof_prb,) PDCCH DMRS referenced from the CORESET's first RB
    (38.211 §7.4.1.3.2: CORESET#0 reference point is its lowest RB)."""
    cinit = ((1 << 17) * (14 * slot + sym + 1) * (2 * pci + 1)
             + 2 * pci) % (1 << 31)
    c = sequence.gold_sequence_np(cinit, 2 * 3 * nof_prb).astype(np.float32)
    r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)
    return r.astype(np.complex64)


_DMRS_OFF = (1, 5, 9)
_DATA_OFF = tuple(o for o in range(NRE) if o not in _DMRS_OFF)


@functools.lru_cache(maxsize=32)
def _search_tables(pci: int, slot: int, cs: Coreset0, candidates: tuple,
                   device: torch.device) -> dict:
    """Per CORESET: the DMRS REs and values (d, nof_prb, 3); per aggregation
    level present in ``candidates``: (positions in the list, the data REs
    (S, n) as flat (symbol, subcarrier) indices into the slot grid, the
    (symbol, RB) of each RE's estimate, and the scrambling signs)."""
    crb = cs.offset_rb + np.arange(cs.nof_prb)
    dmrs_k = crb[:, None] * NRE + np.asarray(_DMRS_OFF)           # (nof_prb, 3)
    dms = np.stack([_pdcch_dmrs(pci, slot, l, cs.nof_prb).reshape(cs.nof_prb, 3)
                    for l in range(cs.duration)])
    levels = {}
    for pos, (l_agg, ncce) in enumerate(candidates):
        rbs = np.asarray(interleaved_candidate_rbs(cs, ncce, l_agg))
        # symbol-major over the candidate's RBs, 9 data REs an RB (k mod 4 != 1)
        sym = np.repeat(np.arange(cs.duration), len(rbs) * 9)
        rb = np.tile(np.repeat(rbs, 9), cs.duration)
        k = np.tile(((cs.offset_rb + rbs)[:, None] * NRE + np.asarray(_DATA_OFF)).reshape(-1),
                    cs.duration)
        lv = levels.setdefault(l_agg, dict(pos=[], re=[], h=[]))
        lv["pos"].append(pos)
        lv["re"].append(k)
        lv["sym"] = sym
        lv["h"].append(sym * cs.nof_prb + rb)
    out = dict(dmrs_k=torch.as_tensor(dmrs_k, device=device),
               dmrs=torch.as_tensor(dms, device=device), levels={})
    for l_agg, lv in levels.items():
        e = 2 * len(lv["sym"])
        sign = 1.0 - 2.0 * polar_3gpp.pdcch_scramble_seq(e, pci).astype(np.float32)
        out["levels"][l_agg] = dict(
            pos=lv["pos"], sym=torch.as_tensor(lv["sym"], device=device),
            k=torch.as_tensor(np.stack(lv["re"]), device=device),
            h=torch.as_tensor(np.stack(lv["h"]), device=device),
            sign=torch.as_tensor(sign, device=device))
    return out


def blind_decode_type0_batch(grid: torch.Tensor, pci: int, slot: int, cs: Coreset0,
                             rnti: int, a: int, noise_var: float = 0.05,
                             candidates: list[tuple[int, int]] | None = None) -> dict:
    """Blind-search a common search space over a batch of slot grids
    (B, 14, nre) whose RB 0 is pointA.  Returns dict(found (B,) bool,
    index (B,) the position in ``candidates`` of the first candidate whose
    CRC passes (-1 if none), bits (B, a)) as tensors, and ``candidates``.
    REs are read symbol-major over the candidate's RBs with 9 data REs per
    RB, matching the reference's pdcch_nr_cp extraction order
    (pdcch_nr.c:424-456); DMRS and its per-RB LS channel estimate are per
    CORESET symbol."""
    dev = grid.device
    b = grid.shape[0]
    if candidates is None:
        candidates = type0_candidates(cs.nof_prb * cs.duration // 6)
    tab = _search_tables(pci, slot, cs, tuple(candidates), dev)
    rows = grid[:, :cs.duration]                                      # (B, d, nre)
    h = (rows[:, :, tab["dmrs_k"]] * tab["dmrs"].conj()).mean(dim=-1)  # (B, d, nof_prb)
    h = h.reshape(b, -1)
    first = torch.full((b,), len(candidates), dtype=torch.int64, device=dev)
    bits = torch.zeros((b, a), dtype=torch.int32, device=dev)
    for lv in tab["levels"].values():
        s = lv["k"].shape[0]
        y = rows[:, lv["sym"], lv["k"]]                                # (B, S, n)
        hh = h[:, lv["h"]]
        x = y * hh.conj() / (hh.abs() ** 2 + 1e-3)
        llr = modem.demodulate_soft("qpsk", x, noise_var) * lv["sign"]
        out = polar_3gpp.dci_decode(llr.reshape(b * s, -1), a, rnti)
        ok = out["crc_ok"].reshape(b, s)
        pos = torch.as_tensor(lv["pos"], device=dev)
        cand = torch.where(ok, pos, len(candidates)).amin(dim=-1)     # earliest passing
        take = cand < first
        j = (pos[None, :] == cand[:, None]).to(torch.int64).argmax(dim=-1)
        got = out["bits"].reshape(b, s, a)[torch.arange(b, device=dev), j]
        bits = torch.where(take[:, None], got.to(torch.int32), bits)
        first = torch.minimum(first, cand)
    found = first < len(candidates)
    return dict(found=found, index=torch.where(found, first, -1), bits=bits,
                candidates=list(candidates))


def blind_decode_type0(grid: torch.Tensor, pci: int, slot: int, cs: Coreset0, rnti: int,
                       a: int, noise_var: float = 0.05,
                       candidates: list[tuple[int, int]] | None = None) -> dict | None:
    """Blind-search a common search space over one slot grid (1, 14, nre),
    as JAX: None, or dict(l_agg, ncce, bits (A,)) of the first candidate
    whose CRC passes."""
    res = blind_decode_type0_batch(grid[:1], pci, slot, cs, rnti, a, noise_var, candidates)
    i = int(res["index"][0])
    if i < 0:
        return None
    l_agg, ncce = res["candidates"][i]
    return dict(l_agg=l_agg, ncce=ncce, bits=res["bits"][0].cpu().numpy())


def dmrs_positions_type_a(ld: int, add_pos: int = 2, l0: int = 2) -> list[int]:
    """Single-symbol PDSCH DMRS symbols for mapping type A (38.211 Table
    7.4.1.1.2-3; srsran_dmrs_sch_get_symbols_idx, dmrs_sch.c:262)."""
    syms = [l0]
    if ld < 8 or add_pos == 0:
        return syms
    if ld < 10:
        syms += [7]
    elif ld < 12:
        syms += ([6, 9] if add_pos > 2 else [9])
    elif ld == 12:
        syms += {1: [9], 2: [6, 9]}.get(add_pos, [5, 8, 11])
    else:
        syms += {1: [11], 2: [7, 11]}.get(add_pos, [5, 8, 11])
    return syms


def _sch_dmrs(pci: int, slot: int, sym: int, off_prb: int, n_prb: int) -> np.ndarray:
    """(6·n_prb,) type-1 PDSCH DMRS, CDM group 0, for allocated PRBs
    [off_prb, off_prb+n_prb) relative to the sequence reference point
    (38.211 §7.4.1.1.1: c_init with n_SCID=0, N_ID = PCI)."""
    cinit = ((1 << 17) * (14 * slot + sym + 1) * (2 * pci + 1)
             + 2 * pci) % (1 << 31)
    c = sequence.gold_sequence_np(
        cinit, 2 * 6 * (off_prb + n_prb)).astype(np.float32)
    r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)
    return r[6 * off_prb:6 * (off_prb + n_prb)].astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _pdsch_tables(pci: int, slot: int, crb0: int, rb_l: int, seq_off: int,
                  dmrs_syms: tuple[int, ...], data_syms: tuple[int, ...], n_bits: int,
                  rnti: int, device: torch.device) -> dict:
    """DMRS, the frequency and time interpolation weights, and the
    scrambling signs of a common PDSCH allocation."""
    sc = np.arange(crb0 * NRE, (crb0 + rb_l) * NRE)
    comb_k = sc[::2].astype(np.float32)      # comb-2, delta 0
    full_k = sc.astype(np.float32)
    ri = np.clip(np.searchsorted(comb_k, full_k), 1, len(comb_k) - 1)
    li = ri - 1
    w = (full_k - comb_k[li]) / np.maximum(comb_k[ri] - comb_k[li], 1e-9)
    t = np.asarray(dmrs_syms, np.float32)
    tj, tw = [], []   # time interpolation: h_f[j] + (h_f[j+1] - h_f[j])·tw
    for l in data_syms:
        if l <= t[0]:
            tj.append(0), tw.append(None)
        elif l >= t[-1]:
            tj.append(len(t) - 1), tw.append(None)
        else:
            j = int(np.searchsorted(t, l) - 1)
            tj.append(j), tw.append(float((l - t[j]) / (t[j + 1] - t[j])))
    cinit = ((rnti << 15) + pci) % (1 << 31)
    scr = sequence.gold_sequence_np(cinit, n_bits).astype(np.float32)
    dmrs = np.stack([_sch_dmrs(pci, slot, l, seq_off, rb_l) for l in dmrs_syms])
    t_ = functools.partial(torch.as_tensor, device=device)
    return dict(sc=t_(sc), dmrs_k=t_(sc[::2]), dmrs=t_(dmrs), li=t_(li), ri=t_(ri),
                w=t_(w.astype(np.float32)), tj=tj, tw=tw, sign=t_(1.0 - 2.0 * scr))


def decode_pdsch_common(grid: torch.Tensor, pci: int, slot: int, rnti: int, ref_rb: int,
                        riv: int, bwp_prb: int, time_assign: int, mcs: int, rv: int = 0,
                        time_ra: tuple[int, int] | None = None,
                        dmrs_ref_rb: int | None = None, n_iter: int = 15) -> dict:
    """Decode a DCI-1_0-scheduled PDSCH from a batch of slot grids
    (B, 14, nre) that carry the same grant.

    Counterpart of srsran_ra_dl_dci_to_grant_nr (ra_nr.c) +
    srsran_ue_dl_nr_decode_pdsch for the common-search-space case:
    frequency type-1 RIV over `bwp_prb` PRBs referenced at carrier RB
    `ref_rb` (= CORESET0's lowest RB for SI/RA/Type0-CSS grants, 38.214
    §5.1.2.2.2), default time allocation table A with typeA_pos=2 (or an
    explicit `time_ra` = (S, L) override), 38.214 §5.1.3 MCS/TBS,
    single-symbol type-1 DMRS with 2 CDM groups without data (-3 dB
    data/DMRS EPRE).  Returns dict(bits (B, tbs), crc_ok (B,)) as tensors,
    and tbs, rb, syms, mod as JAX does."""
    rb_s, rb_l = ra_nr.sliv_decode(bwp_prb, riv)
    if time_ra is not None:
        s_sym, l_sym = time_ra
    else:
        _, s_sym, l_sym = TIME_DEFAULT_A_POS2[time_assign]
    ld = s_sym + l_sym  # mapping type A: duration from symbol 0
    dmrs_syms = dmrs_positions_type_a(ld)
    qm, r_target = ra_nr.mcs_to_qm_r(mcs)
    mod = {2: "qpsk", 4: "16qam", 6: "64qam", 8: "256qam"}[qm]
    tbs = ra_nr.tbs(rb_l, mcs, nof_symb=l_sym, nof_dmrs_re=12 * len(dmrs_syms))
    data_syms = [l for l in range(s_sym, s_sym + l_sym) if l not in dmrs_syms]
    crb0 = ref_rb + rb_s       # first allocated carrier RB
    # DMRS sequence reference point: CORESET start for SI-RNTI grants, CRB0
    # otherwise (38.211 §7.4.1.1.2; ra_nr.c:660-667)
    seq_off = crb0 - (ref_rb if dmrs_ref_rb is None else dmrs_ref_rb)
    n_bits = len(data_syms) * rb_l * NRE * qm
    tab = _pdsch_tables(pci, slot, crb0, rb_l, seq_off, tuple(dmrs_syms), tuple(data_syms),
                        n_bits, rnti, grid.device)
    b = grid.shape[0]
    # LS estimate per DMRS symbol on the comb, 1-2-1 smoothing (edges
    # repeated), linear interpolation to the full band
    h_raw = grid[:, dmrs_syms][..., tab["dmrs_k"]] * tab["dmrs"].conj()
    hp = torch.cat([h_raw[..., :1], h_raw, h_raw[..., -1:]], dim=-1)
    h_p = 0.25 * hp[..., :-2] + 0.5 * hp[..., 1:-1] + 0.25 * hp[..., 2:]
    nv = ((h_raw - h_p).abs() ** 2).reshape(b, -1).mean(dim=-1) / 0.375      # (B,)
    h_f = (1 - tab["w"]) * h_p[..., tab["li"]] + tab["w"] * h_p[..., tab["ri"]]
    h_t = torch.stack([
        h_f[:, j] if tw is None else h_f[:, j] + (h_f[:, j + 1] - h_f[:, j]) * tw
        for j, tw in zip(tab["tj"], tab["tw"])], dim=1)
    # 2 CDM groups without data -> data EPRE is -3 dB vs DMRS (38.214 4.1)
    h_t = h_t / math.sqrt(2)
    y = grid[:, data_syms][..., tab["sc"]]                     # (B, n_data, 12·rb_l)
    x = (y * h_t.conj() / (h_t.abs() ** 2 + nv[:, None, None])).reshape(b, -1)
    llr = modem.demodulate_soft(mod, x.to(torch.complex64), nv.clamp(min=1e-4)[:, None])
    llr = llr * tab["sign"]
    seg = sch_nr.nr_segment(tbs, llr.shape[-1], qm, rv, target_rate=r_target)
    bits, ok, _ = sch_nr.decode(seg, llr, n_iter=n_iter)
    return dict(bits=bits, crc_ok=ok, tbs=tbs, rb=(rb_s, rb_l), syms=(s_sym, l_sym), mod=mod)


@functools.lru_cache(maxsize=16)
def _slot_tables(nof_prb: int, symbol_sz: int, fc_hz: float, slot: int,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(14, symbol_sz) body sample index of every symbol, and the per-symbol
    phase compensation e^{j2π f_c t_l} (t_l from the start of the frame)."""
    cp0 = symbol_sz * 160 // 2048
    cp = symbol_sz * 144 // 2048
    fs = symbol_sz * 15e3
    t_off = slot * (14 * symbol_sz + 2 * cp0 + 12 * cp)
    starts, pos = [], 0
    for l in range(14):
        pos += cp0 if l in (0, 7) else cp
        starts.append(pos)
        pos += symbol_sz
    starts = np.asarray(starts)
    idx = torch.as_tensor(starts[:, None] + np.arange(symbol_sz)[None, :], device=device)
    if not fc_hz:
        return idx, None
    ph = np.exp(2j * np.pi * fc_hz * ((starts + t_off) / fs))
    return idx, torch.as_tensor(ph.astype(np.complex64)[:, None], device=device)


def nr_slot_grid(samples: torch.Tensor, nof_prb: int, symbol_sz: int, fc_hz: float = 0.0,
                 slot: int = 0) -> torch.Tensor:
    """15 kHz NR slots (LTE-equal CP structure) → grids (B, 14, nof_prb·12).

    ``samples``: (L,) one slot → (1, 14, nre), as JAX; or (B, L), a batch of
    slots.  `fc_hz` undoes the 38.211 §5.4 upconversion phase compensation
    the transmitter applied per symbol (e^{-j2π f_c t_l}, t_l = post-CP
    symbol start); `slot` only offsets the phase-compensation time reference
    (t_l is counted from the start of the radio frame)."""
    x = samples if samples.dim() > 1 else samples[None]
    idx, ph = _slot_tables(nof_prb, symbol_sz, float(fc_hz), slot, x.device)
    X = torch.fft.fft(x[..., idx], dim=-1) / math.sqrt(symbol_sz)
    if ph is not None:
        X = X * ph
    nre = nof_prb * NRE
    return torch.cat([X[..., -(nre // 2):], X[..., :nre // 2]], dim=-1).to(torch.complex64)
