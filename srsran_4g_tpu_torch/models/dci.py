"""DCI format pack/unpack (formats 0, 1, 1A), TS 36.212 §5.3.3.1.

Port counterpart of ``srsran_4g_tpu/models/dci.py`` (the reference's
`lib/src/phy/phch/dci.c`), a copy.  Host-side bit
packing — DCI payloads are tiny control-plane data assembled per TTI; the
heavy lifting (conv coding, blind search) is in models/pdcch.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from srsran_4g_tpu_torch.models import ra


def _riv_bits(n_rb: int) -> int:
    return math.ceil(math.log2(n_rb * (n_rb + 1) / 2))


# TS 36.212 §5.3.3.1.2: payload sizes a format-0/1A-ambiguous blind decode
# could confuse (dci.c ambiguous_sizes)
_AMBIGUOUS = (12, 14, 16, 20, 24, 26, 32, 40, 44, 56)


class _BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def array(self, pad_to: int | None = None) -> np.ndarray:
        b = list(self.bits)
        if pad_to is not None:
            b += [0] * (pad_to - len(b))
        return np.asarray(b, dtype=np.int8)


class _BitReader:
    def __init__(self, bits):
        self.bits = np.asarray(bits).astype(np.int64)
        self.pos = 0

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | int(self.bits[self.pos])
            self.pos += 1
        return v


@dataclass(frozen=True)
class Dci1A:
    """Format 1A: compact contiguous DL assignment."""

    rb_start: int
    l_crbs: int
    mcs: int
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    tpc: int = 0
    distributed: bool = False


def format1a_len(n_rb: int) -> int:
    n = 1 + 1 + _riv_bits(n_rb) + 5 + 3 + 1 + 2 + 2
    # padding rules: avoid the ambiguous sizes of TS 36.212 §5.3.3.1.2
    while n in _AMBIGUOUS:
        n += 1
    return n


def pack_1a(dci: Dci1A, n_rb: int) -> np.ndarray:
    w = _BitWriter()
    w.put(1, 1)  # format 0/1A flag: 1A
    w.put(1 if dci.distributed else 0, 1)
    w.put(ra.riv_encode(n_rb, dci.l_crbs, dci.rb_start), _riv_bits(n_rb))
    w.put(dci.mcs, 5)
    w.put(dci.harq_pid, 3)
    w.put(dci.ndi, 1)
    w.put(dci.rv, 2)
    w.put(dci.tpc, 2)
    return w.array(pad_to=format1a_len(n_rb))


def unpack_1a(bits, n_rb: int) -> Dci1A:
    r = _BitReader(bits)
    flag = r.get(1)
    assert flag == 1, "not a format 1A DCI"
    distributed = bool(r.get(1))
    l_crbs, rb_start = ra.riv_decode(n_rb, r.get(_riv_bits(n_rb)))
    return Dci1A(
        rb_start=rb_start, l_crbs=l_crbs, mcs=r.get(5), harq_pid=r.get(3),
        ndi=r.get(1), rv=r.get(2), tpc=r.get(2), distributed=distributed,
    )


@dataclass(frozen=True)
class Dci1:
    """Format 1: type-0 RBG bitmap DL assignment."""

    rbg_bitmap: int
    mcs: int
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    tpc: int = 0


def format1_len(n_rb: int) -> int:
    n_rbg = -(-n_rb // ra.rbg_size(n_rb))
    n = (1 if n_rb > 10 else 0) + n_rbg + 5 + 3 + 1 + 2 + 2
    # must differ from the 0/1A length and avoid ambiguous sizes, re-checking
    # after every bump (dci.c:214-225 dci_format1_sizeof loop)
    while n == format1a_len(n_rb) or n in _AMBIGUOUS:
        n += 1
    return n


def pack_1(dci: Dci1, n_rb: int) -> np.ndarray:
    n_rbg = -(-n_rb // ra.rbg_size(n_rb))
    w = _BitWriter()
    if n_rb > 10:
        w.put(0, 1)  # resource allocation header: type 0
    w.put(dci.rbg_bitmap, n_rbg)
    w.put(dci.mcs, 5)
    w.put(dci.harq_pid, 3)
    w.put(dci.ndi, 1)
    w.put(dci.rv, 2)
    w.put(dci.tpc, 2)
    return w.array(pad_to=format1_len(n_rb))


def unpack_1(bits, n_rb: int) -> Dci1:
    n_rbg = -(-n_rb // ra.rbg_size(n_rb))
    r = _BitReader(bits)
    if n_rb > 10:
        r.get(1)
    return Dci1(
        rbg_bitmap=r.get(n_rbg), mcs=r.get(5), harq_pid=r.get(3),
        ndi=r.get(1), rv=r.get(2), tpc=r.get(2),
    )


@dataclass(frozen=True)
class Dci0:
    """Format 0: UL grant (contiguous)."""

    rb_start: int
    l_crbs: int
    mcs: int
    hopping: bool = False
    ndi: int = 0
    tpc: int = 0
    dmrs_cshift: int = 0
    cqi_request: bool = False


def pack_0(dci: Dci0, n_rb: int) -> np.ndarray:
    w = _BitWriter()
    w.put(0, 1)  # flag: format 0
    w.put(1 if dci.hopping else 0, 1)
    w.put(ra.riv_encode(n_rb, dci.l_crbs, dci.rb_start), _riv_bits(n_rb))
    w.put(dci.mcs, 5)
    w.put(dci.ndi, 1)
    w.put(dci.tpc, 2)
    w.put(dci.dmrs_cshift, 3)
    w.put(1 if dci.cqi_request else 0, 1)
    return w.array(pad_to=format1a_len(n_rb))  # 0 and 1A share one length


def unpack_0(bits, n_rb: int) -> Dci0:
    r = _BitReader(bits)
    assert r.get(1) == 0, "not a format 0 DCI"
    hopping = bool(r.get(1))
    l_crbs, rb_start = ra.riv_decode(n_rb, r.get(_riv_bits(n_rb)))
    return Dci0(
        rb_start=rb_start, l_crbs=l_crbs, mcs=r.get(5), hopping=hopping,
        ndi=r.get(1), tpc=r.get(2), dmrs_cshift=r.get(3),
        cqi_request=bool(r.get(1)),
    )


# ---------------------------------------------------------------------------
# Formats 1B / 1C / 1D: compact closed-loop-MIMO, broadcast and MU-MIMO
# assignments (TS 36.212 §5.3.3.1.3/.3A/.4; dci.c:227-307 sizeof,
# dci_format1Cs_pack:952, dci_format1D_unpack:1025)
# ---------------------------------------------------------------------------

def _tpmi_bits(nof_ports: int) -> int:
    return 2 if nof_ports <= 2 else 4


def format1b_len(n_rb: int, nof_ports: int = 2) -> int:
    """Format 1B: closed-loop rank-1 with TPMI (dci.c:248)."""
    n = 1 + _riv_bits(n_rb) + 5 + 3 + 1 + 2 + 2 + _tpmi_bits(nof_ports) + 1
    n = max(n, format1a_len(n_rb))  # pad to >= format 0 payload
    while n in _AMBIGUOUS:
        n += 1
    return n


def format1d_len(n_rb: int, nof_ports: int = 2) -> int:
    """Format 1D (MU-MIMO with power offset): same size as 1B (dci.c:294)."""
    return format1b_len(n_rb, nof_ports)


def format1c_len(n_rb: int) -> int:
    """Format 1C: very compact SI/RAR/paging assignment (dci.c:227)."""
    n_vrb = ra.type2_n_vrb_dl(n_rb, True)
    n = _riv_bits(n_vrb // ra.type2_n_rb_step(n_rb)) + 5
    if n_rb >= 50:
        n += 1  # N_gap selector
    return n


@dataclass(frozen=True)
class Dci1B:
    """Format 1B: contiguous (type 2) assignment + TPMI/PMI confirmation."""

    rb_start: int
    l_crbs: int
    mcs: int
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    tpc: int = 0
    tpmi: int = 0
    pmi_confirm: int = 0   # 1 = use the PMI from the last report
    distributed: bool = False
    ngap: int = 0


@dataclass(frozen=True)
class Dci1D(Dci1B):
    """Format 1D: as 1B but the last bit is the MU-MIMO power offset."""


def _pack_1b1d(dci, n_rb: int, nof_ports: int, total: int) -> np.ndarray:
    w = _BitWriter()
    w.put(1 if dci.distributed else 0, 1)
    nb_gap = 1 if (dci.distributed and n_rb >= 50) else 0
    if nb_gap:
        w.put(dci.ngap, 1)
    w.put(ra.riv_encode(n_rb, dci.l_crbs, dci.rb_start),
          _riv_bits(n_rb) - nb_gap)
    w.put(dci.mcs, 5)
    w.put(dci.harq_pid, 3)
    w.put(dci.ndi, 1)
    w.put(dci.rv, 2)
    w.put(dci.tpc, 2)
    w.put(dci.tpmi, _tpmi_bits(nof_ports))
    w.put(dci.pmi_confirm, 1)
    return w.array(pad_to=total)


def pack_1b(dci: Dci1B, n_rb: int, nof_ports: int = 2) -> np.ndarray:
    return _pack_1b1d(dci, n_rb, nof_ports, format1b_len(n_rb, nof_ports))


def pack_1d(dci: Dci1D, n_rb: int, nof_ports: int = 2) -> np.ndarray:
    return _pack_1b1d(dci, n_rb, nof_ports, format1d_len(n_rb, nof_ports))


def _unpack_1b1d(cls, bits, n_rb: int, nof_ports: int):
    r = _BitReader(bits)
    distributed = bool(r.get(1))
    ngap = 0
    nb_gap = 1 if (distributed and n_rb >= 50) else 0
    if nb_gap:
        ngap = r.get(1)
    l_crbs, rb_start = ra.riv_decode(n_rb, r.get(_riv_bits(n_rb) - nb_gap))
    return cls(rb_start=rb_start, l_crbs=l_crbs, mcs=r.get(5),
               harq_pid=r.get(3), ndi=r.get(1), rv=r.get(2), tpc=r.get(2),
               tpmi=r.get(_tpmi_bits(nof_ports)), pmi_confirm=r.get(1),
               distributed=distributed, ngap=ngap)


def unpack_1b(bits, n_rb: int, nof_ports: int = 2) -> Dci1B:
    return _unpack_1b1d(Dci1B, bits, n_rb, nof_ports)


def unpack_1d(bits, n_rb: int, nof_ports: int = 2) -> Dci1D:
    return _unpack_1b1d(Dci1D, bits, n_rb, nof_ports)


@dataclass(frozen=True)
class Dci1C:
    """Format 1C: distributed type-2 RIV (in N_RB_step gaps) + 5-bit I_TBS
    (MCS = TBS index directly, 36.213 §7.1.7.2; QPSK always)."""

    riv: int
    mcs: int
    ngap: int = 0


def pack_1c(dci: Dci1C, n_rb: int) -> np.ndarray:
    w = _BitWriter()
    if n_rb >= 50:
        w.put(dci.ngap, 1)
    n_vrb = ra.type2_n_vrb_dl(n_rb, dci.ngap == 0)
    w.put(dci.riv, _riv_bits(n_vrb // ra.type2_n_rb_step(n_rb)))
    w.put(dci.mcs, 5)
    return w.array(pad_to=format1c_len(n_rb))


def unpack_1c(bits, n_rb: int) -> Dci1C:
    r = _BitReader(bits)
    ngap = r.get(1) if n_rb >= 50 else 0
    n_vrb = ra.type2_n_vrb_dl(n_rb, ngap == 0)
    riv = r.get(_riv_bits(n_vrb // ra.type2_n_rb_step(n_rb)))
    return Dci1C(riv=riv, mcs=r.get(5), ngap=ngap)


def dci1c_prbs(dci: Dci1C, n_rb: int) -> tuple[int, ...]:
    """Format 1C RIV → contiguous VRB set in N_RB_step units
    (36.213 §7.1.6.3; the framework maps VRBs 1:1 onto PRBs, i.e. the
    interleaved distributed mapping of 36.211 §6.2.3.2 is not modelled —
    allocations stay contiguous as with the scheduler's other formats)."""
    step = ra.type2_n_rb_step(n_rb)
    n_vrb = ra.type2_n_vrb_dl(n_rb, dci.ngap == 0) // step
    l_step, s_step = ra.riv_decode(n_vrb, dci.riv)
    return tuple(range(s_step * step, (s_step + l_step) * step))


# ---------------------------------------------------------------------------
# Formats 2 / 2A / 2B: dual-codeword spatial multiplexing (TM4 / TM3 / TM8)
# (TS 36.212 §5.3.3.1.5/.5A/.5B; dci.c:310-360 sizeof,
# dci_format2AB_pack:1076 field order)
# ---------------------------------------------------------------------------

def _precoding_bits_f2(nof_ports: int) -> int:
    return 3 if nof_ports <= 2 else 6


def _precoding_bits_f2a(nof_ports: int) -> int:
    return 0 if nof_ports <= 2 else 2


def _format2x_len(n_rb: int, pbits: int) -> int:
    n_rbg = -(-n_rb // ra.rbg_size(n_rb))
    n = n_rbg + 2 + 3 + 1 + 2 * (5 + 1 + 2) + pbits
    if n_rb > 10:
        n += 1
    while n in _AMBIGUOUS:
        n += 1
    return n


def format2_len(n_rb: int, nof_ports: int = 2) -> int:
    return _format2x_len(n_rb, _precoding_bits_f2(nof_ports))


def format2a_len(n_rb: int, nof_ports: int = 2) -> int:
    return _format2x_len(n_rb, _precoding_bits_f2a(nof_ports))


def format2b_len(n_rb: int) -> int:
    return _format2x_len(n_rb, 0)


@dataclass(frozen=True)
class Dci2:
    """Format 2 (TM4 closed-loop spatial mux): type-0 RBG bitmap, two
    transport blocks, 3-bit precoding information.

    pinfo semantics at 2 ports (36.212 Table 5.3.3.1.5-4, two-codeword
    rows): 0 = precoding per the last reported PMI, 1..2 = rank-2
    codebook index 1..2 (mimo._CODEBOOK_2TX_R2)."""

    rbg_bitmap: int
    tpc: int = 0
    harq_pid: int = 0
    tb_swap: int = 0
    mcs0: int = 0
    ndi0: int = 0
    rv0: int = 0
    mcs1: int = 0
    ndi1: int = 0
    rv1: int = 0
    pinfo: int = 0


@dataclass(frozen=True)
class Dci2A(Dci2):
    """Format 2A (TM3 open-loop CDD): as format 2 but 0 precoding bits at
    2 ports (the CDD precoder is fixed)."""


@dataclass(frozen=True)
class Dci2B(Dci2):
    """Format 2B (TM8 dual-layer beamforming): the swap-flag position
    carries the scrambling identity instead (dci.c:1122)."""


def _pack_2x(dci, n_rb: int, pbits: int, total: int) -> np.ndarray:
    n_rbg = -(-n_rb // ra.rbg_size(n_rb))
    w = _BitWriter()
    if n_rb > 10:
        w.put(0, 1)  # resource allocation header: type 0
    w.put(dci.rbg_bitmap, n_rbg)
    w.put(dci.tpc, 2)
    w.put(dci.harq_pid, 3)
    w.put(dci.tb_swap, 1)  # (= scrambling id for 2B)
    w.put(dci.mcs0, 5)
    w.put(dci.ndi0, 1)
    w.put(dci.rv0, 2)
    w.put(dci.mcs1, 5)
    w.put(dci.ndi1, 1)
    w.put(dci.rv1, 2)
    if pbits:
        w.put(dci.pinfo, pbits)
    return w.array(pad_to=total)


def pack_2(dci: Dci2, n_rb: int, nof_ports: int = 2) -> np.ndarray:
    p = _precoding_bits_f2(nof_ports)
    return _pack_2x(dci, n_rb, p, format2_len(n_rb, nof_ports))


def pack_2a(dci: Dci2A, n_rb: int, nof_ports: int = 2) -> np.ndarray:
    p = _precoding_bits_f2a(nof_ports)
    return _pack_2x(dci, n_rb, p, format2a_len(n_rb, nof_ports))


def pack_2b(dci: Dci2B, n_rb: int) -> np.ndarray:
    return _pack_2x(dci, n_rb, 0, format2b_len(n_rb))


def _unpack_2x(cls, bits, n_rb: int, pbits: int):
    n_rbg = -(-n_rb // ra.rbg_size(n_rb))
    r = _BitReader(bits)
    if n_rb > 10:
        r.get(1)
    return cls(rbg_bitmap=r.get(n_rbg), tpc=r.get(2), harq_pid=r.get(3),
               tb_swap=r.get(1), mcs0=r.get(5), ndi0=r.get(1), rv0=r.get(2),
               mcs1=r.get(5), ndi1=r.get(1), rv1=r.get(2),
               pinfo=r.get(pbits) if pbits else 0)


def unpack_2(bits, n_rb: int, nof_ports: int = 2) -> Dci2:
    return _unpack_2x(Dci2, bits, n_rb, _precoding_bits_f2(nof_ports))


def unpack_2a(bits, n_rb: int, nof_ports: int = 2) -> Dci2A:
    return _unpack_2x(Dci2A, bits, n_rb, _precoding_bits_f2a(nof_ports))


def unpack_2b(bits, n_rb: int) -> Dci2B:
    return _unpack_2x(Dci2B, bits, n_rb, 0)
