"""NR DCI formats 0_0 / 1_0 pack/unpack (TS 38.212 7.3.1).

Counterpart of `lib/src/phy/phch/dci_nr.c` (srsran_dci_nr_ul_pack /
dl_pack and size alignment): fallback-format field layouts with the
frequency-domain resource assignment RIV, padded/aligned so 0_0 and
1_0 have equal size (38.212 7.3.1.0).
"""

from __future__ import annotations

from dataclasses import dataclass
from math import ceil, log2

from ..stack.asn1 import BitReader, BitWriter


def riv_encode(n_rb: int, rb_start: int, l_rbs: int) -> int:
    """38.214 5.1.2.2.2 resource indication value."""
    if l_rbs < 1 or rb_start + l_rbs > n_rb:
        raise ValueError("bad RIV allocation")
    if (l_rbs - 1) <= n_rb // 2:
        return n_rb * (l_rbs - 1) + rb_start
    return n_rb * (n_rb - l_rbs + 1) + (n_rb - 1 - rb_start)


def riv_decode(n_rb: int, riv: int) -> tuple[int, int]:
    l_rbs = riv // n_rb + 1
    rb_start = riv % n_rb
    if rb_start + l_rbs > n_rb:  # invalid under branch 1 -> branch 2
        l_rbs = n_rb - l_rbs + 2
        rb_start = n_rb - 1 - rb_start
    return rb_start, l_rbs


def _riv_bits(n_rb: int) -> int:
    return ceil(log2(n_rb * (n_rb + 1) / 2))


@dataclass
class DciNr10:
    """DL fallback format 1_0 (C-RNTI)."""
    n_rb: int
    rb_start: int = 0
    l_rbs: int = 1
    time_assign: int = 0      # 4 bits
    mcs: int = 0              # 5 bits
    ndi: int = 0
    rv: int = 0               # 2 bits
    harq_pid: int = 0         # 4 bits
    dai: int = 0              # 2 bits
    tpc: int = 0              # 2 bits
    pucch_res: int = 0        # 3 bits
    harq_timing: int = 0      # 3 bits

    def pack(self) -> bytes:
        w = BitWriter()
        w.put(1, 1)  # format indicator: 1 = DL
        w.put(riv_encode(self.n_rb, self.rb_start, self.l_rbs),
              _riv_bits(self.n_rb))
        w.put(self.time_assign, 4)
        w.put(0, 1)  # VRB-to-PRB
        w.put(self.mcs, 5)
        w.put(self.ndi, 1)
        w.put(self.rv, 2)
        w.put(self.harq_pid, 4)
        w.put(self.dai, 2)
        w.put(self.tpc, 2)
        w.put(self.pucch_res, 3)
        w.put(self.harq_timing, 3)
        return w.to_bytes()

    @classmethod
    def unpack(cls, data: bytes, n_rb: int) -> "DciNr10":
        r = BitReader(data)
        if r.get(1) != 1:
            raise ValueError("not a DL DCI")
        rb_start, l_rbs = riv_decode(n_rb, r.get(_riv_bits(n_rb)))
        time_assign = r.get(4)
        r.get(1)
        return cls(n_rb=n_rb, rb_start=rb_start, l_rbs=l_rbs,
                   time_assign=time_assign, mcs=r.get(5), ndi=r.get(1),
                   rv=r.get(2), harq_pid=r.get(4), dai=r.get(2),
                   tpc=r.get(2), pucch_res=r.get(3), harq_timing=r.get(3))

    @property
    def nof_bits(self) -> int:
        return 1 + _riv_bits(self.n_rb) + 4 + 1 + 5 + 1 + 2 + 4 + 2 + 2 + 3 + 3


@dataclass
class DciNr00:
    """UL fallback format 0_0, padded to the 1_0 size (38.212 7.3.1.0)."""
    n_rb: int
    rb_start: int = 0
    l_rbs: int = 1
    time_assign: int = 0
    freq_hop: int = 0
    mcs: int = 0
    ndi: int = 0
    rv: int = 0
    harq_pid: int = 0
    tpc: int = 0
    target_bits: int = 0   # pad to DCI 1_0 size when nonzero

    def pack(self) -> bytes:
        w = BitWriter()
        w.put(0, 1)  # format indicator: 0 = UL
        w.put(riv_encode(self.n_rb, self.rb_start, self.l_rbs),
              _riv_bits(self.n_rb))
        w.put(self.time_assign, 4)
        w.put(self.freq_hop, 1)
        w.put(self.mcs, 5)
        w.put(self.ndi, 1)
        w.put(self.rv, 2)
        w.put(self.harq_pid, 4)
        w.put(self.tpc, 2)
        used = 1 + _riv_bits(self.n_rb) + 4 + 1 + 5 + 1 + 2 + 4 + 2
        if self.target_bits > used:
            w.put(0, self.target_bits - used)
        return w.to_bytes()

    @classmethod
    def unpack(cls, data: bytes, n_rb: int) -> "DciNr00":
        r = BitReader(data)
        if r.get(1) != 0:
            raise ValueError("not an UL DCI")
        rb_start, l_rbs = riv_decode(n_rb, r.get(_riv_bits(n_rb)))
        return cls(n_rb=n_rb, rb_start=rb_start, l_rbs=l_rbs,
                   time_assign=r.get(4), freq_hop=r.get(1), mcs=r.get(5),
                   ndi=r.get(1), rv=r.get(2), harq_pid=r.get(4),
                   tpc=r.get(2))
