"""UE NR MAC entity: HARQ entities, proc_ra_nr, BSR/SR, mux/demux.

Counterpart of the reference's `srsue/src/stack/mac_nr/` (mac_nr.cc,
proc_ra_nr.cc, proc_bsr_nr.cc, proc_sr_nr.cc, ul_harq_nr.cc,
dl_harq_nr.cc, mux_nr.cc, demux_nr.cc): the class the NR PHY hands
grants and decoded transport blocks to.  Differences from the LTE
entity (`stack/ue_mac.py`):

- 16 asynchronous HARQ processes in both directions (the DCI carries
  the process id — no synchronous timing rule like LTE UL).
- NR MAC subPDU format (R|F|LCID + 8/16-bit L) via `mac_pdu_nr`.
- Contention resolution by the UE Contention Resolution Identity CE
  (LCID 62) matching the transmitted msg3 CCCH SDU prefix, or by a
  C-RNTI-addressed PDCCH when msg3 carried the C-RNTI CE (38.321 §5.1.5).
- BSR CEs use the NR 8-bit (short, LCID 61) / per-LCG (long, LCID 62)
  formats.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from . import mac_pdu_nr as MAC

N_HARQ_NR = 16

# NR buffer-size table subset (38.321 Table 6.1.3.1-1, 5-bit short BSR):
# index i covers <= _BSR_NR[i] bytes; 31 = "more than the table".
_BSR_NR = [0, 10, 14, 20, 28, 38, 53, 74, 102, 142, 198, 276, 384, 535,
           745, 1038, 1446, 2014, 2806, 3909, 5446, 7587, 10570, 14726,
           20516, 28581, 39818, 55474, 77284, 107669, 150000, 1 << 30]


def bsr_index_nr(nof_bytes: int) -> int:
    for i, ub in enumerate(_BSR_NR):
        if nof_bytes <= ub:
            return i
    return 31


@dataclass
class DlGrantNr:
    rnti: int
    pid: int
    tbs: int          # bytes
    ndi: bool
    rv: int = 0


@dataclass
class UlGrantNr:
    rnti: int
    pid: int
    tbs: int          # bytes
    ndi: bool
    rv: int = 0
    is_msg3: bool = False


@dataclass
class _ProcNr:
    ndi: Optional[bool] = None
    pdu: Optional[bytes] = None
    n_tx: int = 0


class DlHarqNr:
    """16-process DL HARQ (dl_harq_nr.cc): ndi toggle = new transmission."""

    def __init__(self) -> None:
        self.procs = [_ProcNr() for _ in range(N_HARQ_NR)]

    def new_grant(self, g: DlGrantNr) -> bool:
        """True = new transmission (deliver on decode), False = retx."""
        p = self.procs[g.pid % N_HARQ_NR]
        new_tx = p.ndi is None or p.ndi != g.ndi
        p.ndi = g.ndi
        if new_tx:
            p.n_tx = 0
        p.n_tx += 1
        return new_tx


class UlHarqNr:
    """16-process UL HARQ (ul_harq_nr.cc): stores the PDU per process for
    adaptive retransmission on an un-toggled NDI."""

    def __init__(self, max_tx: int = 5) -> None:
        self.procs = [_ProcNr() for _ in range(N_HARQ_NR)]
        self.max_tx = max_tx

    def new_grant(self, g: UlGrantNr,
                  pdu_builder: Callable[[int], bytes]) -> dict:
        p = self.procs[g.pid % N_HARQ_NR]
        new_tx = p.ndi is None or p.ndi != g.ndi or p.pdu is None
        p.ndi = g.ndi
        if new_tx:
            p.pdu = pdu_builder(g.tbs)
            p.n_tx = 1
        else:
            p.n_tx += 1
            if p.n_tx > self.max_tx:
                p.pdu = None
        return dict(pdu=p.pdu, new_tx=new_tx)


@dataclass
class LogicalChannelNr:
    lcid: int
    priority: int
    has_data: Callable[[], int]
    read_pdu: Callable[[int], Optional[bytes]]


class MuxNr:
    """UL PDU assembly by priority (mux_nr.cc) + pending CEs."""

    def __init__(self) -> None:
        self.channels: list[LogicalChannelNr] = []
        self.pending_ces: list[tuple[int, bytes]] = []

    def setup_lcid(self, ch: LogicalChannelNr) -> None:
        self.channels.append(ch)
        self.channels.sort(key=lambda c: c.priority)

    def push_ce(self, lcid: int, payload: bytes = b"") -> None:
        self.pending_ces.append((lcid, payload))

    def pdu_get(self, tbs_bytes: int) -> bytes:
        pdu = MAC.NrMacPdu()
        budget = tbs_bytes
        while self.pending_ces and budget >= 4:
            lcid, payload = self.pending_ces.pop(0)
            pdu.add_ce(lcid, payload)
            budget -= len(payload) + 1
        for ch in self.channels:
            while ch.has_data() > 0 and budget > 3:
                sdu = ch.read_pdu(budget - 3)
                if not sdu:
                    break
                pdu.add_sdu(ch.lcid, sdu)
                budget -= len(sdu) + 3
        return MAC.pack(pdu, tbs_bytes, ul=True)


class DemuxNr:
    """DL PDU → RLC routing + CE handling (demux_nr.cc)."""

    def __init__(self) -> None:
        self.sinks: dict[int, Callable[[bytes], None]] = {}
        self.contention_id: Optional[bytes] = None
        self.ta_commands: list[int] = []

    def add_rlc(self, lcid: int, sink: Callable[[bytes], None]) -> None:
        self.sinks[lcid] = sink

    def push_pdu(self, raw: bytes) -> None:
        pdu = MAC.unpack(raw)
        for sub in pdu.subpdus:
            if not sub.is_sdu:
                if sub.lcid == MAC.LCID_CON_RES:
                    self.contention_id = sub.payload
                elif sub.lcid == MAC.LCID_TA_CMD and sub.payload:
                    self.ta_commands.append(sub.payload[0])
                continue
            sink = self.sinks.get(sub.lcid)
            if sink is not None:
                sink(sub.payload)


class NrRaProc:
    """Contention-based random access FSM (proc_ra_nr.cc, 38.321 §5.1)."""

    IDLE, RAR_WAIT, MSG3_SENT, COMPLETE = range(4)

    def __init__(self, nof_preambles: int = 64, rar_window_ms: int = 10,
                 contention_timer_ms: int = 64, preamble_trans_max: int = 10,
                 rng_seed: int = 0) -> None:
        import random

        self.rng = random.Random(rng_seed)
        self.nof_preambles = nof_preambles
        self.rar_window_ms = rar_window_ms
        self.contention_timer_ms = contention_timer_ms
        self.preamble_trans_max = preamble_trans_max
        self.state = self.IDLE
        self.preamble_idx = 0
        self.preamble_tx_count = 0
        self.timer = 0
        self.temp_crnti = 0
        self.crnti = 0
        self.ue_contention_id: bytes = b""
        self.has_crnti = False     # C-RNTI CE path (reestablishment RA)

    def start(self, contention_id: bytes, crnti: int = 0) -> int:
        self.ue_contention_id = contention_id
        self.crnti = crnti
        self.has_crnti = crnti != 0
        self.preamble_tx_count = 0
        return self._send_preamble()

    def _send_preamble(self) -> int:
        self.preamble_idx = self.rng.randrange(self.nof_preambles)
        self.preamble_tx_count += 1
        self.state = self.RAR_WAIT
        self.timer = 0
        return self.preamble_idx

    def tick(self, ms: int = 1) -> Optional[int]:
        if self.state == self.RAR_WAIT:
            self.timer += ms
            if self.timer > self.rar_window_ms:
                return self._retry()
        elif self.state == self.MSG3_SENT:
            self.timer += ms
            if self.timer > self.contention_timer_ms:
                return self._retry()
        return None

    def _retry(self) -> Optional[int]:
        if self.preamble_tx_count >= self.preamble_trans_max:
            self.state = self.IDLE
            return None
        return self._send_preamble()

    def rar_received(self, rar: MAC.NrRarGrant) -> bool:
        if self.state != self.RAR_WAIT or rar.rapid != self.preamble_idx:
            return False
        self.temp_crnti = rar.tc_rnti
        self.state = self.MSG3_SENT
        self.timer = 0
        return True

    def contention_resolution(self, ce_id: bytes) -> bool:
        """Msg4 con-res CE check (38.321 §5.1.5)."""
        if self.state != self.MSG3_SENT:
            return False
        if ce_id[:len(self.ue_contention_id)] == self.ue_contention_id:
            self.crnti = self.temp_crnti
            self.state = self.COMPLETE
            return True
        self._retry()
        return False

    def pdcch_crnti_addressed(self) -> bool:
        """C-RNTI CE path: a PDCCH addressed to the C-RNTI after msg3
        completes the RA (38.321 §5.1.5 b)."""
        if self.state == self.MSG3_SENT and self.has_crnti:
            self.state = self.COMPLETE
            return True
        return False

    def is_complete(self) -> bool:
        return self.state == self.COMPLETE


class BsrProcNr:
    """Regular/padding BSR (proc_bsr_nr.cc, short format only)."""

    def __init__(self, mux: MuxNr) -> None:
        self.mux = mux
        self.buffer_fn: Callable[[], int] = lambda: 0

    def generate(self) -> None:
        n = self.buffer_fn()
        if n > 0:
            self.mux.push_ce(MAC.LCID_SHORT_BSR, bytes([bsr_index_nr(n)]))


class UeMacNr:
    """The NR MAC entity (mac_nr.cc): PHY-facing surface + procedures."""

    def __init__(self, contention_id: bytes = b"\x00" * 6,
                 rng_seed: int = 0) -> None:
        self.demux = DemuxNr()
        self.mux = MuxNr()
        self.dl_harq = DlHarqNr()
        self.ul_harq = UlHarqNr()
        self.ra = NrRaProc(rng_seed=rng_seed)
        self.bsr = BsrProcNr(self.mux)
        self.contention_id = contention_id
        self.sr_pending = False
        self.metrics = {"dl_ok": 0, "dl_ko": 0, "ul_tx": 0, "ul_retx": 0}

    # -- PHY surface --------------------------------------------------------

    def new_grant_dl(self, g: DlGrantNr) -> bool:
        if self.ra.state == self.ra.MSG3_SENT and self.ra.has_crnti:
            self.ra.pdcch_crnti_addressed()
        return self.dl_harq.new_grant(g)

    def tb_decoded(self, g: DlGrantNr, payload: Optional[bytes]) -> None:
        ok = payload is not None
        self.metrics["dl_ok" if ok else "dl_ko"] += 1
        if not ok:
            return
        self.demux.push_pdu(payload)
        if self.demux.contention_id is not None and not self.ra.is_complete():
            self.ra.contention_resolution(self.demux.contention_id)
            self.demux.contention_id = None

    def new_grant_ul(self, g: UlGrantNr) -> dict:
        def build(tbs_bytes: int) -> bytes:
            if g.is_msg3 and self.ra.has_crnti:
                self.mux.push_ce(MAC.LCID_C_RNTI,
                                 self.ra.crnti.to_bytes(2, "big"))
            self.bsr.generate()
            pdu = self.mux.pdu_get(tbs_bytes)
            if g.is_msg3:
                # 38.321 §5.1.5: the contention-resolution identity is
                # the first 48 bits of the transmitted msg3 CCCH SDU
                for sub in MAC.unpack(pdu, ul=True).subpdus:
                    if sub.is_sdu and sub.lcid == MAC.LCID_CCCH:
                        self.ra.ue_contention_id = \
                            sub.payload[:6].ljust(6, b"\0")
                        break
            return pdu

        out = self.ul_harq.new_grant(g, build)
        self.metrics["ul_tx" if out["new_tx"] else "ul_retx"] += 1
        self.sr_pending = False
        return out

    def has_ul_data(self) -> bool:
        return any(c.has_data() > 0 for c in self.mux.channels) \
            or bool(self.mux.pending_ces)

    def tick(self, ms: int = 1) -> Optional[int]:
        """Returns a preamble index if the RA procedure fires a retry."""
        return self.ra.tick(ms)
