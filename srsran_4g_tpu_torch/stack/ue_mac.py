"""UE-side MAC: HARQ entities, mux/demux, and the RA/BSR/PHR/SR procedures.

TPU-native re-design of the reference UE MAC (TS 36.321 behavior):
reference call paths `srsue/src/stack/mac/mac.cc` (tb_decoded :370),
`dl_harq.cc` / `ul_harq.cc` (8-process HARQ entities),
`demux.cc` (MAC PDU -> RLC routing), `mux.cc` (logical-channel
prioritization), `proc_ra.cc` (RA FSM), `proc_bsr.cc`, `proc_phr.cc`,
`proc_sr.cc`.

Unlike the reference's thread-and-callback design, this MAC is a plain
synchronous actor: the PHY-facing surface is `new_grant_dl` /
`tb_decoded` / `new_grant_ul` / `get_ul_pdu`, driven once per TTI by
the owning stack loop.  Soft-combining state lives on-device in the
PHY's HARQ softbuffers (srsran_4g_tpu_torch.models.sch); MAC only tracks the
NDI/rv bookkeeping that decides whether those buffers are reset.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from . import mac_pdu

# ---------------------------------------------------------------------------
# constants (TS 36.321)

NOF_HARQ_PROC = 8
MAX_RAR_WINDOW = 10

# Table 6.1.3.1-1: buffer size levels (bytes) for 6-bit BSR index.
# Index i covers sizes <= BSR_TABLE[i] (index 0 == 0 bytes, 63 > 150 kB).
BSR_TABLE = [
    0, 10, 12, 14, 17, 19, 22, 26, 31, 36, 42, 49, 57, 67, 78, 91,
    107, 125, 146, 171, 200, 234, 274, 321, 376, 440, 515, 603, 706,
    826, 967, 1132, 1326, 1552, 1817, 2127, 2490, 2915, 3413, 3995,
    4677, 5476, 6411, 7505, 8787, 10287, 12043, 14099, 16507, 19325,
    22624, 26487, 31009, 36304, 42502, 49759, 58255, 68201, 79846,
    93479, 109439, 128125, 150000,
]

# Logical channel IDs (TS 36.321 Table 6.2.1-1/2) — shared with mac_pdu
CCCH_LCID = mac_pdu.LCID_CCCH
CRNTI_CE = mac_pdu.LCID_CRNTI
TRUNC_BSR_CE = mac_pdu.LCID_TRUNC_BSR
SHORT_BSR_CE = mac_pdu.LCID_SHORT_BSR
LONG_BSR_CE = mac_pdu.LCID_LONG_BSR
PHR_CE = mac_pdu.LCID_PHR


def buff_size_index(nof_bytes: int) -> int:
    """6-bit BSR buffer-size index (pdu.cc:982 buff_size_table)."""
    if nof_bytes == 0:
        return 0
    if nof_bytes > BSR_TABLE[-1]:
        return 63
    for i, ub in enumerate(BSR_TABLE):
        if nof_bytes <= ub:
            return i
    return 63


def phr_index(ph_db: float) -> int:
    """6-bit PHR field: PH = -23..40 dB mapped to 0..63 (36.133 9.1.8.4)."""
    return max(0, min(63, int(round(ph_db + 23))))


# ---------------------------------------------------------------------------
# grants (the FAPI-ish structs PHY hands to MAC)


@dataclass
class DlMacGrant:
    rnti: int
    pid: int
    tbs: int          # bytes
    ndi: bool
    rv: int = 0
    tti: int = 0


@dataclass
class UlMacGrant:
    rnti: int
    pid: int
    tbs: int          # bytes
    ndi: bool
    rv: int = 0
    tti: int = 0
    is_rar: bool = False


# ---------------------------------------------------------------------------
# DL HARQ entity (dl_harq.cc)


@dataclass
class _DlProc:
    ndi: Optional[bool] = None
    tbs: int = 0
    decoded_ok: bool = False


class DlHarqEntity:
    """8-process DL HARQ.  Decides new-tx vs combine from the NDI toggle
    and deduplicates already-ACKed TBs (dl_harq.cc new_grant_dl)."""

    def __init__(self) -> None:
        self.proc = [_DlProc() for _ in range(NOF_HARQ_PROC)]
        self.ndi_toggles = 0

    def new_grant(self, g: DlMacGrant) -> dict:
        """Returns action: {'decode': bool, 'reset_softbuffer': bool}."""
        p = self.proc[g.pid % NOF_HARQ_PROC]
        new_tx = p.ndi is None or g.ndi != p.ndi or g.tbs != p.tbs
        if new_tx:
            self.ndi_toggles += 1
            p.ndi, p.tbs, p.decoded_ok = g.ndi, g.tbs, False
            return {"decode": True, "reset_softbuffer": True}
        if p.decoded_ok:
            # retx of an already decoded TB: ACK again, don't re-deliver
            return {"decode": False, "reset_softbuffer": False}
        return {"decode": True, "reset_softbuffer": False}

    def tb_decoded(self, pid: int, ok: bool) -> bool:
        """Record decode result; returns True if the TB should be
        delivered up (first successful decode only)."""
        p = self.proc[pid % NOF_HARQ_PROC]
        if ok and not p.decoded_ok:
            p.decoded_ok = True
            return True
        return False

    def reset(self) -> None:
        self.proc = [_DlProc() for _ in range(NOF_HARQ_PROC)]


# ---------------------------------------------------------------------------
# UL HARQ entity (ul_harq.cc)

RV_SEQ = (0, 2, 3, 1)


@dataclass
class _UlProc:
    ndi: Optional[bool] = None
    nof_retx: int = 0
    pdu: Optional[bytes] = None
    is_msg3: bool = False


class UlHarqEntity:
    def __init__(self, max_harq_tx: int = 5) -> None:
        self.proc = [_UlProc() for _ in range(NOF_HARQ_PROC)]
        self.max_harq_tx = max_harq_tx
        self.dropped = 0

    def new_grant(self, g: UlMacGrant, pdu_builder: Callable[[int], bytes]) -> dict:
        """On a new-tx grant, build a fresh PDU via pdu_builder(tbs);
        on retx, re-send the buffered PDU with the next rv.
        Returns {'pdu': bytes|None, 'rv': int, 'new_tx': bool}."""
        p = self.proc[g.pid % NOF_HARQ_PROC]
        new_tx = p.ndi is None or g.ndi != p.ndi
        if new_tx:
            p.ndi, p.nof_retx = g.ndi, 0
            p.pdu = pdu_builder(g.tbs)
            p.is_msg3 = g.is_rar
            return {"pdu": p.pdu, "rv": 0, "new_tx": True}
        # adaptive retx: rv from grant; non-adaptive: rv sequence
        p.nof_retx += 1
        if p.nof_retx >= self.max_harq_tx:
            self.dropped += 1
            p.pdu = None
            return {"pdu": None, "rv": 0, "new_tx": False}
        rv = g.rv if g.rv else RV_SEQ[p.nof_retx % 4]
        return {"pdu": p.pdu, "rv": rv, "new_tx": False}

    def ack(self, pid: int, ack: bool) -> None:
        if ack:
            self.proc[pid % NOF_HARQ_PROC].pdu = None

    def reset(self) -> None:
        self.proc = [_UlProc() for _ in range(NOF_HARQ_PROC)]


# ---------------------------------------------------------------------------
# demux (demux.cc): MAC PDU -> RLC/CE routing


class Demux:
    def __init__(self) -> None:
        self.rlc_sinks: dict[int, Callable[[bytes], None]] = {}
        self.bcch_sink: Optional[Callable[[bytes], None]] = None
        self.pcch_sink: Optional[Callable[[bytes], None]] = None
        self.ta_cmds: list[int] = []
        self.contention_id: Optional[bytes] = None
        self.active_scells: set[int] = set()
        self.malformed = 0

    def add_rlc(self, lcid: int, sink: Callable[[bytes], None]) -> None:
        self.rlc_sinks[lcid] = sink

    def push_bcch(self, payload: bytes) -> None:
        if self.bcch_sink:
            self.bcch_sink(payload)

    def push_pcch(self, payload: bytes) -> None:
        if self.pcch_sink:
            self.pcch_sink(payload)

    def push_pdu(self, raw: bytes) -> None:
        try:
            pdu = mac_pdu.unpack(raw, ul=False)
        except (IndexError, ValueError):
            self.malformed += 1  # corrupted TB that slipped past CRC
            return
        for sub in pdu.subpdus:
            if sub.lcid <= 10 and sub.lcid in self.rlc_sinks:
                self.rlc_sinks[sub.lcid](sub.payload)
            elif sub.lcid == mac_pdu.LCID_TA_CMD:  # 6.1.3.5
                if sub.payload:
                    self.ta_cmds.append(sub.payload[0] & 0x3F)
            elif sub.lcid == mac_pdu.LCID_ACT_DEACT:  # 6.1.3.8 SCell A/D
                if sub.payload:
                    # bit i (i>=1) = SCell index i activation state
                    self.active_scells = {
                        i for i in range(1, 8)
                        if sub.payload[0] & (1 << i)}
            elif sub.lcid == mac_pdu.LCID_CON_RES:
                self.contention_id = sub.payload


# ---------------------------------------------------------------------------
# mux (mux.cc): logical-channel prioritization


@dataclass
class LogicalChannel:
    lcid: int
    priority: int = 1          # lower = higher priority
    pbr_bytes_per_tti: int = -1  # -1 = infinity
    bucket: float = 0.0
    bsd_ms: int = 100
    has_data: Callable[[], int] = lambda: 0       # returns queued bytes
    read_pdu: Callable[[int], Optional[bytes]] = lambda n: None


class Mux:
    """UL MAC PDU assembly with PBR token buckets (36.321 5.4.3.1)."""

    def __init__(self) -> None:
        self.channels: list[LogicalChannel] = []
        self.pending_ces: list[tuple[int, bytes]] = []
        self.msg3_buf: Optional[bytes] = None

    def setup_lcid(self, ch: LogicalChannel) -> None:
        self.channels = [c for c in self.channels if c.lcid != ch.lcid]
        self.channels.append(ch)
        self.channels.sort(key=lambda c: c.priority)

    def tick(self, ms: int = 1) -> None:
        for c in self.channels:
            if c.pbr_bytes_per_tti >= 0:
                cap = c.pbr_bytes_per_tti * c.bsd_ms
                c.bucket = min(cap, c.bucket + c.pbr_bytes_per_tti * ms)

    def push_ce(self, lcid: int, payload: bytes = b"") -> None:
        self.pending_ces.append((lcid, payload))

    def pdu_get(self, tbs: int) -> bytes:
        """Build one UL MAC PDU of exactly tbs bytes."""
        pdu = mac_pdu.MacPdu()
        budget = tbs
        # CEs first (after CCCH which rides as an SDU)
        for lcid, payload in self.pending_ces:
            need = 1 + len(payload)
            if budget >= need:
                pdu.add_ce(lcid, payload)
                budget -= need
        self.pending_ces.clear()
        # round 1: serve up to bucket for channels with finite PBR
        for rnd in (1, 2):
            for c in self.channels:
                avail = c.has_data()
                if avail <= 0 or budget <= 2:
                    continue
                limit = budget - 2
                if rnd == 1 and c.pbr_bytes_per_tti >= 0:
                    limit = min(limit, int(c.bucket))
                    if limit <= 0:
                        continue
                sdu = c.read_pdu(min(avail, limit))
                if sdu:
                    pdu.add_sdu(c.lcid, sdu)
                    budget -= len(sdu) + 2
                    if c.pbr_bytes_per_tti >= 0:
                        c.bucket -= len(sdu)
        return mac_pdu.pack(pdu, tbs, ul=True)


# ---------------------------------------------------------------------------
# BSR procedure (proc_bsr.cc)


class BsrProc:
    def __init__(self, mux: Mux, periodic_ms: int = 0, retx_ms: int = 2560) -> None:
        self.mux = mux
        self.periodic_ms = periodic_ms
        self.retx_ms = retx_ms
        self.t_periodic = 0
        self.t_retx = 0
        self.triggered = False

    def buffer_state(self) -> int:
        return sum(c.has_data() for c in self.mux.channels)

    def new_data(self) -> None:
        """Regular BSR trigger: data arrived for a channel with higher
        priority than any currently queued (simplified: any arrival when
        queues were empty)."""
        self.triggered = True

    def tick(self, ms: int = 1) -> None:
        if self.periodic_ms:
            self.t_periodic += ms
            if self.t_periodic >= self.periodic_ms:
                self.t_periodic = 0
                self.triggered = True
        if self.t_retx:
            pass

    def generate(self) -> None:
        """If triggered, push a short BSR CE into the mux."""
        if not self.triggered:
            return
        self.triggered = False
        nof_bytes = self.buffer_state()
        idx = buff_size_index(nof_bytes)
        # short BSR: LCG=0 (2 bits) + index (6 bits)
        self.mux.push_ce(SHORT_BSR_CE, bytes([idx & 0x3F]))


class PhrProc:
    """proc_phr.cc: periodic + dl-pathloss-change triggered PHR."""

    def __init__(self, mux: Mux, periodic_ms: int = 1000) -> None:
        self.mux = mux
        self.periodic_ms = periodic_ms
        self.timer = 0
        self.last_ph = 40.0

    def set_ph(self, ph_db: float) -> None:
        if abs(ph_db - self.last_ph) > 3.0:
            self.timer = self.periodic_ms  # trigger now
        self.last_ph = ph_db

    def tick(self, ms: int = 1) -> None:
        self.timer += ms
        if self.timer >= self.periodic_ms:
            self.timer = 0
            self.mux.push_ce(PHR_CE, bytes([phr_index(self.last_ph)]))


class SrProc:
    """proc_sr.cc: scheduling request on PUCCH when BSR can't be sent."""

    def __init__(self, max_sr_tx: int = 64) -> None:
        self.pending = False
        self.count = 0
        self.max_sr_tx = max_sr_tx
        self.release_requested = False

    def start(self) -> None:
        self.pending = True
        self.count = 0

    def need_tx(self) -> bool:
        return self.pending

    def sr_sent(self) -> None:
        self.count += 1
        if self.count >= self.max_sr_tx:
            # 36.321 5.4.4: release PUCCH/SRS and start RA
            self.pending = False
            self.release_requested = True

    def reset(self) -> None:
        self.pending = False
        self.count = 0


# ---------------------------------------------------------------------------
# RA procedure (proc_ra.cc, 36.321 sec 5.1)


@dataclass
class RachConfig:
    nof_preambles: int = 52
    preamble_init_power: float = -104.0
    power_ramp_db: float = 4.0
    preamble_trans_max: int = 10
    rar_window_ms: int = 10
    contention_timer_ms: int = 64


class RaProc:
    """Contention-based random access FSM.

    States: IDLE -> PDCCH_SETUP(send preamble) -> RAR_WAIT ->
    MSG3_SENT(contention-resolution wait) -> COMPLETE / back-off retry.
    """

    IDLE, PREAMBLE_SENT, RAR_WAIT, MSG3_SENT, COMPLETE = range(5)

    def __init__(self, cfg: RachConfig | None = None, rng_seed: int = 0) -> None:
        import random

        self.cfg = cfg or RachConfig()
        self.state = self.IDLE
        self.rng = random.Random(rng_seed)
        self.preamble_idx = 0
        self.preamble_tx_count = 0
        self.rar_timer = 0
        self.contention_timer = 0
        self.backoff_timer = 0
        self.rntis: dict[str, int] = {"crnti": 0, "temp_crnti": 0, "ra_rnti": 0}
        self.tx_power = self.cfg.preamble_init_power
        self.ue_contention_id: bytes = b""
        self.completed_ok = False

    # --- API driven by MAC/RRC

    def start(self, contention_id: bytes) -> int:
        """Begin RA; returns the selected preamble index to hand to PHY."""
        self.ue_contention_id = contention_id
        self.preamble_tx_count = 0
        self.completed_ok = False
        return self._send_preamble()

    def _send_preamble(self) -> int:
        self.preamble_idx = self.rng.randrange(self.cfg.nof_preambles)
        self.preamble_tx_count += 1
        self.tx_power = (
            self.cfg.preamble_init_power
            + (self.preamble_tx_count - 1) * self.cfg.power_ramp_db
        )
        self.state = self.RAR_WAIT
        self.rar_timer = 0
        return self.preamble_idx

    def tick(self, ms: int = 1) -> Optional[int]:
        """Advance timers. Returns a new preamble index if a
        retransmission fires, else None."""
        if self.backoff_timer > 0:
            self.backoff_timer -= ms
            if self.backoff_timer <= 0:
                return self._retry()
            return None
        if self.state == self.RAR_WAIT:
            self.rar_timer += ms
            if self.rar_timer > self.cfg.rar_window_ms:
                return self._retry()
        elif self.state == self.MSG3_SENT:
            self.contention_timer += ms
            if self.contention_timer > self.cfg.contention_timer_ms:
                return self._retry()
        return None

    def _retry(self) -> Optional[int]:
        if self.preamble_tx_count >= self.cfg.preamble_trans_max:
            self.state = self.IDLE  # RA problem -> RRC
            return None
        return self._send_preamble()

    def rar_received(self, rar: mac_pdu.RarGrant, backoff_ms: int | None) -> bool:
        """Process a decoded RAR. Returns True if it matches our preamble
        (then msg3 should be transmitted with the temp C-RNTI)."""
        if self.state != self.RAR_WAIT:
            return False
        if rar.rapid != self.preamble_idx:
            if backoff_ms:
                self.backoff_timer = self.rng.uniform(0, backoff_ms)
            return False
        self.rntis["temp_crnti"] = rar.temp_crnti
        self.state = self.MSG3_SENT
        self.contention_timer = 0
        return True

    def contention_resolution(self, ce_id: bytes) -> bool:
        """Msg4 contention-resolution CE check (36.321 5.1.5)."""
        if self.state != self.MSG3_SENT:
            return False
        if ce_id[: len(self.ue_contention_id)] == self.ue_contention_id:
            self.rntis["crnti"] = self.rntis["temp_crnti"]
            self.state = self.COMPLETE
            self.completed_ok = True
            return True
        return self._retry() is not None and False

    def is_complete(self) -> bool:
        return self.state == self.COMPLETE

    def is_problem(self) -> bool:
        return (
            self.state == self.IDLE
            and self.preamble_tx_count >= self.cfg.preamble_trans_max
        )


# ---------------------------------------------------------------------------
# the MAC entity tying it together (mac.cc)


class UeMac:
    """UE MAC entity: PHY-facing grant/decode surface + procedures."""

    def __init__(self, contention_id: bytes = b"\x00" * 6) -> None:
        self.demux = Demux()
        self.mux = Mux()
        self.dl_harq = DlHarqEntity()
        self.ul_harq = UlHarqEntity()
        self.ra = RaProc()
        self.bsr = BsrProc(self.mux)
        self.phr = PhrProc(self.mux)
        self.sr = SrProc()
        self.contention_id = contention_id
        self.metrics = {"dl_ok": 0, "dl_ko": 0, "ul_tx": 0, "ul_retx": 0}

    # PHY surface ---------------------------------------------------------

    def new_grant_dl(self, g: DlMacGrant) -> dict:
        return self.dl_harq.new_grant(g)

    def tb_decoded(self, g: DlMacGrant, payload: Optional[bytes]) -> None:
        ok = payload is not None
        self.metrics["dl_ok" if ok else "dl_ko"] += 1
        if ok and self.dl_harq.tb_decoded(g.pid, True):
            self.demux.push_pdu(payload)
            if self.demux.contention_id is not None and not self.ra.is_complete():
                self.ra.contention_resolution(self.demux.contention_id)
                self.demux.contention_id = None

    def new_grant_ul(self, g: UlMacGrant) -> dict:
        self.bsr.generate()
        out = self.ul_harq.new_grant(g, self.mux.pdu_get)
        self.metrics["ul_tx" if out["new_tx"] else "ul_retx"] += 1
        return out

    def tick(self, ms: int = 1) -> None:
        self.mux.tick(ms)
        self.bsr.tick(ms)
        self.phr.tick(ms)
        self.ra.tick(ms)
