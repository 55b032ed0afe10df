"""UE RRC measurement events A1–A5 (36.331 §5.5.4).

Counterpart of the reference's `srsue/src/stack/rrc/rrc_meas.cc`: each
configured report has an event id, thresholds/offset, hysteresis and a
time-to-trigger; entry/leave conditions run per measurement tick and a
report fires when the entry condition holds for the whole TTT window.
Leaving condition (with hysteresis on the other side) clears the cell
from the triggered set so it can re-trigger later.

Values are dBm (RSRP) as floats; the report conversion to the 36.133
index happens in `RrcUe.send_meas_report`.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ReportConfig:
    """One reportConfigEUTRA entry."""

    event: str                 # "a1".."a5"
    thresh1_dbm: float = -100.0
    thresh2_dbm: float = -100.0   # a5 second threshold
    offset_db: float = 3.0        # a3 offset
    hysteresis_db: float = 1.0
    time_to_trigger_ms: int = 40
    report_id: int = 0


@dataclass
class _CellTrig:
    elapsed_ms: int = 0
    triggered: bool = False


class MeasEngine:
    """Runs the configured events against serving + neighbour RSRP."""

    def __init__(self) -> None:
        self.configs: list[ReportConfig] = []
        # (report_id, pci) -> trigger state; pci -1 = serving-only events
        self._state: dict[tuple[int, int], _CellTrig] = {}
        self.reports: list[dict] = []

    def configure(self, cfg: ReportConfig) -> None:
        self.configs.append(cfg)

    def remove(self, report_id: int) -> None:
        self.configs = [c for c in self.configs if c.report_id != report_id]
        self._state = {k: v for k, v in self._state.items()
                       if k[0] != report_id}

    # -- condition evaluation (36.331 5.5.4.2-.6) ---------------------------

    @staticmethod
    def _enter(cfg: ReportConfig, ms: float, mn: float | None) -> bool:
        h = cfg.hysteresis_db
        if cfg.event == "a1":
            return ms - h > cfg.thresh1_dbm
        if cfg.event == "a2":
            return ms + h < cfg.thresh1_dbm
        if cfg.event == "a3":
            return mn is not None and mn - h > ms + cfg.offset_db
        if cfg.event == "a4":
            return mn is not None and mn - h > cfg.thresh1_dbm
        if cfg.event == "a5":
            return (mn is not None and ms + h < cfg.thresh1_dbm
                    and mn - h > cfg.thresh2_dbm)
        raise ValueError(cfg.event)

    @staticmethod
    def _leave(cfg: ReportConfig, ms: float, mn: float | None) -> bool:
        h = cfg.hysteresis_db
        if cfg.event == "a1":
            return ms + h < cfg.thresh1_dbm
        if cfg.event == "a2":
            return ms - h > cfg.thresh1_dbm
        if cfg.event == "a3":
            return mn is None or mn + h < ms + cfg.offset_db
        if cfg.event == "a4":
            return mn is None or mn + h < cfg.thresh1_dbm
        if cfg.event == "a5":
            return (mn is None or ms - h > cfg.thresh1_dbm
                    or mn + h < cfg.thresh2_dbm)
        raise ValueError(cfg.event)

    def tick(self, serving_dbm: float, neighbours: dict[int, float],
             dt_ms: int = 1) -> list[dict]:
        """Advance TTT windows; returns reports fired this tick:
        dict(event, report_id, pci, rsrp_dbm, serving_dbm)."""
        fired: list[dict] = []
        for cfg in self.configs:
            cells = ([(-1, None)] if cfg.event in ("a1", "a2")
                     else list(neighbours.items()))
            for pci, rsrp in cells:
                key = (cfg.report_id, pci)
                st = self._state.setdefault(key, _CellTrig())
                if st.triggered:
                    if self._leave(cfg, serving_dbm, rsrp):
                        st.triggered = False
                        st.elapsed_ms = 0
                    continue
                if self._enter(cfg, serving_dbm, rsrp):
                    st.elapsed_ms += dt_ms
                    if st.elapsed_ms >= cfg.time_to_trigger_ms:
                        st.triggered = True
                        rep = dict(event=cfg.event, report_id=cfg.report_id,
                                   pci=pci, rsrp_dbm=rsrp,
                                   serving_dbm=serving_dbm)
                        fired.append(rep)
                        self.reports.append(rep)
                else:
                    st.elapsed_ms = 0
        return fired
