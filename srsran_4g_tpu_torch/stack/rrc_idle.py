"""UE RRC idle-mode procedures: SI acquisition, PLMN search, cell
selection and reselection (36.304 + 36.331 §5.2).

Counterpart of the reference's procedures in
`srsue/hdr/stack/rrc/rrc_procedures.h:38-342` (`si_acquire_proc`,
`plmn_search_proc`, `cell_selection_proc`, reselection inside
`rrc_cell.cc`/`cell_search_proc`):

- **SI acquisition**: the UE may not connect before MIB + SIB1 + SIB2 of
  the serving cell are read from BCCH (`si_acquire_proc`); SIB1 carries
  the PLMN/TAC/cell identity and Q_rxlevmin, SIB2 the common channel
  configuration.  A Paging systemInfoModification invalidates stored SI.
- **PLMN search**: read SIB1 on every detected cell, collect distinct
  PLMN identities for NAS PLMN selection (`plmn_search_proc`).
- **Cell selection**: S-criterion Srxlev = Q_rxlevmeas − Q_rxlevmin > 0
  (36.304 §5.2.3.2); the UE camps on the strongest suitable cell.
- **Cell reselection**: R-ranking R_s = Q_meas,s + Q_hyst vs
  R_n = Q_meas,n (36.304 §5.2.4.6) — the neighbour must out-rank the
  serving cell for T_reselection before the UE reselects.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from . import rrc_msgs as R


@dataclass
class CellInfo:
    """One entry of the UE cell database (rrc_cell.cc meas_cell)."""

    pci: int
    earfcn: int = 0
    rsrp_dbm: float = -140.0
    mib: Optional[R.Mib] = None
    sib1: Optional[R.Sib1] = None
    sib2: Optional[R.Sib2] = None

    @property
    def has_si(self) -> bool:
        return (self.mib is not None and self.sib1 is not None
                and self.sib2 is not None)

    @property
    def plmn(self) -> tuple[int, int] | None:
        if self.sib1 is None:
            return None
        return (self.sib1.plmn_mcc, self.sib1.plmn_mnc)

    def s_criterion(self) -> bool:
        """Srxlev = Q_rxlevmeas − Q_rxlevmin > 0 (36.304 §5.2.3.2)."""
        if self.sib1 is None:
            return False
        return self.rsrp_dbm - 2 * self.sib1.q_rx_lev_min > 0


@dataclass
class ReselectionConfig:
    q_hyst_db: float = 2.0
    t_reselection_ms: int = 100


class IdleProcs:
    """Idle-mode cell DB + selection/reselection state machine."""

    def __init__(self, resel: ReselectionConfig | None = None) -> None:
        self.cells: dict[int, CellInfo] = {}   # by pci
        self.serving_pci: int | None = None
        self.resel = resel or ReselectionConfig()
        self._resel_elapsed: dict[int, int] = {}
        self.events: list[str] = []

    # -- measurements / cell search results -------------------------------

    def report_cell(self, pci: int, rsrp_dbm: float, earfcn: int = 0) -> None:
        c = self.cells.setdefault(pci, CellInfo(pci=pci, earfcn=earfcn))
        c.rsrp_dbm = rsrp_dbm

    # -- SI acquisition (si_acquire_proc) -----------------------------------

    def rx_mib(self, pci: int, mib: R.Mib) -> None:
        self.cells.setdefault(pci, CellInfo(pci=pci)).mib = mib

    def rx_bcch_dlsch(self, pci: int, payload: bytes) -> None:
        """BCCH-DL-SCH SI message: framework SI container (1-byte sib
        type + body), the shape of the reference's bcch_dlsch_msg."""
        c = self.cells.setdefault(pci, CellInfo(pci=pci))
        kind, body = payload[0], payload[1:]
        if kind == 0:
            c.mib = R.Mib.unpack(body)
        elif kind == 1:
            c.sib1 = R.Sib1.unpack(body)
        elif kind == 2:
            c.sib2 = R.Sib2.unpack(body)
        if c.has_si:
            self.events.append(f"si_acquired pci={pci}")

    def si_acquired(self, pci: int | None = None) -> bool:
        pci = self.serving_pci if pci is None else pci
        c = self.cells.get(pci)
        return bool(c and c.has_si)

    def si_modification(self, pci: int | None = None) -> None:
        """Paging systemInfoModification: re-acquire everything
        (36.331 §5.2.1.3)."""
        pci = self.serving_pci if pci is None else pci
        c = self.cells.get(pci)
        if c is not None:
            c.sib1 = c.sib2 = None
            self.events.append(f"si_invalidated pci={pci}")

    # -- PLMN search (plmn_search_proc) --------------------------------------

    def plmn_search(self) -> list[tuple[tuple[int, int], int]]:
        """Distinct (PLMN, best pci) pairs over all cells with SIB1,
        strongest first."""
        best: dict[tuple[int, int], CellInfo] = {}
        for c in sorted(self.cells.values(), key=lambda c: -c.rsrp_dbm):
            if c.plmn is not None and c.plmn not in best:
                best[c.plmn] = c
        return [(plmn, c.pci) for plmn, c in best.items()]

    # -- cell selection (cell_selection_proc) ---------------------------------

    def select_cell(self) -> int | None:
        """Camp on the strongest cell passing the S-criterion."""
        cand = [c for c in self.cells.values() if c.s_criterion()]
        if not cand:
            return None
        best = max(cand, key=lambda c: c.rsrp_dbm)
        if best.pci != self.serving_pci:
            self.events.append(f"selected pci={best.pci}")
        self.serving_pci = best.pci
        self._resel_elapsed.clear()
        return best.pci

    # -- cell reselection (36.304 §5.2.4) --------------------------------------

    def reselection_tick(self, dt_ms: int = 1) -> int | None:
        """R-ranking with hysteresis + T_reselection; returns the new
        serving pci when a reselection happens."""
        if self.serving_pci is None:
            return None
        s = self.cells.get(self.serving_pci)
        if s is None:
            return None
        r_s = s.rsrp_dbm + self.resel.q_hyst_db
        for c in self.cells.values():
            if c.pci == self.serving_pci:
                continue
            if c.rsrp_dbm > r_s and c.s_criterion():
                t = self._resel_elapsed.get(c.pci, 0) + dt_ms
                self._resel_elapsed[c.pci] = t
                if t >= self.resel.t_reselection_ms:
                    old = self.serving_pci
                    self.serving_pci = c.pci
                    self._resel_elapsed.clear()
                    self.events.append(f"reselected {old}->{c.pci}")
                    return c.pci
            else:
                self._resel_elapsed.pop(c.pci, None)
        return None
