"""RRC message codecs (TS 36.331 subset) — 3GPP-exact UPER on the wire.

Counterpart of the reference's generated RRC ASN.1 codecs
(`lib/src/asn1/rrc.cc` + `lib/src/asn1/rrc/*`, ~10 k LoC generated):
typed dataclasses whose pack()/unpack() now encode the REAL 36.331
UPER message classes via the declarative X.691 engine in
`stack/rrc_uper.py`.  Every encoding in this module round-trips
byte-exactly through the reference's own compiled codec
(`tools/ref_rrc.py` harness; tests/test_rrc_wire_exact.py), so the E2E
wire is spec-exact by construction — a Wireshark LTE-RRC dissector or
the reference itself can decode it.

Message set: the connection-establishment / security / reconfiguration
/ reestablishment / release / information-transfer messages used by
the reference's E2E attach flow (srsue rrc_procedures.h:38-342,
srsenb rrc_ue.cc), MIB/SIB1/SIB2 on BCCH, and Paging on PCCH.

Spec notes (differences from the framework's pre-round-4 private
framing):
  * RRCConnectionSetup / RRCConnectionReestablishment carry NO C-RNTI
    on the wire (36.331: the identity comes from the MAC RAR's
    temporary C-RNTI).  The `rnti` dataclass field is kept for the
    in-process API; unpack returns 0 and the UE keeps the MAC-provided
    C-RNTI.
  * EstablishmentCause uses the 36.331 enum (mo-Data = 4).
  * PDCP SN length for UM DRBs is 7 or 12 (LTE), not 18.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import rrc_uper as U
from .asn1 import BitReader, BitWriter, pack_constrained_int, \
    unpack_constrained_int


def _enum_idx(table: tuple, value) -> int:
    try:
        return table.index(value)
    except ValueError:
        raise ValueError(f"{value} not in 36.331 enum {table}") from None


# --------------------------------------------------------------------------
# BCCH: MIB / SIB1 / SIB2


@dataclass
class Mib:
    """MasterInformationBlock (36.331 6.2.2); PHY transport via models/pbch.

    Wire: BCCH-BCH-Message (24 bits exactly; pbch.c payload)."""
    dl_bandwidth: int = 100   # PRBs: one of 6,15,25,50,75,100
    phich_duration: int = 0   # 0=normal
    phich_resource: int = 1   # index into {1/6,1/2,1,2}
    sfn: int = 0

    _BW = [6, 15, 25, 50, 75, 100]

    def pack(self) -> bytes:
        return U.encode_bytes(U.BCCH_BCH_MESSAGE, {"message": {
            "dl_bandwidth": self._BW.index(self.dl_bandwidth),
            "phich_config": {"phich_duration": self.phich_duration,
                             "phich_resource": self.phich_resource},
            "system_frame_number": (self.sfn >> 2) & 0xFF,
            "spare": 0,
        }})

    @classmethod
    def unpack(cls, data: bytes) -> "Mib":
        v, _ = U.decode_bytes(U.BCCH_BCH_MESSAGE, data)
        m = v["message"]
        return cls(dl_bandwidth=cls._BW[m["dl_bandwidth"]],
                   phich_duration=m["phich_config"]["phich_duration"],
                   phich_resource=m["phich_config"]["phich_resource"],
                   sfn=m["system_frame_number"] << 2)


def _plmn_digits(mcc: int, mnc: int) -> dict:
    mnc_digits = [mnc // 10 % 10, mnc % 10] if mnc < 100 else \
        [mnc // 100, mnc // 10 % 10, mnc % 10]
    return {"mcc": [mcc // 100, mcc // 10 % 10, mcc % 10],
            "mnc": mnc_digits}


def _plmn_ints(p: dict) -> tuple[int, int]:
    mcc = int("".join(map(str, p["mcc"])))
    mnc = int("".join(map(str, p["mnc"])))
    return mcc, mnc


_SI_WINDOW_MS = (1, 2, 5, 10, 15, 20, 40)
_SI_PERIOD_RF = (8, 16, 32, 64, 128, 256, 512)


@dataclass
class Sib1:
    plmn_mcc: int = 1
    plmn_mnc: int = 1
    tac: int = 0x0001
    cell_id: int = 0x01
    q_rx_lev_min: int = -65   # *2 dBm
    freq_band: int = 7
    si_window_len_ms: int = 20
    sched_info_period: int = 16  # SIB2 periodicity (radio frames)

    def pack(self) -> bytes:
        sib1 = {
            "cell_access_related_info": {
                "plmn_identity_list": [{
                    "plmn_identity": _plmn_digits(self.plmn_mcc,
                                                  self.plmn_mnc),
                    "cell_reserved_for_operator_use": 1,  # notReserved
                }],
                "tracking_area_code": self.tac,
                "cell_identity": self.cell_id,
                "cell_barred": 1,            # notBarred
                "intra_freq_reselection": 0,  # allowed
                "csg_indication": False,
            },
            "cell_selection_info": {"q_rx_lev_min": self.q_rx_lev_min},
            "freq_band_indicator": self.freq_band,
            # first entry of the first SI message is SIB2 implicitly
            "scheduling_info_list": [{
                "si_periodicity": _enum_idx(_SI_PERIOD_RF,
                                            self.sched_info_period),
                "sib_mapping_info": [],
            }],
            "si_window_length": _enum_idx(_SI_WINDOW_MS,
                                          self.si_window_len_ms),
            "system_info_value_tag": 0,
        }
        return U.encode_bytes(
            U.BCCH_DL_SCH_MESSAGE,
            ("c1", ("system_information_block_type1", sib1)))

    @classmethod
    def unpack(cls, data: bytes) -> "Sib1":
        v, _ = U.decode_bytes(U.BCCH_DL_SCH_MESSAGE, data)
        sib1 = v[1][1]
        acc = sib1["cell_access_related_info"]
        mcc, mnc = _plmn_ints(acc["plmn_identity_list"][0]["plmn_identity"])
        sched = sib1["scheduling_info_list"][0]
        return cls(
            plmn_mcc=mcc, plmn_mnc=mnc,
            tac=acc["tracking_area_code"], cell_id=acc["cell_identity"],
            q_rx_lev_min=sib1["cell_selection_info"]["q_rx_lev_min"],
            freq_band=sib1["freq_band_indicator"],
            si_window_len_ms=_SI_WINDOW_MS[sib1["si_window_length"]],
            sched_info_period=_SI_PERIOD_RF[sched["si_periodicity"]],
        )


_PREAMBLE_TRANS_MAX = (3, 4, 5, 6, 7, 8, 10, 20, 50, 100, 200)
_RA_WINDOW_SF = (2, 3, 4, 5, 6, 7, 8, 10)
_CONTENTION_SF = (8, 16, 24, 32, 40, 48, 56, 64)
_T300_MS = (100, 200, 300, 400, 600, 1000, 1500, 2000)
_T310_MS = (0, 50, 100, 200, 500, 1000, 2000)
_N310 = (1, 2, 3, 4, 6, 8, 10, 20)
_T311_MS = (1000, 3000, 5000, 10000, 15000, 20000, 30000)
_N311 = (1, 2, 3, 4, 5, 6, 8, 10)


@dataclass
class Sib2:
    """The RACH/PUSCH/PUCCH common config subset the MAC/PHY need;
    remaining 36.331 SIB2 mandatory IEs are encoded with the
    reference's enb.conf.example defaults."""
    nof_ra_preambles: int = 52
    preamble_init_power: int = -104
    power_ramp_db: int = 4
    preamble_trans_max: int = 10
    ra_resp_window_sf: int = 10
    contention_timer_sf: int = 64
    prach_config_index: int = 3
    prach_freq_offset: int = 2
    prach_root_seq: int = 128
    zero_corr_zone: int = 5
    t300_ms: int = 1000
    t301_ms: int = 1000
    t310_ms: int = 1000
    n310: int = 1
    t311_ms: int = 1000
    n311: int = 1

    def pack(self) -> bytes:
        sib2 = {
            "radio_resource_config_common": {
                "rach_config_common": {
                    "preamble_info": {
                        "number_of_ra_preambles":
                            self.nof_ra_preambles // 4 - 1,
                    },
                    "power_ramping_parameters": {
                        "power_ramping_step": self.power_ramp_db // 2,
                        "preamble_initial_received_target_power":
                            (self.preamble_init_power + 120) // 2,
                    },
                    "ra_supervision_info": {
                        "preamble_trans_max": _enum_idx(
                            _PREAMBLE_TRANS_MAX, self.preamble_trans_max),
                        "ra_response_window_size": _enum_idx(
                            _RA_WINDOW_SF, self.ra_resp_window_sf),
                        "mac_contention_resolution_timer": _enum_idx(
                            _CONTENTION_SF, self.contention_timer_sf),
                    },
                    "max_harq_msg3_tx": 4,
                },
                "bcch_config": {"modification_period_coeff": 0},
                "pcch_config": {"default_paging_cycle": 1, "nb": 2},
                "prach_config": {
                    "root_sequence_index": self.prach_root_seq,
                    "prach_config_info": {
                        "prach_config_index": self.prach_config_index,
                        "high_speed_flag": False,
                        "zero_correlation_zone_config": self.zero_corr_zone,
                        "prach_freq_offset": self.prach_freq_offset,
                    },
                },
                "pdsch_config_common": {"reference_signal_power": 0,
                                        "p_b": 0},
                "pusch_config_common": {
                    "pusch_config_basic": {
                        "n_sb": 1, "hopping_mode": 0,
                        "pusch_hopping_offset": 0, "enable_64qam": True,
                    },
                    "ul_reference_signals_pusch": {
                        "group_hopping_enabled": False,
                        "group_assignment_pusch": 0,
                        "sequence_hopping_enabled": False,
                        "cyclic_shift": 0,
                    },
                },
                "pucch_config_common": {"delta_pucch_shift": 0,
                                        "n_rb_cqi": 1, "n_cs_an": 0,
                                        "n1_pucch_an": 12},
                "sounding_rs_ul_config_common": ("release", None),
                "uplink_power_control_common": {
                    "p0_nominal_pusch": -85, "alpha": 7,
                    "p0_nominal_pucch": -107,
                    "delta_flist_pucch": {
                        "delta_f_pucch_format1": 1,
                        "delta_f_pucch_format1b": 1,
                        "delta_f_pucch_format2": 1,
                        "delta_f_pucch_format2a": 1,
                        "delta_f_pucch_format2b": 1,
                    },
                    "delta_preamble_msg3": 4,
                },
                "ul_cyclic_prefix_length": 0,
            },
            "ue_timers_and_constants": {
                "t300": _enum_idx(_T300_MS, self.t300_ms),
                "t301": _enum_idx(_T300_MS, self.t301_ms),
                "t310": _enum_idx(_T310_MS, self.t310_ms),
                "n310": _enum_idx(_N310, self.n310),
                "t311": _enum_idx(_T311_MS, self.t311_ms),
                "n311": _enum_idx(_N311, self.n311),
            },
            "freq_info": {"additional_spectrum_emission": 1},
            "time_alignment_timer_common": 7,  # infinity
        }
        si = {"critical_extensions": ("system_information_r8", {
            "sib_type_and_info": [("sib2", sib2)]})}
        return U.encode_bytes(U.BCCH_DL_SCH_MESSAGE,
                              ("c1", ("system_information", si)))

    @classmethod
    def unpack(cls, data: bytes) -> "Sib2":
        v, _ = U.decode_bytes(U.BCCH_DL_SCH_MESSAGE, data)
        si = v[1][1]["critical_extensions"][1]
        sib2 = si["sib_type_and_info"][0][1]
        rrc = sib2["radio_resource_config_common"]
        rach = rrc["rach_config_common"]
        prach = rrc["prach_config"]
        t = sib2["ue_timers_and_constants"]
        return cls(
            nof_ra_preambles=(rach["preamble_info"]
                              ["number_of_ra_preambles"] + 1) * 4,
            preamble_init_power=(rach["power_ramping_parameters"]
                                 ["preamble_initial_received_target_power"]
                                 * 2 - 120),
            power_ramp_db=(rach["power_ramping_parameters"]
                           ["power_ramping_step"] * 2),
            preamble_trans_max=_PREAMBLE_TRANS_MAX[
                rach["ra_supervision_info"]["preamble_trans_max"]],
            ra_resp_window_sf=_RA_WINDOW_SF[
                rach["ra_supervision_info"]["ra_response_window_size"]],
            contention_timer_sf=_CONTENTION_SF[
                rach["ra_supervision_info"]
                ["mac_contention_resolution_timer"]],
            prach_config_index=(prach["prach_config_info"]
                                ["prach_config_index"]),
            prach_freq_offset=(prach["prach_config_info"]
                               ["prach_freq_offset"]),
            prach_root_seq=prach["root_sequence_index"],
            zero_corr_zone=(prach["prach_config_info"]
                            ["zero_correlation_zone_config"]),
            t300_ms=_T300_MS[t["t300"]], t301_ms=_T300_MS[t["t301"]],
            t310_ms=_T310_MS[t["t310"]], n310=_N310[t["n310"]],
            t311_ms=_T311_MS[t["t311"]], n311=_N311[t["n311"]],
        )


# --------------------------------------------------------------------------
# CCCH


@dataclass
class RrcConnectionRequest:
    ue_identity: int = 0      # 40-bit S-TMSI/random value
    establishment_cause: int = 4  # mo-Data (36.331 EstablishmentCause)

    def pack(self) -> bytes:
        req = {"critical_extensions": ("rrc_connection_request_r8", {
            "ue_identity": ("random_value", self.ue_identity),
            "establishment_cause": self.establishment_cause,
            "spare": 0})}
        return U.encode_bytes(U.UL_CCCH_MESSAGE,
                              ("c1", ("rrc_connection_request", req)))


@dataclass
class RrcConnectionReestablishmentRequest:
    c_rnti: int = 0
    phys_cell_id: int = 0
    cause: int = 0  # reconfigurationFailure/handoverFailure/otherFailure

    def pack(self) -> bytes:
        req = {"critical_extensions": (
            "rrc_connection_reestablishment_request_r8", {
                "ue_identity": {"c_rnti": self.c_rnti,
                                "phys_cell_id": self.phys_cell_id,
                                "short_mac_i": 0},
                "reestablishment_cause": self.cause,
                "spare": 0})}
        return U.encode_bytes(
            U.UL_CCCH_MESSAGE,
            ("c1", ("rrc_connection_reestablishment_request", req)))


def unpack_ul_ccch(data: bytes):
    v, _ = U.decode_bytes(U.UL_CCCH_MESSAGE, data)
    name, msg = v[1]
    body = msg["critical_extensions"][1]
    if name == "rrc_connection_request":
        ident = body["ue_identity"]
        if ident[0] == "random_value":
            ue_id = ident[1]
        else:
            ue_id = (ident[1]["mmec"] << 32) | ident[1]["m_tmsi"]
        return RrcConnectionRequest(
            ue_identity=ue_id,
            establishment_cause=body["establishment_cause"])
    if name == "rrc_connection_reestablishment_request":
        return RrcConnectionReestablishmentRequest(
            c_rnti=body["ue_identity"]["c_rnti"],
            phys_cell_id=body["ue_identity"]["phys_cell_id"],
            cause=body["reestablishment_cause"])
    raise ValueError(f"unknown UL-CCCH type {name}")


@dataclass
class SrbToAddMod:
    srb_id: int = 1


@dataclass
class DrbToAddMod:
    drb_id: int = 1
    eps_bearer_id: int = 5
    lcid: int = 3
    pdcp_sn_len: int = 12  # LTE UM: 7 or 12
    rlc_mode: str = "am"  # am | um


def _rr_cfg_ded_srb(srb_id: int) -> dict:
    return {"srb_to_add_mod_list": [{"srb_identity": srb_id}]}


# default AM/UM RLC parameter trees (reference rr.conf defaults; only the
# mode matters to this framework's RLC entities)
_AM_RLC = ("am", {"ul_am_rlc": {"t_poll_retransmit": 15, "poll_pdu": 0,
                                "poll_byte": 14, "max_retx_threshold": 2},
                  "dl_am_rlc": {"t_reordering": 7, "t_status_prohibit": 0}})
_UM_RLC = ("um_bi_directional", {
    "ul_um_rlc": {"sn_field_length": 1},
    "dl_um_rlc": {"sn_field_length": 1, "t_reordering": 7}})


def _drb_value(d: DrbToAddMod) -> dict:
    pdcp: dict = {"header_compression": ("not_used", None)}
    if d.rlc_mode == "am":
        pdcp["rlc_am"] = {"status_report_required": False}
    else:
        pdcp["rlc_um"] = {"pdcp_sn_size": 1 if d.pdcp_sn_len == 12 else 0}
    return {"eps_bearer_identity": d.eps_bearer_id,
            "drb_identity": d.drb_id,
            "pdcp_config": pdcp,
            "rlc_config": _AM_RLC if d.rlc_mode == "am" else _UM_RLC,
            "logical_channel_identity": d.lcid}


def _drb_from_value(v: dict) -> DrbToAddMod:
    mode = "am"
    sn = 12
    rlc = v.get("rlc_config")
    if rlc is not None and rlc[0] != "am":
        mode = "um"
    pdcp = v.get("pdcp_config") or {}
    if "rlc_um" in pdcp:
        sn = 12 if pdcp["rlc_um"]["pdcp_sn_size"] == 1 else 7
    return DrbToAddMod(drb_id=v["drb_identity"],
                       eps_bearer_id=v.get("eps_bearer_identity", 0),
                       lcid=v.get("logical_channel_identity", 3),
                       pdcp_sn_len=sn, rlc_mode=mode)


@dataclass
class RrcConnectionSetup:
    """36.331: carries NO C-RNTI (MAC RAR provides it); `rnti` is kept
    for the in-process API and is NOT encoded."""
    rnti: int = 0
    srb1: SrbToAddMod = field(default_factory=SrbToAddMod)

    def pack(self) -> bytes:
        setup = {"rrc_transaction_identifier": 0,
                 "critical_extensions": ("c1", ("rrc_connection_setup_r8", {
                     "radio_resource_config_dedicated":
                         _rr_cfg_ded_srb(self.srb1.srb_id)}))}
        return U.encode_bytes(U.DL_CCCH_MESSAGE,
                              ("c1", ("rrc_connection_setup", setup)))


@dataclass
class RrcConnectionReject:
    wait_time_s: int = 1

    def pack(self) -> bytes:
        rej = {"critical_extensions": ("c1", ("rrc_connection_reject_r8", {
            "wait_time": self.wait_time_s}))}
        return U.encode_bytes(U.DL_CCCH_MESSAGE,
                              ("c1", ("rrc_connection_reject", rej)))


@dataclass
class RrcConnectionReestablishment:
    rnti: int = 0        # in-process only; NOT encoded (36.331)
    next_hop_chaining_count: int = 0

    def pack(self) -> bytes:
        msg = {"rrc_transaction_identifier": 0,
               "critical_extensions": ("c1", (
                   "rrc_connection_reestablishment_r8", {
                       "radio_resource_config_dedicated":
                           _rr_cfg_ded_srb(1),
                       "next_hop_chaining_count":
                           self.next_hop_chaining_count}))}
        return U.encode_bytes(
            U.DL_CCCH_MESSAGE,
            ("c1", ("rrc_connection_reestablishment", msg)))


@dataclass
class RrcConnectionReestablishmentReject:
    def pack(self) -> bytes:
        msg = {"critical_extensions": (
            "rrc_connection_reestablishment_reject_r8", {})}
        return U.encode_bytes(
            U.DL_CCCH_MESSAGE,
            ("c1", ("rrc_connection_reestablishment_reject", msg)))


def unpack_dl_ccch(data: bytes):
    v, _ = U.decode_bytes(U.DL_CCCH_MESSAGE, data)
    name, msg = v[1]
    if name == "rrc_connection_setup":
        body = msg["critical_extensions"][1][1]
        srbs = body["radio_resource_config_dedicated"].get(
            "srb_to_add_mod_list", [{"srb_identity": 1}])
        return RrcConnectionSetup(
            srb1=SrbToAddMod(srb_id=srbs[0]["srb_identity"]))
    if name == "rrc_connection_reject":
        body = msg["critical_extensions"][1][1]
        return RrcConnectionReject(wait_time_s=body["wait_time"])
    if name == "rrc_connection_reestablishment":
        body = msg["critical_extensions"][1][1]
        return RrcConnectionReestablishment(
            next_hop_chaining_count=body["next_hop_chaining_count"])
    if name == "rrc_connection_reestablishment_reject":
        return RrcConnectionReestablishmentReject()
    raise ValueError(f"unknown DL-CCCH type {name}")


# --------------------------------------------------------------------------
# DCCH


@dataclass
class RrcConnectionSetupComplete:
    selected_plmn: int = 1
    nas_pdu: bytes = b""

    def pack(self) -> bytes:
        msg = {"rrc_transaction_identifier": 0,
               "critical_extensions": ("c1", (
                   "rrc_connection_setup_complete_r8", {
                       "selected_plmn_identity": self.selected_plmn,
                       "dedicated_info_nas": self.nas_pdu}))}
        return U.encode_bytes(
            U.UL_DCCH_MESSAGE,
            ("c1", ("rrc_connection_setup_complete", msg)))


@dataclass
class SecurityModeCommandRrc:
    ciph_alg: int = 2   # eea2
    integ_alg: int = 2  # eia2

    def pack(self) -> bytes:
        msg = {"rrc_transaction_identifier": 0,
               "critical_extensions": ("c1", ("security_mode_command_r8", {
                   "security_config_smc": {"security_algorithm_config": {
                       "ciphering_algorithm": self.ciph_alg,
                       "integrity_prot_algorithm": self.integ_alg}}}))}
        return U.encode_bytes(U.DL_DCCH_MESSAGE,
                              ("c1", ("security_mode_command", msg)))


@dataclass
class SecurityModeCompleteRrc:
    def pack(self) -> bytes:
        msg = {"rrc_transaction_identifier": 0,
               "critical_extensions": ("security_mode_complete_r8", {})}
        return U.encode_bytes(U.UL_DCCH_MESSAGE,
                              ("c1", ("security_mode_complete", msg)))


_T304_MS = (50, 100, 150, 200, 500, 1000, 2000, 2000)


@dataclass
class MobilityControlInfo:
    """Handover command payload (36.331 6.3.4 mobilityControlInfo)."""
    target_pci: int = 0
    new_c_rnti: int = 0
    t304_ms: int = 1000
    ncc: int = 0  # nextHopChainingCount: >0 -> vertical K_eNB* re-key


@dataclass
class AsConfig:
    """Source→target transparent container (36.331 10.2.2 AS-Config,
    reduced): the source cell and DRB configuration the target eNB
    rebuilds at an S1 handover (srsenb rrc_mobility.cc
    fill_mobility_reconf_common / HandoverPreparationInformation)."""
    source_pci: int = 0
    drbs: list[DrbToAddMod] = field(default_factory=list)

    def pack(self) -> bytes:
        w = BitWriter()
        w.put(self.source_pci, 9)
        pack_constrained_int(w, len(self.drbs), 0, 11)
        for d in self.drbs:
            pack_constrained_int(w, d.drb_id, 1, 32)
            pack_constrained_int(w, d.eps_bearer_id, 0, 15)
            pack_constrained_int(w, d.lcid, 3, 10)
        return w.to_bytes()

    @classmethod
    def unpack(cls, data: bytes) -> "AsConfig":
        r = BitReader(data)
        out = cls(source_pci=r.get(9))
        for _ in range(unpack_constrained_int(r, 0, 11)):
            out.drbs.append(DrbToAddMod(
                drb_id=unpack_constrained_int(r, 1, 32),
                eps_bearer_id=unpack_constrained_int(r, 0, 15),
                lcid=unpack_constrained_int(r, 3, 10)))
        return out


# minimal valid RadioResourceConfigCommon for mobilityControlInfo (the
# mandatory-only subset; the target cell's real config rides SIB2)
_RRC_COMMON_HO = {
    "prach_config": {"root_sequence_index": 0},
    "pusch_config_common": {
        "pusch_config_basic": {"n_sb": 1, "hopping_mode": 0,
                               "pusch_hopping_offset": 0,
                               "enable_64qam": True},
        "ul_reference_signals_pusch": {"group_hopping_enabled": False,
                                       "group_assignment_pusch": 0,
                                       "sequence_hopping_enabled": False,
                                       "cyclic_shift": 0}},
    "ul_cyclic_prefix_length": 0,
}


@dataclass
class RrcConnectionReconfiguration:
    drbs: list[DrbToAddMod] = field(default_factory=list)
    nas_pdu: bytes = b""
    meas_config: bool = False
    mobility: MobilityControlInfo | None = None
    # EN-DC (36.331 nr-SecondaryCellGroupConfig-r15 + sk-Counter-r15):
    # opaque NR RRC container from the SgNB plus the S-KgNB counter
    nr_scg: bytes = b""
    sk_counter: int = 0

    def pack(self) -> bytes:
        r8: dict = {}
        if self.meas_config:
            r8["meas_config"] = {}
        if self.mobility is not None:
            r8["mobility_control_info"] = {
                "target_phys_cell_id": self.mobility.target_pci,
                "t304": _enum_idx(_T304_MS, self.mobility.t304_ms),
                "new_ue_identity": self.mobility.new_c_rnti,
                "radio_resource_config_common": _RRC_COMMON_HO,
            }
            r8["security_config_ho"] = {"handover_type": ("intra_lte", {
                "key_change_indicator": False,
                "next_hop_chaining_count": self.mobility.ncc})}
        if self.nas_pdu:
            r8["dedicated_info_nas_list"] = [self.nas_pdu]
        if self.drbs:
            r8["radio_resource_config_dedicated"] = {
                "drb_to_add_mod_list": [_drb_value(d) for d in self.drbs]}
        if self.nr_scg:
            # nonCriticalExtension chain r8→…→v1510 (EN-DC)
            v1510 = {"nr_config_r15": ("setup", {
                "endc_release_and_add_r15": False,
                "nr_secondary_cell_group_config_r15": self.nr_scg}),
                "sk_counter_r15": self.sk_counter}
            # 7 empty wrapper versions (v890..v1430) above the v1510 IEs
            chain = v1510
            for _ in range(7):
                chain = {"non_critical_extension": chain}
            r8["non_critical_extension"] = chain
        msg = {"rrc_transaction_identifier": 0,
               "critical_extensions": ("c1", (
                   "rrc_connection_reconfiguration_r8", r8))}
        return U.encode_bytes(
            U.DL_DCCH_MESSAGE,
            ("c1", ("rrc_connection_reconfiguration", msg)))


@dataclass
class RrcConnectionReconfigurationComplete:
    def pack(self) -> bytes:
        msg = {"rrc_transaction_identifier": 0,
               "critical_extensions": (
                   "rrc_connection_reconfiguration_complete_r8", {})}
        return U.encode_bytes(
            U.UL_DCCH_MESSAGE,
            ("c1", ("rrc_connection_reconfiguration_complete", msg)))


@dataclass
class UlInformationTransfer:
    nas_pdu: bytes = b""

    def pack(self) -> bytes:
        msg = {"critical_extensions": ("c1", ("ul_information_transfer_r8", {
            "dedicated_info_type": ("dedicated_info_nas", self.nas_pdu)}))}
        return U.encode_bytes(U.UL_DCCH_MESSAGE,
                              ("c1", ("ul_information_transfer", msg)))


@dataclass
class DlInformationTransfer:
    nas_pdu: bytes = b""

    def pack(self) -> bytes:
        msg = {"rrc_transaction_identifier": 0,
               "critical_extensions": ("c1", ("dl_information_transfer_r8", {
                   "dedicated_info_type": ("dedicated_info_nas",
                                           self.nas_pdu)}))}
        return U.encode_bytes(U.DL_DCCH_MESSAGE,
                              ("c1", ("dl_information_transfer", msg)))


@dataclass
class RrcConnectionRelease:
    cause: int = 0

    def pack(self) -> bytes:
        msg = {"rrc_transaction_identifier": 0,
               "critical_extensions": ("c1", ("rrc_connection_release_r8", {
                   "release_cause": self.cause}))}
        return U.encode_bytes(U.DL_DCCH_MESSAGE,
                              ("c1", ("rrc_connection_release", msg)))


@dataclass
class MeasReport:
    rsrp: int = 0   # 0..97 (36.133 9.1.4)
    rsrq: int = 0   # 0..34
    pci: int = 0
    is_nr: bool = False  # B1 inter-RAT NR report (measResultNeighCellListNR)

    def pack(self) -> bytes:
        if self.is_nr:
            neigh = ("meas_result_neigh_cell_list_nr_r15", [{
                "pci_r15": self.pci,
                "meas_result_cell_r15": {"rsrp_result_r15": self.rsrp,
                                         "rsrq_result_r15": self.rsrq}}])
            meas_id = 2
        else:
            neigh = ("meas_result_list_eutra", [{
                "phys_cell_id": self.pci,
                "meas_result": {"rsrp_result": self.rsrp,
                                "rsrq_result": self.rsrq}}])
            meas_id = 1
        msg = {"critical_extensions": ("c1", ("measurement_report_r8", {
            "meas_results": {
                "meas_id": meas_id,
                "meas_result_pcell": {"rsrp_result": min(self.rsrp, 97),
                                      "rsrq_result": min(self.rsrq, 34)},
                "meas_result_neigh_cells": neigh}}))}
        return U.encode_bytes(U.UL_DCCH_MESSAGE,
                              ("c1", ("measurement_report", msg)))


def unpack_ul_dcch(data: bytes):
    v, _ = U.decode_bytes(U.UL_DCCH_MESSAGE, data)
    name, msg = v[1]
    if name == "rrc_connection_setup_complete":
        body = msg["critical_extensions"][1][1]
        return RrcConnectionSetupComplete(
            selected_plmn=body["selected_plmn_identity"],
            nas_pdu=body["dedicated_info_nas"])
    if name == "security_mode_complete":
        return SecurityModeCompleteRrc()
    if name == "rrc_connection_reconfiguration_complete":
        return RrcConnectionReconfigurationComplete()
    if name == "ul_information_transfer":
        body = msg["critical_extensions"][1][1]
        return UlInformationTransfer(nas_pdu=body["dedicated_info_type"][1])
    if name == "measurement_report":
        res = msg["critical_extensions"][1][1]["meas_results"]
        neigh = res.get("meas_result_neigh_cells")
        if neigh is None:
            pc = res["meas_result_pcell"]
            return MeasReport(rsrp=pc["rsrp_result"],
                              rsrq=pc["rsrq_result"], pci=0)
        if neigh[0] == "meas_result_neigh_cell_list_nr_r15":
            cell = neigh[1][0]
            m = cell["meas_result_cell_r15"]
            return MeasReport(rsrp=m.get("rsrp_result_r15", 0),
                              rsrq=m.get("rsrq_result_r15", 0),
                              pci=cell["pci_r15"], is_nr=True)
        cell = neigh[1][0]
        return MeasReport(rsrp=cell["meas_result"]["rsrp_result"],
                          rsrq=cell["meas_result"]["rsrq_result"],
                          pci=cell["phys_cell_id"])
    raise ValueError(f"unknown UL-DCCH type {name}")


# --------------------------------------------------------------------------
# PCCH (paging, 36.331 6.2.2)


@dataclass
class Paging:
    """PCCH Paging with up to 16 records (S-TMSI identities)."""
    tmsis: list[int] = field(default_factory=list)
    system_info_modification: bool = False

    def pack(self) -> bytes:
        pg: dict = {}
        if self.tmsis:
            pg["paging_record_list"] = [
                {"ue_identity": ("s_tmsi", {"mmec": (t >> 32) & 0xFF,
                                            "m_tmsi": t & 0xFFFFFFFF}),
                 "cn_domain": 0}
                for t in self.tmsis]
        if self.system_info_modification:
            pg["system_info_modification"] = 0
        return U.encode_bytes(U.PCCH_MESSAGE, ("c1", ("paging", pg)))

    @classmethod
    def unpack(cls, data: bytes) -> "Paging":
        v, _ = U.decode_bytes(U.PCCH_MESSAGE, data)
        pg = v[1][1]
        tmsis = []
        for rec in pg.get("paging_record_list", []):
            ident = rec["ue_identity"]
            if ident[0] == "s_tmsi":
                tmsis.append((ident[1]["mmec"] << 32) | ident[1]["m_tmsi"])
        return cls(tmsis=tmsis,
                   system_info_modification="system_info_modification" in pg)


def unpack_dl_dcch(data: bytes):
    v, _ = U.decode_bytes(U.DL_DCCH_MESSAGE, data)
    name, msg = v[1]
    if name == "security_mode_command":
        alg = (msg["critical_extensions"][1][1]["security_config_smc"]
               ["security_algorithm_config"])
        return SecurityModeCommandRrc(
            ciph_alg=alg["ciphering_algorithm"],
            integ_alg=alg["integrity_prot_algorithm"])
    if name == "rrc_connection_reconfiguration":
        r8 = msg["critical_extensions"][1][1]
        drbs = []
        rr = r8.get("radio_resource_config_dedicated") or {}
        for dv in rr.get("drb_to_add_mod_list", []):
            drbs.append(_drb_from_value(dv))
        nas = b""
        if r8.get("dedicated_info_nas_list"):
            nas = r8["dedicated_info_nas_list"][0]
        mob = None
        if "mobility_control_info" in r8:
            mv = r8["mobility_control_info"]
            ncc = 0
            if "security_config_ho" in r8:
                ncc = (r8["security_config_ho"]["handover_type"][1]
                       ["next_hop_chaining_count"])
            mob = MobilityControlInfo(
                target_pci=mv["target_phys_cell_id"],
                new_c_rnti=mv["new_ue_identity"],
                t304_ms=_T304_MS[mv["t304"]], ncc=ncc)
        nr_scg, sk = b"", 0
        ext = r8.get("non_critical_extension")
        while ext is not None:
            if "nr_config_r15" in ext:
                nr = ext["nr_config_r15"]
                if nr[0] == "setup":
                    nr_scg = nr[1].get(
                        "nr_secondary_cell_group_config_r15", b"")
                sk = ext.get("sk_counter_r15", 0)
                break
            ext = ext.get("non_critical_extension")
        return RrcConnectionReconfiguration(
            drbs=drbs, nas_pdu=nas, meas_config="meas_config" in r8,
            mobility=mob, nr_scg=nr_scg, sk_counter=sk)
    if name == "dl_information_transfer":
        body = msg["critical_extensions"][1][1]
        return DlInformationTransfer(nas_pdu=body["dedicated_info_type"][1])
    if name == "rrc_connection_release":
        body = msg["critical_extensions"][1][1]
        return RrcConnectionRelease(cause=body["release_cause"])
    raise ValueError(f"unknown DL-DCCH type {name}")
