"""3GPP-exact NB-IoT RRC codec (TS 36.331 §NB, UPER).

Counterpart of the reference's generated `lib/src/asn1/rrc_nbiot.cc`
(~28 k LoC): the NB-IoT control-plane message set for cell acquisition
and CP-CIoT attach, interpreted from declarative schemas on the
`rrc_uper` X.691 UPER engine.  Every encoding round-trips byte-exactly
through the reference's own compiled codec (tools/ref_rrc.py harness
with the `*_nb` classes; tests/test_rrc_nbiot.py).

Messages: MasterInformationBlock-NB (BCCH-BCH-NB, pairs with
models/npbch), SystemInformationBlockType1-NB (BCCH-DL-SCH-NB),
RRCConnectionRequest-NB / RRCConnectionSetup-NB /
RRCConnectionSetupComplete-NB (UL/DL-CCCH-NB + UL-DCCH-NB) — the set
srsUE's NB-IoT attach would exercise (reference grammar is r13 with
the r14-r17 fields the generated codec carries inline).
"""

from __future__ import annotations

from dataclasses import dataclass

from . import rrc_uper as U

# ---- MasterInformationBlock-NB (BCCH-BCH-NB) --------------------------------

OPERATION_MODE_INFO = ("choice", False, [
    ("inband_same_pci", ("seq", False, [
        ("eutra_crs_sequence_info", ("int", 0, 31), "m"),
    ])),
    ("inband_different_pci", ("seq", False, [
        ("eutra_num_crs_ports", ("enum", 2), "m"),
        ("raster_offset", ("enum", 4), "m"),
        ("spare", ("bits", 2), "m"),
    ])),
    ("guardband", ("seq", False, [
        ("raster_offset", ("enum", 4), "m"),
        ("spare", ("bits", 3), "m"),
    ])),
    ("standalone", ("seq", False, [
        ("spare", ("bits", 5), "m"),
    ])),
])

MIB_NB = ("seq", False, [
    ("system_frame_number_msb", ("bits", 4), "m"),
    ("hyper_sfn_lsb", ("bits", 2), "m"),
    ("scheduling_info_sib1", ("int", 0, 15), "m"),
    ("system_info_value_tag", ("int", 0, 31), "m"),
    ("ab_enabled", ("bool",), "m"),
    ("operation_mode_info", OPERATION_MODE_INFO, "m"),
    ("additional_transmission_sib1_r15", ("bool",), "m"),
    ("ab_enabled_5gc_r16", ("bool",), "m"),
    ("part_earfcn_17", ("choice", False, [
        ("spare", ("bits", 2)),
        ("earfcn_lsb", ("bits", 2)),
    ]), "m"),
    ("spare", ("bits", 6), "m"),
])

BCCH_BCH_NB_MESSAGE = ("seq", False, [("message", MIB_NB, "m")])

# ---- SystemInformationBlockType1-NB (BCCH-DL-SCH-NB) ------------------------

PLMN_IDENTITY_INFO_NB = ("seq", False, [
    ("attach_without_pdn_connectivity", ("enum", 1), "o"),
    ("plmn_identity", U.PLMN_IDENTITY, "m"),
    ("cell_reserved_for_operator_use", ("enum", 2), "m"),
])

SCHEDULING_INFO_NB = ("seq", False, [
    ("si_periodicity", ("enum", 8), "m"),       # rf64..rf4096+spare
    ("si_repetition_pattern", ("enum", 4), "m"),  # every2nd..every16th rf
    ("sib_mapping_info", ("seqof", 0, 31, ("enum+", 8)), "m"),
    ("si_tb", ("enum", 8), "m"),                # b56..b680
])

SIB1_NB = ("seq", False, [
    ("hyper_sfn_msb", ("bits", 8), "m"),
    ("cell_access_related_info", ("seq", False, [
        ("plmn_identity_list", ("seqof", 1, 6, PLMN_IDENTITY_INFO_NB), "m"),
        ("tracking_area_code", ("bits", 16), "m"),
        ("cell_identity", ("bits", 28), "m"),
        ("cell_barred", ("enum", 2), "m"),
        ("intra_freq_reselection", ("enum", 2), "m"),
    ]), "m"),
    ("cell_selection_info", ("seq", False, [
        ("q_rx_lev_min", ("int", -70, -22), "m"),
        ("q_qual_min", ("int", -34, -3), "m"),
    ]), "m"),
    ("p_max", ("int", -30, 33), "o"),
    ("freq_band_indicator", ("int", 1, 256), "m"),
    ("freq_band_info", ("null",), "o"),
    ("multi_band_info_list", ("null",), "o"),
    ("downlink_bitmap", ("null",), "o"),
    ("eutra_control_region_size", ("enum", 3), "o"),
    ("nrs_crs_power_offset", ("enum", 16), "o"),
    ("scheduling_info_list", ("seqof", 1, 8, SCHEDULING_INFO_NB), "m"),
    ("si_window_length", ("enum", 8), "m"),     # ms160..ms1600+spare
    ("si_radio_frame_offset", ("int", 1, 15), "o"),
    ("system_info_value_tag_list", ("null",), "o"),
    ("late_non_critical_extension", ("octets*",), "o"),
    ("non_critical_extension", ("seq", False, []), "o"),
])

# The field order of SIB1-NB on the wire interleaves presence flags
# first (generated codec style): the schema above intentionally mirrors
# the reference's pack order, which hoists ALL presence bits before the
# field bodies — exactly what the generic "seq" encoder does.

BCCH_DL_SCH_NB_MESSAGE = ("choice", False, [
    ("c1", ("choice", False, [
        ("system_information", ("null",)),
        ("system_information_block_type1", SIB1_NB),
    ])),
    ("message_class_extension", ("seq", False, [])),
])

# ---- UL-CCCH-NB: RRCConnectionRequest-NB ------------------------------------

S_TMSI = ("seq", False, [
    ("mmec", ("bits", 8), "m"),
    ("m_tmsi", ("bits", 32), "m"),
])

RRC_CONNECTION_REQUEST_NB = ("seq", False, [
    ("critical_extensions", ("choice", False, [
        ("rrc_connection_request_r13", ("seq", False, [
            ("multi_tone_support", ("enum", 1), "o"),
            ("multi_carrier_support", ("enum", 1), "o"),
            ("ue_identity", ("choice", False, [
                ("s_tmsi", S_TMSI),
                ("random_value", ("bits", 40)),
            ]), "m"),
            ("establishment_cause", ("enum", 8), "m"),
            ("early_contention_resolution_r14", ("bool",), "m"),
            ("cqi_npdcch_r14", ("enum", 13), "m"),
            ("spare", ("bits", 17), "m"),
        ])),
        ("later", ("choice", False, [
            ("rrc_connection_request_r16", ("null",)),
            ("critical_extensions_future", ("seq", False, [])),
        ])),
    ]), "m"),
])

UL_CCCH_NB_MESSAGE = ("choice", False, [
    ("c1", ("choice", False, [
        ("rrc_connection_reestablishment_request_r13", ("null",)),
        ("rrc_connection_request_r13", RRC_CONNECTION_REQUEST_NB),
        ("rrc_connection_resume_request_r13", ("null",)),
        ("rrc_early_data_request_r15", ("null",)),
    ])),
    ("message_class_extension", ("seq", False, [])),
])

# ---- DL-CCCH-NB: RRCConnectionSetup-NB --------------------------------------

RR_CONFIG_DEDICATED_NB = ("seq", True, [
    ("srb_to_add_mod_list", ("null",), "o"),
    ("drb_to_add_mod_list", ("null",), "o"),
    ("drb_to_release_list", ("null",), "o"),
    ("mac_main_config", ("null",), "o"),
    ("physical_config_dedicated", ("null",), "o"),
    ("rlf_timers_and_constants", ("null",), "o"),
])

RRC_CONNECTION_SETUP_NB = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("c1", ("choice", False, [
            ("rrc_connection_setup_r13", ("seq", False, [
                ("radio_resource_config_dedicated",
                 RR_CONFIG_DEDICATED_NB, "m"),
                ("late_non_critical_extension", ("octets*",), "o"),
                ("non_critical_extension", ("seq", False, []), "o"),
            ])),
            ("spare1", ("null",)),
        ])),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

DL_CCCH_NB_MESSAGE = ("choice", False, [
    ("c1", ("choice", False, [
        ("rrc_connection_reestablishment_r13", ("null",)),
        ("rrc_connection_reestablishment_reject_r13", ("null",)),
        ("rrc_connection_reject_r13", ("null",)),
        ("rrc_connection_setup_r13", RRC_CONNECTION_SETUP_NB),
        ("rrc_early_data_complete_r15", ("null",)),
        ("spare3", ("null",)), ("spare2", ("null",)),
        ("spare1", ("null",)),
    ])),
    ("message_class_extension", ("seq", False, [])),
])

# ---- UL-DCCH-NB: RRCConnectionSetupComplete-NB ------------------------------

RRC_CONNECTION_SETUP_COMPLETE_NB = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("rrc_connection_setup_complete_r13", ("seq", False, [
            ("selected_plmn_identity", ("int", 1, 6), "m"),
            ("s_tmsi", S_TMSI, "o"),
            ("registered_mme", ("seq", False, [
                ("plmn_identity", U.PLMN_IDENTITY, "o"),
                ("mmegi", ("bits", 16), "m"),
                ("mmec", ("bits", 8), "m"),
            ]), "o"),
            ("attach_without_pdn_connectivity", ("enum", 1), "o"),
            ("up_ciot_eps_optimisation", ("enum", 1), "o"),
            ("dedicated_info_nas", ("octets*",), "m"),
            ("late_non_critical_extension", ("octets*",), "o"),
            ("non_critical_extension", ("seq", False, []), "o"),
        ])),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

UL_DCCH_NB_MESSAGE = ("choice", False, [
    ("c1", ("choice", False, [
        ("rrc_connection_reconfiguration_complete_r13", ("null",)),
        ("rrc_connection_reestablishment_complete_r13", ("null",)),
        ("rrc_connection_setup_complete_r13",
         RRC_CONNECTION_SETUP_COMPLETE_NB),
        ("security_mode_complete_r13", ("null",)),
        ("security_mode_failure_r13", ("null",)),
        ("ue_capability_information_r13", ("null",)),
        ("ul_information_transfer_r13", ("null",)),
        ("rrc_connection_resume_complete_r13", ("null",)),
        ("ue_information_response_r16", ("null",)),
        ("pur_config_request_r16", ("null",)),
        ("spare6", ("null",)), ("spare5", ("null",)),
        ("spare4", ("null",)), ("spare3", ("null",)),
        ("spare2", ("null",)), ("spare1", ("null",)),
    ])),
    ("message_class_extension", ("seq", False, [])),
])


# ---- typed message API ------------------------------------------------------

@dataclass
class MibNb:
    """MasterInformationBlock-NB — 34 bits, carried by models/npbch."""
    sfn_msb: int = 0            # 4 MSBs of the 10-bit SFN
    hyper_sfn_lsb: int = 0
    scheduling_info_sib1: int = 0
    system_info_value_tag: int = 0
    ab_enabled: bool = False
    mode: str = "standalone"    # standalone | guardband | inband

    def pack(self) -> bytes:
        if self.mode == "standalone":
            op = ("standalone", {"spare": 0})
        elif self.mode == "guardband":
            op = ("guardband", {"raster_offset": 0, "spare": 0})
        else:
            op = ("inband_same_pci", {"eutra_crs_sequence_info": 0})
        mib = {
            "system_frame_number_msb": self.sfn_msb,
            "hyper_sfn_lsb": self.hyper_sfn_lsb,
            "scheduling_info_sib1": self.scheduling_info_sib1,
            "system_info_value_tag": self.system_info_value_tag,
            "ab_enabled": self.ab_enabled,
            "operation_mode_info": op,
            "additional_transmission_sib1_r15": False,
            "ab_enabled_5gc_r16": False,
            "part_earfcn_17": ("spare", 0),
            "spare": 0,
        }
        return U.encode_bytes(BCCH_BCH_NB_MESSAGE, {"message": mib})

    @classmethod
    def unpack(cls, data: bytes) -> "MibNb":
        v, _ = U.decode_bytes(BCCH_BCH_NB_MESSAGE, data)
        m = v["message"]
        mode = {"standalone": "standalone", "guardband": "guardband"}.get(
            m["operation_mode_info"][0], "inband")
        return cls(sfn_msb=m["system_frame_number_msb"],
                   hyper_sfn_lsb=m["hyper_sfn_lsb"],
                   scheduling_info_sib1=m["scheduling_info_sib1"],
                   system_info_value_tag=m["system_info_value_tag"],
                   ab_enabled=m["ab_enabled"], mode=mode)


@dataclass
class Sib1Nb:
    plmn_mcc: int = 1
    plmn_mnc: int = 1
    tac: int = 0x0001
    cell_id: int = 0x01
    q_rx_lev_min: int = -65
    freq_band: int = 5
    si_window_ms: int = 160

    _SI_WINDOW = (160, 320, 480, 640, 960, 1280, 1600)

    def pack(self) -> bytes:
        from .rrc_msgs import _plmn_digits

        sib1 = {
            "hyper_sfn_msb": 0,
            "cell_access_related_info": {
                "plmn_identity_list": [{
                    "plmn_identity": _plmn_digits(self.plmn_mcc,
                                                  self.plmn_mnc),
                    "cell_reserved_for_operator_use": 1,
                }],
                "tracking_area_code": self.tac,
                "cell_identity": self.cell_id,
                "cell_barred": 1,
                "intra_freq_reselection": 0,
            },
            "cell_selection_info": {"q_rx_lev_min": self.q_rx_lev_min,
                                    "q_qual_min": -20},
            "freq_band_indicator": self.freq_band,
            "scheduling_info_list": [{
                "si_periodicity": 0, "si_repetition_pattern": 0,
                "sib_mapping_info": [], "si_tb": 1,
            }],
            "si_window_length": self._SI_WINDOW.index(self.si_window_ms),
        }
        return U.encode_bytes(
            BCCH_DL_SCH_NB_MESSAGE,
            ("c1", ("system_information_block_type1", sib1)))

    @classmethod
    def unpack(cls, data: bytes) -> "Sib1Nb":
        from .rrc_msgs import _plmn_ints

        v, _ = U.decode_bytes(BCCH_DL_SCH_NB_MESSAGE, data)
        sib1 = v[1][1]
        acc = sib1["cell_access_related_info"]
        mcc, mnc = _plmn_ints(acc["plmn_identity_list"][0]["plmn_identity"])
        return cls(plmn_mcc=mcc, plmn_mnc=mnc,
                   tac=acc["tracking_area_code"],
                   cell_id=acc["cell_identity"],
                   q_rx_lev_min=sib1["cell_selection_info"]["q_rx_lev_min"],
                   freq_band=sib1["freq_band_indicator"],
                   si_window_ms=cls._SI_WINDOW[sib1["si_window_length"]])


# 36.331 EstablishmentCause-NB-r13
CAUSE_MT_ACCESS, CAUSE_MO_SIGNALLING, CAUSE_MO_DATA, CAUSE_MO_EXCEPTION = \
    range(4)


@dataclass
class RrcConnectionRequestNb:
    ue_identity: int = 0        # 40-bit random value
    establishment_cause: int = CAUSE_MO_DATA
    multi_tone: bool = False

    def pack(self) -> bytes:
        r13 = {
            "ue_identity": ("random_value", self.ue_identity),
            "establishment_cause": self.establishment_cause,
            "early_contention_resolution_r14": False,
            "cqi_npdcch_r14": 0,
            "spare": 0,
        }
        if self.multi_tone:
            r13["multi_tone_support"] = 0
        msg = {"critical_extensions": ("rrc_connection_request_r13", r13)}
        return U.encode_bytes(
            UL_CCCH_NB_MESSAGE,
            ("c1", ("rrc_connection_request_r13", msg)))


@dataclass
class RrcConnectionSetupNb:
    def pack(self) -> bytes:
        msg = {"rrc_transaction_identifier": 0,
               "critical_extensions": ("c1", ("rrc_connection_setup_r13", {
                   "radio_resource_config_dedicated": {}}))}
        return U.encode_bytes(
            DL_CCCH_NB_MESSAGE, ("c1", ("rrc_connection_setup_r13", msg)))


@dataclass
class RrcConnectionSetupCompleteNb:
    selected_plmn: int = 1
    nas_pdu: bytes = b""

    def pack(self) -> bytes:
        msg = {"rrc_transaction_identifier": 0,
               "critical_extensions": (
                   "rrc_connection_setup_complete_r13", {
                       "selected_plmn_identity": self.selected_plmn,
                       "dedicated_info_nas": self.nas_pdu})}
        return U.encode_bytes(
            UL_DCCH_NB_MESSAGE,
            ("c1", ("rrc_connection_setup_complete_r13", msg)))


def unpack_ul_ccch_nb(data: bytes):
    v, _ = U.decode_bytes(UL_CCCH_NB_MESSAGE, data)
    name, msg = v[1]
    if name == "rrc_connection_request_r13":
        r13 = msg["critical_extensions"][1]
        ident = r13["ue_identity"]
        ue_id = ident[1] if ident[0] == "random_value" else \
            (ident[1]["mmec"] << 32) | ident[1]["m_tmsi"]
        return RrcConnectionRequestNb(
            ue_identity=ue_id,
            establishment_cause=r13["establishment_cause"],
            multi_tone="multi_tone_support" in r13)
    raise ValueError(f"unsupported UL-CCCH-NB type {name}")


def unpack_ul_dcch_nb(data: bytes):
    v, _ = U.decode_bytes(UL_DCCH_NB_MESSAGE, data)
    name, msg = v[1]
    if name == "rrc_connection_setup_complete_r13":
        r13 = msg["critical_extensions"][1]
        return RrcConnectionSetupCompleteNb(
            selected_plmn=r13["selected_plmn_identity"],
            nas_pdu=r13["dedicated_info_nas"])
    raise ValueError(f"unsupported UL-DCCH-NB type {name}")
