"""38.331 (NR RRC) UPER schema subset on the rrc_uper engine.

Counterpart of the generated `lib/src/asn1/rrc_nr.cc` for the messages
the framework's NSA/SA flows exchange: RRCReconfiguration (with the
secondaryCellGroup container) and RadioBearerConfig with its full
DRB/PDCP/security substructure — declarative specs interpreted by
`rrc_uper.decode/encode`, validated byte-exactly against the
reference's committed vectors (lib/test/asn1/srsran_asn1_rrc_nr_test.cc
test_ue_rrc_reconfiguration, test_radio_bearer_config).
"""

from __future__ import annotations

from .asn1 import BitReader, BitWriter
from .rrc_uper import decode, encode

# ---- PDCP-Config (38.331 §6.3.2) -------------------------------------------

_DISCARD_TIMER = ("enum", 16)     # ms10..infinity
_SN_SIZE = ("enum", 2)            # len12bits, len18bits
_T_REORDERING = ("enum", 36)

_PDCP_DRB = ("seq", False, [
    ("discard_timer", _DISCARD_TIMER, "o"),
    ("pdcp_sn_size_ul", _SN_SIZE, "o"),
    ("pdcp_sn_size_dl", _SN_SIZE, "o"),
    ("header_compression", ("choice", True, [
        ("not_used", ("null",)),
        ("rohc", ("seq", False, [
            ("max_cid", ("int", 1, 16383), "o"),
            ("profiles", ("bits", 9), "m"),
            ("drb_continue_rohc", ("enum", 1), "o")])),
        ("ul_only_rohc", ("seq", False, [
            ("max_cid", ("int", 1, 16383), "o"),
            ("profiles", ("bits", 1), "m"),
            ("drb_continue_rohc", ("enum", 1), "o")]))]), "m"),
    ("integrity_protection", ("enum", 1), "o"),
    ("status_report_required", ("enum", 1), "o"),
    ("out_of_order_delivery", ("enum", 1), "o"),
])

PDCP_CONFIG = ("seq", True, [
    ("drb", _PDCP_DRB, "o"),
    ("more_than_one_rlc", ("seq", False, [
        ("primary_path", ("seq", False, [
            ("cell_group", ("int", 0, 3), "o"),
            ("logical_channel", ("int", 1, 32), "o")]), "m"),
        ("ul_data_split_threshold", ("enum", 64), "o"),
        ("pdcp_duplication", ("bool",), "o")]), "o"),
    ("t_reordering", _T_REORDERING, "o"),
])

# ---- RadioBearerConfig ------------------------------------------------------

SDAP_CONFIG = ("seq", True, [
    ("pdu_session", ("int", 0, 255), "m"),
    ("sdap_hdr_dl", ("enum", 2), "m"),
    ("sdap_hdr_ul", ("enum", 2), "m"),
    ("default_drb", ("bool",), "m"),
    ("mapped_qos_flows_to_add", ("seqof", 1, 64, ("int", 0, 63)), "o"),
    ("mapped_qos_flows_to_release", ("seqof", 1, 64, ("int", 0, 63)), "o"),
])

DRB_TO_ADD_MOD = ("seq", True, [
    ("cn_association", ("choice", False, [
        ("eps_bearer_identity", ("int", 0, 15)),
        ("sdap_config", SDAP_CONFIG)]), "o"),
    ("drb_identity", ("int", 1, 32), "m"),
    ("reestablish_pdcp", ("enum", 1), "o"),
    ("recover_pdcp", ("enum", 1), "o"),
    ("pdcp_config", PDCP_CONFIG, "o"),
])

SRB_TO_ADD_MOD_NR = ("seq", True, [
    ("srb_identity", ("int", 1, 3), "m"),
    ("reestablish_pdcp", ("enum", 1), "o"),
    ("discard_on_pdcp", ("enum", 1), "o"),
    ("pdcp_config", PDCP_CONFIG, "o"),
])

SECURITY_ALGORITHM_CONFIG = ("seq", True, [
    ("ciphering_algorithm", ("enum+", 8), "m"),
    ("integrity_prot_algorithm", ("enum+", 8), "o"),
])

SECURITY_CONFIG = ("seq", True, [
    ("security_algorithm_config", SECURITY_ALGORITHM_CONFIG, "o"),
    ("key_to_use", ("enum", 2), "o"),
])

RADIO_BEARER_CONFIG = ("seq", True, [
    ("srb_to_add_mod_list", ("seqof", 1, 2, SRB_TO_ADD_MOD_NR), "o"),
    ("srb3_to_release", ("enum", 1), "o"),
    ("drb_to_add_mod_list", ("seqof", 1, 29, DRB_TO_ADD_MOD), "o"),
    ("drb_to_release_list", ("seqof", 1, 29, ("int", 1, 32)), "o"),
    ("security_config", SECURITY_CONFIG, "o"),
])

# ---- RRCReconfiguration -----------------------------------------------------

_MEAS_CONFIG_OPAQUE = ("octets*",)   # not exercised by the NSA flow

RRC_RECFG_V1530_IES = ("seq", False, [
    ("master_cell_group", ("octets*",), "o"),
    ("full_config", ("enum", 1), "o"),
    ("dedicated_nas_msg_list", ("seqof", 1, 29, ("octets*",)), "o"),
    ("master_key_update", ("seq", True, [
        ("key_set_change_ind", ("bool",), "m"),
        ("next_hop_chaining_count", ("int", 0, 7), "m"),
        ("nas_container", ("octets*",), "o")]), "o"),
    ("dedicated_sib1_delivery", ("octets*",), "o"),
    ("dedicated_sys_info_delivery", ("octets*",), "o"),
    ("other_config", ("seq", False, [
        ("delay_budget_report_cfg", ("choice", False, [
            ("release", ("null",)),
            ("setup", ("seq", False, [
                ("delay_budget_report_prohibit_timer",
                 ("enum", 8), "m")]))]), "o")]), "o"),
    ("non_crit_ext", ("seq", False, []), "o"),
])

RRC_RECFG_IES = ("seq", False, [
    ("radio_bearer_config", RADIO_BEARER_CONFIG, "o"),
    ("secondary_cell_group", ("octets*",), "o"),
    ("meas_config", _MEAS_CONFIG_OPAQUE, "o"),
    ("late_non_critical_extension", ("octets*",), "o"),
    ("non_critical_extension", RRC_RECFG_V1530_IES, "o"),
])

RRC_RECONFIGURATION = ("seq", False, [
    ("rrc_transaction_id", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("rrc_reconfiguration", RRC_RECFG_IES),
        ("critical_extensions_future", ("seq", False, []))]), "m"),
])


def unpack(spec, data: bytes):
    return decode(spec, BitReader(data))


def pack(spec, value) -> bytes:
    w = BitWriter()
    encode(spec, value, w)
    return w.to_bytes()


# ---- SA connection-control messages (38.331 §6.2.2) -------------------------
# Schemas verified against the reference's generated pack functions
# (lib/src/asn1/rrc_nr.cc: rrc_setup_request_ies_s::pack:18179,
# rrc_setup_ies_s::pack:9424, rrc_setup_complete_ies_s::pack:21766, ...)
# and proven byte-exact through the compiled codec in
# tests/test_rrc_nr_wire_exact.py.

_EMPTY_SEQ = ("seq", False, [])

INITIAL_UE_IDENTITY = ("choice", False, [
    ("ng_5g_s_tmsi_part1", ("bits", 39)),
    ("random_value", ("bits", 39))])

RRC_SETUP_REQUEST = ("seq", False, [
    ("rrc_setup_request", ("seq", False, [
        ("ue_id", INITIAL_UE_IDENTITY, "m"),
        ("establishment_cause", ("enum", 16), "m"),
        ("spare", ("bits", 1), "m")]), "m"),
])

RRC_SETUP_IES = ("seq", False, [
    ("radio_bearer_config", RADIO_BEARER_CONFIG, "m"),
    ("master_cell_group", ("octets*",), "m"),
    ("late_non_crit_ext", ("octets*",), "o"),
    ("non_crit_ext", _EMPTY_SEQ, "o"),
])

RRC_SETUP = ("seq", False, [
    ("rrc_transaction_id", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("rrc_setup", RRC_SETUP_IES),
        ("critical_extensions_future", _EMPTY_SEQ)]), "m"),
])

PLMN_IDENTITY_NR = ("seq", False, [
    ("mcc", ("seqof", 3, 3, ("int", 0, 9)), "o"),
    ("mnc", ("seqof", 2, 3, ("int", 0, 9)), "m"),
])

REGISTERED_AMF = ("seq", False, [
    ("plmn_identity", PLMN_IDENTITY_NR, "o"),
    ("amf_identifier", ("bits", 24), "m"),
])

S_NSSAI = ("choice", False, [
    ("sst", ("bits", 8)),
    ("sst_sd", ("bits", 32))])

RRC_SETUP_COMPLETE_IES = ("seq", False, [
    ("selected_plmn_identity", ("int", 1, 12), "m"),
    ("registered_amf", REGISTERED_AMF, "o"),
    ("guami_type", ("enum", 2), "o"),
    ("s_nssai_list", ("seqof", 1, 8, S_NSSAI), "o"),
    ("dedicated_nas_msg", ("octets*",), "m"),
    ("ng_5g_s_tmsi_value", ("choice", False, [
        ("ng_5g_s_tmsi", ("bits", 48)),
        ("ng_5g_s_tmsi_part2", ("bits", 9))]), "o"),
    ("late_non_crit_ext", ("octets*",), "o"),
    ("non_crit_ext", _EMPTY_SEQ, "o"),
])

RRC_SETUP_COMPLETE = ("seq", False, [
    ("rrc_transaction_id", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("rrc_setup_complete", RRC_SETUP_COMPLETE_IES),
        ("critical_extensions_future", _EMPTY_SEQ)]), "m"),
])

SECURITY_CFG_SMC = ("seq", True, [
    ("security_algorithm_config", SECURITY_ALGORITHM_CONFIG, "m"),
])

SECURITY_MODE_COMMAND = ("seq", False, [
    ("rrc_transaction_id", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("security_mode_command", ("seq", False, [
            ("security_config_smc", SECURITY_CFG_SMC, "m"),
            ("late_non_crit_ext", ("octets*",), "o"),
            ("non_crit_ext", _EMPTY_SEQ, "o")])),
        ("critical_extensions_future", _EMPTY_SEQ)]), "m"),
])

SECURITY_MODE_COMPLETE = ("seq", False, [
    ("rrc_transaction_id", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("security_mode_complete", ("seq", False, [
            ("late_non_crit_ext", ("octets*",), "o"),
            ("non_crit_ext", _EMPTY_SEQ, "o")])),
        ("critical_extensions_future", _EMPTY_SEQ)]), "m"),
])

RRC_RECONFIGURATION_COMPLETE = ("seq", False, [
    ("rrc_transaction_id", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("rrc_reconfiguration_complete", ("seq", False, [
            ("late_non_crit_ext", ("octets*",), "o"),
            ("non_crit_ext", _EMPTY_SEQ, "o")])),
        ("critical_extensions_future", _EMPTY_SEQ)]), "m"),
])

UL_INFORMATION_TRANSFER = ("seq", False, [
    ("critical_extensions", ("choice", False, [
        ("ul_information_transfer", ("seq", False, [
            ("dedicated_nas_msg", ("octets*",), "o"),
            ("late_non_crit_ext", ("octets*",), "o"),
            ("non_crit_ext", _EMPTY_SEQ, "o")])),
        ("critical_extensions_future", _EMPTY_SEQ)]), "m"),
])

DL_INFORMATION_TRANSFER = ("seq", False, [
    ("rrc_transaction_id", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("dl_information_transfer", ("seq", False, [
            ("dedicated_nas_msg", ("octets*",), "o"),
            ("late_non_crit_ext", ("octets*",), "o"),
            ("non_crit_ext", _EMPTY_SEQ, "o")])),
        ("critical_extensions_future", _EMPTY_SEQ)]), "m"),
])

RRC_RECONFIGURATION_FULL = ("seq", False, [
    ("rrc_transaction_id", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("rrc_reconfiguration", RRC_RECFG_IES),
        ("critical_extensions_future", _EMPTY_SEQ)]), "m"),
])

# ---- logical-channel message wrappers (38.331 §6.2.1) -----------------------
# {UL,DL}-{CCCH,DCCH}-Message ::= SEQUENCE { message CHOICE { c1 CHOICE
# {...}, messageClassExtension SEQUENCE {} } }; alternative order follows
# the generated types_opts enums (rrc_nr.h ul_ccch_msg_type_c:7908,
# dl_ccch_msg_type_c:4406, ul_dcch_msg_type_c:10138,
# dl_dcch_msg_type_c:7295).

def _wrapper(alts: list[tuple[str, tuple | None]]):
    full = [(n, s if s is not None else _EMPTY_SEQ) for n, s in alts]
    return ("choice", False, [
        ("c1", ("choice", False, full)),
        ("message_class_extension", _EMPTY_SEQ)])


UL_CCCH_MESSAGE = _wrapper([
    ("rrc_setup_request", RRC_SETUP_REQUEST),
    ("rrc_resume_request", None),
    ("rrc_reestablishment_request", None),
    ("rrc_system_info_request", None)])

DL_CCCH_MESSAGE = _wrapper([
    ("rrc_reject", None),
    ("rrc_setup", RRC_SETUP),
    ("spare2", None),
    ("spare1", None)])

UL_DCCH_MESSAGE = _wrapper([
    ("measurement_report", None),
    ("rrc_reconfiguration_complete", RRC_RECONFIGURATION_COMPLETE),
    ("rrc_setup_complete", RRC_SETUP_COMPLETE),
    ("rrc_reestablishment_complete", None),
    ("rrc_resume_complete", None),
    ("security_mode_complete", SECURITY_MODE_COMPLETE),
    ("security_mode_failure", None),
    ("ul_information_transfer", UL_INFORMATION_TRANSFER),
    ("location_measurement_indication", None),
    ("ue_capability_information", None),
    ("counter_check_response", None),
    ("ue_assistance_information", None),
    ("failure_information", None),
    ("ul_information_transfer_mrdc", None),
    ("scg_failure_information", None),
    ("scg_failure_information_eutra", None)])

DL_DCCH_MESSAGE = _wrapper([
    ("rrc_reconfiguration", RRC_RECONFIGURATION_FULL),
    ("rrc_resume", None),
    ("rrc_release", None),
    ("rrc_reestablishment", None),
    ("security_mode_command", SECURITY_MODE_COMMAND),
    ("dl_information_transfer", DL_INFORMATION_TRANSFER),
    ("ue_capability_enquiry", None),
    ("counter_check", None),
    ("mobility_from_nr_command", None),
    ("spare7", None), ("spare6", None), ("spare5", None),
    ("spare4", None), ("spare3", None), ("spare2", None),
    ("spare1", None)])


def pack_msg(wrapper, name: str, value) -> bytes:
    """Pack one c1 message into its logical-channel wrapper."""
    return pack(wrapper, ("c1", (name, value)))


def unpack_msg(wrapper, data: bytes):
    """→ (message_name, value) from a logical-channel PDU."""
    kind, inner = unpack(wrapper, data)
    assert kind == "c1", kind
    return inner
