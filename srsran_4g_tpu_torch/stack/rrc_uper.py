"""3GPP-exact RRC UPER codec for a golden message subset (TS 36.331).

Golden-interop counterpart of the reference's generated RRC codec
(`lib/src/asn1/rrc/*`, ~400 k generated LoC): instead of generating
imperative pack/unpack code, this module interprets a declarative
schema of the 36.331 grammar with a compact X.691 UPER engine
(unaligned PER: constrained whole numbers, extensible SEQUENCE
preambles, CHOICE indices, constrained SEQUENCE OF lengths, BIT/OCTET
STRINGs).  The acceptance set is the reference's committed golden
vectors (`lib/test/asn1/srsran_asn1_rrc_*_test.cc`), round-tripped
byte-exactly in tests/test_golden_interop.py.

Covered messages: UL-DCCH MeasurementReport, DL-DCCH
UECapabilityEnquiry, DL-CCCH RRCConnectionSetup (full
RadioResourceConfigDedicated), MCCH MBSFNAreaConfiguration-r9,
UL-CCCH RRCConnectionRequest.
"""

from __future__ import annotations

from srsran_4g_tpu_torch.stack.asn1 import BitReader, BitWriter

# --------------------------------------------------------------------------
# X.691 UPER engine over declarative type specs.
#
# A spec is a tuple whose head names the type:
#   ("int", lo, hi)                       constrained whole number
#   ("enum", n)  / ("enum+", n)           enumerated (+ = extensible)
#   ("bool",)
#   ("bits", n) / ("octets", n)           fixed-size BIT/OCTET STRING
#   ("seq", ext, [(name, spec, opt)...])  SEQUENCE; opt in {"m","o"}
#   ("choice", ext, [(name, spec)...])    CHOICE
#   ("seqof", lo, hi, spec)               SEQUENCE (SIZE(lo..hi)) OF
#   ("null",)
# Decoded values: int/bool for scalars, dict for seq, (name, value) for
# choice, list for seqof, int for bits (MSB-first), bytes for octets.


def _nbits(n_values: int) -> int:
    return max(1, (n_values - 1).bit_length()) if n_values > 1 else 0


def decode(spec, r: BitReader):
    kind = spec[0]
    if kind == "int":
        lo, hi = spec[1], spec[2]
        return lo + (r.get(_nbits(hi - lo + 1)) if hi > lo else 0)
    if kind in ("enum", "enum+"):
        if kind == "enum+" and r.get(1):
            # X.691 §14.6: an extension value is a normally-small whole
            # number — decode it to an ("ext-enum", n) marker instead of
            # raising (a receiver must skip unknown extension values,
            # 36.331 §10.4), preserving byte-exact re-encoding
            if r.get(1):
                raise ValueError("large extended-enum value")
            return ("ext-enum", r.get(6))
        return r.get(_nbits(spec[1]))
    if kind == "bool":
        return bool(r.get(1))
    if kind == "bits":
        return r.get(spec[1])
    if kind == "octets":
        return bytes(r.get(8) for _ in range(spec[1]))
    if kind == "octets*":
        # unconstrained OCTET STRING: X.691 §11.9 general length,
        # including the >=16K fragmented form (marker 0b11 | m)
        out = bytearray()
        while True:
            n = r.get(8)
            if n & 0x80 == 0:
                out += bytes(r.get(8) for _ in range(n))
                return bytes(out)
            if n >> 6 == 0b10:
                n = ((n & 0x3F) << 8) | r.get(8)
                out += bytes(r.get(8) for _ in range(n))
                return bytes(out)
            out += bytes(r.get(8) for _ in range(16384 * (n & 0x3F)))
    if kind == "null":
        return None
    if kind == "seq":
        _, ext, fields = spec
        has_ext = bool(ext and r.get(1))
        present = {}
        for name, fspec, opt in fields:
            present[name] = (opt == "m") or bool(r.get(1))
        out = {}
        for name, fspec, opt in fields:
            if present[name]:
                out[name] = decode(fspec, r)
        if has_ext:
            # X.691 §18.7-9: normally-small count, presence bitmap, then
            # each present addition group as an open type.  Preserved as
            # raw octets so re-encoding is byte-exact without a schema.
            if r.get(1):
                raise ValueError("large ext addition count")
            n = r.get(6) + 1
            bitmap = [bool(r.get(1)) for _ in range(n)]
            groups = []
            for p in bitmap:
                if not p:
                    groups.append(None)
                    continue
                ln = r.get(8)
                if ln & 0x80:
                    if ln >> 6 == 0b10:
                        ln = ((ln & 0x3F) << 8) | r.get(8)
                    else:
                        raise ValueError("fragmented open type")
                groups.append(bytes(r.get(8) for _ in range(ln)))
            out["_ext"] = groups
        return out
    if kind == "choice":
        ext, alts = spec[1], spec[2]
        ext_alts = spec[3] if len(spec) > 3 else []
        if ext and r.get(1):
            # X.691 §23.8: extended alternative = normally-small index,
            # then the value as an open type
            if r.get(1):
                raise ValueError("large extended-choice index")
            idx = r.get(6)
            if idx >= len(ext_alts):
                raise ValueError("unknown extended choice alternative")
            name, aspec = ext_alts[idx]
            blob = decode(("octets*",), r)
            inner = BitReader(blob)
            return (name, decode(aspec, inner))
        idx = r.get(_nbits(len(alts)))
        name, aspec = alts[idx]
        return (name, decode(aspec, r))
    if kind == "seqof":
        _, lo, hi, espec = spec
        n = lo + (r.get(_nbits(hi - lo + 1)) if hi > lo else 0)
        return [decode(espec, r) for _ in range(n)]
    raise ValueError(kind)


def encode(spec, v, w: BitWriter) -> None:
    kind = spec[0]
    if kind == "int":
        lo, hi = spec[1], spec[2]
        if hi > lo:
            w.put(v - lo, _nbits(hi - lo + 1))
        return
    if kind in ("enum", "enum+"):
        if kind == "enum+":
            if isinstance(v, tuple) and v[0] == "ext-enum":
                w.put(1, 1)
                w.put(0, 1)
                w.put(v[1], 6)
                return
            w.put(0, 1)
        w.put(v, _nbits(spec[1]))
        return
    if kind == "bool":
        w.put(1 if v else 0, 1)
        return
    if kind == "bits":
        w.put(v, spec[1])
        return
    if kind == "octets":
        for b in v:
            w.put(b, 8)
        return
    if kind == "octets*":
        pos = 0
        while len(v) - pos >= 16384:
            m = min((len(v) - pos) // 16384, 4)
            w.put(0b11, 2)
            w.put(m, 6)
            for b in v[pos:pos + m * 16384]:
                w.put(b, 8)
            pos += m * 16384
        rest = len(v) - pos
        if rest < 128:
            w.put(rest, 8)
        else:
            w.put(0b10, 2)
            w.put(rest, 14)
        for b in v[pos:]:
            w.put(b, 8)
        return
    if kind == "null":
        return
    if kind == "seq":
        _, ext, fields = spec
        if ext:
            w.put(1 if "_ext" in v else 0, 1)
        for name, fspec, opt in fields:
            if opt == "o":
                w.put(1 if name in v else 0, 1)
        for name, fspec, opt in fields:
            if name in v:
                encode(fspec, v[name], w)
            elif opt == "m":
                raise ValueError(f"missing mandatory field {name}")
        if "_ext" in v:
            groups = v["_ext"]
            w.put(0, 1)
            w.put(len(groups) - 1, 6)
            for g in groups:
                w.put(1 if g is not None else 0, 1)
            for g in groups:
                if g is None:
                    continue
                if len(g) < 128:
                    w.put(len(g), 8)
                else:
                    w.put(0b10, 2)
                    w.put(len(g), 14)
                for b in g:
                    w.put(b, 8)
        return
    if kind == "choice":
        ext, alts = spec[1], spec[2]
        ext_alts = spec[3] if len(spec) > 3 else []
        name, val = v
        for i, (n, aspec) in enumerate(ext_alts):
            if n == name:
                w.put(1, 1)          # extension bit
                w.put(0, 1)          # normally-small: <64
                w.put(i, 6)
                inner = BitWriter()
                encode(aspec, val, inner)
                encode(("octets*",), inner.to_bytes() or b"\0", w)
                return
        if ext:
            w.put(0, 1)
        idx = next(i for i, (n, _) in enumerate(alts) if n == name)
        w.put(idx, _nbits(len(alts)))
        encode(alts[idx][1], val, w)
        return
    if kind == "seqof":
        _, lo, hi, espec = spec
        if hi > lo:
            w.put(len(v) - lo, _nbits(hi - lo + 1))
        for e in v:
            encode(espec, e, w)
        return
    raise ValueError(kind)


# --------------------------------------------------------------------------
# 36.331 schema subset (Rel-8/9 grammar; field order/arity cross-checked
# against the reference's generated headers lib/include/srsran/asn1/rrc/*).

def _spare(spec, n):
    """n spare alternatives in a c1 CHOICE."""
    return [(f"spare{i}", ("null",)) for i in range(n, 0, -1)]


PLMN_IDENTITY = ("seq", False, [
    ("mcc", ("seqof", 3, 3, ("int", 0, 9)), "o"),
    ("mnc", ("seqof", 2, 3, ("int", 0, 9)), "m"),
])

DEDICATED_INFO_TYPE = ("choice", False, [
    ("dedicated_info_nas", ("octets*",)),
    ("dedicated_info_cdma2000_1xrtt", ("octets*",)),
    ("dedicated_info_cdma2000_hrpd", ("octets*",)),
])

CELL_GLOBAL_ID_EUTRA = ("seq", False, [
    ("plmn_identity", PLMN_IDENTITY, "m"),
    ("cell_identity", ("bits", 28), "m"),
])

MEAS_RESULT = ("seq", True, [
    ("rsrp_result", ("int", 0, 97), "o"),
    ("rsrq_result", ("int", 0, 34), "o"),
])

MEAS_RESULT_EUTRA = ("seq", False, [
    ("phys_cell_id", ("int", 0, 503), "m"),
    ("cgi_info", ("seq", False, [
        ("cell_global_id", CELL_GLOBAL_ID_EUTRA, "m"),
        ("tracking_area_code", ("bits", 16), "m"),
        ("plmn_identity_list", ("seqof", 1, 5, PLMN_IDENTITY), "o"),
    ]), "o"),
    ("meas_result", MEAS_RESULT, "m"),
])

MEAS_RESULT_NR_R15 = ("seq", True, [
    ("rsrp_result_r15", ("int", 0, 127), "o"),
    ("rsrq_result_r15", ("int", 0, 127), "o"),
    ("rs_sinr_result_r15", ("int", 0, 127), "o"),
])

MEAS_RESULT_CELL_NR_R15 = ("seq", True, [
    ("pci_r15", ("int", 0, 1007), "m"),
    ("meas_result_cell_r15", MEAS_RESULT_NR_R15, "m"),
    ("meas_result_rs_index_list_r15", ("seqof", 1, 32, ("seq", True, [
        ("ssb_index_r15", ("int", 0, 63), "m"),
        ("meas_result_ssb_index_r15", MEAS_RESULT_NR_R15, "o"),
    ])), "o"),
])

MEAS_RESULTS = ("seq", True, [
    ("meas_id", ("int", 1, 32), "m"),
    ("meas_result_pcell", ("seq", False, [
        ("rsrp_result", ("int", 0, 97), "m"),
        ("rsrq_result", ("int", 0, 34), "m"),
    ]), "m"),
    ("meas_result_neigh_cells", ("choice", True, [
        ("meas_result_list_eutra", ("seqof", 1, 8, MEAS_RESULT_EUTRA)),
        ("meas_result_list_utra", ("null",)),
        ("meas_result_list_geran", ("null",)),
        ("meas_results_cdma2000", ("null",)),
    ], [
        # extended alternative (36.331 r15, open-type wrapped): NR B1
        ("meas_result_neigh_cell_list_nr_r15",
         ("seqof", 1, 8, MEAS_RESULT_CELL_NR_R15)),
    ]), "o"),
])

MEASUREMENT_REPORT = ("seq", False, [
    ("critical_extensions", ("choice", False, [
        ("c1", ("choice", False, [
            ("measurement_report_r8", ("seq", False, [
                ("meas_results", MEAS_RESULTS, "m"),
                ("non_critical_extension", ("seq", False, []), "o"),
            ]))] + _spare(("null",), 7))),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

RRC_CONNECTION_RECONFIGURATION_COMPLETE = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("rrc_connection_reconfiguration_complete_r8", ("seq", False, [
            ("non_critical_extension", ("seq", False, []), "o"),
        ])),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

RRC_CONNECTION_REESTABLISHMENT_COMPLETE = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("rrc_connection_reestablishment_complete_r8", ("seq", False, [
            ("non_critical_extension", ("seq", False, []), "o"),
        ])),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

RRC_CONNECTION_SETUP_COMPLETE = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("c1", ("choice", False, [
            ("rrc_connection_setup_complete_r8", ("seq", False, [
                ("selected_plmn_identity", ("int", 1, 6), "m"),
                ("registered_mme", ("seq", False, [
                    ("plmn_identity", PLMN_IDENTITY, "o"),
                    ("mmegi", ("bits", 16), "m"),
                    ("mmec", ("bits", 8), "m"),
                ]), "o"),
                ("dedicated_info_nas", ("octets*",), "m"),
                ("non_critical_extension", ("seq", False, []), "o"),
            ]))] + _spare(("null",), 3))),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

SECURITY_MODE_COMPLETE = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("security_mode_complete_r8", ("seq", False, [
            ("non_critical_extension", ("seq", False, []), "o"),
        ])),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

SECURITY_MODE_FAILURE = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("security_mode_failure_r8", ("seq", False, [
            ("non_critical_extension", ("seq", False, []), "o"),
        ])),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

UL_INFORMATION_TRANSFER = ("seq", False, [
    ("critical_extensions", ("choice", False, [
        ("c1", ("choice", False, [
            ("ul_information_transfer_r8", ("seq", False, [
                ("dedicated_info_type", DEDICATED_INFO_TYPE, "m"),
                ("non_critical_extension", ("seq", False, []), "o"),
            ]))] + _spare(("null",), 3))),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

UL_DCCH_MESSAGE = ("choice", False, [
    ("c1", ("choice", False, [
        ("csfb_parameters_request_cdma2000", ("null",)),
        ("measurement_report", MEASUREMENT_REPORT),
        ("rrc_connection_reconfiguration_complete",
         RRC_CONNECTION_RECONFIGURATION_COMPLETE),
        ("rrc_connection_reestablishment_complete",
         RRC_CONNECTION_REESTABLISHMENT_COMPLETE),
        ("rrc_connection_setup_complete", RRC_CONNECTION_SETUP_COMPLETE),
        ("security_mode_complete", SECURITY_MODE_COMPLETE),
        ("security_mode_failure", SECURITY_MODE_FAILURE),
        ("ue_capability_information", ("null",)),
        ("ul_handover_preparation_transfer", ("null",)),
        ("ul_information_transfer", UL_INFORMATION_TRANSFER),
        ("counter_check_response", ("null",)),
        ("ue_information_response_r9", ("null",)),
        ("proximity_indication_r9", ("null",)),
        ("rn_reconfiguration_complete_r10", ("null",)),
        ("mbms_counting_response_r10", ("null",)),
        ("inter_freq_rstd_measurement_indication_r10", ("null",)),
    ])),
    ("message_class_extension", ("seq", False, [])),
])

# ---- RRCConnectionSetup (DL-CCCH) ------------------------------------------

UL_AM_RLC = ("seq", False, [
    ("t_poll_retransmit", ("enum", 64), "m"),
    ("poll_pdu", ("enum", 8), "m"),
    ("poll_byte", ("enum", 16), "m"),
    ("max_retx_threshold", ("enum", 8), "m"),
])

DL_AM_RLC = ("seq", False, [
    ("t_reordering", ("enum", 32), "m"),
    ("t_status_prohibit", ("enum", 64), "m"),
])

RLC_CONFIG = ("choice", True, [
    ("am", ("seq", False, [
        ("ul_am_rlc", UL_AM_RLC, "m"),
        ("dl_am_rlc", DL_AM_RLC, "m"),
    ])),
    ("um_bi_directional", ("seq", False, [
        ("ul_um_rlc", ("seq", False, [("sn_field_length", ("enum", 2), "m")]), "m"),
        ("dl_um_rlc", ("seq", False, [
            ("sn_field_length", ("enum", 2), "m"),
            ("t_reordering", ("enum", 32), "m"),
        ]), "m"),
    ])),
    ("um_uni_directional_ul", ("null",)),
    ("um_uni_directional_dl", ("null",)),
])

LOGICAL_CHANNEL_CONFIG = ("seq", True, [
    ("ul_specific_parameters", ("seq", False, [
        ("priority", ("int", 1, 16), "m"),
        ("prioritised_bit_rate", ("enum", 16), "m"),
        ("bucket_size_duration", ("enum", 8), "m"),
        ("logical_channel_group", ("int", 0, 3), "o"),
    ]), "o"),
])

SRB_TO_ADD_MOD = ("seq", True, [
    ("srb_identity", ("int", 1, 2), "m"),
    ("rlc_config", ("choice", False, [
        ("explicit_value", RLC_CONFIG),
        ("default_value", ("null",)),
    ]), "o"),
    ("logical_channel_config", ("choice", False, [
        ("explicit_value", LOGICAL_CHANNEL_CONFIG),
        ("default_value", ("null",)),
    ]), "o"),
])

ULSCH_CONFIG = ("seq", False, [
    ("max_harq_tx", ("enum", 16), "o"),
    ("periodic_bsr_timer", ("enum", 16), "o"),
    ("retx_bsr_timer", ("enum", 8), "m"),
    ("tti_bundling", ("bool",), "m"),
])

DRX_CONFIG = ("choice", False, [
    ("release", ("null",)),
    ("setup", ("seq", False, [
        ("on_duration_timer", ("enum", 16), "m"),
        ("drx_inactivity_timer", ("enum", 32), "m"),
        ("drx_retransmission_timer", ("enum", 8), "m"),
        ("long_drx_cycle_start_offset", ("choice", False, [
            ("sf10", ("int", 0, 9)), ("sf20", ("int", 0, 19)),
            ("sf32", ("int", 0, 31)), ("sf40", ("int", 0, 39)),
            ("sf64", ("int", 0, 63)), ("sf80", ("int", 0, 79)),
            ("sf128", ("int", 0, 127)), ("sf160", ("int", 0, 159)),
            ("sf256", ("int", 0, 255)), ("sf320", ("int", 0, 319)),
            ("sf512", ("int", 0, 511)), ("sf640", ("int", 0, 639)),
            ("sf1024", ("int", 0, 1023)), ("sf1280", ("int", 0, 1279)),
            ("sf2048", ("int", 0, 2047)), ("sf2560", ("int", 0, 2559)),
        ]), "m"),
        ("short_drx", ("seq", False, [
            ("short_drx_cycle", ("enum", 16), "m"),
            ("drx_short_cycle_timer", ("int", 1, 16), "m"),
        ]), "o"),
    ])),
])

PHR_CONFIG = ("choice", False, [
    ("release", ("null",)),
    ("setup", ("seq", False, [
        ("periodic_phr_timer", ("enum", 8), "m"),
        ("prohibit_phr_timer", ("enum", 8), "m"),
        ("dl_pathloss_change", ("enum", 4), "m"),
    ])),
])

MAC_MAIN_CONFIG = ("seq", True, [
    ("ul_sch_config", ULSCH_CONFIG, "o"),
    ("drx_config", DRX_CONFIG, "o"),
    ("time_alignment_timer_dedicated", ("enum", 8), "m"),
    ("phr_config", PHR_CONFIG, "o"),
])

PDSCH_CONFIG_DEDICATED = ("seq", False, [("p_a", ("enum", 8), "m")])

PUCCH_CONFIG_DEDICATED = ("seq", False, [
    ("ack_nack_repetition", ("choice", False, [
        ("release", ("null",)),
        ("setup", ("seq", False, [
            ("repetition_factor", ("enum", 4), "m"),
            ("n1_pucch_an_rep", ("int", 0, 2047), "m"),
        ])),
    ]), "m"),
    ("tdd_ack_nack_feedback_mode", ("enum", 2), "o"),
])

PUSCH_CONFIG_DEDICATED = ("seq", False, [
    ("beta_offset_ack_index", ("int", 0, 15), "m"),
    ("beta_offset_ri_index", ("int", 0, 15), "m"),
    ("beta_offset_cqi_index", ("int", 0, 15), "m"),
])

UPLINK_POWER_CONTROL_DEDICATED = ("seq", False, [
    ("p0_ue_pusch", ("int", -8, 7), "m"),
    ("delta_mcs_enabled", ("enum", 2), "m"),
    ("accumulation_enabled", ("bool",), "m"),
    ("p0_ue_pucch", ("int", -8, 7), "m"),
    ("p_srs_offset", ("int", 0, 15), "m"),
    ("filter_coefficient", ("enum+", 16), "o"),  # DEFAULT fc4
])

TPC_PDCCH_CONFIG = ("choice", False, [
    ("release", ("null",)),
    ("setup", ("seq", False, [
        ("tpc_rnti", ("bits", 16), "m"),
        ("tpc_index", ("choice", False, [
            ("index_of_format3", ("int", 1, 15)),
            ("index_of_format3a", ("int", 1, 31)),
        ]), "m"),
    ])),
])

CQI_REPORT_PERIODIC = ("choice", False, [
    ("release", ("null",)),
    ("setup", ("seq", False, [
        ("cqi_pucch_resource_index", ("int", 0, 1185), "m"),
        ("cqi_pmi_config_index", ("int", 0, 1023), "m"),
        ("cqi_format_indicator_periodic", ("choice", False, [
            ("wideband_cqi", ("null",)),
            ("subband_cqi", ("seq", False, [("k", ("int", 1, 4), "m")])),
        ]), "m"),
        ("ri_config_index", ("int", 0, 1023), "o"),
        ("simultaneous_ack_nack_and_cqi", ("bool",), "m"),
    ])),
])

CQI_REPORT_CONFIG = ("seq", False, [
    ("cqi_report_mode_aperiodic", ("enum", 8), "o"),
    ("nom_pdsch_rs_epre_offset", ("int", -1, 6), "m"),
    ("cqi_report_periodic", CQI_REPORT_PERIODIC, "o"),
])

SRS_UL_CONFIG_DEDICATED = ("choice", False, [
    ("release", ("null",)),
    ("setup", ("seq", False, [
        ("srs_bandwidth", ("enum", 4), "m"),
        ("srs_hopping_bandwidth", ("enum", 4), "m"),
        ("freq_domain_position", ("int", 0, 23), "m"),
        ("duration", ("bool",), "m"),
        ("srs_config_index", ("int", 0, 1023), "m"),
        ("transmission_comb", ("int", 0, 1), "m"),
        ("cyclic_shift", ("enum", 8), "m"),
    ])),
])

ANTENNA_INFO_DEDICATED = ("seq", False, [
    ("transmission_mode", ("enum", 8), "m"),
    ("codebook_subset_restriction", ("choice", False, [
        ("n2_tx_antenna_tm3", ("bits", 2)),
        ("n4_tx_antenna_tm3", ("bits", 4)),
        ("n2_tx_antenna_tm4", ("bits", 6)),
        ("n4_tx_antenna_tm4", ("bits", 64)),
        ("n2_tx_antenna_tm5", ("bits", 4)),
        ("n4_tx_antenna_tm5", ("bits", 16)),
        ("n2_tx_antenna_tm6", ("bits", 4)),
        ("n4_tx_antenna_tm6", ("bits", 16)),
    ]), "o"),
    ("ue_transmit_antenna_selection", ("choice", False, [
        ("release", ("null",)),
        ("setup", ("enum", 2)),
    ]), "m"),
])

SCHEDULING_REQUEST_CONFIG = ("choice", False, [
    ("release", ("null",)),
    ("setup", ("seq", False, [
        ("sr_pucch_resource_index", ("int", 0, 2047), "m"),
        ("sr_config_index", ("int", 0, 157), "m"),
        ("dsr_trans_max", ("enum", 8), "m"),
    ])),
])

PHYSICAL_CONFIG_DEDICATED = ("seq", True, [
    ("pdsch_config_dedicated", PDSCH_CONFIG_DEDICATED, "o"),
    ("pucch_config_dedicated", PUCCH_CONFIG_DEDICATED, "o"),
    ("pusch_config_dedicated", PUSCH_CONFIG_DEDICATED, "o"),
    ("uplink_power_control_dedicated", UPLINK_POWER_CONTROL_DEDICATED, "o"),
    ("tpc_pdcch_config_pucch", TPC_PDCCH_CONFIG, "o"),
    ("tpc_pdcch_config_pusch", TPC_PDCCH_CONFIG, "o"),
    ("cqi_report_config", CQI_REPORT_CONFIG, "o"),
    ("sounding_rs_ul_config_dedicated", SRS_UL_CONFIG_DEDICATED, "o"),
    ("antenna_info", ("choice", False, [
        ("explicit_value", ANTENNA_INFO_DEDICATED),
        ("default_value", ("null",)),
    ]), "o"),
    ("scheduling_request_config", SCHEDULING_REQUEST_CONFIG, "o"),
])

PDCP_CONFIG = ("seq", True, [
    ("discard_timer", ("enum", 8), "o"),
    ("rlc_am", ("seq", False, [
        ("status_report_required", ("bool",), "m"),
    ]), "o"),
    ("rlc_um", ("seq", False, [
        ("pdcp_sn_size", ("enum", 2), "m"),
    ]), "o"),
    ("header_compression", ("choice", False, [
        ("not_used", ("null",)),
        ("rohc", ("seq", True, [
            ("max_cid", ("int", 1, 16383), "o"),   # DEFAULT 15
            ("profiles", ("seq", False, [
                (f"profile{p}", ("bool",), "m")
                for p in ("0x0001", "0x0002", "0x0003", "0x0004", "0x0006",
                          "0x0101", "0x0102", "0x0103", "0x0104")
            ]), "m"),
        ])),
    ]), "m"),
])

DRB_TO_ADD_MOD = ("seq", True, [
    ("eps_bearer_identity", ("int", 0, 15), "o"),
    ("drb_identity", ("int", 1, 32), "m"),
    ("pdcp_config", PDCP_CONFIG, "o"),
    ("rlc_config", RLC_CONFIG, "o"),
    ("logical_channel_identity", ("int", 3, 10), "o"),
    ("logical_channel_config", LOGICAL_CHANNEL_CONFIG, "o"),
])

SPS_CONFIG_DL = ("choice", False, [
    ("release", ("null",)),
    ("setup", ("seq", True, [
        ("semi_persist_sched_interval_dl", ("enum", 16), "m"),
        ("number_of_conf_sps_processes", ("int", 1, 8), "m"),
        ("n1_pucch_an_persistent_list",
         ("seqof", 1, 4, ("int", 0, 2047)), "m"),
    ]))])

SPS_CONFIG_UL = ("choice", False, [
    ("release", ("null",)),
    ("setup", ("seq", True, [
        ("semi_persist_sched_interval_ul", ("enum", 16), "m"),
        ("implicit_release_after", ("enum", 4), "m"),
        ("p0_persistent", ("seq", False, [
            ("p0_nominal_pusch_persistent", ("int", -126, 24), "m"),
            ("p0_ue_pusch_persistent", ("int", -8, 7), "m")]), "o"),
        ("two_intervals_config", ("enum", 1), "o"),
    ]))])

SPS_CONFIG = ("seq", False, [
    ("semi_persist_sched_c_rnti", ("bits", 16), "o"),
    ("sps_config_dl", SPS_CONFIG_DL, "o"),
    ("sps_config_ul", SPS_CONFIG_UL, "o"),
])

RADIO_RESOURCE_CONFIG_DEDICATED = ("seq", True, [
    ("srb_to_add_mod_list", ("seqof", 1, 2, SRB_TO_ADD_MOD), "o"),
    ("drb_to_add_mod_list", ("seqof", 1, 11, DRB_TO_ADD_MOD), "o"),
    ("drb_to_release_list", ("seqof", 1, 11, ("int", 1, 32)), "o"),
    ("mac_main_config", ("choice", False, [
        ("explicit_value", MAC_MAIN_CONFIG),
        ("default_value", ("null",)),
    ]), "o"),
    ("sps_config", SPS_CONFIG, "o"),
    ("physical_config_dedicated", PHYSICAL_CONFIG_DEDICATED, "o"),
])

RRC_CONNECTION_SETUP = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("c1", ("choice", False, [
            ("rrc_connection_setup_r8", ("seq", False, [
                ("radio_resource_config_dedicated",
                 RADIO_RESOURCE_CONFIG_DEDICATED, "m"),
                ("non_critical_extension", ("seq", False, []), "o"),
            ]))] + _spare(("null",), 7))),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

RRC_CONNECTION_REESTABLISHMENT = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("c1", ("choice", False, [
            ("rrc_connection_reestablishment_r8", ("seq", False, [
                ("radio_resource_config_dedicated",
                 RADIO_RESOURCE_CONFIG_DEDICATED, "m"),
                ("next_hop_chaining_count", ("int", 0, 7), "m"),
                ("non_critical_extension", ("seq", False, []), "o"),
            ]))] + _spare(("null",), 7))),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

RRC_CONNECTION_REESTABLISHMENT_REJECT = ("seq", False, [
    ("critical_extensions", ("choice", False, [
        ("rrc_connection_reestablishment_reject_r8", ("seq", False, [
            ("non_critical_extension", ("seq", False, []), "o"),
        ])),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

RRC_CONNECTION_REJECT = ("seq", False, [
    ("critical_extensions", ("choice", False, [
        ("c1", ("choice", False, [
            ("rrc_connection_reject_r8", ("seq", False, [
                ("wait_time", ("int", 1, 16), "m"),
                ("non_critical_extension", ("seq", False, []), "o"),
            ]))] + _spare(("null",), 3))),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

DL_CCCH_MESSAGE = ("choice", False, [
    ("c1", ("choice", False, [
        ("rrc_connection_reestablishment", RRC_CONNECTION_REESTABLISHMENT),
        ("rrc_connection_reestablishment_reject",
         RRC_CONNECTION_REESTABLISHMENT_REJECT),
        ("rrc_connection_reject", RRC_CONNECTION_REJECT),
        ("rrc_connection_setup", RRC_CONNECTION_SETUP),
    ])),
    ("message_class_extension", ("seq", False, [])),
])

# ---- RRCConnectionReconfiguration (DL-DCCH) ---------------------------------

THRESHOLD_EUTRA = ("choice", False, [
    ("threshold_rsrp", ("int", 0, 97)),
    ("threshold_rsrq", ("int", 0, 34)),
])

MEAS_OBJECT_EUTRA = ("seq", True, [
    ("carrier_freq", ("int", 0, 65535), "m"),
    ("allowed_meas_bandwidth", ("enum", 6), "m"),
    ("presence_antenna_port1", ("bool",), "m"),
    ("neigh_cell_config", ("bits", 2), "m"),
    ("offset_freq", ("enum", 31), "o"),          # DEFAULT dB0
    ("cells_to_remove_list", ("seqof", 1, 32, ("int", 1, 32)), "o"),
    ("cells_to_add_mod_list", ("seqof", 1, 32, ("seq", False, [
        ("cell_index", ("int", 1, 32), "m"),
        ("phys_cell_id", ("int", 0, 503), "m"),
        ("cell_individual_offset", ("enum", 31), "m"),
    ])), "o"),
    ("black_cells_to_remove_list", ("seqof", 1, 32, ("int", 1, 32)), "o"),
    ("black_cells_to_add_mod_list", ("seqof", 1, 32, ("seq", False, [
        ("cell_index", ("int", 1, 32), "m"),
        ("phys_cell_id_range", ("seq", False, [
            ("start", ("int", 0, 503), "m"),
            ("range", ("enum", 16), "o"),
        ]), "m"),
    ])), "o"),
    ("cell_for_which_to_report_cgi", ("int", 0, 503), "o"),
])

REPORT_CONFIG_EUTRA = ("seq", True, [
    ("trigger_type", ("choice", False, [
        ("event", ("seq", False, [
            ("event_id", ("choice", True, [
                ("a1", ("seq", False, [("a1_threshold", THRESHOLD_EUTRA, "m")])),
                ("a2", ("seq", False, [("a2_threshold", THRESHOLD_EUTRA, "m")])),
                ("a3", ("seq", False, [
                    ("a3_offset", ("int", -30, 30), "m"),
                    ("report_on_leave", ("bool",), "m"),
                ])),
                ("a4", ("seq", False, [("a4_threshold", THRESHOLD_EUTRA, "m")])),
                ("a5", ("seq", False, [
                    ("a5_threshold1", THRESHOLD_EUTRA, "m"),
                    ("a5_threshold2", THRESHOLD_EUTRA, "m"),
                ])),
            ]), "m"),
            ("hysteresis", ("int", 0, 30), "m"),
            ("time_to_trigger", ("enum", 16), "m"),
        ])),
        ("periodical", ("seq", False, [("purpose", ("enum", 2), "m")])),
    ]), "m"),
    ("trigger_quantity", ("enum", 2), "m"),
    ("report_quantity", ("enum", 2), "m"),
    ("max_report_cells", ("int", 1, 8), "m"),
    ("report_interval", ("enum", 16), "m"),
    ("report_amount", ("enum", 8), "m"),
])

MEAS_CONFIG = ("seq", True, [
    ("meas_object_to_remove_list", ("seqof", 1, 32, ("int", 1, 32)), "o"),
    ("meas_object_to_add_mod_list", ("seqof", 1, 32, ("seq", False, [
        ("meas_object_id", ("int", 1, 32), "m"),
        ("meas_object", ("choice", True, [
            ("meas_object_eutra", MEAS_OBJECT_EUTRA),
            ("meas_object_utra", ("null",)),
            ("meas_object_geran", ("null",)),
            ("meas_object_cdma2000", ("null",)),
        ]), "m"),
    ])), "o"),
    ("report_config_to_remove_list", ("seqof", 1, 32, ("int", 1, 32)), "o"),
    ("report_config_to_add_mod_list", ("seqof", 1, 32, ("seq", False, [
        ("report_config_id", ("int", 1, 32), "m"),
        ("report_config", ("choice", False, [
            ("report_config_eutra", REPORT_CONFIG_EUTRA),
            ("report_config_inter_rat", ("null",)),
        ]), "m"),
    ])), "o"),
    ("meas_id_to_remove_list", ("seqof", 1, 32, ("int", 1, 32)), "o"),
    ("meas_id_to_add_mod_list", ("seqof", 1, 32, ("seq", False, [
        ("meas_id", ("int", 1, 32), "m"),
        ("meas_object_id", ("int", 1, 32), "m"),
        ("report_config_id", ("int", 1, 32), "m"),
    ])), "o"),
    ("quantity_config", ("seq", True, [
        ("quantity_config_eutra", ("seq", False, [
            ("filter_coefficient_rsrp", ("enum+", 16), "o"),
            ("filter_coefficient_rsrq", ("enum+", 16), "o"),
        ]), "o"),
        ("quantity_config_utra", ("null",), "o"),
        ("quantity_config_geran", ("null",), "o"),
        ("quantity_config_cdma2000", ("null",), "o"),
    ]), "o"),
    ("meas_gap_config", ("choice", False, [
        ("release", ("null",)),
        ("setup", ("seq", False, [
            ("gap_offset", ("choice", True, [
                ("gp0", ("int", 0, 39)),
                ("gp1", ("int", 0, 79)),
            ]), "m"),
        ])),
    ]), "o"),
    ("s_measure", ("int", 0, 97), "o"),
    ("pre_registration_info_hrpd", ("null",), "o"),
    ("speed_state_pars", ("choice", False, [
        ("release", ("null",)),
        ("setup", ("seq", False, [
            ("mobility_state_parameters", ("seq", False, [
                ("t_evaluation", ("enum", 8), "m"),
                ("t_hyst_normal", ("enum", 8), "m"),
                ("n_cell_change_medium", ("int", 1, 16), "m"),
                ("n_cell_change_high", ("int", 1, 16), "m"),
            ]), "m"),
            ("time_to_trigger_sf", ("seq", False, [
                ("sf_medium", ("enum", 4), "m"),
                ("sf_high", ("enum", 4), "m"),
            ]), "m"),
        ])),
    ]), "o"),
])

RACH_CONFIG_COMMON = ("seq", True, [
    ("preamble_info", ("seq", False, [
        ("number_of_ra_preambles", ("enum", 16), "m"),
        ("preambles_group_a_config", ("seq", True, [
            ("size_of_ra_preambles_group_a", ("enum", 15), "m"),
            ("message_size_group_a", ("enum", 4), "m"),
            ("message_power_offset_group_b", ("enum", 8), "m"),
        ]), "o"),
    ]), "m"),
    ("power_ramping_parameters", ("seq", False, [
        ("power_ramping_step", ("enum", 4), "m"),
        ("preamble_initial_received_target_power", ("enum", 16), "m"),
    ]), "m"),
    ("ra_supervision_info", ("seq", False, [
        ("preamble_trans_max", ("enum", 11), "m"),
        ("ra_response_window_size", ("enum", 8), "m"),
        ("mac_contention_resolution_timer", ("enum", 8), "m"),
    ]), "m"),
    ("max_harq_msg3_tx", ("int", 1, 8), "m"),
])

PRACH_CONFIG = ("seq", False, [
    ("root_sequence_index", ("int", 0, 837), "m"),
    ("prach_config_info", ("seq", False, [
        ("prach_config_index", ("int", 0, 63), "m"),
        ("high_speed_flag", ("bool",), "m"),
        ("zero_correlation_zone_config", ("int", 0, 15), "m"),
        ("prach_freq_offset", ("int", 0, 94), "m"),
    ]), "o"),
])

PUSCH_CONFIG_COMMON = ("seq", False, [
    ("pusch_config_basic", ("seq", False, [
        ("n_sb", ("int", 1, 4), "m"),
        ("hopping_mode", ("enum", 2), "m"),
        ("pusch_hopping_offset", ("int", 0, 98), "m"),
        ("enable_64qam", ("bool",), "m"),
    ]), "m"),
    ("ul_reference_signals_pusch", ("seq", False, [
        ("group_hopping_enabled", ("bool",), "m"),
        ("group_assignment_pusch", ("int", 0, 29), "m"),
        ("sequence_hopping_enabled", ("bool",), "m"),
        ("cyclic_shift", ("int", 0, 7), "m"),
    ]), "m"),
])

RADIO_RESOURCE_CONFIG_COMMON = ("seq", True, [
    ("rach_config_common", RACH_CONFIG_COMMON, "o"),
    ("prach_config", PRACH_CONFIG, "m"),
    ("pdsch_config_common", ("seq", False, [
        ("reference_signal_power", ("int", -60, 50), "m"),
        ("p_b", ("int", 0, 3), "m"),
    ]), "o"),
    ("pusch_config_common", PUSCH_CONFIG_COMMON, "m"),
    ("phich_config", ("seq", False, [
        ("phich_duration", ("enum", 2), "m"),
        ("phich_resource", ("enum", 4), "m"),
    ]), "o"),
    ("pucch_config_common", ("seq", False, [
        ("delta_pucch_shift", ("enum", 3), "m"),
        ("n_rb_cqi", ("int", 0, 98), "m"),
        ("n_cs_an", ("int", 0, 7), "m"),
        ("n1_pucch_an", ("int", 0, 2047), "m"),
    ]), "o"),
    ("sounding_rs_ul_config_common", ("choice", False, [
        ("release", ("null",)),
        ("setup", ("seq", False, [
            ("srs_bandwidth_config", ("enum", 8), "m"),
            ("srs_subframe_config", ("enum", 16), "m"),
            ("ack_nack_srs_simultaneous_transmission", ("bool",), "m"),
            ("srs_max_up_pts", ("enum", 1), "o"),
        ])),
    ]), "o"),
    ("uplink_power_control_common", ("seq", False, [
        ("p0_nominal_pusch", ("int", -126, 24), "m"),
        ("alpha", ("enum", 8), "m"),
        ("p0_nominal_pucch", ("int", -127, -96), "m"),
        ("delta_flist_pucch", ("seq", False, [
            ("delta_f_pucch_format1", ("enum", 3), "m"),
            ("delta_f_pucch_format1b", ("enum", 3), "m"),
            ("delta_f_pucch_format2", ("enum", 4), "m"),
            ("delta_f_pucch_format2a", ("enum", 3), "m"),
            ("delta_f_pucch_format2b", ("enum", 3), "m"),
        ]), "m"),
        ("delta_preamble_msg3", ("int", -1, 6), "m"),
    ]), "o"),
    ("antenna_info_common", ("seq", False, [
        ("antenna_ports_count", ("enum", 4), "m"),
    ]), "o"),
    ("p_max", ("int", -30, 33), "o"),
    ("tdd_config", ("seq", False, [
        ("subframe_assignment", ("enum", 7), "m"),
        ("special_subframe_patterns", ("enum", 9), "m"),
    ]), "o"),
    ("ul_cyclic_prefix_length", ("enum", 2), "m"),
])

MOBILITY_CONTROL_INFO = ("seq", True, [
    ("target_phys_cell_id", ("int", 0, 503), "m"),
    ("carrier_freq", ("seq", False, [
        ("dl_carrier_freq", ("int", 0, 65535), "m"),
        ("ul_carrier_freq", ("int", 0, 65535), "o"),
    ]), "o"),
    ("carrier_bandwidth", ("seq", False, [
        ("dl_bandwidth", ("enum", 16), "m"),
        ("ul_bandwidth", ("enum", 16), "o"),
    ]), "o"),
    ("additional_spectrum_emission", ("int", 1, 32), "o"),
    ("t304", ("enum", 8), "m"),
    ("new_ue_identity", ("bits", 16), "m"),
    ("radio_resource_config_common", RADIO_RESOURCE_CONFIG_COMMON, "m"),
    ("rach_config_dedicated", ("seq", False, [
        ("ra_preamble_index", ("int", 0, 63), "m"),
        ("ra_prach_mask_index", ("int", 0, 15), "m"),
    ]), "o"),
])

SECURITY_CONFIG_HO = ("seq", True, [
    ("handover_type", ("choice", False, [
        ("intra_lte", ("seq", False, [
            ("security_algorithm_config", ("seq", False, [
                ("ciphering_algorithm", ("enum+", 8), "m"),
                ("integrity_prot_algorithm", ("enum+", 8), "m"),
            ]), "o"),
            ("key_change_indicator", ("bool",), "m"),
            ("next_hop_chaining_count", ("int", 0, 7), "m"),
        ])),
        ("inter_rat", ("null",)),
    ]), "m"),
])

# nonCriticalExtension chain r8 → v890 → v920 → v1020 → v1130 → v1250 →
# v1310 → v1430 → v1510 (field arity/order per the reference's generated
# dl_dcch_msg.h structs); only the v1510 EN-DC fields are ever populated
# by this framework — the earlier versions contribute their (all-absent)
# presence bitmaps, exactly as a real r15 eNB encodes them.
RRC_CONN_RECONF_V1510_IES = ("seq", False, [
    ("nr_config_r15", ("choice", False, [
        ("release", ("null",)),
        ("setup", ("seq", False, [
            ("endc_release_and_add_r15", ("bool",), "m"),
            ("nr_secondary_cell_group_config_r15", ("octets*",), "o"),
            ("p_max_eutra_r15", ("int", -30, 33), "o"),
        ])),
    ]), "o"),
    ("sk_counter_r15", ("int", 0, 65535), "o"),
    ("nr_radio_bearer_config1_r15", ("octets*",), "o"),
    ("nr_radio_bearer_config2_r15", ("octets*",), "o"),
    ("tdm_pattern_config_r15", ("null",), "o"),
    ("non_critical_extension", ("seq", False, []), "o"),
])

RRC_CONN_RECONF_V1430_IES = ("seq", False, [
    ("sl_v2x_config_dedicated_r14", ("null",), "o"),
    ("scell_to_add_mod_list_ext_v1430", ("null",), "o"),
    ("per_cc_gap_indication_request_r14", ("enum", 1), "o"),
    ("sib_type2_dedicated_r14", ("octets*",), "o"),
    ("non_critical_extension", RRC_CONN_RECONF_V1510_IES, "o"),
])

RRC_CONN_RECONF_V1310_IES = ("seq", False, [
    ("scell_to_release_list_ext_r13", ("null",), "o"),
    ("scell_to_add_mod_list_ext_r13", ("null",), "o"),
    ("lwa_config_r13", ("null",), "o"),
    ("lwip_config_r13", ("null",), "o"),
    ("rclwi_config_r13", ("null",), "o"),
    ("non_critical_extension", RRC_CONN_RECONF_V1430_IES, "o"),
])

RRC_CONN_RECONF_V1250_IES = ("seq", False, [
    ("wlan_offload_info_r12", ("null",), "o"),
    ("scg_config_r12", ("null",), "o"),
    ("sl_sync_tx_control_r12", ("null",), "o"),
    ("sl_disc_config_r12", ("null",), "o"),
    ("sl_comm_config_r12", ("null",), "o"),
    ("non_critical_extension", RRC_CONN_RECONF_V1310_IES, "o"),
])

RRC_CONN_RECONF_V1130_IES = ("seq", False, [
    ("sib_type1_dedicated_r11", ("octets*",), "o"),
    ("non_critical_extension", RRC_CONN_RECONF_V1250_IES, "o"),
])

RRC_CONN_RECONF_V1020_IES = ("seq", False, [
    ("scell_to_release_list_r10", ("null",), "o"),
    ("scell_to_add_mod_list_r10", ("null",), "o"),
    ("non_critical_extension", RRC_CONN_RECONF_V1130_IES, "o"),
])

RRC_CONN_RECONF_V920_IES = ("seq", False, [
    ("other_config_r9", ("null",), "o"),
    ("full_config_r9", ("enum", 1), "o"),
    ("non_critical_extension", RRC_CONN_RECONF_V1020_IES, "o"),
])

RRC_CONN_RECONF_V890_IES = ("seq", False, [
    ("late_non_critical_extension", ("octets*",), "o"),
    ("non_critical_extension", RRC_CONN_RECONF_V920_IES, "o"),
])

RRC_CONNECTION_RECONFIGURATION = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("c1", ("choice", False, [
            ("rrc_connection_reconfiguration_r8", ("seq", False, [
                ("meas_config", MEAS_CONFIG, "o"),
                ("mobility_control_info", MOBILITY_CONTROL_INFO, "o"),
                ("dedicated_info_nas_list",
                 ("seqof", 1, 11, ("octets*",)), "o"),
                ("radio_resource_config_dedicated",
                 RADIO_RESOURCE_CONFIG_DEDICATED, "o"),
                ("security_config_ho", SECURITY_CONFIG_HO, "o"),
                ("non_critical_extension", RRC_CONN_RECONF_V890_IES, "o"),
            ]))] + _spare(("null",), 7))),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

# ---- SecurityModeCommand / Release / DLInformationTransfer (DL-DCCH) --------

SECURITY_ALGORITHM_CONFIG = ("seq", False, [
    ("ciphering_algorithm", ("enum+", 8), "m"),
    ("integrity_prot_algorithm", ("enum+", 8), "m"),
])

SECURITY_MODE_COMMAND = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("c1", ("choice", False, [
            ("security_mode_command_r8", ("seq", False, [
                ("security_config_smc", ("seq", True, [
                    ("security_algorithm_config",
                     SECURITY_ALGORITHM_CONFIG, "m"),
                ]), "m"),
                ("non_critical_extension", ("seq", False, []), "o"),
            ]))] + _spare(("null",), 3))),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

RRC_CONNECTION_RELEASE = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("c1", ("choice", False, [
            ("rrc_connection_release_r8", ("seq", False, [
                ("release_cause", ("enum", 4), "m"),
                ("redirected_carrier_info", ("choice", True, [
                    ("eutra", ("int", 0, 65535)),
                    ("geran", ("null",)),
                    ("utra_fdd", ("int", 0, 16383)),
                    ("utra_tdd", ("int", 0, 16383)),
                    ("cdma2000_hrpd", ("null",)),
                    ("cdma2000_1xrtt", ("null",)),
                ]), "o"),
                ("idle_mode_mobility_control_info", ("null",), "o"),
                ("non_critical_extension", ("seq", False, []), "o"),
            ]))] + _spare(("null",), 3))),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

DL_INFORMATION_TRANSFER = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("c1", ("choice", False, [
            ("dl_information_transfer_r8", ("seq", False, [
                ("dedicated_info_type", DEDICATED_INFO_TYPE, "m"),
                ("non_critical_extension", ("seq", False, []), "o"),
            ]))] + _spare(("null",), 3))),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

# ---- UECapabilityEnquiry (DL-DCCH) ------------------------------------------

UE_CAPABILITY_ENQUIRY = ("seq", False, [
    ("rrc_transaction_identifier", ("int", 0, 3), "m"),
    ("critical_extensions", ("choice", False, [
        ("c1", ("choice", False, [
            ("ue_capability_enquiry_r8", ("seq", False, [
                ("ue_capability_request",
                 ("seqof", 1, 8, ("enum+", 8)), "m"),
                ("non_critical_extension", ("seq", False, []), "o"),
            ]))] + _spare(("null",), 3))),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

DL_DCCH_MESSAGE = ("choice", False, [
    ("c1", ("choice", False, [
        ("csfb_parameters_response_cdma2000", ("null",)),
        ("dl_information_transfer", DL_INFORMATION_TRANSFER),
        ("handover_from_eutra_preparation_request", ("null",)),
        ("mobility_from_eutra_command", ("null",)),
        ("rrc_connection_reconfiguration", RRC_CONNECTION_RECONFIGURATION),
        ("rrc_connection_release", RRC_CONNECTION_RELEASE),
        ("security_mode_command", SECURITY_MODE_COMMAND),
        ("ue_capability_enquiry", UE_CAPABILITY_ENQUIRY),
        ("counter_check", ("null",)),
        ("ue_information_request_r9", ("null",)),
        ("logged_measurement_configuration_r10", ("null",)),
        ("rn_reconfiguration_r10", ("null",)),
        ("spare4", ("null",)), ("spare3", ("null",)),
        ("spare2", ("null",)), ("spare1", ("null",)),
    ])),
    ("message_class_extension", ("seq", False, [])),
])

# ---- RRCConnectionRequest (UL-CCCH) ------------------------------------------

RRC_CONNECTION_REQUEST = ("seq", False, [
    ("critical_extensions", ("choice", False, [
        ("rrc_connection_request_r8", ("seq", False, [
            ("ue_identity", ("choice", False, [
                ("s_tmsi", ("seq", False, [
                    ("mmec", ("bits", 8), "m"),
                    ("m_tmsi", ("bits", 32), "m"),
                ])),
                ("random_value", ("bits", 40)),
            ]), "m"),
            ("establishment_cause", ("enum", 8), "m"),
            ("spare", ("bits", 1), "m"),
        ])),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

RRC_CONNECTION_REESTABLISHMENT_REQUEST = ("seq", False, [
    ("critical_extensions", ("choice", False, [
        ("rrc_connection_reestablishment_request_r8", ("seq", False, [
            ("ue_identity", ("seq", False, [
                ("c_rnti", ("bits", 16), "m"),
                ("phys_cell_id", ("int", 0, 503), "m"),
                ("short_mac_i", ("bits", 16), "m"),
            ]), "m"),
            ("reestablishment_cause", ("enum", 4), "m"),
            ("spare", ("bits", 2), "m"),
        ])),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

UL_CCCH_MESSAGE = ("choice", False, [
    ("c1", ("choice", False, [
        ("rrc_connection_reestablishment_request",
         RRC_CONNECTION_REESTABLISHMENT_REQUEST),
        ("rrc_connection_request", RRC_CONNECTION_REQUEST),
    ])),
    ("message_class_extension", ("seq", False, [])),
])

# ---- MBSFNAreaConfiguration (MCCH) -------------------------------------------

MBSFN_SUBFRAME_CONFIG = ("seq", False, [
    ("radioframe_allocation_period", ("enum", 6), "m"),
    ("radioframe_allocation_offset", ("int", 0, 7), "m"),
    ("subframe_allocation", ("choice", False, [
        ("one_frame", ("bits", 6)),
        ("four_frames", ("bits", 24)),
    ]), "m"),
])

TMGI_R9 = ("seq", False, [
    ("plmn_id_r9", ("choice", False, [
        ("plmn_index_r9", ("int", 1, 6)),
        ("explicit_value_r9", PLMN_IDENTITY),
    ]), "m"),
    ("service_id_r9", ("octets", 3), "m"),
])

MBMS_SESSION_INFO_R9 = ("seq", True, [
    ("tmgi_r9", TMGI_R9, "m"),
    ("session_id_r9", ("octets", 1), "o"),
    ("logical_channel_identity_r9", ("int", 0, 28), "m"),
])

PMCH_CONFIG_R9 = ("seq", True, [
    ("sf_alloc_end_r9", ("int", 0, 1535), "m"),
    ("data_mcs_r9", ("int", 0, 28), "m"),
    ("mch_scheduling_period_r9", ("enum", 8), "m"),
])

PMCH_INFO_R9 = ("seq", True, [
    ("pmch_config_r9", PMCH_CONFIG_R9, "m"),
    ("mbms_session_info_list_r9",
     ("seqof", 0, 29, MBMS_SESSION_INFO_R9), "m"),
])

MBSFN_AREA_CONFIGURATION_R9 = ("seq", False, [
    ("common_sf_alloc_r9", ("seqof", 1, 8, MBSFN_SUBFRAME_CONFIG), "m"),
    ("common_sf_alloc_period_r9", ("enum", 7), "m"),  # rf4..rf256
    ("pmch_info_list_r9", ("seqof", 0, 15, PMCH_INFO_R9), "m"),
    ("non_critical_extension", ("seq", False, []), "o"),
])

MCCH_MESSAGE = ("choice", False, [
    ("c1", ("choice", False, [
        ("mbsfn_area_configuration_r9", MBSFN_AREA_CONFIGURATION_R9),
    ])),
    ("message_class_extension", ("seq", False, [])),
])


# ---- BCCH: MIB (BCCH-BCH), SIB1 + SystemInformation (BCCH-DL-SCH) -----------

MIB = ("seq", False, [
    ("dl_bandwidth", ("enum", 6), "m"),       # n6,n15,n25,n50,n75,n100
    ("phich_config", ("seq", False, [
        ("phich_duration", ("enum", 2), "m"),
        ("phich_resource", ("enum", 4), "m"),  # oneSixth,half,one,two
    ]), "m"),
    ("system_frame_number", ("bits", 8), "m"),
    ("spare", ("bits", 10), "m"),
])

BCCH_BCH_MESSAGE = ("seq", False, [("message", MIB, "m")])

SIB_TYPE = ("enum+", 16)   # sibType3..sibType18-v1250 base, extensible

SIB1 = ("seq", False, [
    ("cell_access_related_info", ("seq", False, [
        ("plmn_identity_list", ("seqof", 1, 6, ("seq", False, [
            ("plmn_identity", PLMN_IDENTITY, "m"),
            ("cell_reserved_for_operator_use", ("enum", 2), "m"),
        ])), "m"),
        ("tracking_area_code", ("bits", 16), "m"),
        ("cell_identity", ("bits", 28), "m"),
        ("cell_barred", ("enum", 2), "m"),
        ("intra_freq_reselection", ("enum", 2), "m"),
        ("csg_indication", ("bool",), "m"),
        ("csg_identity", ("bits", 27), "o"),
    ]), "m"),
    ("cell_selection_info", ("seq", False, [
        ("q_rx_lev_min", ("int", -70, -22), "m"),
        ("q_rx_lev_min_offset", ("int", 1, 8), "o"),
    ]), "m"),
    ("p_max", ("int", -30, 33), "o"),
    ("freq_band_indicator", ("int", 1, 64), "m"),
    ("scheduling_info_list", ("seqof", 1, 32, ("seq", False, [
        ("si_periodicity", ("enum", 7), "m"),  # rf8..rf512
        ("sib_mapping_info", ("seqof", 0, 31, SIB_TYPE), "m"),
    ])), "m"),
    ("tdd_config", ("seq", False, [
        ("subframe_assignment", ("enum", 7), "m"),
        ("special_subframe_patterns", ("enum", 9), "m"),
    ]), "o"),
    ("si_window_length", ("enum", 7), "m"),    # ms1..ms40
    ("system_info_value_tag", ("int", 0, 31), "m"),
    ("non_critical_extension", ("seq", False, []), "o"),
])

PRACH_CONFIG_SIB = ("seq", False, [
    ("root_sequence_index", ("int", 0, 837), "m"),
    ("prach_config_info", ("seq", False, [
        ("prach_config_index", ("int", 0, 63), "m"),
        ("high_speed_flag", ("bool",), "m"),
        ("zero_correlation_zone_config", ("int", 0, 15), "m"),
        ("prach_freq_offset", ("int", 0, 94), "m"),
    ]), "m"),
])

RADIO_RESOURCE_CONFIG_COMMON_SIB = ("seq", True, [
    ("rach_config_common", RACH_CONFIG_COMMON, "m"),
    ("bcch_config", ("seq", False, [
        ("modification_period_coeff", ("enum", 4), "m"),  # n2,n4,n8,n16
    ]), "m"),
    ("pcch_config", ("seq", False, [
        ("default_paging_cycle", ("enum", 4), "m"),  # rf32..rf256
        ("nb", ("enum", 8), "m"),
    ]), "m"),
    ("prach_config", PRACH_CONFIG_SIB, "m"),
    ("pdsch_config_common", ("seq", False, [
        ("reference_signal_power", ("int", -60, 50), "m"),
        ("p_b", ("int", 0, 3), "m"),
    ]), "m"),
    ("pusch_config_common", PUSCH_CONFIG_COMMON, "m"),
    ("pucch_config_common", ("seq", False, [
        ("delta_pucch_shift", ("enum", 3), "m"),
        ("n_rb_cqi", ("int", 0, 98), "m"),
        ("n_cs_an", ("int", 0, 7), "m"),
        ("n1_pucch_an", ("int", 0, 2047), "m"),
    ]), "m"),
    ("sounding_rs_ul_config_common", ("choice", False, [
        ("release", ("null",)),
        ("setup", ("seq", False, [
            ("srs_bandwidth_config", ("enum", 8), "m"),
            ("srs_subframe_config", ("enum", 16), "m"),
            ("ack_nack_srs_simultaneous_transmission", ("bool",), "m"),
            ("srs_max_up_pts", ("enum", 1), "o"),
        ])),
    ]), "m"),
    ("uplink_power_control_common", ("seq", False, [
        ("p0_nominal_pusch", ("int", -126, 24), "m"),
        ("alpha", ("enum", 8), "m"),
        ("p0_nominal_pucch", ("int", -127, -96), "m"),
        ("delta_flist_pucch", ("seq", False, [
            ("delta_f_pucch_format1", ("enum", 3), "m"),
            ("delta_f_pucch_format1b", ("enum", 3), "m"),
            ("delta_f_pucch_format2", ("enum", 4), "m"),
            ("delta_f_pucch_format2a", ("enum", 3), "m"),
            ("delta_f_pucch_format2b", ("enum", 3), "m"),
        ]), "m"),
        ("delta_preamble_msg3", ("int", -1, 6), "m"),
    ]), "m"),
    ("ul_cyclic_prefix_length", ("enum", 2), "m"),
])

UE_TIMERS_AND_CONSTANTS = ("seq", True, [
    ("t300", ("enum", 8), "m"),   # ms100..ms2000
    ("t301", ("enum", 8), "m"),
    ("t310", ("enum", 7), "m"),   # ms0..ms2000
    ("n310", ("enum", 8), "m"),   # n1..n20
    ("t311", ("enum", 7), "m"),   # ms1000..ms30000
    ("n311", ("enum", 8), "m"),   # n1..n10
])

SIB2 = ("seq", True, [
    ("ac_barring_info", ("seq", False, [
        ("ac_barring_for_emergency", ("bool",), "m"),
        ("ac_barring_for_mo_signalling", ("null",), "o"),
        ("ac_barring_for_mo_data", ("null",), "o"),
    ]), "o"),
    ("radio_resource_config_common", RADIO_RESOURCE_CONFIG_COMMON_SIB, "m"),
    ("ue_timers_and_constants", UE_TIMERS_AND_CONSTANTS, "m"),
    ("freq_info", ("seq", False, [
        ("ul_carrier_freq", ("int", 0, 65535), "o"),
        ("ul_bandwidth", ("enum", 6), "o"),
        ("additional_spectrum_emission", ("int", 1, 32), "m"),
    ]), "m"),
    ("mbsfn_subframe_config_list", ("seqof", 1, 8, MBSFN_SUBFRAME_CONFIG),
     "o"),
    ("time_alignment_timer_common", ("enum", 8), "m"),
])

SYSTEM_INFORMATION = ("seq", False, [
    ("critical_extensions", ("choice", False, [
        ("system_information_r8", ("seq", False, [
            ("sib_type_and_info", ("seqof", 1, 32, ("choice", True, [
                ("sib2", SIB2),
                ("sib3", ("null",)), ("sib4", ("null",)),
                ("sib5", ("null",)), ("sib6", ("null",)),
                ("sib7", ("null",)), ("sib8", ("null",)),
                ("sib9", ("null",)), ("sib10", ("null",)),
                ("sib11", ("null",)),
            ])), "m"),
            ("non_critical_extension", ("seq", False, []), "o"),
        ])),
        ("critical_extensions_future", ("seq", False, [])),
    ]), "m"),
])

BCCH_DL_SCH_MESSAGE = ("choice", False, [
    ("c1", ("choice", False, [
        ("system_information", SYSTEM_INFORMATION),
        ("system_information_block_type1", SIB1),
    ])),
    ("message_class_extension", ("seq", False, [])),
])

# ---- PCCH: Paging ------------------------------------------------------------

PAGING_RECORD = ("seq", True, [
    ("ue_identity", ("choice", True, [
        ("s_tmsi", ("seq", False, [
            ("mmec", ("bits", 8), "m"),
            ("m_tmsi", ("bits", 32), "m"),
        ])),
        ("imsi", ("seqof", 6, 21, ("int", 0, 9))),
    ]), "m"),
    ("cn_domain", ("enum", 2), "m"),
])

PAGING = ("seq", False, [
    ("paging_record_list", ("seqof", 1, 16, PAGING_RECORD), "o"),
    ("system_info_modification", ("enum", 1), "o"),
    ("etws_indication", ("enum", 1), "o"),
    ("non_critical_extension", ("seq", False, []), "o"),
])

PCCH_MESSAGE = ("choice", False, [
    ("c1", ("choice", False, [("paging", PAGING)])),
    ("message_class_extension", ("seq", False, [])),
])


# --------------------------------------------------------------------------
# byte-level entry points

def decode_bytes(spec, data: bytes):
    r = BitReader(data)
    v = decode(spec, r)
    return v, r.pos


def encode_bytes(spec, v) -> bytes:
    w = BitWriter()
    encode(spec, v, w)
    return w.to_bytes()
