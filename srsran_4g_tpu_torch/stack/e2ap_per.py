"""O-RAN-exact E2AP + E2SM-KPM codec on the aligned-PER runtime.

Counterpart of the reference's generated `lib/src/asn1/e2ap.cpp` (16 k)
and `e2sm_kpm_v2.cpp` (6.5 k): the E2AP-PDU container (identical ASN.1
shape to S1AP — reused from `s1ap_per`), typed IE values for the E2
Setup / RIC Subscription / RIC Indication procedures, and the E2SM-KPM
service-model structures (RANfunction-Description, EventTrigger-
Definition format 1, IndicationHeader format 1, IndicationMessage
format 1 with integer measurement records).

Byte-exactness is proven two ways (tests/test_e2_wire_exact.py):
the reference's committed E2AP test vectors
(`srsgnb/src/stack/ric/test/e2ap_test.cc:38,93`) decode and re-encode
through this codec, and every PDU this framework generates re-encodes
identically through the reference's own compiled codec
(`tools/ref_e2.py` harness).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .aper import AperReader, AperWriter
from .s1ap_per import CRIT_IGNORE, CRIT_REJECT, Ie, S1apPdu

# E2AP-PDU has the same container shape as S1AP-PDU (choice of
# initiating/successful/unsuccessful + procedureCode + criticality +
# open-typed message with a ProtocolIE-Container)
E2apPdu = S1apPdu

PDU_INITIATING = 0
PDU_SUCCESSFUL = 1

# procedure codes (O-RAN E2AP v2 §9.3.6)
PROC_E2_SETUP = 1
PROC_RIC_INDICATION = 5
PROC_RIC_SUBSCRIPTION = 8

# protocolIE ids (e2ap.cpp *_ies_o::idx_to_id tables)
IE_CAUSE = 1
IE_GLOBAL_E2NODE_ID = 3
IE_GLOBAL_RIC_ID = 4
IE_RAN_FUNCTION_ID = 5
IE_RAN_FUNCTION_ITEM = 8
IE_RAN_FUNCTIONS_ACCEPTED = 9
IE_RAN_FUNCTIONS_ADDED = 10
IE_RAN_FUNCTION_ID_ITEM = 6
IE_RIC_ACTION_ID = 15
IE_RIC_ACTIONS_ADMITTED = 17
IE_RIC_ACTION_ADMITTED_ITEM = 14
IE_RIC_ACTION_TO_BE_SETUP_ITEM = 19
IE_RIC_INDICATION_HEADER = 25
IE_RIC_INDICATION_MESSAGE = 26
IE_RIC_INDICATION_SN = 27
IE_RIC_INDICATION_TYPE = 28
IE_RIC_REQUEST_ID = 29
IE_RIC_SUBSCRIPTION_DETAILS = 30
IE_TRANSACTION_ID = 49
IE_E2NODE_CONFIG_ADDITION = 50
IE_E2NODE_CONFIG_ADDITION_ACK = 52

RIC_ACTION_REPORT = 0
RIC_IND_TYPE_REPORT = 0


# ---- scalar IE values -------------------------------------------------------

def pack_transaction_id(v: int) -> bytes:
    return AperWriter().put_bool(False).put_constrained(v, 0, 255).to_bytes()


def unpack_transaction_id(d: bytes) -> int:
    r = AperReader(d)
    r.get_bool()
    return r.get_constrained(0, 255)


def pack_ran_function_id(v: int) -> bytes:
    return AperWriter().put_constrained(v, 0, 4095).to_bytes()


def unpack_ran_function_id(d: bytes) -> int:
    return AperReader(d).get_constrained(0, 4095)


def pack_ric_request_id(requestor: int, instance: int) -> bytes:
    w = AperWriter().put_bool(False)
    w.put_constrained(requestor, 0, 65535)
    w.put_constrained(instance, 0, 65535)
    return w.to_bytes()


def unpack_ric_request_id(d: bytes) -> tuple[int, int]:
    r = AperReader(d)
    r.get_bool()
    return r.get_constrained(0, 65535), r.get_constrained(0, 65535)


def pack_global_e2node_id_enb(plmn: bytes, enb_id: int) -> bytes:
    """GlobalE2node-ID CHOICE → eNB {GlobalENB-ID {PLMN, macro BIT(20)}}."""
    w = AperWriter()
    w.put_bool(False)          # choice not extended
    w.put(3, 2)                # eNB
    w.put_bool(False)          # GlobalE2node-eNB-ID sequence extension
    w.put_bool(False)          # GlobalENB-ID sequence extension
    w.put_bytes(plmn)
    w.put_bool(False)          # eNB-ID choice not extended
    w.put(0, 1)                # macro-eNB-ID (2 base alternatives)
    w.align()                  # BIT STRING(20) > 16 bits → aligned
    w.put(enb_id, 20)
    return w.to_bytes()


def unpack_global_e2node_id(d: bytes) -> tuple[str, bytes, int]:
    r = AperReader(d)
    r.get_bool()
    kind = r.get(2)
    if kind != 3:
        return ("other", b"", 0)
    r.get_bool()
    r.get_bool()
    r.align()
    plmn = r.get_bytes(3)
    r.get_bool()
    r.get(1)
    r.align()
    return ("enb", plmn, r.get(20))


# ---- PER string/integer helpers matching asn1_utils semantics ---------------

def _put_printable(w: AperWriter, s: str, lo: int, hi: int,
                   ext: bool = True) -> None:
    """PrintableString (SIZE(lo..hi), ext) — asn1_utils string pack: ext
    bit, constrained length (8-bit field if range<256 else aligned
    16-bit), align, 8-bit chars."""
    if ext:
        w.put_bool(False)
    rng = hi - lo + 1
    if rng < 256:
        w.put(len(s) - lo, 8)
    else:
        w.align()
        w.put(len(s) - lo, 16)
    w.align()
    for c in s.encode():
        w.put(c, 8)


def _get_printable(r: AperReader, lo: int, hi: int, ext: bool = True) -> str:
    if ext:
        assert not r.get_bool()
    rng = hi - lo + 1
    if rng < 256:
        n = r.get(8) + lo
    else:
        r.align()
        n = r.get(16) + lo
    r.align()
    return bytes(r.get(8) for _ in range(n)).decode()


def _put_count(w: AperWriter, n: int, lo: int, hi: int) -> None:
    """SEQUENCE OF count: constrained length determinant for ub < 64K,
    general length determinant above (X.691 §10.9; asn1_utils
    pack_length)."""
    if hi >= 65536:
        w.put_length(n)
    else:
        w.put_constrained(n, lo, hi)


def _get_count(r: AperReader, lo: int, hi: int) -> int:
    if hi >= 65536:
        return r.get_length()
    return r.get_constrained(lo, hi)


# ---- E2SM-KPM service model -------------------------------------------------

KPM_OID = "1.3.6.1.4.1.53148.1.2.2.2"


@dataclass
class KpmRanFunctionDescription:
    short_name: str = "ORAN-E2SM-KPM"
    oid: str = KPM_OID
    description: str = "KPM Monitor"
    # (style_type, style_name, format_type) per RIC report style
    report_styles: tuple = ()

    def pack(self) -> bytes:
        w = AperWriter()
        w.put_bool(False)                      # sequence extension
        w.put_bool(False)                      # eventTriggerStyle list absent
        w.put_bool(bool(self.report_styles))   # reportStyle list
        # RANfunction-Name (ext + instance flag)
        w.put_bool(False)
        w.put_bool(False)
        _put_printable(w, self.short_name, 1, 150)
        _put_printable(w, self.oid, 1, 1000)
        _put_printable(w, self.description, 1, 150)
        if self.report_styles:
            _put_count(w, len(self.report_styles), 1, 63)
            for stype, name, fmt in self.report_styles:
                w.put_bool(False)              # item extension
                _put_int_unconstrained(w, stype)
                _put_printable(w, name, 1, 150)
                _put_int_unconstrained(w, fmt)     # action format
                _put_count(w, 0, 0, 65535)         # measInfo-Action-List
                _put_int_unconstrained(w, 1)       # indication hdr format
                _put_int_unconstrained(w, 1)       # indication msg format
        return w.to_bytes()

    @classmethod
    def unpack(cls, d: bytes) -> "KpmRanFunctionDescription":
        r = AperReader(d)
        r.get_bool()
        has_trigger = r.get_bool()
        has_report = r.get_bool()
        r.get_bool()
        has_instance = r.get_bool()
        short = _get_printable(r, 1, 150)
        oid = _get_printable(r, 1, 1000)
        desc = _get_printable(r, 1, 150)
        del has_trigger, has_report, has_instance  # remainder not needed
        return cls(short_name=short, oid=oid, description=desc)


def _put_int_unconstrained(w: AperWriter, v: int) -> None:
    """Unconstrained INTEGER (X.691 §12.2.6): length + 2's complement."""
    n = max(1, (v.bit_length() + 8) // 8)
    w.put_length(n)
    w.put(v & ((1 << (8 * n)) - 1), 8 * n)


def _get_int_unconstrained(r: AperReader) -> int:
    n = r.get_length()
    v = r.get(8 * n)
    if v >= 1 << (8 * n - 1):
        v -= 1 << (8 * n)
    return v


@dataclass
class KpmEventTriggerDefinition:
    """E2SM-KPM-EventTriggerDefinition → format 1 (reporting period ms)."""
    report_period_ms: int = 1000

    def pack(self) -> bytes:
        w = AperWriter()
        w.put_bool(False)          # sequence extension
        w.put_bool(False)          # formats choice not extended
        # single alternative → 0 choice bits; format1:
        w.put_bool(False)          # format1 sequence extension
        w.put_constrained(self.report_period_ms, 1, 4294967295)
        return w.to_bytes()

    @classmethod
    def unpack(cls, d: bytes) -> "KpmEventTriggerDefinition":
        r = AperReader(d)
        r.get_bool()
        r.get_bool()
        r.get_bool()
        return cls(report_period_ms=r.get_constrained(1, 4294967295))


@dataclass
class KpmIndicationHeader:
    """E2SM-KPM-IndicationHeader → format 1 (collection start time)."""
    collect_start_time: int = 0   # 32-bit seconds counter
    sender_name: str = ""

    def pack(self) -> bytes:
        w = AperWriter()
        w.put_bool(False)          # sequence extension
        w.put_bool(False)          # formats choice not extended
        w.put_bool(False)          # format1 sequence extension
        w.put_bool(False)          # fileFormatversion absent
        w.put_bool(bool(self.sender_name))
        w.put_bool(False)          # senderType absent
        w.put_bool(False)          # vendorName absent
        w.put_bytes(self.collect_start_time.to_bytes(4, "big"))
        if self.sender_name:
            _put_printable(w, self.sender_name, 0, 400, ext=False)
        return w.to_bytes()

    @classmethod
    def unpack(cls, d: bytes) -> "KpmIndicationHeader":
        r = AperReader(d)
        r.get_bool()
        r.get_bool()
        r.get_bool()
        r.get_bool()
        has_sender = r.get_bool()
        r.get_bool()
        r.get_bool()
        r.align()
        t = int.from_bytes(bytes(r.get_bytes(4)), "big")
        sender = _get_printable(r, 0, 400, ext=False) if has_sender else ""
        return cls(collect_start_time=t, sender_name=sender)


@dataclass
class KpmIndicationMessage:
    """E2SM-KPM-IndicationMessage → format 1: one measurement row of
    integer records, with the metric names in measInfoList (noLabel)."""
    names: tuple = ()
    values: tuple = ()
    granul_period_ms: int = 0

    def pack(self) -> bytes:
        w = AperWriter()
        w.put_bool(False)          # sequence extension
        w.put_bool(False)          # formats choice not extended
        w.put(0, 1)                # format1 (2 base alternatives)
        w.put_bool(False)          # format1 sequence extension
        w.put_bool(bool(self.names))
        w.put_bool(self.granul_period_ms > 0)
        # measData: one MeasurementDataItem (ext + incompleteFlag absent)
        _put_count(w, 1, 1, 65535)
        w.put_bool(False)
        w.put_bool(False)
        _put_count(w, len(self.values), 1, 2147483647)
        for v in self.values:
            w.put_bool(False)      # record item choice not extended
            w.put(0, 2)            # integer
            w.put_constrained(int(v), 0, 4294967295)
        if self.names:
            _put_count(w, len(self.names), 1, 65535)
            for name in self.names:
                _put_meas_info(w, name)
        if self.granul_period_ms > 0:
            w.put_constrained(self.granul_period_ms, 1, 4294967295)
        return w.to_bytes()

    @classmethod
    def unpack(cls, d: bytes) -> "KpmIndicationMessage":
        r = AperReader(d)
        r.get_bool()
        r.get_bool()
        assert r.get(1) == 0, "only indication format 1 supported"
        r.get_bool()
        has_info = r.get_bool()
        has_granul = r.get_bool()
        n_data = _get_count(r, 1, 65535)
        values = []
        for _ in range(n_data):
            r.get_bool()
            incomplete = r.get_bool()
            n_rec = _get_count(r, 1, 2147483647)
            for _ in range(n_rec):
                r.get_bool()
                kind = r.get(2)
                assert kind == 0, "only integer records supported"
                values.append(r.get_constrained(0, 4294967295))
            del incomplete
        names = []
        if has_info:
            for _ in range(_get_count(r, 1, 65535)):
                names.append(_get_meas_info(r))
        granul = r.get_constrained(1, 4294967295) if has_granul else 0
        return cls(names=tuple(names), values=tuple(values),
                   granul_period_ms=granul)


def _put_meas_info(w: AperWriter, name: str) -> None:
    """MeasurementInfoItem: measName + one noLabel LabelInfoItem."""
    w.put_bool(False)      # item extension
    w.put_bool(False)      # measType choice not extended
    w.put(0, 1)            # measName
    _put_printable(w, name, 1, 150)
    _put_count(w, 1, 1, 2147483647)
    w.put_bool(False)      # LabelInfoItem extension
    w.put_bool(False)      # MeasurementLabel extension
    w.put_bool(True)       # noLabel present
    for _ in range(20):
        w.put_bool(False)
    w.put_bool(False)      # noLabel ENUM{true} ext bit


def _get_meas_info(r: AperReader) -> str:
    r.get_bool()
    r.get_bool()
    assert r.get(1) == 0
    name = _get_printable(r, 1, 150)
    for _ in range(_get_count(r, 1, 2147483647)):
        r.get_bool()
        r.get_bool()
        flags = [r.get_bool() for _ in range(21)]
        if flags[0]:
            r.get_bool()
        assert not any(flags[1:]), "only noLabel supported"
    return name


@dataclass
class KpmActionDefinition:
    """E2SM-KPM-ActionDefinition → format 1 (measInfoList + granularity)."""
    style_type: int = 1
    names: tuple = ()
    granul_period_ms: int = 1000

    def pack(self) -> bytes:
        w = AperWriter()
        w.put_bool(False)          # sequence extension
        _put_int_unconstrained(w, self.style_type)
        w.put_bool(False)          # formats choice not extended
        w.put(0, 2)                # format1 (3 base alternatives)
        w.put_bool(False)          # format1 sequence extension
        w.put_bool(False)          # cellGlobalID absent
        _put_count(w, len(self.names), 1, 65535)
        for name in self.names:
            _put_meas_info(w, name)
        w.put_constrained(self.granul_period_ms, 1, 4294967295)
        return w.to_bytes()

    @classmethod
    def unpack(cls, d: bytes) -> "KpmActionDefinition":
        r = AperReader(d)
        r.get_bool()
        style = _get_int_unconstrained(r)
        r.get_bool()
        assert r.get(2) == 0, "only action definition format 1 supported"
        r.get_bool()
        has_cgi = r.get_bool()
        names = tuple(_get_meas_info(r)
                      for _ in range(_get_count(r, 1, 65535)))
        granul = r.get_constrained(1, 4294967295)
        del has_cgi
        return cls(style_type=style, names=names, granul_period_ms=granul)


# ---- composite-list IE values ----------------------------------------------

IE_E2NODE_CONFIG_ADDITION_ITEM = 51

# e2nodeComponentInterfaceType enum (e2ap.h:947)
IF_NG, IF_XN, IF_E1, IF_F1, IF_W1, IF_S1, IF_X2 = range(7)


def pack_component_config_addition(interface_name: str,
                                   request: bytes, response: bytes,
                                   interface: int = IF_S1) -> bytes:
    """E2nodeComponentConfigAddition-List (IE 50, mandatory in
    E2setupRequest): one item with the S1 (MME name) component id and
    the request/response config blobs."""
    w = AperWriter()
    _put_count(w, 1, 1, 1024)
    w.put_constrained(IE_E2NODE_CONFIG_ADDITION_ITEM, 0, 65535)
    w.put(CRIT_REJECT, 2)
    item = AperWriter()
    item.put_bool(False)               # item extension
    item.put_bool(False)               # interfaceType enum ext
    item.put(interface, 3)
    item.put_bool(False)               # componentID choice ext
    item.put(interface, 3)             # alternative mirrors the interface
    item.put_bool(False)               # interface-type SEQUENCE extension
    _put_printable(item, interface_name, 1, 150)
    item.put_bool(False)               # e2nodeComponentConfiguration ext
    item.put_octetstring(request)
    item.put_octetstring(response)
    w.put_open(item.to_bytes())
    return w.to_bytes()


def unpack_component_config_addition(
        d: bytes) -> list[tuple[int, str, bytes, bytes]]:
    r = AperReader(d)
    out = []
    for _ in range(_get_count(r, 1, 1024)):
        r.get_constrained(0, 65535)
        r.get(2)
        item = AperReader(r.get_open())
        item.get_bool()
        item.get_bool()
        itype = item.get(3)
        item.get_bool()
        item.get(3)
        item.get_bool()
        name = _get_printable(item, 1, 150)
        item.get_bool()
        req = item.get_octetstring()
        rsp = item.get_octetstring()
        out.append((itype, name, req, rsp))
    return out

def pack_ran_functions_added(
        funcs: list[tuple[int, bytes, int, str]]) -> bytes:
    """RANfunctions-List: SEQUENCE (SIZE(1..256)) OF
    ProtocolIE-SingleContainer{RANfunction-Item}."""
    w = AperWriter()
    _put_count(w, len(funcs), 1, 256)
    for fid, definition, revision, oid in funcs:
        w.put_constrained(IE_RAN_FUNCTION_ITEM, 0, 65535)
        w.put(CRIT_IGNORE, 2)
        item = AperWriter()
        item.put_bool(False)       # RANfunction-Item extension
        item.put_constrained(fid, 0, 4095)
        item.put_open(definition)
        item.put_constrained(revision, 0, 4095)
        _put_printable(item, oid, 1, 1000)
        w.put_open(item.to_bytes())
    return w.to_bytes()


def unpack_ran_functions_added(d: bytes) -> list[tuple[int, bytes, int, str]]:
    r = AperReader(d)
    out = []
    for _ in range(_get_count(r, 1, 256)):
        r.get_constrained(0, 65535)
        r.get(2)
        item = AperReader(r.get_open())
        item.get_bool()
        fid = item.get_constrained(0, 4095)
        definition = item.get_open()
        rev = item.get_constrained(0, 4095)
        oid = _get_printable(item, 1, 1000)
        out.append((fid, definition, rev, oid))
    return out


def pack_ran_functions_accepted(funcs: list[tuple[int, int]]) -> bytes:
    """RANfunctionsID-List: SEQUENCE OF SingleContainer{RANfunctionID-Item
    {ranFunctionID, ranFunctionRevision}}."""
    w = AperWriter()
    _put_count(w, len(funcs), 1, 256)
    for fid, rev in funcs:
        w.put_constrained(IE_RAN_FUNCTION_ID_ITEM, 0, 65535)
        w.put(CRIT_IGNORE, 2)
        item = AperWriter()
        item.put_bool(False)
        item.put_constrained(fid, 0, 4095)
        item.put_constrained(rev, 0, 4095)
        w.put_open(item.to_bytes())
    return w.to_bytes()


def unpack_ran_functions_accepted(d: bytes) -> list[tuple[int, int]]:
    r = AperReader(d)
    out = []
    for _ in range(_get_count(r, 1, 256)):
        r.get_constrained(0, 65535)
        r.get(2)
        item = AperReader(r.get_open())
        item.get_bool()
        out.append((item.get_constrained(0, 4095),
                    item.get_constrained(0, 4095)))
    return out


def pack_subscription_details(trigger: bytes,
                              actions: list[tuple[int, int, bytes]]) -> bytes:
    """RICsubscriptionDetails {ricEventTriggerDefinition,
    ricAction-ToBeSetup-List of (actionID, actionType, actionDefinition)}."""
    w = AperWriter()
    w.put_bool(False)              # sequence extension
    w.put_open(trigger)
    _put_count(w, len(actions), 1, 16)
    for aid, atype, adef in actions:
        w.put_constrained(IE_RIC_ACTION_TO_BE_SETUP_ITEM, 0, 65535)
        w.put(CRIT_IGNORE, 2)
        item = AperWriter()
        item.put_bool(False)       # item extension
        item.put_bool(bool(adef))  # actionDefinition present
        item.put_bool(False)       # subsequentAction absent
        item.put_constrained(aid, 0, 255)
        item.put_bool(False)       # actionType enum ext
        item.put(atype, 2)
        if adef:
            item.put_open(adef)
        w.put_open(item.to_bytes())
    return w.to_bytes()


def unpack_subscription_details(
        d: bytes) -> tuple[bytes, list[tuple[int, int, bytes]]]:
    r = AperReader(d)
    r.get_bool()
    trigger = r.get_open()
    actions = []
    for _ in range(_get_count(r, 1, 16)):
        r.get_constrained(0, 65535)
        r.get(2)
        item = AperReader(r.get_open())
        item.get_bool()
        has_def = item.get_bool()
        has_sub = item.get_bool()
        aid = item.get_constrained(0, 255)
        item.get_bool()
        atype = item.get(2)
        adef = item.get_open() if has_def else b""
        del has_sub
        actions.append((aid, atype, adef))
    return trigger, actions


IE_E2NODE_CONFIG_ADDITION_ACK_ITEM = 53


def pack_component_config_addition_ack(interface_name: str,
                                       interface: int = IF_S1,
                                       success: bool = True) -> bytes:
    """E2nodeComponentConfigAdditionAck-List (IE 52, mandatory in
    E2setupResponse)."""
    w = AperWriter()
    _put_count(w, 1, 1, 1024)
    w.put_constrained(IE_E2NODE_CONFIG_ADDITION_ACK_ITEM, 0, 65535)
    w.put(CRIT_REJECT, 2)
    item = AperWriter()
    item.put_bool(False)               # item extension
    item.put_bool(False)               # interfaceType enum ext
    item.put(interface, 3)
    item.put_bool(False)               # componentID choice ext
    item.put(interface, 3)
    item.put_bool(False)               # interface-type SEQUENCE extension
    _put_printable(item, interface_name, 1, 150)
    item.put_bool(False)               # cfg-ack SEQUENCE extension
    item.put_bool(False)               # failureCause absent
    item.put_bool(False)               # updateOutcome enum ext
    item.put(0 if success else 1, 1)
    w.put_open(item.to_bytes())
    return w.to_bytes()


def pack_global_ric_id(plmn: bytes, ric_id: int) -> bytes:
    w = AperWriter()
    w.put_bool(False)                  # sequence extension
    w.put_bytes(plmn)
    w.put_bitstring(ric_id, 20)
    return w.to_bytes()


def pack_actions_admitted(action_ids: list[int]) -> bytes:
    w = AperWriter()
    _put_count(w, len(action_ids), 1, 16)
    for aid in action_ids:
        w.put_constrained(IE_RIC_ACTION_ADMITTED_ITEM, 0, 65535)
        w.put(CRIT_IGNORE, 2)
        item = AperWriter()
        item.put_bool(False)
        item.put_constrained(aid, 0, 255)
        w.put_open(item.to_bytes())
    return w.to_bytes()


def pack_indication_sn(sn: int) -> bytes:
    return AperWriter().put_constrained(sn, 0, 65535).to_bytes()


def unpack_indication_sn(d: bytes) -> int:
    return AperReader(d).get_constrained(0, 65535)


def pack_indication_type(t: int) -> bytes:
    return AperWriter().put_bool(False).put(t, 1).to_bytes()


def pack_action_id(aid: int) -> bytes:
    return AperWriter().put_constrained(aid, 0, 255).to_bytes()
