"""3GPP-exact S1AP/NGAP PDU codec on the aligned-PER runtime.

Counterpart of the generated `lib/src/asn1/s1ap.cc` / `ngap.cc` top
layer (36.413/38.413 §9): the S1AP-PDU CHOICE, the InitiatingMessage /
SuccessfulOutcome / UnsuccessfulOutcome wrappers and the
ProtocolIE-Container — byte-exact against the reference's committed
test vectors (lib/test/asn1/s1ap_test.cc, ngap_test.cc).

The container layer is fully typed; IE *values* are open types —
decoded by the typed helpers below for the IEs the framework's
attach/handover flows exchange (NAS-PDU, UE S1AP id pairs,
Global-ENB-ID, TAI, EUTRAN-CGI, UESecurityCapabilities, ERAB lists),
and preserved verbatim otherwise so every PDU re-encodes byte-exactly
(the reference's own test_pack_unpack_consistency criterion).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .aper import AperReader, AperWriter

PDU_INITIATING = 0
PDU_SUCCESSFUL = 1
PDU_UNSUCCESSFUL = 2

CRIT_REJECT, CRIT_IGNORE, CRIT_NOTIFY = 0, 1, 2

# S1AP procedure codes (36.413 §9.3.7)
PROC_HO_PREPARATION = 0
PROC_HO_RESOURCE_ALLOC = 1
PROC_ERAB_SETUP = 5
PROC_INITIAL_CONTEXT_SETUP = 9
PROC_PAGING = 10
PROC_DOWNLINK_NAS_TRANSPORT = 11
PROC_INITIAL_UE_MESSAGE = 12
PROC_UPLINK_NAS_TRANSPORT = 13
PROC_S1_SETUP = 17
PROC_UE_CONTEXT_RELEASE_REQUEST = 18
PROC_UE_CONTEXT_RELEASE = 23

# IE ids (36.413 §9.3.7)
IE_MME_UE_S1AP_ID = 0
IE_ENB_UE_S1AP_ID = 8
IE_NAS_PDU = 26
IE_ERAB_TO_BE_SETUP_LIST_CTXT = 24
IE_UE_AGGREGATE_MAX_BITRATE = 66
IE_GLOBAL_ENB_ID = 59
IE_ENB_NAME = 60
IE_SUPPORTED_TAS = 64
IE_TAI = 67
IE_EUTRAN_CGI = 100
IE_RRC_ESTABLISHMENT_CAUSE = 134
IE_UE_SECURITY_CAPABILITIES = 107
IE_SECURITY_KEY = 73
IE_DEFAULT_PAGING_DRX = 137
IE_CAUSE = 2
IE_UE_S1AP_IDS = 99


@dataclass
class Ie:
    """One ProtocolIE-Field; `value` holds the open-type contents."""
    id: int
    crit: int
    value: bytes


@dataclass
class S1apPdu:
    pdu_type: int
    proc_code: int
    crit: int
    ies: list[Ie] = field(default_factory=list)

    # ---- container codec (byte-exact) -----------------------------------

    def pack(self) -> bytes:
        w = AperWriter()
        w.put_bool(False)                 # S1AP-PDU choice not extended
        w.put(self.pdu_type, 2)
        w.put_constrained(self.proc_code, 0, 255)
        w.put(self.crit, 2)               # Criticality: non-extensible enum
        body = AperWriter()
        body.put_bool(False)              # message SEQUENCE extension bit
        body.align()
        body.put_constrained(len(self.ies), 0, 65535)
        for ie in self.ies:
            body.put_constrained(ie.id, 0, 65535)
            body.put(ie.crit, 2)
            body.put_open(ie.value)
        w.put_open(body.to_bytes())
        return w.to_bytes()

    @classmethod
    def unpack(cls, data: bytes) -> "S1apPdu":
        r = AperReader(data)
        assert not r.get_bool(), "extended S1AP-PDU choice"
        pdu_type = r.get(2)
        proc = r.get_constrained(0, 255)
        crit = r.get(2)
        body = AperReader(r.get_open())
        assert not body.get_bool(), "extended message sequence"
        body.align()
        n = body.get_constrained(0, 65535)
        ies = []
        for _ in range(n):
            ie_id = body.get_constrained(0, 65535)
            ie_crit = body.get(2)
            ies.append(Ie(ie_id, ie_crit, body.get_open()))
        return cls(pdu_type=pdu_type, proc_code=proc, crit=crit, ies=ies)

    def ie(self, ie_id: int) -> Ie | None:
        for ie in self.ies:
            if ie.id == ie_id:
                return ie
        return None


# ---- typed IE value codecs --------------------------------------------------

def pack_uint(value: int, hi: int) -> bytes:
    """INTEGER (0..hi) as a standalone open-type value."""
    return AperWriter().put_constrained(value, 0, hi).to_bytes()


def unpack_uint(data: bytes, hi: int) -> int:
    return AperReader(data).get_constrained(0, hi)


def pack_enb_ue_id(v: int) -> bytes:
    return pack_uint(v, 16777215)


def pack_mme_ue_id(v: int) -> bytes:
    return pack_uint(v, 4294967295)


def pack_nas_pdu(nas: bytes) -> bytes:
    return AperWriter().put_octetstring(nas).to_bytes()


def unpack_nas_pdu(data: bytes) -> bytes:
    return AperReader(data).get_octetstring()


def pack_plmn(mcc: int, mnc: int) -> bytes:
    """PLMN identity octets (BCD, 36.413 uses the NAS encoding)."""
    d = [mcc // 100, (mcc // 10) % 10, mcc % 10]
    if mnc < 100:
        m = [0xF, mnc // 10, mnc % 10]
    else:
        m = [mnc // 100, (mnc // 10) % 10, mnc % 10]
    return bytes([d[0] | (d[1] << 4), d[2] | (m[0] << 4),
                  m[1] | (m[2] << 4)])


def pack_global_enb_id(plmn: bytes, enb_id: int) -> bytes:
    """Global-ENB-ID with a macro (20-bit) eNB id."""
    w = AperWriter()
    w.put_bool(False)        # sequence extension
    w.put_bool(False)        # iE-Extensions absent
    w.put_octetstring(plmn, fixed=3)
    w.put_bool(False)        # eNB-ID choice extension
    w.put(0, 1)              # macroENB-ID
    w.put_bitstring(enb_id, 20)
    return w.to_bytes()


def unpack_global_enb_id(data: bytes) -> tuple[bytes, int]:
    r = AperReader(data)
    assert not r.get_bool()
    r.get_bool()
    plmn = r.get_octetstring(fixed=3)
    assert not r.get_bool()
    kind = r.get(1)
    enb_id = r.get_bitstring(20 if kind == 0 else 28)
    return plmn, enb_id


def pack_enb_name(name: str) -> bytes:
    """ENBname ::= PrintableString (SIZE(1..150, ...)) with extension."""
    w = AperWriter()
    w.put_bool(False)                     # size not extended
    w.put_constrained(len(name), 1, 150)
    w.put_bytes(name.encode())
    return w.to_bytes()


def unpack_enb_name(data: bytes) -> str:
    r = AperReader(data)
    assert not r.get_bool()
    n = r.get_constrained(1, 150)
    return r.get_bytes(n).decode()


def pack_tai(plmn: bytes, tac: int) -> bytes:
    w = AperWriter()
    w.put_bool(False)                     # extension
    w.put_bool(False)                     # iE-Extensions absent
    w.put_octetstring(plmn, fixed=3)
    w.put_octetstring(tac.to_bytes(2, "big"), fixed=2)
    return w.to_bytes()


def unpack_tai(data: bytes) -> tuple[bytes, int]:
    r = AperReader(data)
    r.get_bool()
    r.get_bool()
    plmn = r.get_octetstring(fixed=3)
    tac = int.from_bytes(r.get_octetstring(fixed=2), "big")
    return plmn, tac


def pack_eutran_cgi(plmn: bytes, cell_id: int) -> bytes:
    """EUTRAN-CGI: PLMN + 28-bit cell identity."""
    w = AperWriter()
    w.put_bool(False)
    w.put_bool(False)
    w.put_octetstring(plmn, fixed=3)
    w.put_bitstring(cell_id, 28)
    return w.to_bytes()


def unpack_eutran_cgi(data: bytes) -> tuple[bytes, int]:
    r = AperReader(data)
    r.get_bool()
    r.get_bool()
    plmn = r.get_octetstring(fixed=3)
    return plmn, r.get_bitstring(28)


def pack_ue_security_capabilities(eea: int, eia: int) -> bytes:
    """16-bit encryption/integrity algorithm bitmaps; both BIT STRINGs
    have extensible SIZE (one extension bit each)."""
    w = AperWriter()
    w.put_bool(False)        # extension
    w.put_bool(False)        # iE-Extensions absent
    w.put_bool(False)        # encryptionAlgorithms size not extended
    w.put_bitstring(eea, 16)
    w.put_bool(False)        # integrityProtectionAlgorithms size
    w.put_bitstring(eia, 16)
    return w.to_bytes()


def unpack_ue_security_capabilities(data: bytes) -> tuple[int, int]:
    r = AperReader(data)
    r.get_bool()
    r.get_bool()
    assert not r.get_bool()
    eea = r.get_bitstring(16)
    assert not r.get_bool()
    return eea, r.get_bitstring(16)


def pack_security_key(key: bytes) -> bytes:
    """SecurityKey ::= BIT STRING (SIZE(256))."""
    assert len(key) == 32
    w = AperWriter()
    w.align()
    w.put_bytes(key)
    return w.to_bytes()


def pack_cause(group: int, value: int) -> bytes:
    """Cause ::= CHOICE of 5 enum groups (radioNetwork, transport, nas,
    protocol, misc), each extensible."""
    w = AperWriter()
    w.put_bool(False)
    w.put_constrained(group, 0, 4)
    w.put_bool(False)
    sizes = {0: 36, 1: 2, 2: 4, 3: 7, 4: 6}
    w.put_constrained(value, 0, sizes[group] - 1)
    return w.to_bytes()


def unpack_cause(data: bytes) -> tuple[int, int]:
    r = AperReader(data)
    assert not r.get_bool()
    group = r.get_constrained(0, 4)
    assert not r.get_bool()
    sizes = {0: 36, 1: 2, 2: 4, 3: 7, 4: 6}
    return group, r.get_constrained(0, sizes[group] - 1)
