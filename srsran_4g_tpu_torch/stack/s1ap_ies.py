"""36.413-exact IE mappings for the framework's S1AP messages.

Bridges the typed dataclasses of `s1ap_msgs.py` to real S1AP-PDU
protocol IEs on the aligned-PER runtime (`s1ap_per.py`), so every S1
message the E2E exchanges is a 3GPP-exact encoding — the counterpart of
the per-procedure pack/unpack methods in the generated
`lib/src/asn1/s1ap.cc` for the subset the framework drives
(S1 Setup, Initial UE Message, NAS transports, Initial Context Setup,
UE Context Release, Paging, S1 handover + status transfer).
"""

from __future__ import annotations

from .aper import AperReader, AperWriter
from . import s1ap_per as P
from .s1ap_per import Ie

DEFAULT_PLMN = P.pack_plmn(1, 1)

# additional IE ids (36.413 §9.3.7)
IE_HANDOVER_TYPE = 1
IE_TARGET_ID = 4
IE_ERAB_SETUP_LIST_CTXT_RES = 51
IE_ERAB_SETUP_ITEM_CTXT_RES = 50
IE_ERAB_TO_BE_SETUP_ITEM_CTXT = 52
IE_ERAB_TO_BE_SETUP_LIST_HO = 53
IE_ERAB_TO_BE_SETUP_ITEM_HO = 27
IE_ERAB_ADMITTED_LIST = 18
IE_ERAB_ADMITTED_ITEM = 20
IE_SECURITY_CONTEXT = 40
IE_UE_IDENTITY_INDEX = 80
IE_UE_PAGING_ID = 43
IE_CN_DOMAIN = 109
IE_TAI_LIST = 46
IE_TAI_ITEM = 47
IE_SOURCE_TO_TARGET_CONTAINER = 104
IE_TARGET_TO_SOURCE_CONTAINER = 123
IE_ENB_STATUS_TRANSFER_CONTAINER = 90
IE_BEARERS_SUBJECT_TO_STATUS_ITEM = 89
IE_MME_NAME = 61
IE_SERVED_GUMMEIS = 105
IE_RELATIVE_MME_CAPACITY = 87
IE_STMSI = 96


# ---- common value builders --------------------------------------------------

def _transport_addr(addr: bytes) -> None:
    pass


def pack_transport_addr(w: AperWriter, addr: bytes) -> None:
    """TransportLayerAddress ::= BIT STRING (SIZE(1..160, ...))."""
    w.put_bool(False)
    w.put_constrained(8 * len(addr), 1, 160)
    w.align()
    for b in addr:
        w.put(b, 8)


def unpack_transport_addr(r: AperReader) -> bytes:
    assert not r.get_bool()
    nbits = r.get_constrained(1, 160)
    r.align()
    return bytes(r.get(8) for _ in range(nbits // 8))


def pack_erab_qos(w: AperWriter, qci: int) -> None:
    """E-RABLevelQoSParameters with default ARP (prio 15, no pre-emption)."""
    w.put_bool(False)          # ext
    w.put(0, 2)                # gbrQosInformation, iE-Extensions absent
    w.put_constrained(qci, 0, 255)
    w.put_bool(False)          # ARP ext
    w.put_bool(False)          # ARP iE-Extensions absent
    w.put_constrained(15, 0, 15)
    w.put(1, 1)                # pre-emption capability: shall-not-trigger
    w.put(0, 1)                # vulnerability: pre-emptable... not
    # enum values are single-bit (2 root values each, non-extensible)


def unpack_erab_qos(r: AperReader) -> int:
    assert not r.get_bool()
    opts = r.get(2)
    qci = r.get_constrained(0, 255)
    r.get_bool()
    arp_opt = r.get_bool()
    r.get_constrained(0, 15)
    r.get(1)
    r.get(1)
    if arp_opt:
        r.get_open()           # ARP iE-Extensions
    if opts & 2:
        raise ValueError("GBR QoS not modelled")
    if opts & 1:
        r.get_open()
    return qci


def pack_count(w: AperWriter, count: int) -> None:
    """COUNTvalue ::= SEQUENCE {pdcp-SN (0..4095), hFN (0..1048575), ...ext}"""
    w.put_bool(False)
    w.put_bool(False)          # iE-Extensions absent
    w.put_constrained(count & 0xFFF, 0, 4095)
    w.put_constrained(count >> 12, 0, 1048575)


def unpack_count(r: AperReader) -> int:
    r.get_bool()
    opt = r.get_bool()
    sn = r.get_constrained(0, 4095)
    hfn = r.get_constrained(0, 1048575)
    if opt:
        r.get_open()
    return (hfn << 12) | sn


def pack_single_container(ie_id: int, content: bytes,
                          crit: int = P.CRIT_REJECT) -> bytes:
    """ProtocolIE-SingleContainer (list items are wrapped IEs)."""
    w = AperWriter()
    w.put_constrained(ie_id, 0, 65535)
    w.put(crit, 2)
    w.put_open(content)
    return w.to_bytes()


def unpack_single_container(r: AperReader) -> tuple[int, bytes]:
    ie_id = r.get_constrained(0, 65535)
    r.get(2)
    return ie_id, r.get_open()


# ---- per-message converters -------------------------------------------------

def s1_setup_request_ies(m) -> list[Ie]:
    supported = AperWriter()
    supported.put_constrained(1, 1, 256)          # one TA
    supported.put_bool(False)                     # item ext
    supported.put_bool(False)                     # iE-Extensions absent
    supported.put_octetstring(m.tac.to_bytes(2, "big"), fixed=2)
    supported.put_constrained(1, 1, 6)            # one broadcast PLMN
    supported.put_octetstring(m.plmn.to_bytes(3, "big"), fixed=3)
    drx = AperWriter().put_enum(1, 4).to_bytes()  # v64 paging DRX
    return [
        Ie(P.IE_GLOBAL_ENB_ID, P.CRIT_REJECT,
           P.pack_global_enb_id(m.plmn.to_bytes(3, "big"),
                                m.global_enb_id)),
        Ie(P.IE_ENB_NAME, P.CRIT_IGNORE, P.pack_enb_name(m.enb_name)),
        Ie(P.IE_SUPPORTED_TAS, P.CRIT_REJECT, supported.to_bytes()),
        Ie(P.IE_DEFAULT_PAGING_DRX, P.CRIT_IGNORE, drx),
    ]


def s1_setup_request_from(cls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    plmn, enb_id = P.unpack_global_enb_id(by[P.IE_GLOBAL_ENB_ID])
    r = AperReader(by[P.IE_SUPPORTED_TAS])
    r.get_constrained(1, 256)
    r.get_bool()
    r.get_bool()
    tac = int.from_bytes(r.get_octetstring(fixed=2), "big")
    return cls(global_enb_id=enb_id,
               enb_name=P.unpack_enb_name(by[P.IE_ENB_NAME]),
               tac=tac, plmn=int.from_bytes(plmn, "big"))


def s1_setup_response_ies(m) -> list[Ie]:
    gummeis = AperWriter()
    gummeis.put_constrained(1, 1, 8)
    gummeis.put_bool(False)                       # item ext
    gummeis.put_bool(False)                       # iE-Extensions absent
    gummeis.put_constrained(1, 1, 32)             # one served PLMN
    gummeis.put_octetstring(DEFAULT_PLMN, fixed=3)
    gummeis.put_constrained(1, 1, 65535)          # one group id
    gummeis.put_octetstring(m.mme_group.to_bytes(2, "big"), fixed=2)
    gummeis.put_constrained(1, 1, 256)            # one MME code
    gummeis.put_octetstring(bytes([m.mme_code]), fixed=1)
    return [
        Ie(IE_MME_NAME, P.CRIT_IGNORE, P.pack_enb_name(m.mme_name)),
        Ie(IE_SERVED_GUMMEIS, P.CRIT_REJECT, gummeis.to_bytes()),
        Ie(IE_RELATIVE_MME_CAPACITY, P.CRIT_IGNORE,
           P.pack_uint(m.rel_capacity, 255)),
    ]


def s1_setup_response_from(cls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    r = AperReader(by[IE_SERVED_GUMMEIS])
    r.get_constrained(1, 8)
    r.get_bool()
    r.get_bool()
    r.get_constrained(1, 32)
    r.get_octetstring(fixed=3)
    r.get_constrained(1, 65535)
    grp = int.from_bytes(r.get_octetstring(fixed=2), "big")
    r.get_constrained(1, 256)
    code = r.get_octetstring(fixed=1)[0]
    return cls(mme_name=P.unpack_enb_name(by[IE_MME_NAME]),
               mme_group=grp, mme_code=code,
               rel_capacity=P.unpack_uint(by[IE_RELATIVE_MME_CAPACITY], 255))


def initial_ue_message_ies(m) -> list[Ie]:
    cause = AperWriter().put_enum(m.rrc_cause, 5).to_bytes()
    ies = [
        Ie(P.IE_ENB_UE_S1AP_ID, P.CRIT_REJECT, P.pack_enb_ue_id(m.enb_ue_s1ap_id)),
        Ie(P.IE_NAS_PDU, P.CRIT_REJECT, P.pack_nas_pdu(m.nas_pdu)),
        Ie(P.IE_TAI, P.CRIT_REJECT, P.pack_tai(DEFAULT_PLMN, m.tac)),
        Ie(P.IE_EUTRAN_CGI, P.CRIT_IGNORE,
           P.pack_eutran_cgi(DEFAULT_PLMN, m.cell_id)),
        Ie(P.IE_RRC_ESTABLISHMENT_CAUSE, P.CRIT_IGNORE, cause),
    ]
    if m.mtmsi:
        st = AperWriter()
        st.put_bool(False)                        # ext
        st.put_bool(False)                        # iE-Extensions absent
        st.put_octetstring(b"\x1a", fixed=1)      # MMEC
        st.put_octetstring(m.mtmsi.to_bytes(4, "big"), fixed=4)
        ies.append(Ie(IE_STMSI, P.CRIT_REJECT, st.to_bytes()))
    return ies


def initial_ue_message_from(cls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    _, tac = P.unpack_tai(by[P.IE_TAI])
    _, cgi = P.unpack_eutran_cgi(by[P.IE_EUTRAN_CGI])
    mtmsi = 0
    if IE_STMSI in by:
        r = AperReader(by[IE_STMSI])
        r.get_bool()
        r.get_bool()
        r.get_octetstring(fixed=1)
        mtmsi = int.from_bytes(r.get_octetstring(fixed=4), "big")
    return cls(enb_ue_s1ap_id=P.unpack_uint(by[P.IE_ENB_UE_S1AP_ID], 16777215),
               nas_pdu=P.unpack_nas_pdu(by[P.IE_NAS_PDU]),
               tac=tac, cell_id=cgi, mtmsi=mtmsi,
               rrc_cause=AperReader(
                   by[P.IE_RRC_ESTABLISHMENT_CAUSE]).get_enum(5))


def nas_transport_ies(m) -> list[Ie]:
    # UplinkNASTransport additionally mandates EUTRAN-CGI + TAI
    # (36.413 §9.1.5.2); harmless extras on the DL direction
    return [
        Ie(P.IE_MME_UE_S1AP_ID, P.CRIT_REJECT, P.pack_mme_ue_id(m.mme_ue_s1ap_id)),
        Ie(P.IE_ENB_UE_S1AP_ID, P.CRIT_REJECT, P.pack_enb_ue_id(m.enb_ue_s1ap_id)),
        Ie(P.IE_NAS_PDU, P.CRIT_REJECT, P.pack_nas_pdu(m.nas_pdu)),
        Ie(P.IE_EUTRAN_CGI, P.CRIT_IGNORE, P.pack_eutran_cgi(DEFAULT_PLMN, 1)),
        Ie(P.IE_TAI, P.CRIT_IGNORE, P.pack_tai(DEFAULT_PLMN, 1)),
    ]


def nas_transport_from(cls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    return cls(mme_ue_s1ap_id=P.unpack_uint(by[P.IE_MME_UE_S1AP_ID], 4294967295),
               enb_ue_s1ap_id=P.unpack_uint(by[P.IE_ENB_UE_S1AP_ID], 16777215),
               nas_pdu=P.unpack_nas_pdu(by[P.IE_NAS_PDU]))


def _erab_to_setup_item(e) -> bytes:
    w = AperWriter()
    w.put_bool(False)                             # ext
    w.put(1 if e.nas_pdu else 0, 1)               # nAS-PDU present
    w.put(0, 1)                                   # iE-Extensions absent
    w.put_bool(False)                             # e-RAB-ID not extended
    w.put_constrained(e.erab_id, 0, 15)
    pack_erab_qos(w, e.qci)
    pack_transport_addr(w, e.transport_addr)
    w.put_octetstring(e.gtp_teid.to_bytes(4, "big"), fixed=4)
    if e.nas_pdu:
        w.put_octetstring(e.nas_pdu)
    return w.to_bytes()


def _erab_to_setup_item_from(ecls, data: bytes):
    r = AperReader(data)
    assert not r.get_bool()
    has_nas = bool(r.get(1))
    has_ext = bool(r.get(1))
    assert not r.get_bool()
    erab_id = r.get_constrained(0, 15)
    qci = unpack_erab_qos(r)
    addr = unpack_transport_addr(r)
    teid = int.from_bytes(r.get_octetstring(fixed=4), "big")
    nas = r.get_octetstring() if has_nas else b""
    if has_ext:
        r.get_open()
    return ecls(erab_id=erab_id, qci=qci, gtp_teid=teid,
                transport_addr=addr, nas_pdu=nas)


def initial_ctxt_setup_request_ies(m) -> list[Ie]:
    ambr = AperWriter()
    ambr.put_bool(False)                          # ext
    ambr.put_bool(False)                          # iE-Extensions absent
    ambr.put_constrained(m.ue_ambr_dl, 0, 10_000_000_000)
    ambr.put_constrained(m.ue_ambr_ul, 0, 10_000_000_000)
    erabs = AperWriter()
    erabs.put_constrained(len(m.erabs), 1, 256)
    for e in m.erabs:
        erabs.put_bytes(pack_single_container(
            IE_ERAB_TO_BE_SETUP_ITEM_CTXT, _erab_to_setup_item(e)))
    return [
        Ie(P.IE_MME_UE_S1AP_ID, P.CRIT_REJECT, P.pack_mme_ue_id(m.mme_ue_s1ap_id)),
        Ie(P.IE_ENB_UE_S1AP_ID, P.CRIT_REJECT, P.pack_enb_ue_id(m.enb_ue_s1ap_id)),
        Ie(P.IE_UE_AGGREGATE_MAX_BITRATE, P.CRIT_REJECT, ambr.to_bytes()),
        Ie(P.IE_ERAB_TO_BE_SETUP_LIST_CTXT, P.CRIT_REJECT, erabs.to_bytes()),
        Ie(P.IE_UE_SECURITY_CAPABILITIES, P.CRIT_REJECT,
           P.pack_ue_security_capabilities(m.encryption_algs << 8,
                                           m.integrity_algs << 8)),
        Ie(P.IE_SECURITY_KEY, P.CRIT_REJECT,
           P.pack_security_key(m.security_key)),
    ]


def initial_ctxt_setup_request_from(cls, ecls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    ambr = AperReader(by[P.IE_UE_AGGREGATE_MAX_BITRATE])
    ambr.get_bool()
    ambr.get_bool()
    dl = ambr.get_constrained(0, 10_000_000_000)
    ul = ambr.get_constrained(0, 10_000_000_000)
    eea, eia = P.unpack_ue_security_capabilities(
        by[P.IE_UE_SECURITY_CAPABILITIES])
    r = AperReader(by[P.IE_ERAB_TO_BE_SETUP_LIST_CTXT])
    n = r.get_constrained(1, 256)
    erabs = []
    for _ in range(n):
        ie_id, content = unpack_single_container(r)
        assert ie_id == IE_ERAB_TO_BE_SETUP_ITEM_CTXT
        erabs.append(_erab_to_setup_item_from(ecls, content))
    key = AperReader(by[P.IE_SECURITY_KEY]).get_bytes(32)
    return cls(mme_ue_s1ap_id=P.unpack_uint(by[P.IE_MME_UE_S1AP_ID], 4294967295),
               enb_ue_s1ap_id=P.unpack_uint(by[P.IE_ENB_UE_S1AP_ID], 16777215),
               ue_ambr_dl=dl, ue_ambr_ul=ul, erabs=erabs,
               security_key=key, encryption_algs=eea >> 8,
               integrity_algs=eia >> 8)


def _erab_setup_item(e) -> bytes:
    w = AperWriter()
    w.put_bool(False)                             # ext
    w.put(0, 1)                                   # iE-Extensions absent
    w.put_bool(False)
    w.put_constrained(e.erab_id, 0, 15)
    pack_transport_addr(w, e.transport_addr)
    w.put_octetstring(e.gtp_teid.to_bytes(4, "big"), fixed=4)
    return w.to_bytes()


def _erab_setup_item_from(ecls, data: bytes):
    r = AperReader(data)
    assert not r.get_bool()
    has_ext = bool(r.get(1))
    assert not r.get_bool()
    erab_id = r.get_constrained(0, 15)
    addr = unpack_transport_addr(r)
    teid = int.from_bytes(r.get_octetstring(fixed=4), "big")
    if has_ext:
        r.get_open()
    return ecls(erab_id=erab_id, gtp_teid=teid, transport_addr=addr)


def initial_ctxt_setup_response_ies(m) -> list[Ie]:
    erabs = AperWriter()
    erabs.put_constrained(len(m.erabs), 1, 256)
    for e in m.erabs:
        erabs.put_bytes(pack_single_container(
            IE_ERAB_SETUP_ITEM_CTXT_RES, _erab_setup_item(e),
            crit=P.CRIT_IGNORE))
    return [
        Ie(P.IE_MME_UE_S1AP_ID, P.CRIT_IGNORE, P.pack_mme_ue_id(m.mme_ue_s1ap_id)),
        Ie(P.IE_ENB_UE_S1AP_ID, P.CRIT_IGNORE, P.pack_enb_ue_id(m.enb_ue_s1ap_id)),
        Ie(IE_ERAB_SETUP_LIST_CTXT_RES, P.CRIT_IGNORE, erabs.to_bytes()),
    ]


def initial_ctxt_setup_response_from(cls, ecls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    r = AperReader(by[IE_ERAB_SETUP_LIST_CTXT_RES])
    n = r.get_constrained(1, 256)
    erabs = []
    for _ in range(n):
        _, content = unpack_single_container(r)
        erabs.append(_erab_setup_item_from(ecls, content))
    return cls(mme_ue_s1ap_id=P.unpack_uint(by[P.IE_MME_UE_S1AP_ID], 4294967295),
               enb_ue_s1ap_id=P.unpack_uint(by[P.IE_ENB_UE_S1AP_ID], 16777215),
               erabs=erabs)


def paging_ies(m) -> list[Ie]:
    idx = AperWriter()
    idx.put_bitstring(m.ue_index, 10)
    pid = AperWriter()
    pid.put_bool(False)                           # UEPagingID choice ext
    pid.put(0, 1)                                 # s-TMSI
    pid.put_bool(False)                           # S-TMSI seq ext
    pid.put_bool(False)                           # iE-Extensions absent
    pid.put_octetstring(b"\x1a", fixed=1)
    pid.put_octetstring(m.mtmsi.to_bytes(4, "big"), fixed=4)
    dom = AperWriter().put_constrained(0, 0, 1).to_bytes()   # ps domain
    tais = AperWriter()
    tais.put_constrained(1, 1, 256)
    tai_item = AperWriter()
    tai_item.put_bool(False)
    tai_item.put_bool(False)
    tai_item.put_bytes(P.pack_tai(DEFAULT_PLMN, m.tac))
    tais.put_bytes(pack_single_container(IE_TAI_ITEM, tai_item.to_bytes()))
    return [
        Ie(IE_UE_IDENTITY_INDEX, P.CRIT_IGNORE, idx.to_bytes()),
        Ie(IE_UE_PAGING_ID, P.CRIT_IGNORE, pid.to_bytes()),
        Ie(IE_CN_DOMAIN, P.CRIT_IGNORE, dom),
        Ie(IE_TAI_LIST, P.CRIT_IGNORE, tais.to_bytes()),
    ]


def paging_from(cls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    idx = AperReader(by[IE_UE_IDENTITY_INDEX]).get_bitstring(10)
    r = AperReader(by[IE_UE_PAGING_ID])
    assert not r.get_bool()
    assert r.get(1) == 0
    r.get_bool()
    r.get_bool()
    r.get_octetstring(fixed=1)
    mtmsi = int.from_bytes(r.get_octetstring(fixed=4), "big")
    rt = AperReader(by[IE_TAI_LIST])
    rt.get_constrained(1, 256)
    _, item = unpack_single_container(rt)
    ri = AperReader(item)
    ri.get_bool()
    ri.get_bool()
    # TAI value is aligned within the item
    ri.align()
    _, tac = P.unpack_tai(ri.data[ri.pos // 8:])
    return cls(ue_index=idx, mtmsi=mtmsi, tac=tac)


def ue_ctxt_release_ies(m) -> list[Ie]:
    """UEContextReleaseCommand: UE-S1AP-IDs pair + Cause."""
    ids = AperWriter()
    ids.put_bool(False)                           # choice ext
    ids.put(0, 1)                                 # uE-S1AP-ID-pair
    ids.put_bool(False)                           # pair seq ext
    ids.put_bool(False)                           # iE-Extensions absent
    ids.put_constrained(m.mme_ue_s1ap_id, 0, 4294967295)
    ids.put_constrained(m.enb_ue_s1ap_id, 0, 16777215)
    return [
        Ie(P.IE_UE_S1AP_IDS, P.CRIT_REJECT, ids.to_bytes()),
        Ie(P.IE_CAUSE, P.CRIT_IGNORE, P.pack_cause(2, m.cause)),  # nas group
    ]


def ue_ctxt_release_from(cls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    r = AperReader(by[P.IE_UE_S1AP_IDS])
    assert not r.get_bool()
    assert r.get(1) == 0
    r.get_bool()
    r.get_bool()
    mme = r.get_constrained(0, 4294967295)
    enb = r.get_constrained(0, 16777215)
    _, cause = P.unpack_cause(by[P.IE_CAUSE])
    return cls(mme_ue_s1ap_id=mme, enb_ue_s1ap_id=enb, cause=cause)


# ---- S1 handover (36.413 §8.4) ---------------------------------------------

def _target_id(plmn: bytes, enb_id: int, tac: int) -> bytes:
    """TargetID ::= CHOICE { targetENB-ID SEQ{global-ENB-ID,
    selected-TAI, ...}, targetRNC-ID, cGI }."""
    w = AperWriter()
    w.put_bool(False)
    w.put_constrained(0, 0, 2)     # targeteNB-ID
    w.put_bool(False)              # seq ext
    w.put_bool(False)              # iE-Extensions absent
    w.put_bytes(P.pack_global_enb_id(plmn, enb_id))
    w.put_bytes(P.pack_tai(plmn, tac))
    return w.to_bytes()


def _target_id_from(data: bytes) -> int:
    r = AperReader(data)
    assert not r.get_bool()
    assert r.get_constrained(0, 2) == 0
    r.get_bool()
    r.get_bool()
    r.align()
    _, enb_id = P.unpack_global_enb_id(r.data[r.pos // 8:])
    return enb_id


def handover_required_ies(m) -> list[Ie]:
    ho_type = AperWriter().put_enum(0, 5).to_bytes()   # intralte
    return [
        Ie(P.IE_MME_UE_S1AP_ID, P.CRIT_REJECT, P.pack_mme_ue_id(m.mme_ue_s1ap_id)),
        Ie(P.IE_ENB_UE_S1AP_ID, P.CRIT_REJECT, P.pack_enb_ue_id(m.enb_ue_s1ap_id)),
        Ie(IE_HANDOVER_TYPE, P.CRIT_REJECT, ho_type),
        Ie(P.IE_CAUSE, P.CRIT_IGNORE, P.pack_cause(0, m.cause)),
        Ie(IE_TARGET_ID, P.CRIT_REJECT,
           _target_id(DEFAULT_PLMN, m.target_enb_id, 1)),
        Ie(IE_SOURCE_TO_TARGET_CONTAINER, P.CRIT_REJECT,
           P.pack_nas_pdu(m.container)),
    ]


def handover_required_from(cls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    _, cause = P.unpack_cause(by[P.IE_CAUSE])
    return cls(mme_ue_s1ap_id=P.unpack_uint(by[P.IE_MME_UE_S1AP_ID], 4294967295),
               enb_ue_s1ap_id=P.unpack_uint(by[P.IE_ENB_UE_S1AP_ID], 16777215),
               target_enb_id=_target_id_from(by[IE_TARGET_ID]), cause=cause,
               container=P.unpack_nas_pdu(by[IE_SOURCE_TO_TARGET_CONTAINER]))


def _erab_ho_item(e) -> bytes:
    w = AperWriter()
    w.put_bool(False)              # ext
    w.put(0, 1)                    # iE-Extensions absent
    w.put_bool(False)
    w.put_constrained(e.erab_id, 0, 15)
    pack_transport_addr(w, b"\x7f\x00\x01\x01")
    w.put_octetstring(e.gtp_teid.to_bytes(4, "big"), fixed=4)
    pack_erab_qos(w, e.qci)
    return w.to_bytes()


def _erab_ho_item_from(ecls, data: bytes):
    r = AperReader(data)
    assert not r.get_bool()
    has_ext = bool(r.get(1))
    assert not r.get_bool()
    erab_id = r.get_constrained(0, 15)
    unpack_transport_addr(r)
    teid = int.from_bytes(r.get_octetstring(fixed=4), "big")
    qci = unpack_erab_qos(r)
    if has_ext:
        r.get_open()
    return ecls(erab_id=erab_id, qci=qci, gtp_teid=teid)


def handover_request_ies(m) -> list[Ie]:
    ho_type = AperWriter().put_enum(0, 5).to_bytes()
    erabs = AperWriter()
    erabs.put_constrained(len(m.erabs), 1, 256)
    for e in m.erabs:
        erabs.put_bytes(pack_single_container(
            IE_ERAB_TO_BE_SETUP_ITEM_HO, _erab_ho_item(e)))
    sec = AperWriter()
    sec.put_bool(False)            # ext
    sec.put_bool(False)            # iE-Extensions absent
    sec.put_constrained(m.ncc, 0, 7)
    sec.align()
    sec.put_bytes(m.security_key)
    return [
        Ie(P.IE_MME_UE_S1AP_ID, P.CRIT_REJECT, P.pack_mme_ue_id(m.mme_ue_s1ap_id)),
        Ie(IE_HANDOVER_TYPE, P.CRIT_REJECT, ho_type),
        Ie(P.IE_CAUSE, P.CRIT_IGNORE, P.pack_cause(0, 0)),
        Ie(IE_ERAB_TO_BE_SETUP_LIST_HO, P.CRIT_REJECT, erabs.to_bytes()),
        Ie(IE_SOURCE_TO_TARGET_CONTAINER, P.CRIT_REJECT,
           P.pack_nas_pdu(m.container)),
        Ie(IE_SECURITY_CONTEXT, P.CRIT_REJECT, sec.to_bytes()),
    ]


def handover_request_from(cls, ecls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    r = AperReader(by[IE_ERAB_TO_BE_SETUP_LIST_HO])
    n = r.get_constrained(1, 256)
    erabs = []
    for _ in range(n):
        _, content = unpack_single_container(r)
        erabs.append(_erab_ho_item_from(ecls, content))
    rs = AperReader(by[IE_SECURITY_CONTEXT])
    rs.get_bool()
    rs.get_bool()
    ncc = rs.get_constrained(0, 7)
    key = rs.get_bytes(32)
    return cls(mme_ue_s1ap_id=P.unpack_uint(by[P.IE_MME_UE_S1AP_ID], 4294967295),
               security_key=key, ncc=ncc, erabs=erabs,
               container=P.unpack_nas_pdu(by[IE_SOURCE_TO_TARGET_CONTAINER]))


def handover_request_ack_ies(m) -> list[Ie]:
    erabs = AperWriter()
    erabs.put_constrained(len(m.erabs), 1, 256)
    for e in m.erabs:
        item = AperWriter()
        item.put_bool(False)
        item.put(0, 4)             # dl/ul forwarding addrs, iE-Ext absent
        item.put_bool(False)
        item.put_constrained(e.erab_id, 0, 15)
        pack_transport_addr(item, e.transport_addr)
        item.put_octetstring(e.gtp_teid.to_bytes(4, "big"), fixed=4)
        erabs.put_bytes(pack_single_container(
            IE_ERAB_ADMITTED_ITEM, item.to_bytes()))
    return [
        Ie(P.IE_MME_UE_S1AP_ID, P.CRIT_IGNORE, P.pack_mme_ue_id(m.mme_ue_s1ap_id)),
        Ie(P.IE_ENB_UE_S1AP_ID, P.CRIT_IGNORE, P.pack_enb_ue_id(m.enb_ue_s1ap_id)),
        Ie(IE_ERAB_ADMITTED_LIST, P.CRIT_IGNORE, erabs.to_bytes()),
        Ie(IE_TARGET_TO_SOURCE_CONTAINER, P.CRIT_REJECT,
           P.pack_nas_pdu(m.container)),
    ]


def handover_request_ack_from(cls, ecls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    r = AperReader(by[IE_ERAB_ADMITTED_LIST])
    n = r.get_constrained(1, 256)
    erabs = []
    for _ in range(n):
        _, content = unpack_single_container(r)
        ri = AperReader(content)
        ri.get_bool()
        ri.get(4)
        ri.get_bool()
        erab_id = ri.get_constrained(0, 15)
        addr = unpack_transport_addr(ri)
        teid = int.from_bytes(ri.get_octetstring(fixed=4), "big")
        erabs.append(ecls(erab_id=erab_id, gtp_teid=teid,
                          transport_addr=addr))
    return cls(mme_ue_s1ap_id=P.unpack_uint(by[P.IE_MME_UE_S1AP_ID], 4294967295),
               enb_ue_s1ap_id=P.unpack_uint(by[P.IE_ENB_UE_S1AP_ID], 16777215),
               erabs=erabs,
               container=P.unpack_nas_pdu(by[IE_TARGET_TO_SOURCE_CONTAINER]))


def handover_command_ies(m) -> list[Ie]:
    ho_type = AperWriter().put_enum(0, 5).to_bytes()
    return [
        Ie(P.IE_MME_UE_S1AP_ID, P.CRIT_REJECT, P.pack_mme_ue_id(m.mme_ue_s1ap_id)),
        Ie(P.IE_ENB_UE_S1AP_ID, P.CRIT_REJECT, P.pack_enb_ue_id(m.enb_ue_s1ap_id)),
        Ie(IE_HANDOVER_TYPE, P.CRIT_REJECT, ho_type),
        Ie(IE_TARGET_TO_SOURCE_CONTAINER, P.CRIT_REJECT,
           P.pack_nas_pdu(m.container)),
    ]


def handover_command_from(cls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    return cls(mme_ue_s1ap_id=P.unpack_uint(by[P.IE_MME_UE_S1AP_ID], 4294967295),
               enb_ue_s1ap_id=P.unpack_uint(by[P.IE_ENB_UE_S1AP_ID], 16777215),
               container=P.unpack_nas_pdu(by[IE_TARGET_TO_SOURCE_CONTAINER]))


def status_transfer_ies(m) -> list[Ie]:
    cont = AperWriter()
    cont.put_bool(False)           # container seq ext
    cont.put_bool(False)           # iE-Extensions absent
    cont.put_constrained(len(m.bearers), 1, 256)
    for b in m.bearers:
        item = AperWriter()
        item.put_bool(False)       # item ext
        item.put(0, 2)             # receiveStatus, iE-Extensions absent
        item.put_bool(False)
        item.put_constrained(b.erab_id, 0, 15)
        pack_count(item, b.ul_count)
        pack_count(item, b.dl_count)
        cont.put_bytes(pack_single_container(
            IE_BEARERS_SUBJECT_TO_STATUS_ITEM, item.to_bytes()))
    return [
        Ie(P.IE_MME_UE_S1AP_ID, P.CRIT_REJECT, P.pack_mme_ue_id(m.mme_ue_s1ap_id)),
        Ie(P.IE_ENB_UE_S1AP_ID, P.CRIT_REJECT, P.pack_enb_ue_id(m.enb_ue_s1ap_id)),
        Ie(IE_ENB_STATUS_TRANSFER_CONTAINER, P.CRIT_REJECT, cont.to_bytes()),
    ]


def status_transfer_from(cls, bcls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    r = AperReader(by[IE_ENB_STATUS_TRANSFER_CONTAINER])
    r.get_bool()
    r.get_bool()
    n = r.get_constrained(1, 256)
    bearers = []
    for _ in range(n):
        _, content = unpack_single_container(r)
        ri = AperReader(content)
        ri.get_bool()
        ri.get(2)
        ri.get_bool()
        erab_id = ri.get_constrained(0, 15)
        ul = unpack_count(ri)
        dl = unpack_count(ri)
        bearers.append(bcls(erab_id=erab_id, ul_count=ul, dl_count=dl))
    return cls(mme_ue_s1ap_id=P.unpack_uint(by[P.IE_MME_UE_S1AP_ID], 4294967295),
               enb_ue_s1ap_id=P.unpack_uint(by[P.IE_ENB_UE_S1AP_ID], 16777215),
               bearers=bearers)


def handover_notify_ies(m) -> list[Ie]:
    return [
        Ie(P.IE_MME_UE_S1AP_ID, P.CRIT_REJECT, P.pack_mme_ue_id(m.mme_ue_s1ap_id)),
        Ie(P.IE_ENB_UE_S1AP_ID, P.CRIT_REJECT, P.pack_enb_ue_id(m.enb_ue_s1ap_id)),
        Ie(P.IE_EUTRAN_CGI, P.CRIT_IGNORE,
           P.pack_eutran_cgi(DEFAULT_PLMN, m.cell_id)),
        Ie(P.IE_TAI, P.CRIT_IGNORE, P.pack_tai(DEFAULT_PLMN, m.tac)),
    ]


def handover_notify_from(cls, ies: list[Ie]):
    by = {i.id: i.value for i in ies}
    _, tac = P.unpack_tai(by[P.IE_TAI])
    _, cgi = P.unpack_eutran_cgi(by[P.IE_EUTRAN_CGI])
    return cls(mme_ue_s1ap_id=P.unpack_uint(by[P.IE_MME_UE_S1AP_ID], 4294967295),
               enb_ue_s1ap_id=P.unpack_uint(by[P.IE_ENB_UE_S1AP_ID], 16777215),
               tac=tac, cell_id=cgi)
