"""NAS EMM/ESM message codec (TS 24.301) + security-protected framing.

Counterpart of the reference's hand-written NAS codec
`lib/src/asn1/liblte_mme.cc` (~10.5 k LoC): typed message dataclasses
with byte-exact pack()/unpack(), the EMM/ESM protocol discriminators
and message types used on the attach path, and the security-protected
NAS header (integrity MAC-I via EIA2, ciphering via EEA2) as used by
`srsue/src/stack/upper/nas.cc` and `srsepc/src/mme/nas.cc`.

Only the attach/detach/auth message family is implemented — the set
exercised by the reference's E2E test (test/run_lte.sh); the codec
runtime generalises to the rest.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import security

# protocol discriminators
PD_EMM = 0x07
PD_ESM = 0x02

# EMM message types (24.301 table 9.8.1)
MSG_ATTACH_REQUEST = 0x41
MSG_ATTACH_ACCEPT = 0x42
MSG_ATTACH_COMPLETE = 0x43
MSG_ATTACH_REJECT = 0x44
MSG_DETACH_REQUEST = 0x45
MSG_DETACH_ACCEPT = 0x46
MSG_AUTHENTICATION_REQUEST = 0x52
MSG_AUTHENTICATION_RESPONSE = 0x53
MSG_AUTHENTICATION_REJECT = 0x54
MSG_AUTHENTICATION_FAILURE = 0x5C
MSG_IDENTITY_REQUEST = 0x55
MSG_IDENTITY_RESPONSE = 0x56
MSG_SECURITY_MODE_COMMAND = 0x5D
MSG_SECURITY_MODE_COMPLETE = 0x5E
MSG_SERVICE_REQUEST = 0x4D  # has special short header
MSG_SERVICE_REJECT = 0x4E
MSG_TAU_REQUEST = 0x48
MSG_TAU_ACCEPT = 0x49
MSG_TAU_COMPLETE = 0x4A
MSG_TAU_REJECT = 0x4B
MSG_EMM_INFORMATION = 0x61

# ESM message types
MSG_ACT_DEF_EPS_BEARER_REQ = 0xC1
MSG_ACT_DEF_EPS_BEARER_ACCEPT = 0xC2
MSG_ACT_DED_EPS_BEARER_REQ = 0xC5
MSG_ACT_DED_EPS_BEARER_ACCEPT = 0xC6
MSG_PDN_CONNECTIVITY_REQUEST = 0xD0

# security header types (24.301 9.3.1)
SEC_NONE = 0x0
SEC_INTEGRITY = 0x1
SEC_INTEGRITY_CIPHERED = 0x2
SEC_INTEGRITY_NEW_CTX = 0x3
SEC_INTEGRITY_CIPHERED_NEW_CTX = 0x4


def _imsi_to_mobile_id(imsi: str) -> bytes:
    """Mobile Identity IE value for an IMSI (24.008 10.5.1.4)."""
    digits = [int(c) for c in imsi]
    odd = len(digits) % 2
    b0 = (digits[0] << 4) | (odd << 3) | 0x1  # type=IMSI
    rest = digits[1:] + ([0xF] if not odd else [])
    out = [b0]
    for i in range(0, len(rest), 2):
        hi = rest[i + 1] if i + 1 < len(rest) else 0xF
        out.append((hi << 4) | rest[i])
    return bytes(out)


def _apn_ie(apn: str) -> bytes:
    """Access Point Name LV (24.008 10.5.6.1): total length, then each
    dot-separated label as len+chars (liblte pack_access_point_name_ie)."""
    out = bytearray([len(apn) + 1])
    for label in apn.split("."):
        out.append(len(label))
        out += label.encode()
    return bytes(out)


def _apn_from_ie(value: bytes) -> str:
    labels = []
    pos = 0
    while pos < len(value):
        n = value[pos]
        labels.append(value[pos + 1:pos + 1 + n].decode())
        pos += 1 + n
    return ".".join(labels)


def _guti_ie_value(plmn: bytes, mmegi: int, mmec: int, mtmsi: int) -> bytes:
    """EPS mobile identity value for a GUTI (24.301 9.9.3.12): 0xF6
    (filler+type), PLMN, MME group id, MME code, M-TMSI — 11 bytes."""
    return (bytes([0xF6]) + plmn + mmegi.to_bytes(2, "big")
            + bytes([mmec]) + mtmsi.to_bytes(4, "big"))


def _mobile_id_to_imsi(data: bytes) -> str:
    digits = [str(data[0] >> 4)]
    odd = bool(data[0] & 0x8)
    for b in data[1:]:
        digits.append(str(b & 0xF))
        digits.append(str(b >> 4))
    if not odd:
        digits.pop()
    return "".join(digits)


@dataclass
class AttachRequest:
    imsi: str
    ue_network_cap: bytes = b"\xe0\xe0"  # EEA0-2/EIA1-2
    esm_msg: bytes = b""
    eps_attach_type: int = 1  # EPS attach
    nas_ksi: int = 7          # no key available

    def pack(self) -> bytes:
        mid = _imsi_to_mobile_id(self.imsi)
        out = bytearray([PD_EMM, MSG_ATTACH_REQUEST])
        out.append((self.nas_ksi << 4) | self.eps_attach_type)
        out.append(len(mid))
        out += mid
        out.append(len(self.ue_network_cap))
        out += self.ue_network_cap
        out += len(self.esm_msg).to_bytes(2, "big")
        out += self.esm_msg
        return bytes(out)

    @classmethod
    def unpack(cls, data: bytes) -> "AttachRequest":
        assert data[0] & 0x0F == PD_EMM and data[1] == MSG_ATTACH_REQUEST
        ksi_type = data[2]
        pos = 3
        n = data[pos]; pos += 1
        imsi = _mobile_id_to_imsi(data[pos:pos + n]); pos += n
        n = data[pos]; pos += 1
        cap = data[pos:pos + n]; pos += n
        n = int.from_bytes(data[pos:pos + 2], "big"); pos += 2
        esm = data[pos:pos + n]
        return cls(imsi=imsi, ue_network_cap=bytes(cap), esm_msg=bytes(esm),
                   eps_attach_type=ksi_type & 0xF, nas_ksi=ksi_type >> 4)


@dataclass
class AuthenticationRequest:
    rand: bytes  # 16
    autn: bytes  # 16
    nas_ksi: int = 0

    def pack(self) -> bytes:
        return bytes([PD_EMM, MSG_AUTHENTICATION_REQUEST, self.nas_ksi,
                      *self.rand, len(self.autn), *self.autn])

    @classmethod
    def unpack(cls, d: bytes) -> "AuthenticationRequest":
        assert d[1] == MSG_AUTHENTICATION_REQUEST
        rand = d[3:19]
        n = d[19]
        return cls(rand=bytes(rand), autn=bytes(d[20:20 + n]), nas_ksi=d[2])


@dataclass
class AuthenticationResponse:
    res: bytes

    def pack(self) -> bytes:
        return bytes([PD_EMM, MSG_AUTHENTICATION_RESPONSE, len(self.res),
                      *self.res])

    @classmethod
    def unpack(cls, d: bytes) -> "AuthenticationResponse":
        assert d[1] == MSG_AUTHENTICATION_RESPONSE
        return cls(res=bytes(d[3:3 + d[2]]))


@dataclass
class AuthenticationFailure:
    cause: int  # e.g. 21 = synch failure
    auts: bytes = b""

    def pack(self) -> bytes:
        out = bytearray([PD_EMM, MSG_AUTHENTICATION_FAILURE, self.cause])
        if self.auts:
            out += bytes([0x30, len(self.auts)]) + self.auts
        return bytes(out)

    @classmethod
    def unpack(cls, d: bytes) -> "AuthenticationFailure":
        assert d[1] == MSG_AUTHENTICATION_FAILURE
        auts = b""
        if len(d) > 3 and d[3] == 0x30:
            auts = bytes(d[5:5 + d[4]])
        return cls(cause=d[2], auts=auts)


@dataclass
class SecurityModeCommand:
    eea: int = 2  # selected ciphering alg
    eia: int = 2  # selected integrity alg
    nas_ksi: int = 0
    replayed_ue_cap: bytes = b"\xe0\xe0"

    def pack(self) -> bytes:
        return bytes([PD_EMM, MSG_SECURITY_MODE_COMMAND,
                      (self.eea << 4) | self.eia, self.nas_ksi,
                      len(self.replayed_ue_cap), *self.replayed_ue_cap])

    @classmethod
    def unpack(cls, d: bytes) -> "SecurityModeCommand":
        assert d[1] == MSG_SECURITY_MODE_COMMAND
        n = d[4]
        return cls(eea=d[2] >> 4, eia=d[2] & 0xF, nas_ksi=d[3],
                   replayed_ue_cap=bytes(d[5:5 + n]))


@dataclass
class SecurityModeComplete:
    imeisv: str = ""

    def pack(self) -> bytes:
        out = bytearray([PD_EMM, MSG_SECURITY_MODE_COMPLETE])
        if self.imeisv:
            mid = _imsi_to_mobile_id(self.imeisv)
            out += bytes([0x23, len(mid)]) + mid
        return bytes(out)

    @classmethod
    def unpack(cls, d: bytes) -> "SecurityModeComplete":
        assert d[1] == MSG_SECURITY_MODE_COMPLETE
        imeisv = ""
        if len(d) > 2 and d[2] == 0x23:
            imeisv = _mobile_id_to_imsi(d[4:4 + d[3]])
        return cls(imeisv=imeisv)


@dataclass
class ActivateDefaultEpsBearerRequest:
    """ESM: carries the UE IP address (24.301 piggybacked in AttachAccept)."""
    eps_bearer_id: int = 5
    pti: int = 1
    apn: str = "srsapn"
    ip_addr: bytes = b"\x00\x00\x00\x00"  # IPv4
    qci: int = 9

    def pack(self) -> bytes:
        out = bytearray([(self.eps_bearer_id << 4) | PD_ESM, self.pti,
                         MSG_ACT_DEF_EPS_BEARER_REQ])
        out += bytes([1, self.qci])              # EPS QoS LV (qci only)
        out += _apn_ie(self.apn)                 # APN LV (DNS labels)
        out += bytes([len(self.ip_addr) + 1, 0x01])  # PDN address LV, IPv4
        out += self.ip_addr
        return bytes(out)

    @classmethod
    def unpack(cls, d: bytes) -> "ActivateDefaultEpsBearerRequest":
        assert d[0] & 0x0F == PD_ESM and d[2] == MSG_ACT_DEF_EPS_BEARER_REQ
        pos = 3
        nq = d[pos]
        qci = d[pos + 1]
        pos += 1 + nq
        n = d[pos]
        apn = _apn_from_ie(d[pos + 1:pos + 1 + n])
        pos += 1 + n
        m = d[pos]
        ip = bytes(d[pos + 2:pos + 1 + m])
        return cls(eps_bearer_id=d[0] >> 4, pti=d[1], qci=qci, apn=apn,
                   ip_addr=ip)


@dataclass
class ActivateDefaultEpsBearerAccept:
    eps_bearer_id: int = 5
    pti: int = 1

    def pack(self) -> bytes:
        return bytes([(self.eps_bearer_id << 4) | PD_ESM, self.pti,
                      MSG_ACT_DEF_EPS_BEARER_ACCEPT])

    @classmethod
    def unpack(cls, d: bytes) -> "ActivateDefaultEpsBearerAccept":
        assert d[2] == MSG_ACT_DEF_EPS_BEARER_ACCEPT
        return cls(eps_bearer_id=d[0] >> 4, pti=d[1])


@dataclass
class ActivateDedicatedEpsBearerRequest:
    """ESM: dedicated bearer with its TFT (24.301 8.3.3; reference
    liblte_mme.cc activate_dedicated_eps_bearer_context_request)."""
    eps_bearer_id: int = 6
    pti: int = 0                 # network-initiated: no PTI
    linked_ebi: int = 5
    qci: int = 1
    tft: bytes = b""             # 24.008 10.5.6.12 TFT IE value

    def pack(self) -> bytes:
        return bytes([(self.eps_bearer_id << 4) | PD_ESM, self.pti,
                      MSG_ACT_DED_EPS_BEARER_REQ, self.linked_ebi,
                      self.qci, len(self.tft)]) + self.tft

    @classmethod
    def unpack(cls, d: bytes) -> "ActivateDedicatedEpsBearerRequest":
        assert d[0] & 0x0F == PD_ESM and d[2] == MSG_ACT_DED_EPS_BEARER_REQ
        n = d[5]
        return cls(eps_bearer_id=d[0] >> 4, pti=d[1], linked_ebi=d[3],
                   qci=d[4], tft=bytes(d[6:6 + n]))


@dataclass
class ActivateDedicatedEpsBearerAccept:
    eps_bearer_id: int = 6
    pti: int = 0

    def pack(self) -> bytes:
        return bytes([(self.eps_bearer_id << 4) | PD_ESM, self.pti,
                      MSG_ACT_DED_EPS_BEARER_ACCEPT])

    @classmethod
    def unpack(cls, d: bytes) -> "ActivateDedicatedEpsBearerAccept":
        assert d[2] == MSG_ACT_DED_EPS_BEARER_ACCEPT
        return cls(eps_bearer_id=d[0] >> 4, pti=d[1])


@dataclass
class AttachAccept:
    t3412_val: int = 30
    # TAI list IE value (type-of-list byte + PLMN + TAC; 24.301 9.9.3.33,
    # reference-canonical type = one-PLMN-non-consecutive-TACs)
    tai_list: bytes = b"\x20\x00\xf1\x10\x00\x01"
    esm_msg: bytes = b""
    guti_mtmsi: int = 0
    guti_plmn: bytes = b"\x00\xf1\x10"
    guti_mmegi: int = 1
    guti_mmec: int = 1

    def pack(self) -> bytes:
        out = bytearray([PD_EMM, MSG_ATTACH_ACCEPT, 0x01, self.t3412_val,
                         len(self.tai_list)])
        out += self.tai_list
        out += len(self.esm_msg).to_bytes(2, "big")
        out += self.esm_msg
        # GUTI IE (IEI 0x50, TLV): full 24.301 9.9.3.12 EPS mobile identity
        guti = _guti_ie_value(self.guti_plmn, self.guti_mmegi,
                              self.guti_mmec, self.guti_mtmsi)
        out += bytes([0x50, len(guti)]) + guti
        return bytes(out)

    @classmethod
    def unpack(cls, d: bytes) -> "AttachAccept":
        assert d[1] == MSG_ATTACH_ACCEPT
        pos = 4
        n = d[pos]; pos += 1
        tai = bytes(d[pos:pos + n]); pos += n
        m = int.from_bytes(d[pos:pos + 2], "big"); pos += 2
        esm = bytes(d[pos:pos + m]); pos += m
        mtmsi, plmn, mmegi, mmec = 0, b"\x00\xf1\x10", 1, 1
        if pos < len(d) and d[pos] == 0x50:
            g = d[pos + 2:pos + 2 + d[pos + 1]]
            plmn = bytes(g[1:4])
            mmegi = int.from_bytes(g[4:6], "big")
            mmec = g[6]
            mtmsi = int.from_bytes(g[7:11], "big")
        return cls(t3412_val=d[3], tai_list=tai, esm_msg=esm,
                   guti_mtmsi=mtmsi, guti_plmn=plmn, guti_mmegi=mmegi,
                   guti_mmec=mmec)


@dataclass
class AttachComplete:
    esm_msg: bytes = b""

    def pack(self) -> bytes:
        out = bytearray([PD_EMM, MSG_ATTACH_COMPLETE])
        out += len(self.esm_msg).to_bytes(2, "big")
        out += self.esm_msg
        return bytes(out)

    @classmethod
    def unpack(cls, d: bytes) -> "AttachComplete":
        assert d[1] == MSG_ATTACH_COMPLETE
        n = int.from_bytes(d[2:4], "big")
        return cls(esm_msg=bytes(d[4:4 + n]))


@dataclass
class DetachRequest:
    switch_off: bool = True
    guti_mtmsi: int = 0
    guti_plmn: bytes = b"\x00\xf1\x10"
    guti_mmegi: int = 1
    guti_mmec: int = 1

    def pack(self) -> bytes:
        # detach type (switch-off bit + EPS detach) | NAS KSI nibble,
        # then the mandatory EPS mobile identity LV (GUTI; 24.301 8.2.11)
        guti = _guti_ie_value(self.guti_plmn, self.guti_mmegi,
                              self.guti_mmec, self.guti_mtmsi)
        return bytes([PD_EMM, MSG_DETACH_REQUEST,
                      (0x8 if self.switch_off else 0) | 0x1,
                      len(guti)]) + guti

    @classmethod
    def unpack(cls, d: bytes) -> "DetachRequest":
        out = cls(switch_off=bool(d[2] & 0x8))
        if len(d) > 3:
            g = d[4:4 + d[3]]
            out.guti_plmn = bytes(g[1:4])
            out.guti_mmegi = int.from_bytes(g[4:6], "big")
            out.guti_mmec = g[6]
            out.guti_mtmsi = int.from_bytes(g[7:11], "big")
        return out


@dataclass
class TrackingAreaUpdateRequest:
    """TAU request (24.301 §8.2.29, nas.cc send_tracking_area_update_request):
    EPS update type + old GUTI (M-TMSI)."""
    update_type: int = 0  # 0 = TA updating
    guti_mtmsi: int = 0

    def pack(self) -> bytes:
        return bytes([PD_EMM, MSG_TAU_REQUEST, self.update_type & 0x0F]) + \
            self.guti_mtmsi.to_bytes(4, "big")

    @classmethod
    def unpack(cls, d: bytes) -> "TrackingAreaUpdateRequest":
        return cls(update_type=d[2] & 0x0F,
                   guti_mtmsi=int.from_bytes(d[3:7], "big"))


@dataclass
class TrackingAreaUpdateAccept:
    update_type: int = 0
    t3412_min: int = 54
    guti_mtmsi: int = 0  # 0 = GUTI unchanged

    def pack(self) -> bytes:
        return bytes([PD_EMM, MSG_TAU_ACCEPT, self.update_type & 0x0F,
                      self.t3412_min & 0xFF]) + \
            self.guti_mtmsi.to_bytes(4, "big")

    @classmethod
    def unpack(cls, d: bytes) -> "TrackingAreaUpdateAccept":
        return cls(update_type=d[2] & 0x0F, t3412_min=d[3],
                   guti_mtmsi=int.from_bytes(d[4:8], "big"))


@dataclass
class TrackingAreaUpdateComplete:
    def pack(self) -> bytes:
        return bytes([PD_EMM, MSG_TAU_COMPLETE])

    @classmethod
    def unpack(cls, d: bytes) -> "TrackingAreaUpdateComplete":
        return cls()


@dataclass
class ServiceReject:
    cause: int = 9  # UE identity cannot be derived

    def pack(self) -> bytes:
        return bytes([PD_EMM, MSG_SERVICE_REJECT, self.cause])

    @classmethod
    def unpack(cls, d: bytes) -> "ServiceReject":
        return cls(cause=d[2])


# --- service request (24.301 §9.1.2: special short format) -------------------

SEC_SERVICE_REQUEST = 0xC


def pack_service_request(k_nas_int: bytes, count: int, ksi: int = 0) -> bytes:
    """4-byte service request: [0xC|PD][KSI(3)|SEQ(5)][short MAC (2B)].
    The short MAC is the 2 low bytes of the NAS-MAC over the first two
    octets (nas.cc gen_service_request / 24.301 annex)."""
    seq = count & 0x1F
    head = bytes([(SEC_SERVICE_REQUEST << 4) | PD_EMM,
                  ((ksi & 0x7) << 5) | seq])
    mac = security.eia2(k_nas_int, count, 0, NAS_DIR_UL, head)
    return head + mac[2:4]


def is_service_request(data: bytes) -> bool:
    return len(data) == 4 and (data[0] >> 4) == SEC_SERVICE_REQUEST and \
        (data[0] & 0x0F) == PD_EMM


def check_service_request(data: bytes, k_nas_int: bytes,
                          count_hint: int) -> tuple[bool, int]:
    """Validate the short MAC, reconstructing the full count from the
    5-bit SEQ against count_hint.  Returns (ok, count)."""
    seq = data[1] & 0x1F
    count = (count_hint & ~0x1F) | seq
    if count < count_hint and (count_hint - count) > 16:
        count += 0x20
    mac = security.eia2(k_nas_int, count, 0, NAS_DIR_UL, data[:2])
    return mac[2:4] == data[2:4], count


# ---------------------------------------------------------------------------
# security-protected NAS framing (24.301 9.1/9.5; nas.cc integrity+cipher)

NAS_DIR_UL = 0
NAS_DIR_DL = 1


def pack_protected(plain: bytes, k_nas_int: bytes, k_nas_enc: bytes | None,
                   count: int, direction: int, sec_hdr: int) -> bytes:
    """Wrap a plain NAS message in a security-protected header:
    [sec_hdr|PD_EMM][MAC-I 4B][SN 1B][msg...], ciphering first if enabled."""
    body = plain
    if sec_hdr in (SEC_INTEGRITY_CIPHERED, SEC_INTEGRITY_CIPHERED_NEW_CTX) \
            and k_nas_enc is not None:
        body = security.eea2(k_nas_enc, count, 0, direction, plain)
    sn = count & 0xFF
    mac = security.eia2(k_nas_int, count, 0, direction, bytes([sn]) + body)
    return bytes([(sec_hdr << 4) | PD_EMM]) + mac[:4] + bytes([sn]) + body


def unpack_protected(data: bytes, k_nas_int: bytes, k_nas_enc: bytes | None,
                     count_hint: int, direction: int
                     ) -> tuple[bytes, bool, int]:
    """Returns (plain_msg, integrity_ok, count). count is reconstructed
    from the 8-bit SN against count_hint (24.301 4.4.3.3)."""
    sec_hdr = data[0] >> 4
    if sec_hdr == SEC_NONE:
        return data, True, count_hint
    mac_rx = data[1:5]
    sn = data[5]
    count = (count_hint & ~0xFF) | sn
    if count < count_hint and (count_hint - count) > 128:
        count += 0x100
    body = data[6:]
    mac = security.eia2(k_nas_int, count, 0, direction, bytes([sn]) + body)
    ok = mac[:4] == mac_rx
    if sec_hdr in (SEC_INTEGRITY_CIPHERED, SEC_INTEGRITY_CIPHERED_NEW_CTX) \
            and k_nas_enc is not None:
        body = security.eea2(k_nas_enc, count, 0, direction, body)
    return body, ok, count


_EMM_TYPES = {
    MSG_ATTACH_REQUEST: AttachRequest,
    MSG_ATTACH_ACCEPT: AttachAccept,
    MSG_ATTACH_COMPLETE: AttachComplete,
    MSG_AUTHENTICATION_REQUEST: AuthenticationRequest,
    MSG_AUTHENTICATION_RESPONSE: AuthenticationResponse,
    MSG_AUTHENTICATION_FAILURE: AuthenticationFailure,
    MSG_SECURITY_MODE_COMMAND: SecurityModeCommand,
    MSG_SECURITY_MODE_COMPLETE: SecurityModeComplete,
    MSG_DETACH_REQUEST: DetachRequest,
    MSG_TAU_REQUEST: TrackingAreaUpdateRequest,
    MSG_TAU_ACCEPT: TrackingAreaUpdateAccept,
    MSG_TAU_COMPLETE: TrackingAreaUpdateComplete,
    MSG_SERVICE_REJECT: ServiceReject,
}


def parse(plain: bytes):
    """Dispatch a plain NAS message to its dataclass."""
    pd = plain[0] & 0x0F
    if pd == PD_EMM:
        cls = _EMM_TYPES.get(plain[1])
        if cls is None:
            raise ValueError(f"unknown EMM msg type 0x{plain[1]:02x}")
        return cls.unpack(plain)
    if pd == PD_ESM:
        t = plain[2]
        if t == MSG_ACT_DEF_EPS_BEARER_REQ:
            return ActivateDefaultEpsBearerRequest.unpack(plain)
        if t == MSG_ACT_DEF_EPS_BEARER_ACCEPT:
            return ActivateDefaultEpsBearerAccept.unpack(plain)
        if t == MSG_ACT_DED_EPS_BEARER_REQ:
            return ActivateDedicatedEpsBearerRequest.unpack(plain)
        if t == MSG_ACT_DED_EPS_BEARER_ACCEPT:
            return ActivateDedicatedEpsBearerAccept.unpack(plain)
        raise ValueError(f"unknown ESM msg type 0x{t:02x}")
    raise ValueError(f"unknown protocol discriminator 0x{pd:x}")
