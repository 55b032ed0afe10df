"""3GPP-exact 5GS NAS codec (TS 24.501 / 24.007 encoding rules).

Golden-interop counterpart of the reference's generated 5G NAS codec
(`lib/src/asn1/nas_5g_*`): this module decodes and byte-exactly
re-encodes real 24.501 messages — the vectors committed in
`lib/test/asn1/nas_5g_msg_test.cc` are the acceptance set
(tests/test_golden_interop.py).

Structure follows 24.007 §11.2: a message is the plain header
(EPD 0x7E, security header type, message type), mandatory IEs in fixed
order, then optional IEs identified by IEI in TV / TV-half-octet /
TLV / TLV-E format.  Security-protected messages wrap an inner plain
message with MAC + sequence number.  Optional-IE payloads are preserved
verbatim so re-encoding is byte-exact even for IEs this framework does
not interpret semantically.
"""

from __future__ import annotations

from dataclasses import dataclass, field

EPD_5GMM = 0x7E
EPD_5GSM = 0x2E

MSG_REGISTRATION_REQUEST = 0x41
MSG_REGISTRATION_ACCEPT = 0x42
MSG_REGISTRATION_COMPLETE = 0x43
MSG_DEREGISTRATION_REQUEST_UE = 0x45
MSG_AUTHENTICATION_REQUEST = 0x56
MSG_AUTHENTICATION_RESPONSE = 0x57
MSG_SECURITY_MODE_COMMAND = 0x5D
MSG_SECURITY_MODE_COMPLETE = 0x5E
MSG_UL_NAS_TRANSPORT = 0x67
MSG_DL_NAS_TRANSPORT = 0x68

_NAMES = {
    MSG_REGISTRATION_REQUEST: "RegistrationRequest",
    MSG_REGISTRATION_ACCEPT: "RegistrationAccept",
    MSG_REGISTRATION_COMPLETE: "RegistrationComplete",
    MSG_DEREGISTRATION_REQUEST_UE: "DeregistrationRequestUeOrig",
    MSG_AUTHENTICATION_REQUEST: "AuthenticationRequest",
    MSG_AUTHENTICATION_RESPONSE: "AuthenticationResponse",
    MSG_SECURITY_MODE_COMMAND: "SecurityModeCommand",
    MSG_SECURITY_MODE_COMPLETE: "SecurityModeComplete",
    MSG_UL_NAS_TRANSPORT: "UlNasTransport",
    MSG_DL_NAS_TRANSPORT: "DlNasTransport",
}

# Mandatory-part layout per message type.  Tokens:
#  "b"    one byte (two half-octet fields packed by the caller)
#  "lv"   1-byte length + value
#  "lve"  2-byte length + value (LV-E)
_MANDATORY: dict[int, list[tuple[str, str]]] = {
    MSG_REGISTRATION_REQUEST: [("reg_type_ngksi", "b"),
                               ("mobile_identity", "lve")],
    MSG_REGISTRATION_ACCEPT: [("reg_result", "lv")],
    MSG_REGISTRATION_COMPLETE: [],
    MSG_DEREGISTRATION_REQUEST_UE: [("dereg_type_ngksi", "b"),
                                    ("mobile_identity", "lve")],
    MSG_AUTHENTICATION_REQUEST: [("ngksi", "b"), ("abba", "lv")],
    MSG_AUTHENTICATION_RESPONSE: [],
    MSG_SECURITY_MODE_COMMAND: [("nas_sec_algs", "b"), ("ngksi", "b"),
                                ("replayed_ue_sec_caps", "lv")],
    MSG_SECURITY_MODE_COMPLETE: [],
    MSG_UL_NAS_TRANSPORT: [("payload_container_type", "b"),
                           ("payload_container", "lve")],
    MSG_DL_NAS_TRANSPORT: [("payload_container_type", "b"),
                           ("payload_container", "lve")],
}

# Optional-IE format per (message type, IEI).  Formats (24.007 §11.2.1.1):
#  "tvh"  IEI in the high nibble, value in the low (1 byte total)
#  "tv:N" IEI byte + N fixed value bytes
#  "tlv"  IEI + 1-byte length + value
#  "tlve" IEI + 2-byte length + value
_OPTIONAL: dict[int, dict[int, str]] = {
    MSG_REGISTRATION_REQUEST: {
        0x2E: "tlv",    # UE security capability
        0x17: "tlv",    # S1 UE network capability
        0x10: "tlv",    # 5GMM capability
        0x2F: "tlv",    # Requested NSSAI
        0x52: "tv:2",   # Last visited registered TAI... (TV 6) unused
        0xB0: "tvh",    # MICO indication
        0x2B: "tlv",    # requested DRX
        0x18: "tlv",    # UE's usage setting
        0x74: "tlve",   # LADN indication
        0x53: "tlv",    # 5GS update type
    },
    MSG_REGISTRATION_ACCEPT: {
        0x77: "tlve",   # 5G-GUTI (5GS mobile identity)
        0x4A: "tlv",    # equivalent PLMNs
        0x54: "tv:6",   # TAI list — wireshark shows TLV in vectors
        0x15: "tlv",    # allowed NSSAI
        0x5E: "tlv",    # T3512 (GPRS timer 3)
        0x16: "tlv",    # T3502 (GPRS timer 2)
        0x21: "tlv",    # PDU session status? (vector-driven)
    },
    MSG_REGISTRATION_COMPLETE: {0x73: "tlve"},
    MSG_DEREGISTRATION_REQUEST_UE: {},
    MSG_AUTHENTICATION_REQUEST: {
        0x21: "tv:16",  # RAND
        0x20: "tlv",    # AUTN
        0x78: "tlve",   # EAP message
    },
    MSG_AUTHENTICATION_RESPONSE: {
        0x2D: "tlv",    # Authentication response parameter (RES*)
        0x78: "tlve",
    },
    MSG_SECURITY_MODE_COMMAND: {
        0xE0: "tvh",    # IMEISV request
        0x57: "tv:4",   # EPS NAS security algorithms? (unused)
        0x36: "tlv",    # Additional 5G security information
        0x78: "tlve",
        0x38: "tlv",    # ABBA
        0x19: "tlv",    # Replayed S1 UE security capability
    },
    MSG_SECURITY_MODE_COMPLETE: {
        0x77: "tlve",   # IMEISV (5GS mobile identity)
        0x71: "tlve",   # NAS message container
        0x78: "tlve",
    },
    MSG_UL_NAS_TRANSPORT: {
        0x12: "tv:1",   # PDU session ID 2
        0x59: "tv:1",   # old PDU session ID
        0x80: "tvh",    # Request type
        0x22: "tlv",    # S-NSSAI
        0x25: "tlv",    # DNN
        0x24: "tlv",    # additional information
    },
    MSG_DL_NAS_TRANSPORT: {
        0x12: "tv:1",
        0x58: "tvh",    # 5GMM cause? (TV)
        0x37: "tlv",    # back-off timer
        0x24: "tlv",
    },
}

# the TAI-list vectors use TLV encoding (IEI 0x54 + len), per 24.501 9.11.3.9
_OPTIONAL[MSG_REGISTRATION_ACCEPT][0x54] = "tlv"


@dataclass
class Nas5gsMessage:
    msg_type: int
    sec_hdr: int = 0                 # of THIS header (0 = plain)
    mac: bytes = b"\x00" * 4         # security-protected envelope only
    seq: int = 0
    fields: dict = field(default_factory=dict)   # mandatory, by name
    ies: list = field(default_factory=list)      # [(iei, fmt, payload)]
    inner: "Nas5gsMessage | None" = None

    @property
    def name(self) -> str:
        return _NAMES.get(self.msg_type, f"0x{self.msg_type:02x}")

    def ie(self, iei: int) -> bytes | None:
        for i, _, p in self.ies:
            if i == iei:
                return p
        return None


def _decode_plain(data: bytes) -> Nas5gsMessage:
    if data[0] != EPD_5GMM or (data[1] & 0x0F) != 0:
        raise ValueError("not a plain 5GMM message")
    msg_type = data[2]
    pos = 3
    m = Nas5gsMessage(msg_type=msg_type)
    for name, fmt in _MANDATORY.get(msg_type, []):
        if fmt == "b":
            m.fields[name] = data[pos]
            pos += 1
        elif fmt == "lv":
            n = data[pos]
            m.fields[name] = data[pos + 1:pos + 1 + n]
            pos += 1 + n
        elif fmt == "lve":
            n = int.from_bytes(data[pos:pos + 2], "big")
            m.fields[name] = data[pos + 2:pos + 2 + n]
            pos += 2 + n
    table = _OPTIONAL.get(msg_type, {})
    while pos < len(data):
        b0 = data[pos]
        fmt = table.get(b0)
        if fmt is None and (b0 & 0xF0) in table \
                and table[b0 & 0xF0] == "tvh":
            m.ies.append((b0 & 0xF0, "tvh", bytes([b0 & 0x0F])))
            pos += 1
            continue
        if fmt is None:
            raise ValueError(
                f"unknown IEI 0x{b0:02x} in {m.name} at offset {pos}")
        if fmt == "tvh":
            m.ies.append((b0 & 0xF0, "tvh", bytes([b0 & 0x0F])))
            pos += 1
        elif fmt.startswith("tv:"):
            n = int(fmt[3:])
            m.ies.append((b0, fmt, data[pos + 1:pos + 1 + n]))
            pos += 1 + n
        elif fmt == "tlv":
            n = data[pos + 1]
            m.ies.append((b0, fmt, data[pos + 2:pos + 2 + n]))
            pos += 2 + n
        else:  # tlve
            n = int.from_bytes(data[pos + 1:pos + 3], "big")
            m.ies.append((b0, fmt, data[pos + 3:pos + 3 + n]))
            pos += 3 + n
    return m


def decode(data: bytes) -> Nas5gsMessage:
    """Decode a 5GS NAS PDU (plain or security protected)."""
    if data[0] != EPD_5GMM:
        raise ValueError(f"bad EPD 0x{data[0]:02x}")
    sec_hdr = data[1] & 0x0F
    if sec_hdr == 0:
        return _decode_plain(data)
    inner = decode(data[7:])
    return Nas5gsMessage(msg_type=inner.msg_type, sec_hdr=sec_hdr,
                         mac=data[2:6], seq=data[6], fields=inner.fields,
                         ies=inner.ies, inner=inner)


def _encode_plain(m: Nas5gsMessage) -> bytes:
    out = bytearray([EPD_5GMM, 0x00, m.msg_type])
    for name, fmt in _MANDATORY.get(m.msg_type, []):
        v = m.fields[name]
        if fmt == "b":
            out.append(v)
        elif fmt == "lv":
            out.append(len(v))
            out += v
        else:
            out += len(v).to_bytes(2, "big")
            out += v
    for iei, fmt, payload in m.ies:
        if fmt == "tvh":
            out.append(iei | (payload[0] & 0x0F))
        elif fmt.startswith("tv:"):
            out.append(iei)
            out += payload
        elif fmt == "tlv":
            out += bytes([iei, len(payload)])
            out += payload
        else:
            out.append(iei)
            out += len(payload).to_bytes(2, "big")
            out += payload
    return bytes(out)


def encode(m: Nas5gsMessage) -> bytes:
    plain = _encode_plain(m.inner if m.inner is not None else m)
    if m.sec_hdr == 0:
        return plain
    return bytes([EPD_5GMM, m.sec_hdr]) + m.mac + bytes([m.seq]) + plain


# ---- 5GSM (EPD 0x2E) messages (24.501 §8.3; 24.007 §11.2.3.1a) -------------
# Header: [EPD][PDU session identity][PTI][message type], then mandatory
# IEs in fixed order and optional TLVs.

MSG_PDU_SESSION_EST_REQUEST = 0xC1
MSG_PDU_SESSION_EST_ACCEPT = 0xC2

_MANDATORY_5GSM: dict[int, list[tuple[str, str]]] = {
    # integrity protection maximum data rate: 2 fixed bytes (§9.11.4.7)
    MSG_PDU_SESSION_EST_REQUEST: [("int_prot_max_data_rate", "v:2")],
    # selected PDU session type + SSC mode (one byte is NOT how 24.501
    # packs them: each is a half-octet V field; they pair into one byte),
    # authorized QoS rules LV-E, session AMBR LV
    MSG_PDU_SESSION_EST_ACCEPT: [("pdu_session_type_ssc_mode", "b"),
                                 ("qos_rules", "lve"),
                                 ("session_ambr", "lv")],
}

_OPTIONAL_5GSM: dict[int, dict[int, str]] = {
    MSG_PDU_SESSION_EST_REQUEST: {
        0x90: "tvh",    # PDU session type (9.11.4.11)
        0xA0: "tvh",    # SSC mode
        0x28: "tlv",    # 5GSM capability
        0x55: "tv:2",   # maximum number of supported packet filters
        0x39: "tlv",    # SM PDU DN request container
        0x7B: "tlve",   # extended protocol configuration options
    },
    MSG_PDU_SESSION_EST_ACCEPT: {
        0x59: "tv:1",   # 5GSM cause
        0x29: "tlv",    # PDU address (9.11.4.10)
        0x56: "tv:2",   # RQ timer
        0x22: "tlv",    # S-NSSAI
        0x79: "tlve",   # authorized QoS flow descriptions
        0x7B: "tlve",
        0x25: "tlv",    # DNN
    },
}


@dataclass
class Nas5gsSmMessage:
    msg_type: int
    psi: int = 1                 # PDU session identity
    pti: int = 0
    fields: dict = field(default_factory=dict)
    ies: list = field(default_factory=list)

    def ie(self, iei: int) -> bytes | None:
        for i, _, p in self.ies:
            if i == iei:
                return p
        return None


def decode_5gsm(data: bytes) -> Nas5gsSmMessage:
    if data[0] != EPD_5GSM:
        raise ValueError(f"bad 5GSM EPD 0x{data[0]:02x}")
    m = Nas5gsSmMessage(msg_type=data[3], psi=data[1], pti=data[2])
    pos = 4
    for name, fmt in _MANDATORY_5GSM.get(m.msg_type, []):
        if fmt == "b":
            m.fields[name] = data[pos]
            pos += 1
        elif fmt.startswith("v:"):
            n = int(fmt[2:])
            m.fields[name] = data[pos:pos + n]
            pos += n
        elif fmt == "lv":
            n = data[pos]
            m.fields[name] = data[pos + 1:pos + 1 + n]
            pos += 1 + n
        elif fmt == "lve":
            n = int.from_bytes(data[pos:pos + 2], "big")
            m.fields[name] = data[pos + 2:pos + 2 + n]
            pos += 2 + n
    table = _OPTIONAL_5GSM.get(m.msg_type, {})
    while pos < len(data):
        b0 = data[pos]
        fmt = table.get(b0)
        if fmt is None and (b0 & 0xF0) in table \
                and table[b0 & 0xF0] == "tvh":
            m.ies.append((b0 & 0xF0, "tvh", bytes([b0 & 0x0F])))
            pos += 1
            continue
        if fmt is None:
            raise ValueError(f"unknown 5GSM IEI 0x{b0:02x}")
        if fmt == "tvh":
            m.ies.append((b0 & 0xF0, "tvh", bytes([b0 & 0x0F])))
            pos += 1
        elif fmt.startswith("tv:"):
            n = int(fmt[3:])
            m.ies.append((b0, fmt, data[pos + 1:pos + 1 + n]))
            pos += 1 + n
        elif fmt == "tlv":
            n = data[pos + 1]
            m.ies.append((b0, fmt, data[pos + 2:pos + 2 + n]))
            pos += 2 + n
        else:
            n = int.from_bytes(data[pos + 1:pos + 3], "big")
            m.ies.append((b0, fmt, data[pos + 3:pos + 3 + n]))
            pos += 3 + n
    return m


def encode_5gsm(m: Nas5gsSmMessage) -> bytes:
    out = bytearray([EPD_5GSM, m.psi, m.pti, m.msg_type])
    for name, fmt in _MANDATORY_5GSM.get(m.msg_type, []):
        v = m.fields[name]
        if fmt == "b":
            out.append(v)
        elif fmt.startswith("v:"):
            out += v
        elif fmt == "lv":
            out.append(len(v))
            out += v
        else:
            out += len(v).to_bytes(2, "big")
            out += v
    for iei, fmt, payload in m.ies:
        if fmt == "tvh":
            out.append(iei | (payload[0] & 0x0F))
        elif fmt.startswith("tv:"):
            out.append(iei)
            out += payload
        elif fmt == "tlv":
            out += bytes([iei, len(payload)])
            out += payload
        else:
            out.append(iei)
            out += len(payload).to_bytes(2, "big")
            out += payload
    return bytes(out)
