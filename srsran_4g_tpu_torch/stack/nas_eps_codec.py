"""3GPP-exact EPS NAS codec (TS 24.301 / 24.007 encoding rules).

Golden-interop counterpart of the reference's `liblte_mme.cc` NAS
codec: decodes and byte-exactly re-encodes real 24.301 messages — the
vectors committed in `lib/test/asn1/srsran_asn1_nas_test.cc` are the
acceptance set (tests/test_golden_interop.py).

EMM messages carry PD 7 in the low nibble of the first byte (security
header type in the high nibble); ESM messages carry PD 2 with the EPS
bearer identity in the high nibble, followed by the procedure
transaction identity.  Optional IEs follow 24.007 §11.2.1.1 TV /
TV-half-octet / TLV / TLV-E rules; payloads are preserved verbatim for
byte-exact re-encode.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PD_EMM = 0x07
PD_ESM = 0x02

MSG_ACT_DED_EPS_BEARER_REQ = 0xC5
MSG_DL_GENERIC_NAS_TRANSPORT = 0x68
MSG_UL_GENERIC_NAS_TRANSPORT = 0x69
MSG_ATTACH_REQUEST = 0x41
MSG_ATTACH_ACCEPT = 0x42

_NAMES = {
    MSG_ACT_DED_EPS_BEARER_REQ: "ActivateDedicatedEpsBearerContextRequest",
    MSG_DL_GENERIC_NAS_TRANSPORT: "DlGenericNasTransport",
    MSG_UL_GENERIC_NAS_TRANSPORT: "UlGenericNasTransport",
    MSG_ATTACH_REQUEST: "AttachRequest",
    MSG_ATTACH_ACCEPT: "AttachAccept",
}

_MANDATORY: dict[int, list[tuple[str, str]]] = {
    MSG_ACT_DED_EPS_BEARER_REQ: [("linked_ebi", "b"), ("eps_qos", "lv"),
                                 ("tft", "lv")],
    MSG_DL_GENERIC_NAS_TRANSPORT: [("container_type", "b"),
                                   ("container", "lve")],
    MSG_UL_GENERIC_NAS_TRANSPORT: [("container_type", "b"),
                                   ("container", "lve")],
}

_OPTIONAL: dict[int, dict[int, str]] = {
    MSG_ACT_DED_EPS_BEARER_REQ: {
        0x5D: "tlv",    # transaction identifier
        0x80: "tvh",    # radio priority
        0x34: "tlv",    # packet flow identifier
        0x30: "tlv",    # protocol configuration options (IEI 0x27 in spec)
        0x27: "tlv",
        0x5E: "tlv",
    },
    MSG_DL_GENERIC_NAS_TRANSPORT: {0x65: "tlv"},   # additional information
    MSG_UL_GENERIC_NAS_TRANSPORT: {0x65: "tlv"},
}


@dataclass
class NasEpsMessage:
    pd: int
    msg_type: int
    sec_hdr: int = 0
    mac: bytes = b"\x00" * 4
    seq: int = 0
    ebi: int = 0            # ESM only
    pti: int = 0            # ESM only
    fields: dict = field(default_factory=dict)
    ies: list = field(default_factory=list)

    @property
    def name(self) -> str:
        return _NAMES.get(self.msg_type, f"0x{self.msg_type:02x}")

    def ie(self, iei: int) -> bytes | None:
        for i, _, p in self.ies:
            if i == iei:
                return p
        return None


def decode(data: bytes) -> NasEpsMessage:
    pd = data[0] & 0x0F
    hi = data[0] >> 4
    if pd == PD_EMM and hi != 0:
        # security protected: MAC(4) + SEQ(1) + inner plain message
        m = decode(data[6:])
        m.sec_hdr, m.mac, m.seq = hi, data[1:5], data[5]
        return m
    if pd == PD_ESM:
        m = NasEpsMessage(pd=pd, msg_type=data[2], ebi=hi, pti=data[1])
        pos = 3
    else:
        m = NasEpsMessage(pd=pd, msg_type=data[1])
        pos = 2
    for name, fmt in _MANDATORY.get(m.msg_type, []):
        if fmt == "b":
            m.fields[name] = data[pos]
            pos += 1
        elif fmt == "lv":
            n = data[pos]
            m.fields[name] = data[pos + 1:pos + 1 + n]
            pos += 1 + n
        else:
            n = int.from_bytes(data[pos:pos + 2], "big")
            m.fields[name] = data[pos + 2:pos + 2 + n]
            pos += 2 + n
    table = _OPTIONAL.get(m.msg_type, {})
    while pos < len(data):
        b0 = data[pos]
        fmt = table.get(b0)
        if fmt is None and (b0 & 0xF0) in table and \
                table[b0 & 0xF0] == "tvh":
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
        else:
            n = int.from_bytes(data[pos + 1:pos + 3], "big")
            m.ies.append((b0, fmt, data[pos + 3:pos + 3 + n]))
            pos += 3 + n
    return m


def encode(m: NasEpsMessage) -> bytes:
    if m.pd == PD_ESM:
        out = bytearray([(m.ebi << 4) | PD_ESM, m.pti, m.msg_type])
    else:
        out = bytearray([m.pd, m.msg_type])
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
    body = bytes(out)
    if m.sec_hdr:
        return bytes([(m.sec_hdr << 4) | PD_EMM]) + m.mac \
            + bytes([m.seq]) + body
    return body
