"""LTE security: ciphering, integrity, key derivation, Milenage AKA.

Counterpart of the reference's `lib/src/common/security.cc` /
`liblte_security.cc` (TS 33.401, 35.206): the AES-based algorithm set —
EEA0/EEA2 ciphering (AES-CTR), EIA2 integrity (AES-CMAC), the HMAC-SHA256
KDF family (K_ASME → K_eNB → K_RRCint/K_RRCenc/K_UPenc, NH chaining), and
Milenage f1-f5 for AKA vector generation (the HSS/USIM side).

SNOW3G (EEA1/EIA1) and ZUC (EEA3/EIA3) live in `snow3g_zuc.py`; the
`cipher()`/`integrity()` dispatchers below select by 33.401 algorithm id
(the reference's `cipher_algorithm_id_t`/`integrity_algorithm_id_t` in
`lib/include/srsran/common/security.h`).

Port counterpart of ``srsran_4g_tpu/stack/security.py``, and the one stack
module of the port that is not a copy of its JAX-package file: the JAX
package takes AES-128 (for EEA2's CTR mode, EIA2's CMAC and Milenage's
block encryptions) from the `cryptography` package, and the port needs no
package beyond torch and numpy.  Here AES-128 encryption of one block
(FIPS-197, table-driven on 32-bit words), CTR and CMAC (RFC 4493) are plain
Python; everything else is the JAX file's code.
"""

from __future__ import annotations

import hashlib
import hmac
import struct

import functools


# --- KDF family (TS 33.401 Annex A) ------------------------------------------


def _kdf(key: bytes, fc: int, *params: bytes) -> bytes:
    s = bytes([fc])
    for p in params:
        s += p + struct.pack(">H", len(p))
    return hmac.new(key, s, hashlib.sha256).digest()


def k_asme(ck: bytes, ik: bytes, plmn: bytes, sqn_xor_ak: bytes) -> bytes:
    return _kdf(ck + ik, 0x10, plmn, sqn_xor_ak)


def k_enb(k_asme_: bytes, ul_nas_count: int) -> bytes:
    return _kdf(k_asme_, 0x11, struct.pack(">I", ul_nas_count))


def nh(k_asme_: bytes, sync_input: bytes) -> bytes:
    """Next-hop key for vertical K_eNB* derivation at handover
    (33.401 A.4); the first NH chains from the initial K_eNB, later
    ones from the previous NH."""
    return _kdf(k_asme_, 0x12, sync_input)


def k_enb_star(key: bytes, pci: int, earfcn_dl: int = 3400) -> bytes:
    """K_eNB* bound to the target cell (33.401 A.5); `key` is NH for
    vertical derivation or the current K_eNB for horizontal."""
    return _kdf(key, 0x13, struct.pack(">H", pci),
                struct.pack(">I", earfcn_dl))


def s_kgnb(k_enb_: bytes, scg_counter: int) -> bytes:
    """EN-DC secondary-node key (33.401 Annex A.15): S-KgNB =
    KDF(K_eNB, FC=0x1C, SCG counter)."""
    return _kdf(k_enb_, 0x1C, struct.pack(">H", scg_counter))


def k_nas(k_asme_: bytes, alg_id: int, integrity: bool) -> bytes:
    dist = b"\x02" if integrity else b"\x01"
    return _kdf(k_asme_, 0x15, dist, bytes([alg_id]))[16:]


def k_rrc_up(k_enb_: bytes, alg_id: int, which: str) -> bytes:
    dist = {"rrc_enc": 3, "rrc_int": 4, "up_enc": 5, "up_int": 6}[which]
    return _kdf(k_enb_, 0x15, bytes([dist]), bytes([alg_id]))[16:]


def nh(k_asme_: bytes, sync_input: bytes) -> bytes:
    return _kdf(k_asme_, 0x12, sync_input)


# --- AES-128 (FIPS-197), CTR and CMAC (RFC 4493) --------------------------------


def _xtime(b: int) -> int:
    b <<= 1
    return (b ^ 0x11B) if b & 0x100 else b


def _sbox() -> list[int]:
    """The S-box: the inverse in GF(2^8) (0 → 0), then the affine map."""
    exp, log = [0] * 255, [0] * 256
    x = 1
    for i in range(255):  # 3 generates the multiplicative group
        exp[i], log[x] = x, i
        x ^= _xtime(x)
    box = []
    for b in range(256):
        inv = exp[(255 - log[b]) % 255] if b else 0
        s = inv
        for r in range(1, 5):
            s ^= ((inv << r) | (inv >> (8 - r))) & 0xFF
        box.append(s ^ 0x63)
    return box


_S = _sbox()
# round tables: column (2s, s, s, 3s) of MixColumns after SubBytes, and its
# byte rotations for the other three rows
_T0 = [(_xtime(s) << 24) | (s << 16) | (s << 8) | (_xtime(s) ^ s) for s in _S]
_T1 = [((t >> 8) | (t << 24)) & 0xFFFFFFFF for t in _T0]
_T2 = [((t >> 16) | (t << 16)) & 0xFFFFFFFF for t in _T0]
_T3 = [((t >> 24) | (t << 8)) & 0xFFFFFFFF for t in _T0]


@functools.lru_cache(maxsize=64)
def _round_keys(k: bytes) -> tuple[int, ...]:
    """The 44 words of the AES-128 key schedule."""
    if len(k) != 16:
        raise ValueError(f"AES-128 takes a 16-byte key, not {len(k)} bytes")
    w = list(struct.unpack(">4I", k))
    rcon = 1
    for i in range(4, 44):
        t = w[i - 1]
        if i % 4 == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF
            t = ((_S[t >> 24] << 24) | (_S[(t >> 16) & 255] << 16)
                 | (_S[(t >> 8) & 255] << 8) | _S[t & 255]) ^ (rcon << 24)
            rcon = _xtime(rcon)
        w.append(w[i - 4] ^ t)
    return tuple(w)


def _aes_block(k: bytes, block: bytes) -> bytes:
    """AES-128 encryption of one 16-byte block."""
    rk = _round_keys(k)
    s0, s1, s2, s3 = (v ^ rk[i] for i, v in enumerate(struct.unpack(">4I", block)))
    for r in range(4, 40, 4):
        s0, s1, s2, s3 = (
            _T0[s0 >> 24] ^ _T1[(s1 >> 16) & 255] ^ _T2[(s2 >> 8) & 255] ^ _T3[s3 & 255] ^ rk[r],
            _T0[s1 >> 24] ^ _T1[(s2 >> 16) & 255] ^ _T2[(s3 >> 8) & 255] ^ _T3[s0 & 255] ^ rk[r + 1],
            _T0[s2 >> 24] ^ _T1[(s3 >> 16) & 255] ^ _T2[(s0 >> 8) & 255] ^ _T3[s1 & 255] ^ rk[r + 2],
            _T0[s3 >> 24] ^ _T1[(s0 >> 16) & 255] ^ _T2[(s1 >> 8) & 255] ^ _T3[s2 & 255] ^ rk[r + 3])
    s = (s0, s1, s2, s3)
    return struct.pack(">4I", *(
        ((_S[s[i] >> 24] << 24) | (_S[(s[(i + 1) % 4] >> 16) & 255] << 16)
         | (_S[(s[(i + 2) % 4] >> 8) & 255] << 8) | _S[s[(i + 3) % 4] & 255]) ^ rk[40 + i]
        for i in range(4)))


def _aes_ctr(k: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-128-CTR: the 128-bit counter block starts at ``iv`` and counts up
    by one a block, modulo 2^128."""
    ctr = int.from_bytes(iv, "big")
    out = bytearray()
    for i in range(0, len(data), 16):
        ks = _aes_block(k, ((ctr + i // 16) % (1 << 128)).to_bytes(16, "big"))
        out += _xor(data[i:i + 16], ks)
    return bytes(out)


def _cmac_subkey(b: bytes) -> bytes:
    v = int.from_bytes(b, "big") << 1
    if v >> 128:
        v ^= 0x87
    return (v & ((1 << 128) - 1)).to_bytes(16, "big")


def _aes_cmac(k: bytes, m: bytes) -> bytes:
    """AES-128-CMAC of ``m``, the full 16-byte tag (RFC 4493 §2.4)."""
    k1 = _cmac_subkey(_aes_block(k, bytes(16)))
    n = max(1, -(-len(m) // 16))
    last = m[16 * (n - 1):]
    if len(last) == 16:
        last = _xor(last, k1)
    else:
        last = _xor(last + b"\x80" + bytes(15 - len(last)), _cmac_subkey(k1))
    x = bytes(16)
    for i in range(n - 1):
        x = _aes_block(k, _xor(x, m[16 * i:16 * i + 16]))
    return _aes_block(k, _xor(x, last))


# --- EEA2 / EIA2 (AES) -------------------------------------------------------


def _eea2_ctr(key: bytes, count: int, bearer: int, direction: int) -> bytes:
    return struct.pack(">IB11x", count & 0xFFFFFFFF, ((bearer & 0x1F) << 3)
                       | ((direction & 1) << 2))


def eea2(key: bytes, count: int, bearer: int, direction: int,
         data: bytes) -> bytes:
    """128-EEA2 ciphering (AES-128-CTR), symmetric."""
    return _aes_ctr(key, _eea2_ctr(key, count, bearer, direction), data)


def eea0(key: bytes, count: int, bearer: int, direction: int,
         data: bytes) -> bytes:
    return data  # null ciphering


def eia2(key: bytes, count: int, bearer: int, direction: int,
         data: bytes) -> bytes:
    """128-EIA2 integrity (AES-128-CMAC) → 4-byte MAC-I."""
    m = struct.pack(">IB3x", count & 0xFFFFFFFF,
                    ((bearer & 0x1F) << 3) | ((direction & 1) << 2)) + data
    return _aes_cmac(key, m)[:4]


# --- algorithm-id dispatch (33.401: 0=EEA0/EIA0, 1=SNOW3G, 2=AES, 3=ZUC) ------


def cipher(alg_id: int, key: bytes, count: int, bearer: int,
           direction: int, data: bytes) -> bytes:
    if alg_id == 0:
        return data
    if alg_id == 2:
        return eea2(key, count, bearer, direction, data)
    from srsran_4g_tpu_torch.stack import snow3g_zuc
    fn = {1: snow3g_zuc.eea1, 3: snow3g_zuc.eea3}[alg_id]
    return fn(key, count, bearer, direction, data)


def integrity(alg_id: int, key: bytes, count: int, bearer: int,
              direction: int, data: bytes) -> bytes:
    if alg_id == 2:
        return eia2(key, count, bearer, direction, data)
    from srsran_4g_tpu_torch.stack import snow3g_zuc
    fn = {1: snow3g_zuc.eia1, 3: snow3g_zuc.eia3}[alg_id]
    return fn(key, count, bearer, direction, data)


# --- Milenage (TS 35.206) ----------------------------------------------------


def _aes_enc(k: bytes, block: bytes) -> bytes:
    return b"".join(_aes_block(k, block[i:i + 16]) for i in range(0, len(block), 16))


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def _rot(x: bytes, r_bits: int) -> bytes:
    r = r_bits // 8
    return x[r:] + x[:r]


def milenage(k: bytes, opc: bytes, rand: bytes, sqn: bytes, amf: bytes):
    """f1..f5: returns (mac_a, xres, ck, ik, ak)."""
    temp = _aes_enc(k, _xor(rand, opc))
    inp = sqn + amf + sqn + amf
    out1 = _xor(
        _aes_enc(k, _xor(_rot(_xor(inp, opc), 64), temp)), opc)
    mac_a = out1[:8]
    # f2/f5: OUT2 = E[rot(TEMP ^ OPc, r2) ^ c2]K ^ OPc, r2=0, c2=...0001
    c2 = bytes(15) + b"\x01"
    out2 = _xor(_aes_enc(k, _xor(_xor(temp, opc), c2)), opc)
    xres = out2[8:]
    ak = out2[:6]
    # f3: r3=32, c3=...0002
    c3 = bytes(15) + b"\x02"
    out3 = _xor(_aes_enc(k, _xor(_rot(_xor(temp, opc), 32), c3)), opc)
    ck = out3
    # f4: r4=64, c4=...0004
    c4 = bytes(15) + b"\x04"
    out4 = _xor(_aes_enc(k, _xor(_rot(_xor(temp, opc), 64), c4)), opc)
    ik = out4
    return mac_a, xres, ck, ik, ak


def opc_from_op(k: bytes, op: bytes) -> bytes:
    return _xor(_aes_enc(k, op), op)
