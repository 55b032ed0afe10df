"""SNOW 3G and ZUC stream ciphers: 128-EEA1/EIA1 and 128-EEA3/EIA3.

Host-side control/user-plane crypto, counterpart of the reference's
`lib/src/common/s3g.cc` + `zuc.cc` + the 128-bit LTE wrappers in
`lib/src/common/liblte_security.cc:497,737,818,982`.  Algorithms per
3GPP TS 35.216 (SNOW 3G / UEA2-UIA2 Document 2) and TS 35.221/222
(128-EEA3/EIA3, ZUC Document 1/2); parameter-to-IV mappings per
TS 33.401 Annex B.

S-box tables (`SNOW3G_SQ`, `ZUC_S0`, `ZUC_S1`) and the ZUC key-expansion
constants `ZUC_D` are fixed public constants from those specs.  The
Rijndael S-box used by SNOW 3G's S1 and the alpha multiplication/division
tables are derived computationally below from their algebraic
definitions (GF(2^8) inversion + affine map; MULxPOW over 0xA9).

Keystream generation is inherently sequential per packet; it runs in
plain Python (hot ciphering in the E2E paths defaults to EEA2, which is
OpenSSL-backed AES-CTR).  Bulk XOR of keystream with payload uses
numpy.
"""

from __future__ import annotations

import struct

import numpy as np

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF

# --- spec constant tables -----------------------------------------------------

# TS 35.216 section 3.3.2 (S-box SQ), as tabulated in the spec.
SNOW3G_SQ = bytes([
    0x25, 0x24, 0x73, 0x67, 0xD7, 0xAE, 0x5C, 0x30, 0xA4, 0xEE, 0x6E, 0xCB, 0x7D, 0xB5, 0x82, 0xDB,
    0xE4, 0x8E, 0x48, 0x49, 0x4F, 0x5D, 0x6A, 0x78, 0x70, 0x88, 0xE8, 0x5F, 0x5E, 0x84, 0x65, 0xE2,
    0xD8, 0xE9, 0xCC, 0xED, 0x40, 0x2F, 0x11, 0x28, 0x57, 0xD2, 0xAC, 0xE3, 0x4A, 0x15, 0x1B, 0xB9,
    0xB2, 0x80, 0x85, 0xA6, 0x2E, 0x02, 0x47, 0x29, 0x07, 0x4B, 0x0E, 0xC1, 0x51, 0xAA, 0x89, 0xD4,
    0xCA, 0x01, 0x46, 0xB3, 0xEF, 0xDD, 0x44, 0x7B, 0xC2, 0x7F, 0xBE, 0xC3, 0x9F, 0x20, 0x4C, 0x64,
    0x83, 0xA2, 0x68, 0x42, 0x13, 0xB4, 0x41, 0xCD, 0xBA, 0xC6, 0xBB, 0x6D, 0x4D, 0x71, 0x21, 0xF4,
    0x8D, 0xB0, 0xE5, 0x93, 0xFE, 0x8F, 0xE6, 0xCF, 0x43, 0x45, 0x31, 0x22, 0x37, 0x36, 0x96, 0xFA,
    0xBC, 0x0F, 0x08, 0x52, 0x1D, 0x55, 0x1A, 0xC5, 0x4E, 0x23, 0x69, 0x7A, 0x92, 0xFF, 0x5B, 0x5A,
    0xEB, 0x9A, 0x1C, 0xA9, 0xD1, 0x7E, 0x0D, 0xFC, 0x50, 0x8A, 0xB6, 0x62, 0xF5, 0x0A, 0xF8, 0xDC,
    0x03, 0x3C, 0x0C, 0x39, 0xF1, 0xB8, 0xF3, 0x3D, 0xF2, 0xD5, 0x97, 0x66, 0x81, 0x32, 0xA0, 0x00,
    0x06, 0xCE, 0xF6, 0xEA, 0xB7, 0x17, 0xF7, 0x8C, 0x79, 0xD6, 0xA7, 0xBF, 0x8B, 0x3F, 0x1F, 0x53,
    0x63, 0x75, 0x35, 0x2C, 0x60, 0xFD, 0x27, 0xD3, 0x94, 0xA5, 0x7C, 0xA1, 0x05, 0x58, 0x2D, 0xBD,
    0xD9, 0xC7, 0xAF, 0x6B, 0x54, 0x0B, 0xE0, 0x38, 0x04, 0xC8, 0x9D, 0xE7, 0x14, 0xB1, 0x87, 0x9C,
    0xDF, 0x6F, 0xF9, 0xDA, 0x2A, 0xC4, 0x59, 0x16, 0x74, 0x91, 0xAB, 0x26, 0x61, 0x76, 0x34, 0x2B,
    0xAD, 0x99, 0xFB, 0x72, 0xEC, 0x33, 0x12, 0xDE, 0x98, 0x3B, 0xC0, 0x9B, 0x3E, 0x18, 0x10, 0x3A,
    0x56, 0xE1, 0x77, 0xC9, 0x1E, 0x9E, 0x95, 0xA3, 0x90, 0x19, 0xA8, 0x6C, 0x09, 0xD0, 0xF0, 0x86])

# TS 35.222 section 3.4 (ZUC S-boxes S0/S1) and 3.6 (key constants D).
ZUC_S0 = bytes([
    0x3E, 0x72, 0x5B, 0x47, 0xCA, 0xE0, 0x00, 0x33, 0x04, 0xD1, 0x54, 0x98, 0x09, 0xB9, 0x6D, 0xCB,
    0x7B, 0x1B, 0xF9, 0x32, 0xAF, 0x9D, 0x6A, 0xA5, 0xB8, 0x2D, 0xFC, 0x1D, 0x08, 0x53, 0x03, 0x90,
    0x4D, 0x4E, 0x84, 0x99, 0xE4, 0xCE, 0xD9, 0x91, 0xDD, 0xB6, 0x85, 0x48, 0x8B, 0x29, 0x6E, 0xAC,
    0xCD, 0xC1, 0xF8, 0x1E, 0x73, 0x43, 0x69, 0xC6, 0xB5, 0xBD, 0xFD, 0x39, 0x63, 0x20, 0xD4, 0x38,
    0x76, 0x7D, 0xB2, 0xA7, 0xCF, 0xED, 0x57, 0xC5, 0xF3, 0x2C, 0xBB, 0x14, 0x21, 0x06, 0x55, 0x9B,
    0xE3, 0xEF, 0x5E, 0x31, 0x4F, 0x7F, 0x5A, 0xA4, 0x0D, 0x82, 0x51, 0x49, 0x5F, 0xBA, 0x58, 0x1C,
    0x4A, 0x16, 0xD5, 0x17, 0xA8, 0x92, 0x24, 0x1F, 0x8C, 0xFF, 0xD8, 0xAE, 0x2E, 0x01, 0xD3, 0xAD,
    0x3B, 0x4B, 0xDA, 0x46, 0xEB, 0xC9, 0xDE, 0x9A, 0x8F, 0x87, 0xD7, 0x3A, 0x80, 0x6F, 0x2F, 0xC8,
    0xB1, 0xB4, 0x37, 0xF7, 0x0A, 0x22, 0x13, 0x28, 0x7C, 0xCC, 0x3C, 0x89, 0xC7, 0xC3, 0x96, 0x56,
    0x07, 0xBF, 0x7E, 0xF0, 0x0B, 0x2B, 0x97, 0x52, 0x35, 0x41, 0x79, 0x61, 0xA6, 0x4C, 0x10, 0xFE,
    0xBC, 0x26, 0x95, 0x88, 0x8A, 0xB0, 0xA3, 0xFB, 0xC0, 0x18, 0x94, 0xF2, 0xE1, 0xE5, 0xE9, 0x5D,
    0xD0, 0xDC, 0x11, 0x66, 0x64, 0x5C, 0xEC, 0x59, 0x42, 0x75, 0x12, 0xF5, 0x74, 0x9C, 0xAA, 0x23,
    0x0E, 0x86, 0xAB, 0xBE, 0x2A, 0x02, 0xE7, 0x67, 0xE6, 0x44, 0xA2, 0x6C, 0xC2, 0x93, 0x9F, 0xF1,
    0xF6, 0xFA, 0x36, 0xD2, 0x50, 0x68, 0x9E, 0x62, 0x71, 0x15, 0x3D, 0xD6, 0x40, 0xC4, 0xE2, 0x0F,
    0x8E, 0x83, 0x77, 0x6B, 0x25, 0x05, 0x3F, 0x0C, 0x30, 0xEA, 0x70, 0xB7, 0xA1, 0xE8, 0xA9, 0x65,
    0x8D, 0x27, 0x1A, 0xDB, 0x81, 0xB3, 0xA0, 0xF4, 0x45, 0x7A, 0x19, 0xDF, 0xEE, 0x78, 0x34, 0x60])
ZUC_S1 = bytes([
    0x55, 0xC2, 0x63, 0x71, 0x3B, 0xC8, 0x47, 0x86, 0x9F, 0x3C, 0xDA, 0x5B, 0x29, 0xAA, 0xFD, 0x77,
    0x8C, 0xC5, 0x94, 0x0C, 0xA6, 0x1A, 0x13, 0x00, 0xE3, 0xA8, 0x16, 0x72, 0x40, 0xF9, 0xF8, 0x42,
    0x44, 0x26, 0x68, 0x96, 0x81, 0xD9, 0x45, 0x3E, 0x10, 0x76, 0xC6, 0xA7, 0x8B, 0x39, 0x43, 0xE1,
    0x3A, 0xB5, 0x56, 0x2A, 0xC0, 0x6D, 0xB3, 0x05, 0x22, 0x66, 0xBF, 0xDC, 0x0B, 0xFA, 0x62, 0x48,
    0xDD, 0x20, 0x11, 0x06, 0x36, 0xC9, 0xC1, 0xCF, 0xF6, 0x27, 0x52, 0xBB, 0x69, 0xF5, 0xD4, 0x87,
    0x7F, 0x84, 0x4C, 0xD2, 0x9C, 0x57, 0xA4, 0xBC, 0x4F, 0x9A, 0xDF, 0xFE, 0xD6, 0x8D, 0x7A, 0xEB,
    0x2B, 0x53, 0xD8, 0x5C, 0xA1, 0x14, 0x17, 0xFB, 0x23, 0xD5, 0x7D, 0x30, 0x67, 0x73, 0x08, 0x09,
    0xEE, 0xB7, 0x70, 0x3F, 0x61, 0xB2, 0x19, 0x8E, 0x4E, 0xE5, 0x4B, 0x93, 0x8F, 0x5D, 0xDB, 0xA9,
    0xAD, 0xF1, 0xAE, 0x2E, 0xCB, 0x0D, 0xFC, 0xF4, 0x2D, 0x46, 0x6E, 0x1D, 0x97, 0xE8, 0xD1, 0xE9,
    0x4D, 0x37, 0xA5, 0x75, 0x5E, 0x83, 0x9E, 0xAB, 0x82, 0x9D, 0xB9, 0x1C, 0xE0, 0xCD, 0x49, 0x89,
    0x01, 0xB6, 0xBD, 0x58, 0x24, 0xA2, 0x5F, 0x38, 0x78, 0x99, 0x15, 0x90, 0x50, 0xB8, 0x95, 0xE4,
    0xD0, 0x91, 0xC7, 0xCE, 0xED, 0x0F, 0xB4, 0x6F, 0xA0, 0xCC, 0xF0, 0x02, 0x4A, 0x79, 0xC3, 0xDE,
    0xA3, 0xEF, 0xEA, 0x51, 0xE6, 0x6B, 0x18, 0xEC, 0x1B, 0x2C, 0x80, 0xF7, 0x74, 0xE7, 0xFF, 0x21,
    0x5A, 0x6A, 0x54, 0x1E, 0x41, 0x31, 0x92, 0x35, 0xC4, 0x33, 0x07, 0x0A, 0xBA, 0x7E, 0x0E, 0x34,
    0x88, 0xB1, 0x98, 0x7C, 0xF3, 0x3D, 0x60, 0x6C, 0x7B, 0xCA, 0xD3, 0x1F, 0x32, 0x65, 0x04, 0x28,
    0x64, 0xBE, 0x85, 0x9B, 0x2F, 0x59, 0x8A, 0xD7, 0xB0, 0x25, 0xAC, 0xAF, 0x12, 0x03, 0xE2, 0xF2])
ZUC_D = (0x44D7, 0x26BC, 0x626B, 0x135E, 0x5789, 0x35E2, 0x7135, 0x09AF,
         0x4D78, 0x2F13, 0x6BC4, 0x1AF1, 0x5E26, 0x3C4D, 0x789A, 0x47AC)


# --- GF(2^8) helpers and derived tables ---------------------------------------


def _mulx(v: int, c: int) -> int:
    """MULx of TS 35.216 3.1.1: multiply by x in GF(2^8) mod poly `c`."""
    return ((v << 1) ^ c) & 0xFF if v & 0x80 else (v << 1)


def _mulxpow(v: int, i: int, c: int) -> int:
    for _ in range(i):
        v = _mulx(v, c)
    return v


def _rijndael_sbox() -> bytes:
    # GF(2^8) inverse mod x^8+x^4+x^3+x+1 then the AES affine transform.
    exp, log = [0] * 256, [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= _mulx(x, 0x1B)  # multiply by generator 0x03
    box = bytearray(256)
    for a in range(256):
        inv = 0 if a == 0 else exp[(255 - log[a]) % 255]
        b = inv
        for sh in (1, 2, 3, 4):
            b ^= ((inv << sh) | (inv >> (8 - sh))) & 0xFF
        box[a] = b ^ 0x63
    return bytes(box)


SNOW3G_SR = _rijndael_sbox()

# MULalpha / DIValpha tables (TS 35.216 3.4.2/3.4.3): byte -> u32.
_MUL_ALPHA = tuple(
    (_mulxpow(c, 23, 0xA9) << 24) | (_mulxpow(c, 245, 0xA9) << 16)
    | (_mulxpow(c, 48, 0xA9) << 8) | _mulxpow(c, 239, 0xA9)
    for c in range(256))
_DIV_ALPHA = tuple(
    (_mulxpow(c, 16, 0xA9) << 24) | (_mulxpow(c, 39, 0xA9) << 16)
    | (_mulxpow(c, 6, 0xA9) << 8) | _mulxpow(c, 64, 0xA9)
    for c in range(256))


def _mixcol_tables(sbox: bytes, poly: int):
    """Per-byte-position lookup tables for the S1/S2 32->32 S-boxes
    (TS 35.216 3.3.1/3.3.2): the MixColumn-style diffusion is linear in
    each substituted byte, so S(w) = T0[b0]^T1[b1]^T2[b2]^T3[b3]."""
    t0, t1, t2, t3 = [], [], [], []
    for b in range(256):
        a = sbox[b]
        a2 = _mulx(a, poly)
        a3 = a2 ^ a
        t0.append((a2 << 24) | (a3 << 16) | (a << 8) | a)
        t1.append((a << 24) | (a2 << 16) | (a3 << 8) | a)
        t2.append((a << 24) | (a << 16) | (a2 << 8) | a3)
        t3.append((a3 << 24) | (a << 16) | (a << 8) | a2)
    return tuple(t0), tuple(t1), tuple(t2), tuple(t3)


_S1T = _mixcol_tables(SNOW3G_SR, 0x1B)
_S2T = _mixcol_tables(SNOW3G_SQ, 0x69)


# --- SNOW 3G core (TS 35.216 sections 3-4) ------------------------------------


class Snow3G:
    """SNOW 3G keystream generator. `k` and `iv` are 4 big-endian u32
    words each, laid out as in the spec's initialization (section 4.1:
    k[3] holds the most-significant key word)."""

    def __init__(self, k, iv):
        one = 0xFFFFFFFF
        s = [k[0] ^ one, k[1] ^ one, k[2] ^ one, k[3] ^ one,
             k[0], k[1], k[2], k[3],
             k[0] ^ one, k[1] ^ one ^ iv[3], k[2] ^ one ^ iv[2], k[3] ^ one,
             k[0] ^ iv[1], k[1], k[2], k[3] ^ iv[0]]
        self.s = s
        self.r1 = self.r2 = self.r3 = 0
        for _ in range(32):
            f = self._clock_fsm()
            self._clock_lfsr(f)

    def _clock_fsm(self) -> int:
        s = self.s
        f = ((s[15] + self.r1) & _M32) ^ self.r2
        r = (self.r2 + (self.r3 ^ s[5])) & _M32
        w = self.r2
        self.r3 = (_S2T[0][w >> 24] ^ _S2T[1][(w >> 16) & 0xFF]
                   ^ _S2T[2][(w >> 8) & 0xFF] ^ _S2T[3][w & 0xFF])
        w = self.r1
        self.r2 = (_S1T[0][w >> 24] ^ _S1T[1][(w >> 16) & 0xFF]
                   ^ _S1T[2][(w >> 8) & 0xFF] ^ _S1T[3][w & 0xFF])
        self.r1 = r
        return f

    def _clock_lfsr(self, f: int = 0) -> None:
        s = self.s
        v = (((s[0] << 8) & 0xFFFFFF00) ^ _MUL_ALPHA[s[0] >> 24] ^ s[2]
             ^ (s[11] >> 8) ^ _DIV_ALPHA[s[11] & 0xFF] ^ f)
        del s[0]
        s.append(v)

    def keystream(self, n: int):
        """n keystream words (section 4.2)."""
        self._clock_fsm()
        self._clock_lfsr()
        out = []
        for _ in range(n):
            f = self._clock_fsm()
            out.append(f ^ self.s[0])
            self._clock_lfsr()
        return out


def _s3g_key_words(key: bytes):
    # liblte layout: k[3] = first 4 key bytes (big-endian), ... k[0] = last.
    w = struct.unpack(">4I", key)
    return [w[3], w[2], w[1], w[0]]


def _xor_keystream(data: bytes, ks_words, bit_len: int) -> bytes:
    ks = np.array(ks_words, dtype=">u4").tobytes()[:len(data)]
    out = (np.frombuffer(data, np.uint8) ^ np.frombuffer(ks, np.uint8))
    # zero tailing bits beyond bit_len (reference zero_tailing_bits)
    rem = bit_len % 8
    if rem:
        out = out.copy()
        out[bit_len // 8] &= (0xFF << (8 - rem)) & 0xFF
        out[bit_len // 8 + 1:] = 0
    return out.tobytes()


def eea1(key: bytes, count: int, bearer: int, direction: int,
         data: bytes, bit_len: int | None = None) -> bytes:
    """128-EEA1 ciphering (SNOW 3G f8; TS 33.401 B.1.2). Symmetric."""
    if bit_len is None:
        bit_len = 8 * len(data)
    n_words = (bit_len + 31) // 32
    iv2 = ((bearer & 0x1F) << 27) | ((direction & 1) << 26)
    ks = Snow3G(_s3g_key_words(key),
                [iv2, count & _M32, iv2, count & _M32]).keystream(n_words)
    return _xor_keystream(data, ks, bit_len)


def _mul64(v: int, p: int, c: int = 0x1B) -> int:
    """MUL64 of TS 35.216 4.3.2: GF(2^64) product with reduction
    polynomial x^64 + x^4 + x^3 + x + 1 (represented by c)."""
    res = 0
    for i in range(64):
        if (p >> i) & 1:
            res ^= v
        v = ((v << 1) ^ c) & _M64 if v >> 63 else v << 1
    return res


def eia1(key: bytes, count: int, bearer: int, direction: int,
         data: bytes, bit_len: int | None = None) -> bytes:
    """128-EIA1 integrity (SNOW 3G f9 with FRESH = BEARER<<27;
    TS 33.401 B.2.2) -> 4-byte MAC-I."""
    if bit_len is None:
        bit_len = 8 * len(data)
    fresh = (bearer & 0x1F) << 27
    iv = [fresh ^ ((direction & 1) << 15),
          (count ^ ((direction & 1) << 31)) & _M32,
          fresh, count & _M32]
    z = Snow3G(_s3g_key_words(key), iv).keystream(5)
    p = (z[0] << 32) | z[1]
    q = (z[2] << 32) | z[3]
    # Horner evaluation of the message polynomial at P over GF(2^64)
    # (TS 35.216 4.4: D = #64-bit blocks incl. the length block)
    d = (bit_len >> 6) + (1 if bit_len % 64 == 0 else 2)
    padded = (data + bytes(8 * d))[:8 * d]
    eval_ = 0
    for i in range(d - 1):
        m = int.from_bytes(padded[8 * i:8 * i + 8], "big")
        if i == d - 2:  # mask tail bits beyond bit_len
            rem = bit_len - 64 * (d - 2)
            m &= (_M64 << (64 - rem)) & _M64
        eval_ = _mul64(eval_ ^ m, p)
    eval_ ^= bit_len
    mac32 = (_mul64(eval_, q) >> 32) ^ z[4]
    return struct.pack(">I", mac32)


# --- ZUC core (TS 35.222) ------------------------------------------------------


def _add31(a: int, b: int) -> int:
    c = a + b
    return (c & 0x7FFFFFFF) + (c >> 31)


def _rot32(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


class Zuc:
    """ZUC keystream generator (128-bit key, 128-bit IV)."""

    def __init__(self, key: bytes, iv: bytes):
        self.s = [((key[i] << 23) | (ZUC_D[i] << 8) | iv[i])
                  for i in range(16)]
        self.r1 = self.r2 = 0
        for _ in range(32):
            w = self._f(*self._bitreorg()[:3])
            self._lfsr_next(w >> 1)
        self._f(*self._bitreorg()[:3])
        self._lfsr_next()

    def _bitreorg(self):
        s = self.s
        x0 = ((s[15] & 0x7FFF8000) << 1) | (s[14] & 0xFFFF)
        x1 = ((s[11] & 0xFFFF) << 16) | (s[9] >> 15)
        x2 = ((s[7] & 0xFFFF) << 16) | (s[5] >> 15)
        x3 = ((s[2] & 0xFFFF) << 16) | (s[0] >> 15)
        return x0, x1, x2, x3

    def _f(self, x0: int, x1: int, x2: int) -> int:
        w = ((x0 ^ self.r1) + self.r2) & _M32
        w1 = (self.r1 + x1) & _M32
        w2 = self.r2 ^ x2
        u = ((w1 << 16) & _M32) | (w2 >> 16)
        v = ((w2 << 16) & _M32) | (w1 >> 16)
        u = u ^ _rot32(u, 2) ^ _rot32(u, 10) ^ _rot32(u, 18) ^ _rot32(u, 24)
        v = v ^ _rot32(v, 8) ^ _rot32(v, 14) ^ _rot32(v, 22) ^ _rot32(v, 30)
        self.r1 = ((ZUC_S0[u >> 24] << 24) | (ZUC_S1[(u >> 16) & 0xFF] << 16)
                   | (ZUC_S0[(u >> 8) & 0xFF] << 8) | ZUC_S1[u & 0xFF])
        self.r2 = ((ZUC_S0[v >> 24] << 24) | (ZUC_S1[(v >> 16) & 0xFF] << 16)
                   | (ZUC_S0[(v >> 8) & 0xFF] << 8) | ZUC_S1[v & 0xFF])
        return w

    def _lfsr_next(self, u: int = 0) -> None:
        # s16 = 2^15 s15 + 2^17 s13 + 2^21 s10 + 2^20 s4 + (1+2^8) s0 + u
        # over GF(2^31 - 1)  (TS 35.222 3.2)
        s = self.s
        f = s[0]
        for idx, k in ((0, 8), (4, 20), (10, 21), (13, 17), (15, 15)):
            f = _add31(f, ((s[idx] << k) | (s[idx] >> (31 - k))) & 0x7FFFFFFF)
        if u:
            f = _add31(f, u)
        if f == 0:
            f = 0x7FFFFFFF
        del s[0]
        s.append(f)

    def keystream(self, n: int):
        out = []
        for _ in range(n):
            x0, x1, x2, x3 = self._bitreorg()
            out.append(self._f(x0, x1, x2) ^ x3)
            self._lfsr_next()
        return out


def eea3(key: bytes, count: int, bearer: int, direction: int,
         data: bytes, bit_len: int | None = None) -> bytes:
    """128-EEA3 ciphering (ZUC; TS 33.401 B.1.3). Symmetric."""
    if bit_len is None:
        bit_len = 8 * len(data)
    cb = struct.pack(">I", count & _M32)
    half = cb + bytes([((bearer & 0x1F) << 3) | ((direction & 1) << 2), 0, 0, 0])
    ks = Zuc(key, half + half).keystream((bit_len + 31) // 32)
    return _xor_keystream(data, ks, bit_len)


def eia3(key: bytes, count: int, bearer: int, direction: int,
         data: bytes, bit_len: int | None = None) -> bytes:
    """128-EIA3 integrity (ZUC; TS 33.401 B.2.3) -> 4-byte MAC-I."""
    if bit_len is None:
        bit_len = 8 * len(data)
    cb = struct.pack(">I", count & _M32)
    d = direction & 1
    iv = bytes([cb[0], cb[1], cb[2], cb[3],
                (bearer & 0x1F) << 3, 0, 0, 0,
                cb[0] ^ (d << 7), cb[1], cb[2], cb[3],
                (bearer & 0x1F) << 3, 0, d << 7, 0])
    n_words = (bit_len + 64 + 31) // 32
    ks = Zuc(key, iv).keystream(n_words)
    # universal hash: XOR the 32-bit keystream window at offset i for
    # every set message bit, plus the window at offset bit_len
    ks_bits = np.unpackbits(
        np.frombuffer(np.array(ks, dtype=">u4").tobytes(), np.uint8))
    windows = np.lib.stride_tricks.sliding_window_view(ks_bits, 32)
    msg_bits = np.unpackbits(np.frombuffer(data, np.uint8))[:bit_len]
    sel = np.nonzero(msg_bits)[0]
    t_bits = windows[bit_len].copy()
    if sel.size:
        t_bits ^= np.bitwise_xor.reduce(windows[sel], axis=0)
    t = int.from_bytes(np.packbits(t_bits).tobytes(), "big")
    return struct.pack(">I", t ^ ks[-1])
