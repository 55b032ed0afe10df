"""Aligned PER (X.691) runtime for the S1AP/NGAP codecs.

Counterpart of the reference's hand-rolled PER runtime
(`lib/src/asn1/asn1_utils.cc`: bit_ref + pack/unpack helpers used by the
generated `s1ap.cc`/`ngap.cc`): aligned-variant primitives only, since
36.413/38.413 specify ALIGNED PER — constrained whole numbers with the
octet-alignment rules, general length determinants, enumerations,
extensible CHOICE/SEQUENCE preambles, fixed/variable BIT STRINGs,
OCTET STRINGs and open types.

The UPER runtime for RRC lives in `rrc_uper.py`; this module is the
aligned sibling (the alignment rules differ enough that sharing a code
path obscures both).
"""

from __future__ import annotations


class AperWriter:
    def __init__(self) -> None:
        self.bits: list[int] = []

    # -- raw bits ----------------------------------------------------------

    def put(self, value: int, nof_bits: int) -> "AperWriter":
        for i in range(nof_bits - 1, -1, -1):
            self.bits.append((value >> i) & 1)
        return self

    def put_bool(self, b: bool) -> "AperWriter":
        self.bits.append(1 if b else 0)
        return self

    def align(self) -> "AperWriter":
        while len(self.bits) % 8:
            self.bits.append(0)
        return self

    def put_bytes(self, data: bytes) -> "AperWriter":
        self.align()
        for byte in data:
            self.put(byte, 8)
        return self

    # -- X.691 aligned primitives -----------------------------------------

    def put_constrained(self, value: int, lo: int, hi: int) -> "AperWriter":
        """Constrained whole number (X.691 §10.5 + §13 alignment)."""
        rng = hi - lo + 1
        v = value - lo
        if rng == 1:
            return self
        if rng <= 255:
            nbits = (rng - 1).bit_length()
            return self.put(v, nbits)          # bit-field, no alignment
        if rng == 256:
            self.align()
            return self.put(v, 8)
        if rng <= 65536:
            self.align()
            return self.put(v, 16)
        # indefinite-length case: minimal octets, preceded by a length
        n_octets = max(1, (v.bit_length() + 7) // 8)
        max_octets = ((rng - 1).bit_length() + 7) // 8
        self.put_constrained(n_octets, 1, max_octets)
        self.align()
        return self.put(v, 8 * n_octets)

    def put_length(self, n: int) -> "AperWriter":
        """General length determinant (X.691 §10.9, aligned); values
        >= 16K are signalled as fragments by the caller (put_open)."""
        self.align()
        if n < 128:
            return self.put(n, 8)
        if n < 16384:
            return self.put(0x8000 | n, 16)
        raise NotImplementedError("use fragmented framing (put_open)")

    def put_enum(self, idx: int, n_root: int,
                 extensible: bool = True) -> "AperWriter":
        if extensible:
            self.put_bool(False)
        return self.put_constrained(idx, 0, n_root - 1)

    def put_open(self, content: bytes) -> "AperWriter":
        if not content:
            content = b"\0"
        # X.691 §11.9.3.8: lengths >= 16K go out in 16K-block fragments
        # (marker 0b11 | m, m in 1..4), each followed by its octets
        pos = 0
        while len(content) - pos >= 16384:
            m = min((len(content) - pos) // 16384, 4)
            self.align()
            self.put(0xC0 | m, 8)
            self.put_bytes(content[pos:pos + m * 16384])
            pos += m * 16384
        self.put_length(len(content) - pos)
        return self.put_bytes(content[pos:])

    def put_bitstring(self, value: int, nof_bits: int) -> "AperWriter":
        """Fixed-size BIT STRING: bit-field if ≤ 16 bits, else aligned
        (X.691 §15.8/§15.11)."""
        if nof_bits > 16:
            self.align()
        return self.put(value, nof_bits)

    def put_octetstring(self, data: bytes, fixed: int | None = None
                        ) -> "AperWriter":
        """OCTET STRING: fixed sizes 1-2 are unaligned bit-fields, other
        fixed sizes aligned with no length, variable with a length."""
        if fixed is not None:
            assert len(data) == fixed
            if fixed <= 2:
                return self.put(int.from_bytes(data, "big"), 8 * fixed)
            return self.put_bytes(data)
        self.put_length(len(data))
        return self.put_bytes(data)

    def to_bytes(self) -> bytes:
        self.align()
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            v = 0
            for b in self.bits[i:i + 8]:
                v = (v << 1) | b
            out.append(v)
        return bytes(out)


class AperReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def get(self, nof_bits: int) -> int:
        v = 0
        for _ in range(nof_bits):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def get_bool(self) -> bool:
        return bool(self.get(1))

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def get_bytes(self, n: int) -> bytes:
        self.align()
        off = self.pos >> 3
        self.pos += 8 * n
        return self.data[off:off + n]

    def get_constrained(self, lo: int, hi: int) -> int:
        rng = hi - lo + 1
        if rng == 1:
            return lo
        if rng <= 255:
            return lo + self.get((rng - 1).bit_length())
        if rng == 256:
            self.align()
            return lo + self.get(8)
        if rng <= 65536:
            self.align()
            return lo + self.get(16)
        max_octets = ((rng - 1).bit_length() + 7) // 8
        n_octets = self.get_constrained(1, max_octets)
        self.align()
        return lo + self.get(8 * n_octets)

    def get_length(self) -> int:
        """One length determinant; a fragment marker returns the
        negative block count (callers that accept fragments loop)."""
        self.align()
        b0 = self.get(8)
        if b0 < 128:
            return b0
        if b0 & 0x40:
            return -(b0 & 0x3F)      # §11.9: m blocks of 16384 follow
        return ((b0 & 0x3F) << 8) | self.get(8)

    def get_enum(self, n_root: int, extensible: bool = True) -> int:
        if extensible:
            assert not self.get_bool(), "extended enum value"
        return self.get_constrained(0, n_root - 1)

    def get_open(self) -> bytes:
        out = bytearray()
        while True:
            n = self.get_length()
            if n >= 0:
                out += self.get_bytes(n)
                return bytes(out)
            out += self.get_bytes(-n * 16384)

    def get_bitstring(self, nof_bits: int) -> int:
        if nof_bits > 16:
            self.align()
        return self.get(nof_bits)

    def get_octetstring(self, fixed: int | None = None) -> bytes:
        if fixed is not None:
            if fixed <= 2:
                return self.get(8 * fixed).to_bytes(fixed, "big")
            return self.get_bytes(fixed)
        return self.get_bytes(self.get_length())

    def remaining(self) -> int:
        return 8 * len(self.data) - self.pos
