"""arkworks-compatible canonical serialization for BN254.

Bit-exactness of transcripts and verkle roots hinges on replicating
ark-serialize's compressed encodings byte-for-byte (SURVEY.md section 2.3
item 8; consumed by ``vector-commit/src/transcript.rs:64-71`` and
``vector-commit/src/lib.rs:56-67``).

Conventions replicated (ark-serialize / ark-ec 0.4):
  * Fr / Fq serialize_compressed: 32 little-endian bytes (modulus is 254 bits
    + 0 flag bits -> ceil(254/8) = 32).
  * G1 compressed: 32 LE bytes of affine x with SWFlags OR'd into the top two
    bits of the final byte: infinity = 1<<6 (with x = 0), y-is-negative =
    1<<7 where "negative" means y > -y as canonical integers.
  * usize: 8 LE bytes; u8: 1 byte.
  * from_le_bytes_mod_order / from_be_bytes_mod_order: full byte string
    (including any flag bits) interpreted as an integer and reduced.
"""

from __future__ import annotations

from ..errors import SerializationError
from ..params import Q, R

INFINITY_FLAG = 1 << 6
Y_NEGATIVE_FLAG = 1 << 7


def fr_to_bytes(x: int) -> bytes:
    return (x % R).to_bytes(32, "little")


def fq_to_bytes(x: int) -> bytes:
    return (x % Q).to_bytes(32, "little")


def fr_from_le_bytes_mod_order(b: bytes) -> int:
    return int.from_bytes(b, "little") % R


def fr_from_be_bytes_mod_order(b: bytes) -> int:
    return int.from_bytes(b, "big") % R


def usize_to_bytes(x: int) -> bytes:
    return x.to_bytes(8, "little")


def g1_to_compressed_bytes(p) -> bytes:
    """ark-ec short-Weierstrass compressed affine encoding of a G1 point
    (``None`` = infinity)."""
    if p is None:
        return bytes(31) + bytes([INFINITY_FLAG])
    x, y = p
    buf = bytearray((x % Q).to_bytes(32, "little"))
    neg_y = (Q - y) % Q
    # SWFlags::from_y_coordinate: negative iff y > -y (canonical ints)
    if (y % Q) > neg_y:
        buf[31] |= Y_NEGATIVE_FLAG
    return bytes(buf)


def g1_from_compressed_bytes(b: bytes):
    """Inverse of g1_to_compressed_bytes (canonical deserialize, no subgroup
    check needed: BN254 G1 has cofactor 1). Raises ValueError on invalid."""
    from .curve import g1_from_x

    if len(b) != 32:
        raise SerializationError("expected 32 bytes")
    flags = b[31] & 0xC0
    masked = bytearray(b)
    masked[31] &= 0x3F
    x = int.from_bytes(bytes(masked), "little")
    if flags == INFINITY_FLAG:
        if x != 0:
            raise SerializationError("infinity flag with nonzero x")
        return None
    if flags == (INFINITY_FLAG | Y_NEGATIVE_FLAG):
        raise SerializationError("invalid flag combination")
    if x >= Q:
        raise SerializationError("x out of range")
    # serialization marked negative iff y > -y; reconstruct accordingly
    pt = g1_from_x(x, greatest=(flags == Y_NEGATIVE_FLAG))
    if pt is None:
        raise SerializationError("x not on curve")
    return pt


def g1_to_data_item(p) -> int:
    """Commitment -> Fr data item: zero for infinity, else
    Fr::from_le_bytes_mod_order(compressed bytes). Mirrors the blanket
    VCCommitment impl in ``vector-commit/src/lib.rs:56-67``."""
    if p is None:
        return 0
    return fr_from_le_bytes_mod_order(g1_to_compressed_bytes(p))


class _ParseFailure:
    """Unique sentinel: the bytes map to no point (distinct from the infinity
    point, which this codebase represents as ``None``)."""

    __repr__ = lambda self: "PARSE_FAILURE"  # noqa: E731


PARSE_FAILURE = _ParseFailure()


def g1_from_random_bytes(b: bytes):
    """ark-ec AffineRepr::from_random_bytes semantics (used by the reference's
    hash-to-curve, ``vector-commit/src/ipa/ipa_point_generator.rs:104``):

      * parse 32 LE bytes, strip SWFlags from the top 2 bits of byte 31;
      * reject if the masked value >= q or both flag bits are set;
      * infinity flag: point at infinity iff x == 0, else reject;
      * otherwise pick y via get_point_from_x_unchecked(x, greatest =
        flags.is_positive()) -- i.e. NO flag bits -> the larger y.

    Returns the affine point, ``None`` for the infinity point, or
    ``PARSE_FAILURE`` when the bytes map to no point (caller retries).
    """
    from .curve import g1_from_x

    if len(b) < 32:
        return PARSE_FAILURE
    b = b[:32]
    flags = b[31] & 0xC0
    masked = bytearray(b)
    masked[31] &= 0x3F
    x = int.from_bytes(bytes(masked), "little")
    if x >= Q:
        return PARSE_FAILURE
    if flags == (INFINITY_FLAG | Y_NEGATIVE_FLAG):
        return PARSE_FAILURE
    if flags == INFINITY_FLAG:
        return None if x == 0 else PARSE_FAILURE
    # YIsPositive (0x00) -> greatest=True; YIsNegative (0x80) -> greatest=False
    pt = g1_from_x(x, greatest=(flags == 0))
    return PARSE_FAILURE if pt is None else pt
