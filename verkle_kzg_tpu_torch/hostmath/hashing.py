"""RFC-9380 expand_message_xmd hash-to-field and the reference's
SHA-256 try-and-increment hash-to-curve.

Replicates, byte-for-byte:
  * ark_ff::field_hashers::DefaultFieldHasher<Sha256> (SEC_PARAM = 128):
    len_per_elem = ceil((254 + 128) / 8) = 48 bytes, big-endian reduction.
    Used for every Fiat-Shamir challenge (``vector-commit/src/transcript.rs:55``).
  * EthereumHashToCurve: SHA-256(domain || msg) -> Affine::from_random_bytes,
    try-and-increment over a little-endian u64 counter
    (``vector-commit/src/ipa/ipa_point_generator.rs:85-109`` and ``:51-67``).
"""

from __future__ import annotations

import hashlib

from ..errors import PointGeneratorError, TranscriptError
from ..params import R
from .serialize import PARSE_FAILURE, g1_from_random_bytes

_SHA256_BLOCK = 64  # r_in_bytes
_SHA256_OUT = 32  # b_in_bytes

#: DefaultFieldHasher len-per-element for BN254 Fr at 128-bit security.
FR_HASH_LEN = 48


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 section 5.3.1 with SHA-256."""
    ell = -(-len_in_bytes // _SHA256_OUT)
    if ell > 255 or len_in_bytes > 65535 or len(dst) > 255:
        raise TranscriptError("expand_message_xmd bounds exceeded")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = bytes(_SHA256_BLOCK)
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    b = [hashlib.sha256(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        xored = bytes(x ^ y for x, y in zip(b0, b[-1]))
        b.append(hashlib.sha256(xored + i.to_bytes(1, "big") + dst_prime).digest())
    return b"".join(b)[:len_in_bytes]


def hash_to_fr(msg: bytes, dst: bytes, count: int = 1) -> list[int]:
    """DefaultFieldHasher<Sha256>::hash_to_field for BN254 Fr: expand to
    count * 48 bytes, each 48-byte chunk reduced big-endian mod r."""
    uniform = expand_message_xmd(msg, dst, count * FR_HASH_LEN)
    return [
        int.from_bytes(uniform[i * FR_HASH_LEN : (i + 1) * FR_HASH_LEN], "big") % R
        for i in range(count)
    ]


def eth_hash_to_curve(domain: bytes, msg: bytes):
    """SHA-256(domain || msg) -> G1 affine via from_random_bytes.

    Returns the point, ``None`` for infinity, or PARSE_FAILURE (caller
    retries with the next counter).
    """
    digest = hashlib.sha256(domain + msg).digest()
    return g1_from_random_bytes(digest)


def eth_try_and_increment(seed: bytes, num: int) -> list:
    """The IPAPointGenerator::gen loop: hash LE-u64 counters, skipping
    failures, until ``num`` points are produced
    (``vector-commit/src/ipa/ipa_point_generator.rs:51-67``)."""
    out = []
    i = 0
    while len(out) < num:
        pt = eth_hash_to_curve(seed, i.to_bytes(8, "little"))
        if pt is not PARSE_FAILURE:
            out.append(pt)
        i += 1
    return out


def eth_gen_at(seed: bytes, index: int):
    """IPAPointGenerator::gen_at: single attempt at the exact counter; raises
    on failure (``ipa_point_generator.rs:69-78``)."""
    pt = eth_hash_to_curve(seed, index.to_bytes(8, "little"))
    if pt is PARSE_FAILURE:
        raise PointGeneratorError("invalid point at index")
    return pt
