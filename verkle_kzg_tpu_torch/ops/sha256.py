"""SHA-256 and RFC 9380 hash-to-field on tensors, for Fiat-Shamir on the
device (``verkle_kzg_tpu/ops/sha256.py``).

The IPA prove's halving loop draws a challenge after every round. With the
digests on the device, the loop runs from the upload of the transcript
state to the read of the finished proof with no host round trip
(``schemes/ipa.py::_low_level_ipa``). Every function here gives the bytes
and field elements of ``hostmath/hashing.py`` and
``hostmath/serialize.py``, byte for byte, for a message of any length.

Layout: a byte string is a 1-D ``uint8`` tensor; Fr and Fq elements are
(..., 8) int32 words (``ops/field.py``); affine points (..., 2, 8).

What runs: on a CUDA tensor, :func:`sha256_bytes`, :func:`expand_message_xmd`,
:func:`hash_to_fr` and :func:`g1_compressed_bytes` launch kernel FSX
(``ops/cuda_fiat_shamir.py``, ``csrc/fiat_shamir.cu``), never torch ops: a
digest is a few thousand dependent 32-bit operations, one launch each as
torch ops. On a CPU tensor they run the plain versions below: FIPS 180-4's
compression on int64 tensors holding 32-bit words, RFC 9380
``expand_message_xmd`` (ell = 2 for 48 bytes), and the reduction
hi 2^192 + lo mod r on K1's plain product and add. :func:`fr_to_bytes` is a
view of the words' bytes on either device.
"""

from __future__ import annotations

import torch

from ..errors import TranscriptError
from ..utils.metrics import wait_for
from . import field as F

# FIPS 180-4 constants.
_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

BLOCK = 64  # bytes
FR_HASH_LEN = 48  # DefaultFieldHasher<Sha256> len_per_elem for BN254 Fr
_M32 = 0xFFFFFFFF


def const_bytes(raw: bytes, device) -> torch.Tensor:
    """A byte string -> (len,) uint8 tensor on ``device``."""
    return wait_for("sha256.upload", torch.tensor(list(raw), dtype=torch.uint8).to, device)


def _check_bytes(msg: torch.Tensor) -> None:
    if msg.dim() != 1 or msg.dtype != torch.uint8:
        raise ValueError(f"a byte string is a 1-D uint8 tensor, got {msg.dtype} {tuple(msg.shape)}")


def _sigma(x: torch.Tensor, r1: int, r2: int, r3: int, shift: bool = False) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ (x >> r3 when ``shift``, else rotr(x, r3))
    of a 32-bit word in int64: each rotation is a shift of x || x, whose low
    32 bits hold the rotated word (the sign that the top bit may take never
    reaches them)."""
    xx = x | (x << 32)
    return ((xx >> r1) ^ (xx >> r2) ^ ((x >> r3) if shift else (xx >> r3))) & _M32


def _compress(h: list, w16: torch.Tensor) -> list:
    """One FIPS 180-4 compression of the eight 0-d int64 state words ``h``
    by a block's sixteen big-endian words ``w16`` (16,) int64."""
    w = list(w16.unbind(0))
    for t in range(16, 64):
        s0, s1 = _sigma(w[t - 15], 7, 18, 3, True), _sigma(w[t - 2], 17, 19, 10, True)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, hh = h
    for t in range(64):
        t1 = hh + _sigma(e, 6, 11, 25) + ((e & f) ^ (~e & g)) + (_K[t] + w[t])
        t2 = _sigma(a, 2, 13, 22) + ((a & b) ^ (c & (a ^ b)))
        a, b, c, d, e, f, g, hh = (t1 + t2) & _M32, a, b, c, (d + t1) & _M32, e, f, g
    return [(x + y) & _M32 for x, y in zip(h, (a, b, c, d, e, f, g, hh))]


def plain_sha256(msg: torch.Tensor) -> torch.Tensor:
    """The plain SHA-256 of (n,) uint8 bytes -> (32,) uint8, on any device:
    padding to whole blocks, then one compression a block."""
    n = msg.shape[0]
    total = (n + 9 + BLOCK - 1) // BLOCK * BLOCK
    tail = [0x80] + [0] * (total - n - 9) + list((8 * n).to_bytes(8, "big"))
    padded = torch.cat([msg, torch.tensor(tail, dtype=torch.uint8, device=msg.device)]).to(torch.int64)
    words = padded.reshape(-1, 16, 4)
    words = (words[..., 0] << 24) | (words[..., 1] << 16) | (words[..., 2] << 8) | words[..., 3]
    h = list(torch.tensor(_H0, dtype=torch.int64, device=msg.device).unbind(0))
    for blk in words:
        h = _compress(h, blk)
    dig = torch.stack(h)
    shifts = torch.tensor([24, 16, 8, 0], device=msg.device)
    return ((dig[:, None] >> shifts) & 0xFF).reshape(32).to(torch.uint8)


def _dst_prime(dst: bytes) -> bytes:
    if len(dst) > 255:
        raise TranscriptError("expand_message_xmd bounds exceeded")
    return dst + bytes([len(dst)])


def plain_expand_message_xmd(msg: torch.Tensor, dst: bytes, len_in_bytes: int) -> torch.Tensor:
    """RFC 9380 section 5.3.1 with SHA-256 on :func:`plain_sha256`."""
    ell = -(-len_in_bytes // 32)
    if ell > 255 or len_in_bytes > 65535:
        raise TranscriptError("expand_message_xmd bounds exceeded")
    dev = msg.device
    dst_prime = const_bytes(_dst_prime(dst), dev)
    b0 = plain_sha256(torch.cat([torch.zeros(BLOCK, dtype=torch.uint8, device=dev), msg,
                                 const_bytes(len_in_bytes.to_bytes(2, "big") + b"\x00", dev), dst_prime]))
    bs = [plain_sha256(torch.cat([b0, const_bytes(b"\x01", dev), dst_prime]))]
    for i in range(2, ell + 1):
        bs.append(plain_sha256(torch.cat([b0 ^ bs[-1], const_bytes(bytes([i]), dev), dst_prime])))
    return torch.cat(bs)[:len_in_bytes]


def _be_words(b: torch.Tensor) -> torch.Tensor:
    """(24,) big-endian bytes -> (8,) int32 little-endian words of the same
    integer (below 2^192)."""
    le = torch.cat([b.flip(0), torch.zeros(8, dtype=torch.uint8, device=b.device)])
    return le.view(torch.int32)


def plain_hash_to_fr(msg: torch.Tensor, dst: bytes) -> torch.Tensor:
    """One DefaultFieldHasher<Sha256> element: the 48 expanded bytes read
    big-endian as hi 2^192 + lo, reduced mod r as the Montgomery product of
    hi by 2^192 R and a modular add of lo, on K1's plain versions. -> (8,)
    standard-form words, reduced."""
    uniform = plain_expand_message_xmd(msg, dst, FR_HASH_LEN)
    hi, lo = _be_words(uniform[:24]), _be_words(uniform[24:])
    c192 = F.const_mont(1 << 192, "fr", msg.device)
    return F.add(F.mont_mul(hi, c192, "fr"), lo, "fr")


def fr_to_bytes(x_std: torch.Tensor) -> torch.Tensor:
    """(8,) reduced standard-form words -> (32,) little-endian bytes
    (serialize_compressed, ``hostmath/serialize.py::fr_to_bytes``): the
    words' own bytes, a view on either device."""
    return x_std.contiguous().view(torch.uint8)


def plain_g1_compressed_bytes(aff_mont: torch.Tensor) -> torch.Tensor:
    """(B, 2, 8) Montgomery affine, (0, 0) the infinity sentinel -> (B, 32)
    uint8 compressed points (``hostmath/serialize.py::g1_to_compressed_bytes``):
    x in standard form, little-endian; byte 31 carries SWFlags, bit 7 when
    y > -y, bit 6 for infinity (x all zero)."""
    x_std = F.from_mont(aff_mont[:, 0], "fq")
    y_std = F.from_mont(aff_mont[:, 1], "fq")
    inf = (aff_mont == 0).flatten(1).all(1)
    y_int = F.words_to_ints(y_std)
    neg = torch.tensor([y > (F.SPECS["fq"].modulus - y) % F.SPECS["fq"].modulus for y in y_int],
                       dtype=torch.bool, device=aff_mont.device)
    out = x_std.contiguous().view(torch.uint8).reshape(-1, 32).clone()
    flags = torch.where(inf, 1 << 6, torch.where(neg, 1 << 7, 0)).to(torch.uint8)
    out[:, 31] |= flags
    return out


def sha256_bytes(msg: torch.Tensor) -> torch.Tensor:
    """(n,) uint8 -> (32,) uint8 SHA-256 digest. FSX on a card."""
    _check_bytes(msg)
    if msg.device.type == "cpu":
        return plain_sha256(msg)
    return _fsx.digest(msg)


def expand_message_xmd(msg: torch.Tensor, dst: bytes, len_in_bytes: int) -> torch.Tensor:
    """RFC 9380 ``expand_message_xmd`` with SHA-256 -> (len_in_bytes,) uint8
    (``hostmath/hashing.py::expand_message_xmd``). FSX on a card."""
    _check_bytes(msg)
    if msg.device.type == "cpu":
        return plain_expand_message_xmd(msg, dst, len_in_bytes)
    return _fsx.expand(msg, dst, len_in_bytes)


def hash_to_fr(msg: torch.Tensor, dst: bytes) -> torch.Tensor:
    """DefaultFieldHasher<Sha256>::hash_to_field, one element -> (8,)
    standard-form words, reduced (``hostmath/hashing.py::hash_to_fr``).
    FSX on a card."""
    _check_bytes(msg)
    if msg.device.type == "cpu":
        return plain_hash_to_fr(msg, dst)
    return _fsx.challenge(msg, dst, [], b"")[0][0]


def g1_compressed_bytes(aff_mont: torch.Tensor) -> torch.Tensor:
    """(B, 2, 8) Montgomery affine -> (B, 32) uint8 compressed points. FSX's
    compression on a card."""
    if aff_mont.dim() != 3 or aff_mont.shape[1:] != (2, F.WORDS):
        raise ValueError(f"g1_compressed_bytes: points must be (B, 2, 8), got {tuple(aff_mont.shape)}")
    if aff_mont.device.type == "cpu":
        return plain_g1_compressed_bytes(aff_mont)
    return _fsx.compress(aff_mont)


from . import cuda_fiat_shamir as _fsx  # noqa: E402  (FSX wrapper; it imports this module)
