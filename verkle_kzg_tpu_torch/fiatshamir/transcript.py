"""Fiat-Shamir transcript, byte-compatible with the reference's
``TranscriptHasher`` (``vector-commit/src/transcript.rs:28-62``).

State machine:
  * ``new(label)``: empty state; the hasher's DST is the label bytes.
  * ``append(value, label)``: state += label_bytes + serialize_compressed(value).
  * ``digest(label, clear)``: state += label_bytes; challenge =
    hash_to_field(state, 1)[0]; if clear, state is reset to
    serialize_compressed(challenge) + label_bytes.

Challenges are BN254 Fr elements via DefaultFieldHasher<Sha256> (RFC 9380
expand_message_xmd, 48 bytes big-endian mod r).
"""

from __future__ import annotations

from ..hostmath.hashing import hash_to_fr
from ..hostmath.serialize import fr_to_bytes, g1_to_compressed_bytes, usize_to_bytes


class Transcript:
    def __init__(self, label: str):
        self._dst = label.encode()
        self._state = bytearray()

    # -- append -------------------------------------------------------------

    def append_bytes(self, raw: bytes, label: str) -> None:
        self._state += label.encode()
        self._state += raw

    def append_scalar(self, value: int, label: str) -> None:
        """Append an Fr element (serialize_compressed = 32 LE bytes)."""
        self.append_bytes(fr_to_bytes(value), label)

    def append_point(self, point, label: str) -> None:
        """Append a G1 point (compressed affine encoding)."""
        self.append_bytes(g1_to_compressed_bytes(point), label)

    def append_usize(self, value: int, label: str) -> None:
        """Append a usize (ark-serialize: 8 LE bytes)."""
        self.append_bytes(usize_to_bytes(value), label)

    # -- digest ---------------------------------------------------------------

    def digest(self, label: str, clear: bool) -> int:
        self._state += label.encode()
        res = hash_to_fr(bytes(self._state), self._dst, 1)[0]
        if clear:
            self._state = bytearray(fr_to_bytes(res)) + label.encode()
        return res
