"""Typed error hierarchy, mirroring the reference's per-module thiserror
enums with one Python base class:

  * ``PointGeneratorError``  — ``vector-commit/src/lib.rs:176-182``
    (SerializationError / InvalidPoint / OutOfBounds variants).
  * ``IPAError``             — ``vector-commit/src/ipa/mod.rs:86-96``.
  * ``KZGError``             — ``vector-commit/src/kzg/mod.rs:86-93``.
  * ``TranscriptError``      — ``vector-commit/src/transcript.rs:7-11``.
  * ``NodeError``            — ``verkle-tree/src/node.rs:14-18``
    (InvalidKey / InvalidPath variants).
  * ``SerializationError``   — ark-serialize failures (invalid compressed
    bytes, flags, off-curve x).
  * ``BoundsError``          — TPU-build-specific static bounds (lazy-sum
    reduction sizes, domain ceilings) that the reference has no analog
    for; raised instead of bare asserts so callers can catch precisely.

Everything derives from ``VKZGError``; library code never raises bare
``ValueError``/``AssertionError`` for protocol-level failures.
"""

from __future__ import annotations


class VKZGError(Exception):
    """Base class for all verkle_kzg_tpu errors."""


class SerializationError(VKZGError):
    """Invalid canonical encoding (bytes length, flags, off-curve x)."""


class PointGeneratorError(VKZGError):
    """CRS generation failure (``lib.rs:176-182``)."""


class IPAError(VKZGError):
    """IPA scheme failure (``ipa/mod.rs:86-96``)."""


class KZGError(VKZGError):
    """KZG scheme failure (``kzg/mod.rs:86-93``), incl. out-of-domain
    index panics surfaced as errors."""


class TranscriptError(VKZGError):
    """Fiat-Shamir transcript failure (``transcript.rs:7-11``)."""


class NodeError(VKZGError):
    """Verkle trie failure (``node.rs:14-18``): invalid key or path."""


class BoundsError(VKZGError):
    """A TPU-kernel static bound would be violated (e.g. lazy-column
    reduction size >= 2^16, multiproof domain ceiling)."""
