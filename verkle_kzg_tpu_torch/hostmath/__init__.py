"""Exact host-side BN254 math: the oracle for every device kernel and the
production path for O(1)-sized host work (transcripts, pairings, setup)."""

from . import curve, field, hashing, pairing, serialize  # noqa: F401
