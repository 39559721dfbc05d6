"""IPA CRS generator (``verkle_kzg_tpu/schemes/generators.py``, IPA half):
the reference's SHA-256 try-and-increment hash-to-curve points
(``ipa_point_generator.rs:36-83``). The KZG SRS comes with its slice."""

from __future__ import annotations

from ..hostmath.hashing import eth_try_and_increment

DEFAULT_IPA_SEED = b"eth_verkle_oct_2021"


def ipa_generate_points(num: int, seed: bytes = DEFAULT_IPA_SEED) -> list:
    """num host affine points, bit-compatible with IPAPointGenerator::gen."""
    return eth_try_and_increment(seed, num)
