"""CRS point generators (``verkle_kzg_tpu/schemes/generators.py``).

* ``ipa_generate_points``: the reference's SHA-256 try-and-increment
  hash-to-curve points (``ipa_point_generator.rs:36-83``), default seed
  "eth_verkle_oct_2021".
* ``kzg_generate_monomial_srs``: the reference's insecure, test-only
  trusted setup (``kzg_point_generator.rs:10-51``, default secret s = 100):
  [G, sG, s^2 G, ...]. The secret is exposed so that G2 and the Lagrange
  SRS can be derived, as the reference's ``secret()`` feeds
  ``kzg/mod.rs:122``.
"""

from __future__ import annotations

from ..hostmath.curve import g1_generator, g2_generator, g2_mul
from ..hostmath.hashing import eth_try_and_increment
from ..ops import cuda_lib
from ..ops import curve as C
from ..ops import field as F
from ..params import R

DEFAULT_IPA_SEED = b"eth_verkle_oct_2021"
DEFAULT_KZG_SECRET = 100


def ipa_generate_points(num: int, seed: bytes = DEFAULT_IPA_SEED) -> list:
    """num host affine points, bit-compatible with IPAPointGenerator::gen."""
    return eth_try_and_increment(seed, num)


def kzg_generate_monomial_srs(num: int, secret: int = DEFAULT_KZG_SECRET, device=None) -> list:
    """[s^i G] as host affine points, computed as one batched scalar
    multiplication of the generator (K5, as the JAX package runs
    ``pallas_curve.scalar_mul_affine``) on the CUDA card unless ``device``
    says otherwise: the reference's serial running multiple
    (``kzg_point_generator.rs:32-43``) as one data-parallel launch."""
    powers = [1] * num
    for i in range(1, num):
        powers[i] = powers[i - 1] * secret % R
    return generator_multiples(powers, device)


def generator_multiples(scalars: list, device=None) -> list:
    """[k_i G] for the G1 generator G as host affine points: one K5 launch
    over copies of G, on the CUDA card unless ``device`` says otherwise."""
    device = cuda_lib.resolve_device(device)
    g = C.host_points_to_affine([g1_generator()] * len(scalars), device)
    return C.projective_to_host_points(C.scalar_mul_affine(g, F.ints_to_words(scalars, device)))


def kzg_g2(secret: int = DEFAULT_KZG_SECRET):
    """alpha H in G2."""
    return g2_mul(g2_generator(), secret)
