"""KZG over BN254 with a Lagrange SRS, in plain Python integers, worked
out from the secret s: the SRS's i-th point is l_i(s) G, so a commitment
to the evaluations f_i is f(s) G with f(s) = sum f_i l_i(s), and the
opening at z is ((f(s) - f(z)) / (s - z)) G (``kzg/mod.rs:126-154``).
The all-points proofs (``kzg/mod.rs:200-235``, FK) are the openings at
every w^i, with y_i = f_i. EIP-4844's ``compute_challenge`` gives z.

``truncate`` is the control: each scalar of G is cut to its low 128 bits.
"""

from __future__ import annotations

import functools
import hashlib

from . import bn254 as E
from .bn254 import R
from .ipa import LOW128

#: EIP-4844's FIAT_SHAMIR_PROTOCOL_DOMAIN.
FS_DOMAIN = b"FSBLOBVERIFY_V1_"


@functools.lru_cache(maxsize=1)
def _g() -> E.FixedBase:
    return E.FixedBase(E.G1)


def blob_bytes(vals: list) -> bytes:
    """A blob as EIP-4844 lays it out: each element 32 bytes big-endian."""
    return b"".join(v.to_bytes(32, "big") for v in vals)


def compute_challenge(blob: bytes, n: int, commitment) -> int:
    """EIP-4844's ``compute_challenge`` on BN254: SHA-256 over the domain
    tag, the degree as 16 bytes big-endian, the blob and the commitment's
    compressed encoding, read big-endian and reduced mod r."""
    data = FS_DOMAIN + n.to_bytes(16, "big") + blob + E.compress(commitment)
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % R


def evaluate(vals: list, x: int, omegas: list) -> int:
    """f(x) = ((x^n - 1) / n) sum f_i w^i / (x - w^i), for x off the domain."""
    n = len(omegas)
    inv = E.batch_inverse([(x - w) % R for w in omegas])
    acc = sum(f * w % R * d for f, w, d in zip(vals, omegas, inv)) % R
    return (pow(x, n, R) - 1) * pow(n, R - 2, R) % R * acc % R


def _mul_g(ks: list, truncate: bool) -> list:
    return _g().mul_many([k & LOW128 if truncate else k for k in ks])


def blob_sidecar(vals: list, secret: int, omegas: list, truncate: bool = False) -> tuple:
    """(commitment, proof at z, y = f(z)) for one blob, z by EIP-4844."""
    fs = evaluate(vals, secret, omegas)
    commitment = _mul_g([fs], truncate)[0]
    z = compute_challenge(blob_bytes(vals), len(vals), commitment)
    y = evaluate(vals, z, omegas)
    proof = _mul_g([(fs - y) * pow(secret - z, R - 2, R) % R], truncate)[0]
    return commitment, proof, y


def all_proofs(vals: list, secret: int, omegas: list, truncate: bool = False) -> list:
    """[(proof at w^i, f_i)] for every i."""
    fs = evaluate(vals, secret, omegas)
    inv = E.batch_inverse([(secret - w) % R for w in omegas])
    proofs = _mul_g([(fs - f) * d % R for f, d in zip(vals, inv)], truncate)
    return list(zip(proofs, vals))
