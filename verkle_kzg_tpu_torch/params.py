"""BN254 (alt_bn128) parameters and limb-plane layout constants.

The reference (SleepingShell/verkle-kzg) instantiates everything concretely on
``ark_bn254`` (``vector-commit/src/ipa/mod.rs:375-380``, ``kzg/mod.rs:247-254``).
This module is the single source of truth for the curve/field constants and for
the TPU limb layout (16 x 16-bit limbs held in uint32 planes).

All derived constants are *computed* here from the two moduli and the standard
generators, rather than hardcoded, so they can be independently re-checked.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# ---------------------------------------------------------------------------
# Base/scalar field moduli (standard BN254 / alt_bn128 constants).
# ---------------------------------------------------------------------------

#: Base field modulus (coordinates of G1 live in F_q).
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583

#: Scalar field modulus (the "data" field F_r; group order of G1/G2).
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

assert Q % 4 == 3, "sqrt via pow((q+1)/4) relies on q = 3 mod 4"

#: Curve equation y^2 = x^3 + B over F_q.
B = 3

#: G1 generator (affine), ark_bn254 G1Affine::generator().
G1_GENERATOR = (1, 2)

#: G2 generator (affine over Fq2, components (c0, c1)), ark_bn254 G2Affine.
G2_GENERATOR_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GENERATOR_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

#: BN parameter x: q(x), r(x) are the standard BN polynomials at this x.
BN_X = 4965661367192848881

#: Optimal-ate Miller loop length 6x + 2.
ATE_LOOP_COUNT = 6 * BN_X + 2

# ---------------------------------------------------------------------------
# F_r multiplicative structure (for NTT / evaluation domains).
# ark_bn254::Fr has GENERATOR = 5 and TWO_ADICITY = 28; the 2^28-th root of
# unity is derived exactly as arkworks does: g^((r-1) / 2^28).
# ---------------------------------------------------------------------------

FR_GENERATOR = 5
FR_TWO_ADICITY = 28
assert (R - 1) % (1 << FR_TWO_ADICITY) == 0
FR_TWO_ADIC_ROOT_OF_UNITY = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)


def fr_root_of_unity(size: int) -> int:
    """omega for the radix-2 evaluation domain of ``size`` points.

    Mirrors ark_poly Radix2EvaluationDomain::new (group_gen used by
    ``vector-commit/src/precompute.rs:27``).
    """
    assert size & (size - 1) == 0, "domain size must be a power of two"
    log = size.bit_length() - 1
    assert log <= FR_TWO_ADICITY
    return pow(FR_TWO_ADIC_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - log), R)


# ---------------------------------------------------------------------------
# Limb-plane layout: 16 limbs x 16 bits, little-endian limb order, stored in
# uint32 planes. Chosen so a limb product fits in uint32 and column sums stay
# far below 2^32 (see ops/field.py).
# ---------------------------------------------------------------------------

LIMB_BITS = 16
NLIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
TOTAL_BITS = LIMB_BITS * NLIMBS  # 256
MONT_R = 1 << TOTAL_BITS  # Montgomery radix R = 2^256


def int_to_limbs(x: int, nlimbs: int = NLIMBS) -> np.ndarray:
    """Little-endian 16-bit limb decomposition as uint32."""
    assert 0 <= x < (1 << (LIMB_BITS * nlimbs))
    return np.array(
        [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(nlimbs)], dtype=np.uint32
    )


def limbs_to_int(limbs) -> int:
    out = 0
    for i, limb in enumerate(np.asarray(limbs, dtype=np.uint64).tolist()):
        out |= int(limb) << (LIMB_BITS * i)
    return out


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static per-field constants consumed by the device kernels."""

    name: str
    modulus: int

    @functools.cached_property
    def modulus_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus)

    @functools.cached_property
    def n0inv(self) -> int:
        """-modulus^-1 mod 2^LIMB_BITS (Montgomery m-factor)."""
        return (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @functools.cached_property
    def r_mod(self) -> int:
        """R mod modulus == to_mont(1)."""
        return MONT_R % self.modulus

    @functools.cached_property
    def r2_mod(self) -> int:
        """R^2 mod modulus (used by to_mont: mont_mul(a, R^2) = a*R)."""
        return (MONT_R * MONT_R) % self.modulus

    @functools.cached_property
    def r_mod_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r_mod)

    @functools.cached_property
    def r2_mod_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r2_mod)

    @functools.cached_property
    def inv_exponent(self) -> int:
        """Fermat inversion exponent modulus - 2."""
        return self.modulus - 2


FQ = FieldSpec("fq", Q)
FR = FieldSpec("fr", R)
