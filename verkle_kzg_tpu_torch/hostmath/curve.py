"""Exact host-side BN254 group operations (affine, python bigints).

G1 points are ``(x, y)`` int tuples, G2 points ``(x, y)`` Fq2 tuples; the
point at infinity is ``None``. Used for setup/oracle paths; the batched hot
path lives on device in ``verkle_kzg_tpu.ops.curve``.

Mirrors the capabilities the reference pulls from ark_ec (see SURVEY.md
section 2.3 item 2; e.g. ``vector-commit/src/ipa/mod.rs:3``).
"""

from __future__ import annotations

from ..params import B, G1_GENERATOR, G2_GENERATOR_X, G2_GENERATOR_Y, Q, R
from .field import Fq2, fq_inv, fq_sqrt

# ---------------------------------------------------------------------------
# Generic short-Weierstrass affine ops, parametric in the coordinate field.
# fieldops = (add, sub, mul, inv, eq_zero) closures.
# ---------------------------------------------------------------------------


def _g1_ops():
    return (
        lambda a, b: (a + b) % Q,
        lambda a, b: (a - b) % Q,
        lambda a, b: (a * b) % Q,
        fq_inv,
        lambda a: a % Q == 0,
    )


def _g2_ops():
    return (
        lambda a, b: a + b,
        lambda a, b: a - b,
        lambda a, b: a * b,
        lambda a: a.inv(),
        lambda a: a.is_zero(),
    )


def _add(p, q, ops):
    add, sub, mul, inv, is0 = ops
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if is0(sub(x1, x2)):
        if is0(add(y1, y2)):
            return None  # p == -q
        # doubling: lambda = 3x^2 / 2y
        num = mul(3, mul(x1, x1)) if isinstance(x1, int) else mul(x1, x1) * 3
        lam = mul(num, inv(add(y1, y1)))
    else:
        lam = mul(sub(y2, y1), inv(sub(x2, x1)))
    x3 = sub(sub(mul(lam, lam), x1), x2)
    y3 = sub(mul(lam, sub(x1, x3)), y1)
    return (x3, y3)


def _neg(p, ops):
    if p is None:
        return None
    _, sub, _, _, _ = ops
    x, y = p
    zero = 0 if isinstance(y, int) else Fq2.zero()
    return (x, sub(zero, y))


def _mul(p, k, ops):
    k %= R
    result = None
    addend = p
    while k:
        if k & 1:
            result = _add(result, addend, ops)
        addend = _add(addend, addend, ops)
        k >>= 1
    return result


# ---------------------------------------------------------------------------
# G1
# ---------------------------------------------------------------------------

_G1OPS = _g1_ops()


def g1_add(p, q):
    return _add(p, q, _G1OPS)


def g1_neg(p):
    return _neg(p, _G1OPS)


def g1_mul(p, k: int):
    return _mul(p, k, _G1OPS)


def g1_generator():
    return G1_GENERATOR


def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B) % Q == 0


def g1_msm_naive(points, scalars):
    """Reference-semantics MSM: serial fold of scalar*point products,
    mirroring ``inner_product`` in ``vector-commit/src/utils.rs:16-19``."""
    acc = None
    for p, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(p, s))
    return acc


def g1_from_x(x: int, greatest: bool):
    """Point with given x, selecting the lexicographically larger y when
    ``greatest`` (ark_ec get_point_from_x_unchecked semantics)."""
    y = fq_sqrt((x * x % Q * x + B) % Q)
    if y is None:
        return None
    neg_y = (Q - y) % Q
    hi, lo = (y, neg_y) if y > neg_y else (neg_y, y)
    return (x, hi if greatest else lo)


# ---------------------------------------------------------------------------
# G2 (on the D-twist y^2 = x^3 + 3/(9+u))
# ---------------------------------------------------------------------------

_G2OPS = _g2_ops()

TWIST_B = Fq2(3, 0) * Fq2.xi().inv()


def g2_generator():
    return (
        Fq2(G2_GENERATOR_X[0], G2_GENERATOR_X[1]),
        Fq2(G2_GENERATOR_Y[0], G2_GENERATOR_Y[1]),
    )


def g2_add(p, q):
    return _add(p, q, _G2OPS)


def g2_neg(p):
    return _neg(p, _G2OPS)


def g2_mul(p, k: int):
    return _mul(p, k, _G2OPS)


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - TWIST_B).is_zero()
