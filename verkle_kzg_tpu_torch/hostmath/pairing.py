"""BN254 optimal-ate pairing, exact host-side implementation.

Used only by KZG verification (two pairings per verify, O(1) size), matching
where the reference calls ``ark_ec::pairing::Pairing``
(``vector-commit/src/kzg/mod.rs:182-186``). Written from the standard
optimal-ate construction for BN curves:

    e(P, Q) = f_{6x+2, Q}(P) * l_{T, pi(Q)}(P) * l_{T', -pi^2(Q)}(P)
              raised to (q^12 - 1) / r

The Miller loop runs on the *untwisted* image of Q in E(Fq12) with affine
line functions. This is the port's own copy of
``verkle_kzg_tpu/hostmath/pairing.py``. ``multi_pairing`` takes the port's
``native.py`` C++ pairing first and this Python loop only where the
native library is unavailable; ``tests/test_torch_kzg.py`` runs KZG
verify through both.
"""

from __future__ import annotations

from ..params import ATE_LOOP_COUNT, Q, R
from .field import Fq2, Fq6, Fq12


def _untwist(q):
    """E'(Fq2) -> E(Fq12): (x, y) -> (v * x, w^3 * y) with w^2 = v, v^3 = xi."""
    x, y = q
    zero2 = Fq2.zero()
    x12 = Fq12(Fq6(zero2, x, zero2), Fq6.zero())
    y12 = Fq12(Fq6.zero(), Fq6(zero2, y, zero2))
    return (x12, y12)


def _embed_g1(p):
    x, y = p
    return (Fq12.from_fq(x), Fq12.from_fq(y))


def _line(t, q, p):
    """Evaluate at p the line through t and q (tangent if t == q), all in
    E(Fq12) affine. Returns an Fq12 value. Assumes no input is infinity."""
    x1, y1 = t
    x2, y2 = q
    xp, yp = p
    if x1 == x2 and y1 == y2:
        lam = (x1 * x1 * 3) * ((y1 + y1).inv())
    elif x1 == x2:
        # vertical line x - x1
        return xp - x1
    else:
        lam = (y2 - y1) * ((x2 - x1).inv())
    return (yp - y1) - lam * (xp - x1)


def _add_e12(t, q):
    x1, y1 = t
    x2, y2 = q
    if x1 == x2 and y1 == y2:
        lam = (x1 * x1 * 3) * ((y1 + y1).inv())
    elif x1 == x2:
        return None
    else:
        lam = (y2 - y1) * ((x2 - x1).inv())
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def _frob_point(pt):
    x, y = pt
    return (x.pow(Q), y.pow(Q))


def miller_loop(p, q) -> Fq12:
    """f_{6x+2,Q}(P) with the two optimal-ate correction lines.

    p: G1 affine (ints), q: G2 affine (Fq2). Either None -> 1.
    """
    if p is None or q is None:
        return Fq12.one()
    pe = _embed_g1(p)
    qe = _untwist(q)

    f = Fq12.one()
    t = qe
    bits = bin(ATE_LOOP_COUNT)[3:]  # skip leading 1
    for bit in bits:
        f = f.square() * _line(t, t, pe)
        t = _add_e12(t, t)
        if bit == "1":
            f = f * _line(t, qe, pe)
            t = _add_e12(t, qe)

    q1 = _frob_point(qe)
    q2 = _frob_point(q1)
    nq2 = (q2[0], -q2[1])

    f = f * _line(t, q1, pe)
    t = _add_e12(t, q1)
    f = f * _line(t, nq2, pe)
    return f


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((q^12 - 1) / r), easy part via conjugation/inversion then a plain
    square-and-multiply for the hard part (q^4 - q^2 + 1)/r."""
    # easy part: f^(q^6 - 1) then ^(q^2 + 1)
    f1 = f.conjugate() * f.inv()  # ^(q^6 - 1)
    f2 = f1.pow(Q * Q) * f1  # ^(q^2 + 1)
    hard = (Q**4 - Q**2 + 1) // R
    return f2.pow(hard)


def _fq12_from_coeffs(vals) -> Fq12:
    c2s = [Fq2(vals[2 * i], vals[2 * i + 1]) for i in range(6)]
    return Fq12(Fq6(*c2s[:3]), Fq6(*c2s[3:]))


def multi_pairing(pairs) -> Fq12:
    """Product of pairings with one shared final exponentiation: the C++
    pairing (``native.py``) where its library loads, else the Python loop
    of this module."""
    from .. import native

    vals = native.multi_pairing(pairs)
    if vals is not None:
        return _fq12_from_coeffs(vals)
    f = Fq12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f)
