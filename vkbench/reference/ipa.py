"""The IPA (a Pedersen vector commitment with no trusted setup) and the
multiproof of SleepingShell/verkle-kzg in plain Python integers: the
basis by SHA-256 try-and-increment (``ipa/mod.rs:121-128``), the commit
(``:130-135``), the prover's halving loop with its generators folded in
point space (``:268-319``), and Dankrad Feist's multiproof over it
(``multiproof.rs:99-176``), with the upstream's conventions: an in-domain
point is the integer index (one-hot b), and the multiproof's h divides by
t - z for the integer z.

``truncate`` is the control: every scalar that meets a group element is cut
to its low 128 bits, which breaks the configuration's guarantee that
commitments and proofs bind full Fr elements.
"""

from __future__ import annotations

from . import bn254 as E
from .bn254 import R

LOW128 = (1 << 128) - 1


def _cut(ks: list, truncate: bool) -> list:
    return [k & LOW128 for k in ks] if truncate else ks


def basis(n: int, seed: bytes) -> tuple:
    """(g_0 .. g_{n-1}, q): the n + 1 first points of the generator."""
    pts = E.try_and_increment(seed, n + 1)
    return pts[:n], pts[n]


def commit(g: list, vals: list, truncate: bool = False):
    return E.msm(g[: len(vals)], _cut(vals, truncate))


def barycentric(point: int, omegas: list) -> list:
    """b_i: one-hot at an integer index below n, else
    ((z^n - 1) / n) w^i / (z - w^i)."""
    n = len(omegas)
    if 0 <= point < n:
        return [int(i == point) for i in range(n)]
    t = (pow(point, n, R) - 1) * pow(n, R - 2, R) % R
    inv = E.batch_inverse([(point - w) % R for w in omegas])
    return [t * w % R * d % R for w, d in zip(omegas, inv)]


def _inner(a: list, b: list) -> int:
    return sum(x * y for x, y in zip(a, b)) % R


def prove(g: list, q, commitment, point: int, a: list, omegas: list, tr: E.Transcript,
          truncate: bool = False) -> tuple:
    """The IPA opening of ``a`` at ``point`` against ``commitment``:
    -> (L points, R points, the final scalar, y = <a, b>)."""
    b = barycentric(point, omegas)
    y = _inner(a, b)
    tr.point(commitment, "C")
    tr.scalar(point % R, "input point")
    tr.scalar(y, "output point")
    w = tr.digest("w")
    qw = E.smul(q, w & LOW128 if truncate else w)
    ls, rs = [], []
    while len(a) > 1:
        h = len(a) // 2
        a_l, a_r, b_l, b_r, g_l, g_r = a[:h], a[h:], b[:h], b[h:], g[:h], g[h:]
        left = E.msm(g_r + [qw], _cut(a_l + [_inner(a_l, b_r)], truncate))
        right = E.msm(g_l + [qw], _cut(a_r + [_inner(a_r, b_l)], truncate))
        ls.append(left)
        rs.append(right)
        tr.point(left, "L")
        tr.point(right, "R")
        x = tr.digest("x")
        xg = x & LOW128 if truncate else x
        a = [(lo + x * hi) % R for lo, hi in zip(a_l, a_r)]
        b = [(lo + x * hi) % R for lo, hi in zip(b_r, b_l)]
        g = E.batch_to_affine([E.jmadd(E.smul_jac(hi, xg), lo) for lo, hi in zip(g_r, g_l)])
    return ls, rs, a[0], y


def _quotient(f: list, z: int, omegas: list) -> list:
    """(f(X) - f(w^z)) / (X - w^z) on the domain: (f_i - f_z) / (w^i - w^z)
    off z, and at z the sum of -q_i A'(w^z) / A'(w^i) = -q_i w^(i - z)."""
    n = len(f)
    inv = E.batch_inverse([(w - omegas[z]) % R for w in omegas])
    q = [(fi - f[z]) * d % R for fi, d in zip(f, inv)]
    q[z] = sum(-q[i] * omegas[(i - z) % n] for i in range(n)) % R
    return q


def multiproof(g: list, q, queries: list, omegas: list, truncate: bool = False) -> tuple:
    """queries: (values, commitment, z, y) with z an integer index.
    -> (D, (L points, R points, final scalar, y)) of the multiproof."""
    n = len(omegas)
    tr = E.Transcript("multiproof")
    for _, c, z, y in queries:
        tr.point(c, "C")
        tr.usize(z, "z")
        tr.scalar(y, "y")
    r = tr.digest("r")
    # sum over the queries at each point z of r^m f_m, kept per vector
    weights: dict = {}
    vectors: dict = {}
    rp = 1
    for vals, _, z, _ in queries:
        key = (id(vals), z)
        vectors[id(vals)] = vals
        weights[key] = (weights.get(key, 0) + rp) % R
        rp = rp * r % R
    grouped: dict = {}
    for (vid, z), wt in weights.items():
        row = grouped.setdefault(z, [0] * n)
        for i, v in enumerate(vectors[vid]):
            row[i] += wt * v
    grouped = {z: [v % R for v in row] for z, row in grouped.items()}
    gx = [0] * n
    for z, row in grouped.items():
        for i, v in enumerate(_quotient(row, z, omegas)):
            gx[i] += v
    gx = [v % R for v in gx]
    d = commit(g, gx, truncate)
    tr.point(d, "D")
    t = tr.digest("t")
    zs = sorted(grouped)
    inv = dict(zip(zs, E.batch_inverse([(t - z) % R for z in zs])))
    hx = [0] * n
    for z, row in grouped.items():
        for i, v in enumerate(row):
            hx[i] += v * inv[z]
    hx = [v % R for v in hx]
    e = commit(g, hx, truncate)
    tr.point(e, "E")
    diff = E.add(e, E.neg(d))
    return d, prove(g, q, diff, t, [(h - x) % R for h, x in zip(hx, gx)], omegas, tr, truncate)
