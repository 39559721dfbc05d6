"""Exact host-side BN254 field arithmetic (python bigints).

This is the oracle layer: every TPU kernel in ``verkle_kzg_tpu.ops`` is tested
bit-for-bit against these functions. It also *is* the production path for the
O(1)-sized host computations (pairings in KZG verify, transcript hashing,
CRS hash-to-curve), mirroring what the reference delegates to arkworks
(``vector-commit/Cargo.toml:12-16``).

Tower layout (standard BN254):
    Fq2  = Fq[u]  / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi),  xi = 9 + u
    Fq12 = Fq6[w] / (w^2 - v)
"""

from __future__ import annotations

from ..params import Q, R
from ..utils.metrics import span

# ---------------------------------------------------------------------------
# Prime fields as plain ints
# ---------------------------------------------------------------------------


def fq(x: int) -> int:
    return x % Q


def fr(x: int) -> int:
    return x % R


def fq_inv(x: int) -> int:
    if x % Q == 0:
        raise ZeroDivisionError("inverse of 0 in Fq")
    return pow(x, Q - 2, Q)


def fr_inv(x: int) -> int:
    if x % R == 0:
        raise ZeroDivisionError("inverse of 0 in Fr")
    return pow(x, R - 2, R)


def fq_sqrt(x: int):
    """Square root in Fq (q = 3 mod 4), or None if non-residue."""
    x %= Q
    root = pow(x, (Q + 1) // 4, Q)
    if root * root % Q != x:
        return None
    return root


@span("protocol", "fr_batch_inverse")
def fr_batch_inverse(xs):
    """Montgomery's trick, matching ark_ff::batch_inversion semantics:
    zero entries are left untouched (arkworks skips zeros)."""
    return _batch_inverse(xs, R)


def fq_batch_inverse(xs):
    return _batch_inverse(xs, Q)


def _batch_inverse(xs, m):
    prefix = []
    acc = 1
    for x in xs:
        prefix.append(acc)
        if x % m != 0:
            acc = acc * x % m
    inv = pow(acc, m - 2, m)
    out = list(xs)
    for i in range(len(xs) - 1, -1, -1):
        if xs[i] % m != 0:
            out[i] = inv * prefix[i] % m
            inv = inv * xs[i] % m
    return out


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------


class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % Q
        self.c1 = c1 % Q

    # xi = 9 + u, the Fq6 non-residue
    @staticmethod
    def xi() -> "Fq2":
        return Fq2(9, 1)

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(0, 0)

    @staticmethod
    def one() -> "Fq2":
        return Fq2(1, 0)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, other) -> bool:
        return self.c0 == other.c0 and self.c1 == other.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        # (a0 + a1 u)(b0 + b1 u) = a0b0 - a1b1 + (a0b1 + a1b0) u
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        return Fq2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    __rmul__ = __mul__

    def square(self) -> "Fq2":
        return self * self

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def inv(self) -> "Fq2":
        # 1/(a + bu) = (a - bu) / (a^2 + b^2)
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % Q
        n = fq_inv(norm)
        return Fq2(self.c0 * n, -self.c1 * n)

    def pow(self, e: int) -> "Fq2":
        result, base = Fq2.one(), self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def frobenius(self) -> "Fq2":
        """x^q == conjugate in Fq2."""
        return self.conjugate()

    def __repr__(self):
        return f"Fq2({self.c0}, {self.c1})"


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v] / (v^3 - xi)
# ---------------------------------------------------------------------------


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o) -> bool:
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o) -> "Fq6":
        if isinstance(o, (int, Fq2)):
            return Fq6(self.c0 * o, self.c1 * o, self.c2 * o)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        xi = Fq2.xi()
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = t0 + xi * ((a1 + a2) * (b1 + b2) - t1 - t2)
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + xi * t2
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def mul_by_v(self) -> "Fq6":
        """Multiply by v (shift with xi wrap)."""
        return Fq6(self.c2 * Fq2.xi(), self.c0, self.c1)

    def inv(self) -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        xi = Fq2.xi()
        t0 = a0 * a0 - xi * (a1 * a2)
        t1 = xi * (a2 * a2) - a0 * a1
        t2 = a1 * a1 - a0 * a2
        norm = a0 * t0 + xi * (a2 * t1) + xi * (a1 * t2)
        n = norm.inv()
        return Fq6(t0 * n, t1 * n, t2 * n)


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w] / (w^2 - v)
# ---------------------------------------------------------------------------


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.one(), Fq6.zero())

    @staticmethod
    def zero() -> "Fq12":
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def from_fq(x: int) -> "Fq12":
        return Fq12(Fq6(Fq2(x, 0), Fq2.zero(), Fq2.zero()), Fq6.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, o) -> bool:
        return self.c0 == o.c0 and self.c1 == o.c1

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq12":
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o) -> "Fq12":
        if isinstance(o, (int, Fq2)):
            return Fq12(self.c0 * o, self.c1 * o)
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def square(self) -> "Fq12":
        return self * self

    def conjugate(self) -> "Fq12":
        """x -> x^(q^6): negates the w coefficient."""
        return Fq12(self.c0, -self.c1)

    def inv(self) -> "Fq12":
        a0, a1 = self.c0, self.c1
        norm = a0 * a0 - (a1 * a1).mul_by_v()
        n = norm.inv()
        return Fq12(a0 * n, -(a1 * n))

    def pow(self, e: int) -> "Fq12":
        if e < 0:
            return self.inv().pow(-e)
        result, base = Fq12.one(), self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def frobenius(self) -> "Fq12":
        """x -> x^q, computed generically (correct, not fast)."""
        return self.pow(Q)
