"""BN254 G1 group law on word tensors, in PyTorch.

The counterpart of ``verkle_kzg_tpu/ops/curve.py``: the complete
projective formulas of Renes-Costello-Batina 2016 (algorithms 7-9, a = 0,
b3 = 9), the identity (0 : 1 : 0), and the affine (0, 0) sentinel for
infinity (not on the curve, since b = 3).

Layout: projective points ``(..., N, 3, 8)`` int32 (X, Y, Z in Montgomery
form), affine points ``(..., N, 2, 8)``, one point per row.

The formulas below run on 16-bit limbs (``(..., 3, 16)`` int64) and are
the plain versions of the group law in ``csrc/bn254_curve.cuh``: each
follows the same sequence of field operations as its Pallas twin in
``verkle_kzg_tpu/ops/pallas_curve.py``, so in the same domain (reduced or
lazy) all three give the same projective representative. On word tensors
``add``, ``double`` and ``mixed_add`` are kernels K2, K11 and K12
(``cuda_curve.py``), ``neg`` is a K1 subtraction, ``scalar_mul`` is kernel
G1SMUL (``cuda_g1_chain.py``), and ``scalar_mul_affine`` is kernel K5
(``cuda_scalar_mul.py``).
"""

from __future__ import annotations

import torch

from ..params import Q

from . import field as F

_FQ = "fq"


def _ops(lazy: bool):
    """Field ops for the formulas, each taking several operand pairs and
    running them as ONE batched tensor op: the plain versions are bound by
    the count of tensor ops, and the values do not depend on the batching."""

    def batched(fn):
        def run(*pairs):
            xs = torch.broadcast_tensors(*[v for pair in pairs for v in pair])
            return fn(torch.stack(xs[0::2]), torch.stack(xs[1::2]), _FQ, lazy).unbind(0)

        return run

    return batched(F.mont_mul16), batched(F.add16), batched(F.sub16)


def _finish(mul, add, sub, t0, t1, t2, t3, t4, Y3):
    """The common second half of RCB16 algorithms 7 and 8, from
    X3 = t0 + t0 on (``ops/curve.py::add`` lines ``X3 = fadd(t0, t0)``
    to the end), with the two x9 chains run side by side."""
    X3, t2x2, y2 = add((t0, t0), (t2, t2), (Y3, Y3))
    t0, t2x4, y4 = add((X3, t0), (t2x2, t2x2), (y2, y2))
    t2x8, y8 = add((t2x4, t2x4), (y4, y4))
    t2, Y3 = add((t2x8, t2), (y8, Y3))  # t2 = 9 t2, Y3 = 9 Y3
    (Z3,) = add((t1, t2))
    (t1,) = sub((t1, t2))
    X3, t2, Y3, t1, t0, Z3 = mul((t4, Y3), (t3, t1), (Y3, t0), (t1, Z3), (t0, t3), (Z3, t4))
    (X3,) = sub((t2, X3))
    Y3, Z3 = add((t1, Y3), (Z3, t0))
    return torch.stack([X3, Y3, Z3], dim=-2)


def add16(p: torch.Tensor, q: torch.Tensor, lazy: bool = False) -> torch.Tensor:
    """RCB16 algorithm 7 on (..., 3, 16) limbs (``k_point_add``, or
    ``k_point_add_lazy`` when ``lazy``): the same field operations on the
    same operands, independent ones batched together."""
    mul, add, sub = _ops(lazy)
    X1, Y1, Z1 = p.unbind(-2)
    X2, Y2, Z2 = q.unbind(-2)
    a1, a2, b1, b2, c1, c2 = add((X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2))
    t0, t1, t2, t3, t4, X3 = mul((X1, X2), (Y1, Y2), (Z1, Z2), (a1, a2), (b1, b2), (c1, c2))
    u1, u2, u3 = add((t0, t1), (t1, t2), (t0, t2))
    t3, t4, Y3 = sub((t3, u1), (t4, u2), (X3, u3))
    return _finish(mul, add, sub, t0, t1, t2, t3, t4, Y3)


def add_sparse(p: torch.Tensor, q: torch.Tensor, lazy: bool = False) -> torch.Tensor:
    """:func:`add16` on (..., 3, 8) words, computed only where p or q is not
    the identity's words (0, R mod m, 0): RCB16 maps that pair to the same
    words in both domains, so the result is the same. The plain versions of
    K2 and K4 meet mostly such pairs in wide bucket tables (2^15 rows a
    window at c = 16) and are bound by the rows they compute."""
    p, q = torch.broadcast_tensors(p, q)
    inf = infinity((), p.device)
    live = ~((p == inf) & (q == inf)).flatten(-2).all(-1)
    if bool(live.all()):
        return F.from_limbs(add16(F.to_limbs(p), F.to_limbs(q), lazy))
    out = p.clone()
    idx = live.nonzero(as_tuple=True)
    if idx[0].numel():
        out[idx] = F.from_limbs(add16(F.to_limbs(p[idx]), F.to_limbs(q[idx]), lazy))
    return out


def mixed_add16(p: torch.Tensor, q_aff: torch.Tensor, lazy: bool = False) -> torch.Tensor:
    """RCB16 algorithm 8 with q affine (Z2 = 1); the (0, 0) sentinel
    selects p (``k_point_mixed_add`` / ``k_point_mixed_add_lazy``)."""
    mul, add, sub = _ops(lazy)
    X1, Y1, Z1 = p.unbind(-2)
    X2, Y2 = q_aff.unbind(-2)
    a2, a1 = add((X2, Y2), (X1, Y1))
    t0, t1, t3, t4, Y3 = mul((X1, X2), (Y1, Y2), (a2, a1), (Y2, Z1), (X2, Z1))
    u, t4, Y3 = add((t0, t1), (t4, Y1), (Y3, X1))
    (t3,) = sub((t3, u))
    out = _finish(mul, add, sub, t0, t1, Z1, t3, t4, Y3)
    inf = (q_aff == 0).flatten(-2).all(-1)
    return torch.where(inf[..., None, None], p, out)


def double16(p: torch.Tensor, lazy: bool = False) -> torch.Tensor:
    """RCB16 algorithm 9 (``k_point_double`` / ``k_point_double_lazy``)."""
    mul, add, sub = _ops(lazy)
    X, Y, Z = p.unbind(-2)
    t0, t1, t2, txy = mul((Y, Y), (Y, Z), (Z, Z), (X, Y))
    z2, a = add((t0, t0), (t2, t2))
    z4, b = add((z2, z2), (a, a))
    Z3, c = add((z4, z4), (b, b))
    (t2,) = add((c, t2))  # 9 t2
    X3, Z3 = mul((t2, Z3), (t1, Z3))
    Y3, t1 = add((t0, t2), (t2, t2))
    (t2,) = add((t1, t2))
    (t0,) = sub((t0, t2))
    Y3, X3b = mul((t0, Y3), (t0, txy))
    Y3, X3 = add((X3, Y3), (X3b, X3b))
    return torch.stack([X3, Y3, Z3], dim=-2)


def reduce16(p: torch.Tensor) -> torch.Tensor:
    """Lazy [0, 2m) coordinates -> [0, m) (``k_point_reduce``)."""
    return F.cond_sub16(p, _FQ)


def infinity16(shape, device) -> torch.Tensor:
    """(*shape, 3, 16) limbs of the identity (0 : 1 : 0)."""
    one = torch.tensor(F._int_limbs(F.SPECS[_FQ].r_mod), dtype=torch.int64, device=device)
    p = torch.zeros(tuple(shape) + (3, F.LIMBS), dtype=torch.int64, device=device)
    p[..., 1, :] = one
    return p


# ---------------------------------------------------------------------------
# Public API on word tensors
# ---------------------------------------------------------------------------


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(..., 3, 8) + (..., 3, 8) -> (..., 3, 8), reduced coordinates. K2."""
    return _k2.add(p, q)


def double(p: torch.Tensor) -> torch.Tensor:
    """2p on (..., 3, 8) words (``ops/curve.py::double``). K11."""
    return _k2.double(p)


def mixed_add(p: torch.Tensor, q_aff: torch.Tensor) -> torch.Tensor:
    """p + q_aff, q_aff (..., 2, 8) affine with the (0, 0) sentinel
    (``ops/curve.py::mixed_add``). K12."""
    return _k2.mixed_add(p, q_aff)


def neg(p: torch.Tensor) -> torch.Tensor:
    """-p: Y negated (``ops/curve.py::neg``), through K1."""
    x, y, z = p.unbind(-2)
    return torch.stack([x, F.neg(y, _FQ), z], dim=-2)


def scalar_mul(p: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Double-and-add (``ops/curve.py::scalar_mul``): (..., 3, 8) projective
    points x (..., 8) standard scalars, reduced domain, in one G1SMUL launch.
    Its rounds are the JAX package's XLA scan step for step (a doubling, a
    complete add and a select a bit, MSB first; only steps that leave the
    words as they are skipped), so the projective coordinates are the same."""
    return _g1.scalar_mul(p, scalars)


def scalar_mul_affine(pts: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """(n, 2, 8) canonical affine x (n, 8) standard scalars -> (n, 3, 8)
    reduced projective products (``pallas_curve.scalar_mul_affine``). K5."""
    return _k5.scalar_mul_affine(pts, scalars)


def affine_is_infinity(a: torch.Tensor) -> torch.Tensor:
    """(..., 2, 8) affine -> (...) bool: the (0, 0) sentinel."""
    return (a == 0).flatten(-2).all(-1)


def scalar_bits_msb(scalars: torch.Tensor) -> torch.Tensor:
    """(..., 8) standard scalar words -> (256, ...) int64 bits, MSB first."""
    v = scalars.to(torch.int64) & 0xFFFFFFFF
    bits = (v[..., None] >> torch.arange(32, device=v.device)) & 1  # bit j of word w
    return bits.flatten(-2).flip(-1).movedim(-1, 0)


def infinity(shape, device) -> torch.Tensor:
    """(*shape, 3, 8) words of the identity (0 : 1 : 0)."""
    return F.from_limbs(infinity16((), device)).expand(tuple(shape) + (3, F.WORDS)).clone()


def from_affine(a: torch.Tensor) -> torch.Tensor:
    """(..., 2, 8) affine with the (0, 0) sentinel -> (..., 3, 8) projective."""
    one = F.const_words(F.SPECS[_FQ].r_mod, a.device)
    inf = affine_is_infinity(a)[..., None]
    x, y = a.unbind(-2)
    y = torch.where(inf, one, y)
    z = torch.where(inf, torch.zeros_like(one), one).expand_as(x)
    return torch.stack([x, y, z], dim=-2)


def to_affine(p: torch.Tensor) -> torch.Tensor:
    """(..., 3, 8) projective -> (..., 2, 8) canonical affine, (0, 0) for
    infinity (``ops/curve.py::to_affine``): one Fermat inversion of Z per
    point through K1. Z = 0 inverts to 0, which zeroes both coordinates."""
    x, y, z = p.unbind(-2)
    zinv = F.inv_mont(z, _FQ)
    return torch.stack([F.mont_mul(x, zinv, _FQ), F.mont_mul(y, zinv, _FQ)], dim=-2)


def host_points_to_affine(points, device) -> torch.Tensor:
    """Host affine points ((x, y) ints or None) -> (N, 2, 8) Montgomery words
    with the (0, 0) sentinel."""
    coords = []
    for pt in points:
        coords.extend((0, 0) if pt is None else ((pt[0] << 256) % Q, (pt[1] << 256) % Q))
    return F.ints_to_words(coords, device).reshape(len(points), 2, F.WORDS)


def projective_to_host_points(p: torch.Tensor) -> list:
    """(..., 3, 8) projective -> flat list of canonical host affine points
    (None for infinity), computed with python ints on the host."""
    xyz = F.words_to_ints(p)
    rinv = pow(1 << 256, -1, Q)
    out = []
    for i in range(0, len(xyz), 3):
        x, y, z = (v * rinv % Q for v in xyz[i : i + 3])
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, Q)
        out.append((x * zi % Q, y * zi % Q))
    return out


from . import cuda_curve as _k2  # noqa: E402  (K2 wrapper; it imports this module)
from . import cuda_scalar_mul as _k5  # noqa: E402  (K5 wrapper; it imports this module)
from . import cuda_g1_chain as _g1  # noqa: E402  (G1SMUL wrapper; it imports this module)
