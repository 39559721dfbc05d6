"""Kernels K2 and K11's two regimes (verkle_kzg_tpu_torch.ops.cuda_curve):
the regime choice, and a Python model of each group schedule of
``csrc/warp_point.cuh``'s ``warp_add`` / ``warp_double`` (which thread of
a group of 4, 8 or 32 takes which Montgomery product at which level, the
sums each thread forms between the levels, the two passes a level of the
add on 4 threads), run on the plain field operations in the reduced domain
(K2, K11) and the lazy one (the K4/K7 tail, K5). The model's words are held
against the plain versions (``cuda_curve.plain`` / ``plain_double``, and
the lazy ``curve.add16`` / ``double16``) and against the JAX package's
``ops/curve.add`` / ``double``, on points made from a numpy seed with the
identity, P + P and P + (-P) among them.
"""

import numpy as np
import pytest
import torch

from verkle_kzg_tpu.hostmath import curve as hc
from verkle_kzg_tpu.ops import curve as JC
from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.ops import cuda_curve as KC
from verkle_kzg_tpu_torch.ops import cuda_lib
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F

torch.set_num_threads(1)

GROUP_SIZES = (4, 8, 32)


def _to_port(arr) -> torch.Tensor:
    """JAX (k, 16, N) coordinate planes -> port (N, k, 8) words."""
    arr = np.asarray(arr)
    return torch.stack([convert.limb_planes_to_tensor(arr[k], "cpu") for k in range(arr.shape[0])], dim=1)


@pytest.fixture(scope="module")
def points():
    """Host pairs (p, q) from a numpy seed: sums of two points in the JAX
    package and the port alike (Z != 1), lane 0 the identity + q, lane 1
    p + the identity, lane 2 P + P, lane 3 P + (-P), lane 4 the identity
    twice. Returns the JAX and port projective words of p and q."""
    rng = np.random.default_rng(170)
    n = 12
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=2 * n + 1)]
    base = [hc.g1_mul(hc.g1_generator(), k) for k in ks]
    a, b = base[:n], base[n : 2 * n]
    p = [hc.g1_add(x, y) for x, y in zip(a, b)]
    q = list(p[3:]) + list(p[:3])
    p[0], q[1], q[2], q[3], p[4], q[4] = None, None, p[2], hc.g1_neg(p[3]), None, None
    jp = JC.from_affine(JC.host_points_to_affine(p))
    jq = JC.from_affine(JC.host_points_to_affine(q))
    # Z != 1: each side doubled, in both packages
    jp, jq = JC.double(jp), JC.double(jq)
    pp, pq = KC.plain_double(_to_port(JC.from_affine(JC.host_points_to_affine(p)))), KC.plain_double(
        _to_port(JC.from_affine(JC.host_points_to_affine(q))))
    assert torch.equal(pp, _to_port(jp)) and torch.equal(pq, _to_port(jq))
    host = (C.projective_to_host_points(pp), C.projective_to_host_points(pq))
    return jp, jq, pp, pq, host


def _field(lazy: bool):
    mul = lambda a, b: F.mont_mul16(a, b, "fq", lazy)  # noqa: E731
    add = lambda a, b: F.add16(a, b, "fq", lazy)  # noqa: E731
    sub = lambda a, b: F.sub16(a, b, "fq", lazy)  # noqa: E731

    def mul9(x):
        t = add(x, x)
        t = add(t, t)
        t = add(t, t)
        return add(t, x)

    return mul, add, sub, mul9


def _passes(t: int, count: int, group: int) -> list:
    """The product slots thread t takes at a level of ``count`` products:
    ``for (p = t; p < count; p += G) { ...; if (G >= 6) break; }``."""
    slots = list(range(t, count, group))
    return slots[:1] if group >= 6 else slots


def model_add(acc, q, group: int, lazy: bool):
    """``warp_add<LAZY, G>`` on (N, 16) limb coordinates: (X, Y, Z) of acc
    and q -> the new acc and the trace [(level, thread, slot)] of its
    products."""
    mul, add, sub, mul9 = _field(lazy)
    trace, p1, p2 = [], [None] * 6, [None] * 6
    for t in range(group):  # X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2)
        for p in _passes(t, 6, group):
            i = p if p < 3 else (1 if p == 4 else 0)
            k = 1 if p == 3 else 2
            a, b = acc[i], q[i]
            if p >= 3:
                a, b = add(a, acc[k]), add(b, q[k])
            p1[p] = mul(a, b)
            trace.append((1, t, p))
    for t in range(min(group, 6)):  # every thread that takes a product forms the sums
        t0, t1, t2, t3, t4, y3 = p1
        t3 = sub(t3, add(t0, t1))
        t4 = sub(t4, add(t1, t2))
        y3 = mul9(sub(y3, add(t0, t2)))
        t0 = add(add(t0, t0), t0)
        t2 = mul9(t2)
        z3 = add(t1, t2)
        t1 = sub(t1, t2)
        for p in _passes(t, 6, group):  # t4 Y3, t3 t1, Y3 t0, t1 Z3, t0 t3, Z3 t4
            a = (t4, t3, y3, t1, t0, z3)[p]
            b = (y3, t1, t0, z3, t3, t4)[p]
            p2[p] = mul(a, b)
            trace.append((2, t, p))
    out = [sub(p2[1], p2[0]), add(p2[3], p2[2]), add(p2[5], p2[4])]  # threads 0-2
    return out, trace


def model_double(acc, group: int, lazy: bool):
    """``warp_double<LAZY>`` on (N, 16) limb coordinates -> the new acc and
    its products' trace."""
    mul, add, sub, mul9 = _field(lazy)
    X, Y, Z = acc
    trace, p1, p2 = [], [None] * 4, [None] * 4
    for t in range(min(group, 4)):  # Y Y, Y Z, Z Z, X Y
        a = X if t == 3 else (Z if t == 2 else Y)
        b = Y if t in (0, 3) else Z
        p1[t] = mul(a, b)
        trace.append((1, t, t))
    for t in range(min(group, 4)):
        t0, t1, t2, txy = p1
        z3 = add(t0, t0)
        z3 = add(z3, z3)
        z3 = add(z3, z3)
        t2 = mul9(t2)
        y3 = add(t0, t2)
        t0 = sub(t0, add(add(t2, t2), t2))
        a = (t2, t1, t0, t0)[t]
        b = (z3, z3, y3, txy)[t]
        p2[t] = mul(a, b)
        trace.append((2, t, t))
    zero = torch.zeros_like(p2[0])
    out = [add(p2[3], p2[3]), add(p2[0], p2[2]), add(p2[1], zero)]  # threads 0-2
    return out, trace


def _run(op: str, p: torch.Tensor, q: torch.Tensor, group: int, lazy: bool) -> tuple:
    """The model on (N, 3, 8) words -> (N, 3, 8) words and the trace."""
    acc = F.to_limbs(p).unbind(-2)
    if op == "add":
        out, trace = model_add(acc, F.to_limbs(q).unbind(-2), group, lazy)
    else:
        out, trace = model_double(acc, group, lazy)
    return F.from_limbs(torch.stack(out, -2)), trace


def test_regime_choice():
    """Up to SWITCH points a group of GROUP["few"] threads a point, above
    it GROUP["many"]; both sizes are ones the C entry points take, and the
    few-point group holds a level's products in one pass."""
    assert isinstance(KC.SWITCH, int) and KC.SWITCH >= 1
    assert [KC.regime(n) for n in (1, KC.SWITCH - 1, KC.SWITCH, KC.SWITCH + 1, 1 << 20)] == [
        "few", "few", "few", "many", "many"]
    assert set(KC.GROUP) == {"few", "many"} and set(KC.GROUP.values()) <= set(KC.GROUPS)
    assert KC.GROUP["few"] >= 6 and KC.GROUP["many"] < KC.GROUP["few"]
    assert set(KC.regime_launches) == {"K2", "K11", "K12"}


def test_cpu_takes_plain_and_counts_nothing(points):
    _, _, pp, pq, _ = points
    cuda_lib.reset_launches()
    KC.reset_regimes()
    assert torch.equal(KC.add(pp, pq), KC.plain(pp, pq))
    assert torch.equal(KC.double(pp), KC.plain_double(pp))
    assert cuda_lib.launches["K2"] == cuda_lib.launches["K11"] == 0
    assert KC.regime_launches == {k: {"few": 0, "many": 0} for k in ("K2", "K11", "K12")}


@pytest.mark.parametrize("op", ["add", "double"])
@pytest.mark.parametrize("group", GROUP_SIZES)
def test_schedule_threads_and_chain(points, op, group):
    """Each level's products are each taken once, by thread p mod G (one
    pass when G >= 6, two for the add on 4 threads), so a point's dependent
    chain is 2 products a level pass."""
    _, _, pp, pq, _ = points
    _, trace = _run(op, pp[:2], pq[:2], group, False)
    count = 6 if op == "add" else 4
    for level in (1, 2):
        slots = sorted(p for lv, _, p in trace if lv == level)
        assert slots == list(range(count))
        assert all(t == p % group for lv, t, p in trace if lv == level)
    passes = max(sum(1 for lv, t, _ in trace if lv == 1 and t == u) for u in range(group))
    assert passes == (2 if op == "add" and group == 4 else 1)


@pytest.mark.parametrize("op", ["add", "double"])
@pytest.mark.parametrize("group", GROUP_SIZES)
@pytest.mark.parametrize("lazy", [False, True], ids=["reduced", "lazy"])
def test_schedule_matches_plain(points, op, group, lazy):
    """The model's words in each domain are the plain versions' in it:
    reduced, K2's and K11's (``cuda_curve.plain`` / ``plain_double``, each
    intermediate canonical); lazy, the tail's and K5's (``add16`` /
    ``double16`` with ``lazy=True``, the same operations in the same order)."""
    _, _, pp, pq, host = points
    got, _ = _run(op, pp, pq, group, lazy)
    if lazy:
        lp, lq = F.to_limbs(pp), F.to_limbs(pq)
        want = F.from_limbs(C.add16(lp, lq, lazy=True) if op == "add" else C.double16(lp, lazy=True))
    else:
        want = KC.plain(pp, pq) if op == "add" else KC.plain_double(pp)
    assert torch.equal(got, want)
    hp, hq = host
    expect = [hc.g1_add(a, b) for a, b in zip(hp, hq)] if op == "add" else [hc.g1_add(a, a) for a in hp]
    assert C.projective_to_host_points(F.from_limbs(C.reduce16(F.to_limbs(got)))) == expect
    if op == "add":
        assert expect[0] == hq[0] and expect[1] == hp[1] and expect[3] is None and expect[4] is None


@pytest.mark.parametrize("op", ["add", "double"])
@pytest.mark.parametrize("group", GROUP_SIZES)
def test_reduced_schedule_matches_jax(points, op, group):
    """In the reduced domain each group schedule gives the JAX package's
    ``ops/curve.add`` / ``double`` words."""
    jp, jq, pp, pq, _ = points
    got, _ = _run(op, pp, pq, group, False)
    want = JC.add(jp, jq) if op == "add" else JC.double(jp)
    assert torch.equal(got, _to_port(want))


@pytest.mark.parametrize("op", ["add", "double"])
def test_lazy_reduced_once_gives_reduced_words(points, op):
    """Every lazy intermediate lies in [0, 2m) and is congruent to the
    reduced one, so the lazy result reduced once is the reduced domain's
    canonical words (what ``tools/point_probe.cu``'s lazy variants rest
    on)."""
    _, _, pp, pq, _ = points
    lazy, _ = _run(op, pp, pq, 8, True)
    reduced = KC.plain(pp, pq) if op == "add" else KC.plain_double(pp)
    assert torch.equal(F.from_limbs(C.reduce16(F.to_limbs(lazy))), reduced)
