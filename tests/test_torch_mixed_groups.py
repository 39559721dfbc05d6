"""Kernel K12's two regimes (verkle_kzg_tpu_torch.ops.cuda_curve.mixed_add):
the regime choice, and a Python model of ``csrc/warp_point.cuh``'s
``warp_mixed_add<G>`` as the few-point regime runs it (``curve.cu``'s
``point_group_kernel`` with a group of 4, 8 or 32 threads a point): which
thread takes which Montgomery product at which level, the sums each thread
forms between the levels, the two passes a level on 4 threads, the
``keep`` flag that leaves a (0, 0) sentinel lane's point as it was, and
the one reduction of each coordinate at the end, on the plain lazy field
operations. Its words are held against the plain version
(``cuda_curve.plain_mixed_add``), the lazy plain body the many-point regime
and the sorted sums run (``curve.mixed_add16(..., lazy=True)``), the JAX
package's ``ops/curve.mixed_add`` and the host oracle, on points made from
a numpy seed with the sentinel, the identity + Q, P + P and P + (-P) among
them.
"""

import numpy as np
import pytest
import torch
from test_torch_point_groups import _field, _passes, _to_port

from verkle_kzg_tpu.hostmath import curve as hc
from verkle_kzg_tpu.ops import curve as JC
from verkle_kzg_tpu_torch.ops import cuda_curve as KC
from verkle_kzg_tpu_torch.ops import cuda_lib
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F

torch.set_num_threads(1)

GROUP_SIZES = (4, 8, 32)
SENTINELS = (1, 4, 9)  # lane 9 shares a warp of 8-thread groups with live lanes 8, 10 and 11


@pytest.fixture(scope="module")
def points():
    """Projective p (Z != 1: doubled, in both packages) and affine q from a
    numpy seed: lane 0 the identity + q, lane 1 p + the (0, 0) sentinel,
    lane 2 P + P, lane 3 P + (-P), lane 4 the identity + the sentinel,
    lane 9 another sentinel. Returns the JAX and port words and the host
    points of both."""
    rng = np.random.default_rng(180)
    n = 12
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=2 * n)]
    host_p = [hc.g1_mul(hc.g1_generator(), k) for k in ks[:n]]
    host_p[0] = host_p[4] = None
    jp = JC.double(JC.from_affine(JC.host_points_to_affine(host_p)))
    pp = KC.plain_double(_to_port(JC.from_affine(JC.host_points_to_affine(host_p))))
    assert torch.equal(pp, _to_port(jp))
    doubled = C.projective_to_host_points(pp)
    host_q = [hc.g1_mul(hc.g1_generator(), k) for k in ks[n:]]
    host_q[2], host_q[3] = doubled[2], hc.g1_neg(doubled[3])
    for i in SENTINELS:
        host_q[i] = None
    jq = JC.host_points_to_affine(host_q)
    return jp, jq, pp, _to_port(jq), doubled, host_q


def model_mixed(acc, q, group: int):
    """``warp_mixed_add<G>`` on (N, 16) limbs, lazy: (X1, Y1, Z1) of acc
    and the affine (x, y) of q -> the new acc (each lane's acc as it was
    where q is the (0, 0) sentinel, ``keep`` false), unreduced, and the
    trace [(level, thread, slot)] of its products."""
    mul, add, sub, mul9 = _field(True)
    X1, Y1, Z1 = acc
    x, y = q
    trace, p1, p2 = [], [None] * 5, [None] * 6
    for t in range(group):  # X1 x, Y1 y, (X1 + Y1)(x + y), Z1 y, Z1 x
        for p in _passes(t, 5, group):
            a = (X1, Y1, X1, Z1, Z1)[p]
            b = (x, y, x, y, x)[p]
            if p == 2:
                a, b = add(a, Y1), add(b, y)
            p1[p] = mul(a, b)
            trace.append((1, t, p))
    for t in range(min(group, 6)):  # every thread that takes a product forms the sums
        t0, t1, t3, t4, y3 = p1
        t3 = sub(t3, add(t0, t1))
        t4 = add(t4, Y1)  # y Z1 + Y1
        y3 = add(y3, X1)  # x Z1 + X1
        t0 = add(add(t0, t0), t0)
        t2 = mul9(Z1)
        z3 = add(t1, t2)
        t1 = sub(t1, t2)
        y3 = mul9(y3)
        for p in _passes(t, 6, group):  # t4 Y3, t3 t1, Y3 t0, t1 Z3, t0 t3, Z3 t4
            a = (t4, t3, y3, t1, t0, z3)[p]
            b = (y3, t1, t0, z3, t3, t4)[p]
            p2[p] = mul(a, b)
            trace.append((2, t, p))
    out = torch.stack([sub(p2[1], p2[0]), add(p2[3], p2[2]), add(p2[5], p2[4])], -2)  # threads 0-2
    keep = ~(q[0] == 0).all(-1) | ~(q[1] == 0).all(-1)
    return torch.where(keep[:, None, None], out, torch.stack(acc, -2)), keep, trace


def _run(p: torch.Tensor, q: torch.Tensor, group: int, reduce: bool = True) -> tuple:
    """The group kernel's model on (N, 3, 8) and (N, 2, 8) words -> (N, 3,
    8) words and the trace; ``reduce``: threads 0-2 reduce each coordinate
    once where ``keep``, as the kernel stores it."""
    acc, keep, trace = model_mixed(F.to_limbs(p).unbind(-2), F.to_limbs(q).unbind(-2), group)
    if reduce:
        acc = torch.where(keep[:, None, None], C.reduce16(acc), acc)
    return F.from_limbs(acc), trace


def test_regime_choice():
    """K12 shares K2's and K11's switch: up to SWITCH points a group of
    GROUP["few"] threads a point, above it GROUP["many"], counted under its
    own key."""
    assert [KC.regime(n) for n in (1, KC.SWITCH - 1, KC.SWITCH, KC.SWITCH + 1)] == ["few", "few", "few", "many"]
    assert KC.GROUP["few"] in KC.GROUPS and KC.GROUP["many"] == 1
    assert set(KC.regime_launches) == {"K2", "K11", "K12"}


def test_cpu_takes_plain_and_counts_nothing(points):
    _, _, pp, qa, _, _ = points
    cuda_lib.reset_launches()
    KC.reset_regimes()
    assert torch.equal(KC.mixed_add(pp, qa), KC.plain_mixed_add(pp, qa))
    assert torch.equal(C.mixed_add(pp[:1], qa), KC.plain_mixed_add(pp[:1].expand_as(pp), qa))
    assert cuda_lib.launches["K12"] == 0 and KC.regime_launches["K12"] == {"few": 0, "many": 0}


@pytest.mark.parametrize("group", GROUP_SIZES)
def test_schedule_threads_and_chain(points, group):
    """Level 1's five products and level 2's six are each taken once, by
    thread p mod G: one pass a level on 8 or 32 threads, two on 4, so a
    point's dependent chain is 2 products (4 on a group of 4)."""
    _, _, pp, qa, _, _ = points
    _, trace = _run(pp[:2], qa[:2], group)
    for level, count in ((1, 5), (2, 6)):
        slots = sorted(p for lv, _, p in trace if lv == level)
        assert slots == list(range(count))
        assert all(t == p % group for lv, t, p in trace if lv == level)
    chain = sum(max(sum(1 for lv, t, _ in trace if lv == level and t == u) for u in range(group)) for level in (1, 2))
    assert chain == (4 if group == 4 else 2)


@pytest.mark.parametrize("group", GROUP_SIZES)
def test_schedule_matches_plain_and_host(points, group):
    """Lazy, reduced once where keep, the model's words are the plain
    version's (reduced domain, each intermediate canonical), and its points
    the host oracle's sums; the sentinel lanes keep p."""
    _, _, pp, qa, doubled, host_q = points
    got, _ = _run(pp, qa, group)
    assert torch.equal(got, KC.plain_mixed_add(pp, qa))
    expect = [hc.g1_add(a, b) for a, b in zip(doubled, host_q)]
    assert C.projective_to_host_points(got) == expect
    assert expect[0] == host_q[0] and expect[3] is None
    for i in SENTINELS:
        assert torch.equal(got[i], pp[i])


@pytest.mark.parametrize("group", GROUP_SIZES)
def test_schedule_matches_jax(points, group):
    """The model's words are the JAX package's ``ops/curve.mixed_add``."""
    jp, jq, pp, qa, _, _ = points
    got, _ = _run(pp, qa, group)
    assert torch.equal(got, _to_port(JC.mixed_add(jp, jq)))


@pytest.mark.parametrize("group", GROUP_SIZES)
def test_lazy_schedule_is_the_sums_body(points, group):
    """Before its reduction the model's lanes hold the lazy plain body's
    words (``mixed_add16(..., lazy=True)``, ``point_mixed_add<true>`` of the
    sorted sums and the many-point regime), and that body reduced once is
    the plain version's: the two regimes store the same words."""
    _, _, pp, qa, _, _ = points
    lazy = F.from_limbs(C.mixed_add16(F.to_limbs(pp), F.to_limbs(qa), lazy=True))
    unreduced, _ = _run(pp, qa, group, reduce=False)
    assert torch.equal(unreduced, lazy)
    assert not torch.equal(lazy, KC.plain_mixed_add(pp, qa))  # some lazy word lies in [m, 2m)
    assert torch.equal(F.from_limbs(C.reduce16(F.to_limbs(lazy))), KC.plain_mixed_add(pp, qa))
