"""G1SMUL's and G1BFLY's group schedule (``csrc/g1_chain.cu``) as a Python
model, held word for word against their plain versions
(``cuda_g1_chain.plain_scalar_mul`` / ``plain_butterfly``) on the CPU.

The model runs what the kernels run, in Python ints: a lane a group of G
threads, 32 / G groups a warp; the rounds from the warp's highest set bit
over its groups down, a doubling a round after the first; the add on a
round where any group of the warp has the bit set, kept only by the groups
whose bit is set; ``warp_double<true>`` / ``warp_add<true, G>``'s field
operations in their order in the lazy domain ([0, 2m)); each coordinate
reduced once at the end. G1BFLY's butterflies are j-major and its -t
negates the reduced Y. Scalars 0, 1, r - 1 and a 56-bit one sit in one
warp beside random ones, and the identity among the points, so one warp's
groups differ in top bit and in bits. No JAX: the plain versions are held
to the JAX scan in ``test_torch_g1_chain.py``.
"""

import inspect

import numpy as np
import pytest
import torch

from verkle_kzg_tpu_torch.hostmath import curve as hc
from verkle_kzg_tpu_torch.ops import cuda_g1_chain as G
from verkle_kzg_tpu_torch.ops import cuda_lib
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import ntt as N
from verkle_kzg_tpu_torch.params import Q, R
from verkle_kzg_tpu_torch.tools.point_regimes import dependent_chain

torch.set_num_threads(1)

M2 = 2 * Q
RADIX = 1 << 256
NPRIME = -pow(Q, -1, RADIX) % RADIX
MONT_ONE = RADIX % Q
WARP = 32


def mul(a: int, b: int) -> int:
    """fmul<Fq, true>: the Montgomery product with no final subtraction
    (the word-by-word CIOS gives this integer: its quotient is the unique
    one below 2^256)."""
    t = a * b
    return (t + (t * NPRIME % RADIX) * Q) >> 256


def add(a: int, b: int) -> int:
    s = a + b
    return s - M2 if s >= M2 else s


def sub(a: int, b: int) -> int:
    return a - b + M2 if a < b else a - b


def mul9(x: int) -> int:
    t = add(x, x)
    t = add(t, t)
    t = add(t, t)
    return add(t, x)


def warp_double(p: tuple) -> tuple:
    """``warp_double<true>``'s products and sums, in its order."""
    x, y, z = p
    t0, t1, t2, txy = mul(y, y), mul(y, z), mul(z, z), mul(x, y)
    z3 = add(t0, t0)
    z3 = add(z3, z3)
    z3 = add(z3, z3)
    t2 = mul9(t2)
    y3 = add(t0, t2)
    u = add(t2, t2)
    u = add(u, t2)
    t0 = sub(t0, u)
    a, b, c, d = mul(t2, z3), mul(t1, z3), mul(t0, y3), mul(t0, txy)
    return add(d, d), add(a, c), add(b, 0)


def warp_add(p: tuple, q: tuple) -> tuple:
    """``warp_add<true, G>``'s products and sums, in its order."""
    (x1, y1, z1), (x2, y2, z2) = p, q
    t0, t1, t2 = mul(x1, x2), mul(y1, y2), mul(z1, z2)
    t3 = mul(add(x1, y1), add(x2, y2))
    t4 = mul(add(y1, z1), add(y2, z2))
    y3 = mul(add(x1, z1), add(x2, z2))
    t3 = sub(t3, add(t0, t1))
    t4 = sub(t4, add(t1, t2))
    y3 = mul9(sub(y3, add(t0, t2)))
    t0 = add(add(t0, t0), t0)
    t2 = mul9(t2)
    z3 = add(t1, t2)
    t1 = sub(t1, t2)
    p2 = [mul(t4, y3), mul(t3, t1), mul(y3, t0), mul(t1, z3), mul(t0, t3), mul(z3, t4)]
    return sub(p2[1], p2[0]), add(p2[3], p2[2]), add(p2[5], p2[4])


def reduced(p: tuple) -> tuple:
    """cond_sub<Fq, false> on each coordinate."""
    return tuple(v - Q if v >= Q else v for v in p)


def model_scalar_mul(points: list, scalars: list, group: int) -> tuple:
    """G1SMUL's schedule over lanes in launch order: -> (the lazy
    accumulators, the most point operations any warp ran). A warp's last
    groups past the lanes take the scalar 0."""
    per = WARP // group
    out, chain = [], 0
    for w0 in range(0, len(scalars), per):
        ks, ps = scalars[w0 : w0 + per], points[w0 : w0 + per]
        ks = ks + [0] * (per - len(ks))
        anyk = 0
        for k in ks:
            anyk |= k
        accs = [(0, MONT_ONE, 0)] * len(ps)
        ops = 0
        for b in range(anyk.bit_length() - 1, -1, -1):
            if b < anyk.bit_length() - 1:
                accs = [warp_double(a) for a in accs]
                ops += 1
            if (anyk >> b) & 1:
                accs = [warp_add(a, p) if (k >> b) & 1 else a for a, p, k in zip(accs, ps, ks)]
                ops += 1
        out += accs
        chain = max(chain, ops)
    return out, chain


def bfly_lanes(n: int, stage: int) -> list:
    """(j, u index) of G1BFLY's butterflies in launch order: j-major."""
    half, nblk = 1 << stage, n >> (stage + 1)
    return [(g // nblk, (g % nblk) * 2 * half + g // nblk) for g in range(n // 2)]


def model_butterfly(x: list, tw: list, stage: int, group: int) -> tuple:
    """G1BFLY's schedule: -> (the (n, 3) coordinates out, the chain)."""
    half = 1 << stage
    lanes = bfly_lanes(len(x), stage)
    ts, chain = model_scalar_mul([x[lo + half] for _, lo in lanes], [tw[j] for j, _ in lanes], group)
    out = [None] * len(x)
    for (_, lo), t in zip(lanes, ts):
        t = reduced(t)
        neg = (t[0], (Q - t[1]) % Q, t[2])
        out[lo] = reduced(warp_add(x[lo], t))
        out[lo + half] = reduced(warp_add(x[lo], neg))
    return out, chain + 2


def _coords(p: torch.Tensor) -> list:
    return [tuple(F.words_to_ints(row)) for row in p]


def _words(coords: list) -> torch.Tensor:
    return F.ints_to_words([v for c in coords for v in c], "cpu").reshape(len(coords), 3, F.WORDS)


def _points(n: int, seed: int) -> torch.Tensor:
    """n projective points with Z != 1 (doubled), the identity at slot 1."""
    rng = np.random.default_rng(seed)
    pts = [hc.g1_mul(hc.g1_generator(), int(k)) for k in rng.integers(1, 1 << 62, size=n)]
    pts[1] = None
    return C.double(C.from_affine(C.host_points_to_affine(pts, "cpu")))


def _scalars(n: int, seed: int) -> list:
    """0, 1, r - 1 and a 56-bit scalar among random ones."""
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    ks[:4] = [0, 1, R - 1, int(rng.integers(1 << 55, 1 << 56))]
    return ks


@pytest.fixture(scope="module")
def smul_case():
    """20 lanes (at G = 4 two whole warps and one of 4 live groups; at G =
    8 five warps), the identity at lane 1 with the scalar 1, and the plain
    version's words."""
    p, ks = _points(20, 200), _scalars(20, 201)
    return p, ks, G.plain_scalar_mul(p, F.ints_to_words(ks, "cpu"))


@pytest.fixture(scope="module", params=[(16, 0, "plan"), (16, 1, "plan"), (16, 3, "edge")],
                ids=["s0-plan", "s1-plan", "s3-edge"])
def bfly_case(request):
    """A stage of the size-16 forward G1 NTT: stage 0 (every twiddle 1),
    stage 1 (two twiddles, j-major: a warp shares one at G = 8 and holds
    two at G = 4) with the plan's twiddles, stage 3 (every butterfly its
    own twiddle) with 0, 1, r - 1, a 56-bit one and random ones; and the
    plain version's words."""
    n, stage, kind = request.param
    x = _points(n, 210 + stage)
    tw = N._Plan(n, False).stages[stage][2][: 1 << stage] if kind == "plan" else _scalars(1 << stage, 211)
    return x, tw, stage, G.plain_butterfly(x, F.ints_to_words(tw, "cpu"), stage)


def test_wrappers_take_no_knob_and_regimes_are_kernel_sizes():
    """No block or group argument on the path's entry points; up to SWITCH
    lanes a warp a lane, above it GROUP["many"] threads, and the C entry
    points take these two sizes only; the path's calls (at most 512
    lanes) are few-lane."""
    assert list(inspect.signature(G.scalar_mul).parameters) == ["p", "k"]
    assert list(inspect.signature(G.butterfly).parameters) == ["x", "tw", "stage"]
    assert set(G.GROUP) == {"few", "many"} and set(G.GROUPS) == set(G.GROUP.values())
    assert [G.regime(n) for n in (1, 512, G.SWITCH, G.SWITCH + 1, 1 << 15)] == ["few", "few", "few", "many", "many"]
    assert G.GROUP["few"] == 32 and G.GROUP["many"] < G.GROUP["few"]


def test_cpu_takes_plain_and_counts_nothing(smul_case):
    p, ks, want = smul_case
    cuda_lib.reset_launches()
    assert torch.equal(G.scalar_mul(p, F.ints_to_words(ks, "cpu")), want)
    assert cuda_lib.launches["G1SMUL"] == cuda_lib.launches["G1BFLY"] == 0


@pytest.mark.parametrize("group", [4, 8, 32])
def test_scalar_mul_schedule_matches_plain(smul_case, group):
    """Reduced once, the model's lazy accumulators are the plain version's
    words, whatever the warp's top bit and its other groups' bits."""
    p, ks, want = smul_case
    accs, chain = model_scalar_mul(_coords(p), ks, group)
    assert torch.equal(_words([reduced(a) for a in accs]), want)
    assert chain == dependent_chain(ks, group)


def test_lazy_accumulators_are_not_all_reduced(smul_case):
    """The model is lazy: some accumulator word lies in [m, 2m) before its
    one reduction (so the test above holds the reduction, not a no-op)."""
    p, ks, _ = smul_case
    accs, _ = model_scalar_mul(_coords(p), ks, 4)
    assert any(v >= Q for a in accs for v in a)


def test_warp_top_bit_and_keep():
    """A warp's groups share its top bit and its add rounds: a group whose
    scalar is shorter doubles its identity and keeps it through the adds
    it does not take; its chain is the warp's, not its own."""
    ks = [1, R - 1, 0, 5, 1 << 55, 3, 2, 1]
    assert dependent_chain(ks[:1], 32) == 1
    assert dependent_chain(ks, 4) == (R - 1).bit_length() - 1 + bin(R - 1 | 1 << 55 | 7).count("1")
    assert dependent_chain(ks, 8) == dependent_chain(ks[:4], 8)
    assert dependent_chain([0] * 8, 4) == 0


@pytest.mark.parametrize("group", [4, 8, 32])
def test_butterfly_schedule_matches_plain(bfly_case, group):
    """G1BFLY's j-major lanes, t reduced once and negated, u + t and u - t
    reduced once: the plain version's words."""
    x, tw, stage, want = bfly_case
    out, chain = model_butterfly(_coords(x), tw, stage, group)
    assert torch.equal(_words(out), want)
    per_lane = [tw[j] for j, _ in bfly_lanes(x.shape[0], stage)]
    assert chain == dependent_chain(per_lane, group) + 2


def test_butterfly_lanes_are_j_major_and_cover_the_pairs():
    """Each (u, u + half) pair once; while n / 2^(stage + 1) >= 32 / G a
    warp's groups share one twiddle."""
    for n, stage in ((16, 0), (16, 1), (16, 3), (512, 3), (512, 8)):
        lanes = bfly_lanes(n, stage)
        j, u_idx = G._pairs(n, stage, "cpu")
        assert sorted(lanes) == sorted(zip(j.tolist(), u_idx.tolist()))
        for group in (4, 8, 32):
            per = WARP // group
            if n >> (stage + 1) >= per:
                assert all(len({lanes[g][0] for g in range(w, w + per)}) == 1 for w in range(0, n // 2, per))
