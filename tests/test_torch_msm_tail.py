"""The MSM tail shared by K4 and K7 (``cuda_msm.plain_tail``, the plain
version of ``csrc/msm_tail.cuh``) on the CPU: its plan, the group-law facts
its sparse rows rest on, and its output against JAX ``msm_batched`` and the
native oracle at host points, over the single MSM's bucket tables at
c = 1, 8 (both signs) and 16, and the batched MSM's at c = 5 in 40 lanes.
One JAX compile (the 40-lane batched MSM, whose lanes also give the single
MSMs' values) keeps the file short."""

import random

import jax.numpy as jnp
import pytest
import torch

from verkle_kzg_tpu.hostmath import curve as hc
from verkle_kzg_tpu.ops import curve as JC
from verkle_kzg_tpu.ops import msm as JM
from verkle_kzg_tpu.ops.limbs import ints_to_limbs
from verkle_kzg_tpu.params import R
from verkle_kzg_tpu_torch import native
from verkle_kzg_tpu_torch.ops import cuda_msm as K
from verkle_kzg_tpu_torch.ops import cuda_msm_batched as KB
from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import msm as M

torch.set_num_threads(1)

B, N = 40, 16  # lanes x points of the batched case
SINGLE = 5  # the single MSM runs over the first 5 lanes' points (lane 0's scalars zero)


@pytest.fixture(scope="module")
def case():
    """B lanes of N points and scalars (lane 0's scalars all zero; ties and
    r - 1 among the rest), each lane's MSM from JAX msm_batched, and the
    sum of the first SINGLE lanes' (the single MSM's value)."""
    rng = random.Random(700)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(96)) for _ in range(24)]
    pts = [base[rng.randrange(24)] for _ in range(B * N)]
    ks = [0] * N + [rng.randrange(R) for _ in range(N, B * N)]
    ks[N : N + 4] = [R - 1, 1 << 7, (1 << 15) | (1 << 200), 1]
    ap = JC.host_points_to_affine(pts)  # (2, 16, B * N)
    js = jnp.asarray(ints_to_limbs(ks).T).reshape(16, B, N)
    lanes = JC.projective_to_host_points(JM.msm_batched(jnp.moveaxis(ap.reshape(2, 16, B, N), 2, 0),
                                                        jnp.moveaxis(js, 1, 0)))
    total = None
    for p in lanes[:SINGLE]:
        total = hc.g1_add(total, p)
    return pts, ks, lanes, total


_buckets = {}


def _single_buckets(pts, ks, c, signed):
    """The single MSM's (W, rows, 3, 8) buckets over the first SINGLE
    lanes' points, through the plain accumulation: the sorted K3 / K9
    signed, K8 unsigned."""
    if (c, signed) in _buckets:
        return _buckets[c, signed]
    n = SINGLE * N
    pa, sc = C.host_points_to_affine(pts[:n], "cpu"), F.ints_to_words(ks[:n], "cpu")
    _buckets[c, signed] = KS.accumulate(pa, sc, c, signed=signed)[:, 0].contiguous()
    return _buckets[c, signed]


def test_plan():
    """Runs of 4 rows up to 128 rows, 32 runs a window up to 1,024 rows (one
    CUDA launch), then levels of 32 groups: c = 12 signed and c = 16 take
    three or four launches."""
    assert [K.run_len(r) for r in (1, 16, 128, 255, 512, 1024, 65535)] == [4, 4, 4, 8, 16, 32, 32]
    assert K.tail_levels(128) == [(32, 2)] and K.tail_launches(128) == 1
    assert K.tail_levels(255) == [(32, 3)] and K.tail_launches(1 << 10) == 1
    assert K.tail_levels(1 << 11) == [(64, 5), (2, 10)] and K.tail_launches(1 << 11) == 3
    assert K.tail_levels(65535) == [(2048, 5), (64, 10), (2, 15)] and K.tail_launches(65535) == 4


def test_group_law_facts_the_sparse_rows_rest_on():
    """The plain tail skips rows where both operands are the identity's
    words, and identity rows of a doubling, which RCB16 maps to those words
    again; and adds its operands in either order, as the kernel's lanes do,
    which gives the same words since a Montgomery product is symmetric."""
    inf = C.infinity16((), "cpu")
    assert torch.equal(C.add16(inf, inf, lazy=True), inf)
    assert torch.equal(C.double16(inf, lazy=True), inf)
    rng = random.Random(701)
    pts = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(128)) for _ in range(6)]
    p = F.to_limbs(C.from_affine(C.host_points_to_affine(pts, "cpu")))
    q = C.add16(p, p.roll(1, 0), lazy=True)
    assert torch.equal(C.add16(p, q, lazy=True), C.add16(q, p, lazy=True))


@pytest.mark.parametrize("c,signed", [(1, True), (8, True), (8, False), (16, True)])
def test_single_tail_matches_jax_and_oracle(case, c, signed):
    """K4's shapes: c = 1 (256 windows of one row, Horner alone), the IPA's
    signed 32 x 128, unsigned 32 x 255 (a ragged last run of 7 rows) and a
    sparse signed c = 16 table (32,768 rows, two combine levels), over 80
    points; equal to the sum of JAX's lanes and to the native oracle."""
    pts, ks, _, want = case
    buckets = _single_buckets(pts, ks, c, signed)
    assert buckets.shape == (K.windows(c), K.rows(c, signed), 3, 8)
    got = C.projective_to_host_points(K.tail(buckets, c))
    assert got == [want] == [native.g1_msm(pts[: SINGLE * N], ks[: SINGLE * N])]


def test_batched_tail_matches_jax_and_oracle(case):
    """K7's shape in the verkle commit (c = 5, 52 windows of 16 rows) in
    40 lanes, lane 0 all identity: each lane equal to JAX's lane and to the
    native oracle."""
    pts, ks, lanes, _ = case
    c = 5
    basis = C.host_points_to_affine(pts, "cpu").reshape(B, N, 2, 8)
    scalars = F.ints_to_words(ks, "cpu").reshape(B, N, 8)
    digits = M.window_digits_signed(scalars, c).to(torch.int32)
    buckets = KS.accumulate_digits(basis, digits, c)  # the sorted K6, B lanes
    assert buckets.shape == (52, B, 16, 3, 8)
    assert torch.equal(buckets[:, 0], C.infinity((52, 16), "cpu"))
    got = C.projective_to_host_points(KB.tail(buckets, c))
    assert got == lanes
    assert got[:3] == [native.g1_msm(pts[b * N : b * N + N], ks[b * N : b * N + N]) for b in range(3)]


def test_k4_and_k7_plain_agree_word_for_word(case):
    """One function: K7 on one lane gives K4's words (both wrappers take the
    plain version on the CPU)."""
    pts, ks, _, _ = case
    buckets = _single_buckets(pts, ks, 8, True)
    assert torch.equal(KB.tail(buckets[:, None].contiguous(), 8)[0], K.tail(buckets, 8))
