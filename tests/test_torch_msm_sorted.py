"""K3 and K9, the bucket-sorted signed accumulation (``cuda_msm_sorted``,
its plain version on the CPU): the in-kernel carry rule against JAX
``signed_carries``, the buckets against host sums of their points (zero
scalars, r - 1, (0, 0) sentinels, a point twice in a bucket, P and -P in
one, all scalars equal so that a bucket spans many chunks), in one lane and
in four, and the single MSM against JAX ``msm_auto`` and the native oracle,
without ``signed_carries`` or a K2 fold on its path."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from verkle_kzg_tpu.hostmath import curve as hc
from verkle_kzg_tpu.ops import curve as JC
from verkle_kzg_tpu.ops import msm as JM
from verkle_kzg_tpu.ops.limbs import ints_to_limbs
from verkle_kzg_tpu.params import R
from verkle_kzg_tpu_torch import native
from verkle_kzg_tpu_torch.ops import cuda_msm as K
from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import msm as M

torch.set_num_threads(1)

TIES = (1 << 15) | (1 << 31) | (1 << 200)  # a tie at c = 1, 4, 8 and 16


def _case(n, seed, equal=False):
    """n points over 16 multiples of G and n scalars: the (0, 0) sentinel
    at 2, a zero scalar, r - 1 and the tie scalar; P twice with one scalar
    (every bucket of P's doubles it) and P, -P with one scalar (they cancel
    in every window). ``equal``: every scalar the same."""
    rng = random.Random(seed)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(96)) for _ in range(16)]
    pts = [base[i % 16] for i in range(n)]
    ks = [rng.randrange(R) for _ in range(n)]
    if equal:
        ks = [ks[0]] * n
    else:
        ks[:4] = [0, R - 1, 0, TIES]
        pts[5], ks[5] = pts[4], ks[4]
        pts[7], ks[7] = hc.g1_neg(pts[6]), ks[6]
    pts[2] = None
    return pts, ks


def _port(pts, ks):
    return C.host_points_to_affine(pts, "cpu"), F.ints_to_words(ks, "cpu")


@pytest.mark.parametrize("c", [1, 4, 8, 16])
def test_carry_rule_matches_jax_signed_carries(c):
    """The digits kernel's in-register carries give the digits of JAX's
    packed carry words, ties included, and sum to the scalar."""
    _, ks = _case(40, 10 + c)
    ts = F.ints_to_words(ks, "cpu")
    words = np.asarray(JM.signed_carries(jnp.asarray(ints_to_limbs(ks).T), c)).T.astype(np.uint32)
    want = K.scalar_digits(ts, torch.from_numpy(words.view(np.int32).copy()), c, True)
    got = KS.carry_digits(ts, c)
    assert torch.equal(got, want)
    assert [sum(int(d) << (c * w) for w, d in enumerate(row)) for row in got.tolist()] == ks


def _check_buckets(pts, ks, c, lanes, buckets):
    """Each touched row is the host sum of its lane's points whose digit is
    +-(row + 1), y negated for a negative digit; every other row holds the
    identity's words."""
    n = len(pts)
    w, rows = KS.windows(c), KS.rows(c)
    assert buckets.shape == (w, lanes, rows, 3, 8)
    digits = KS.carry_digits(F.ints_to_words(ks, "cpu"), c).tolist()
    want = {}
    for p, (pt, ds) in enumerate(zip(pts, digits)):
        for win, d in enumerate(ds):
            if d and pt is not None:
                key = (win * lanes + p // (n // lanes)) * rows + abs(d) - 1
                want[key] = hc.g1_add(want.get(key), pt if d > 0 else hc.g1_neg(pt))
    flat = buckets.reshape(-1, 3, 8)
    keys = sorted(want)
    assert C.projective_to_host_points(flat[keys]) == [want[k] for k in keys]
    rest = torch.ones(flat.shape[0], dtype=torch.bool)
    rest[keys] = False
    assert torch.equal(flat[rest], C.infinity((int(rest.sum()),), "cpu"))
    return want


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("c", [4, 8, 16])
def test_buckets_are_host_sums(c, lanes):
    pts, ks = _case(64, 20 + c)
    pa, sc = _port(pts, ks)
    sums = _check_buckets(pts, ks, c, lanes, KS.accumulate(pa, sc, c, lanes))
    assert None in sums.values()  # P and -P cancelled in a touched row


@pytest.mark.parametrize("plan", ["default", "long_chunks", "window_groups"])
def test_equal_scalars_span_chunks(monkeypatch, plan):
    """All 200 scalars equal: each window's one bucket spans about 100
    chunks of 2 (the tree combine at depth 7); fewer, longer chunks (TARGET
    lowered); and windows in groups (SCRATCH_BYTES lowered), which give the
    same group elements."""
    if plan == "long_chunks":
        monkeypatch.setattr(KS, "TARGET", 7)
    if plan == "window_groups":
        monkeypatch.setattr(KS, "SCRATCH_BYTES", 16 * 200 * 5)
        assert len(KS.window_groups(200, 8)) == 7
    pts, ks = _case(200, 30, equal=True)
    pa, sc = _port(pts, ks)
    entries = KS.live_entries(pa, sc, 8)
    assert KS.chunk_len(entries) == (-(-entries // 7) if plan == "long_chunks" else KS.L_MIN)
    buckets = KS.accumulate(pa, sc, 8)
    _check_buckets(pts, ks, 8, 1, buckets)
    assert C.projective_to_host_points(K.tail(buckets[:, 0].contiguous())) == [native.g1_msm(pts, ks)]


def test_given_carry_words_match_computed_ones():
    """With the caller's carry words (the lane-stream functions) the
    buckets equal those of the in-kernel carries, word for word."""
    pts, ks = _case(64, 40)
    pa, sc = _port(pts, ks)
    masks = M.signed_carries(sc, 8)
    assert torch.equal(KS.accumulate(pa, sc, 8, 4, masks), KS.accumulate(pa, sc, 8, 4))


def test_msm_matches_jax_and_native():
    """The port's msm_auto and msm_pippenger at 64, 65 and 257 points
    against the native oracle each, and against JAX msm_auto through one
    call: JAX's MSM of k_64 + 2 k_65 + 4 k_257 (the prefixes' scalars, zero
    above n) equals P_64 + 2 P_65 + 4 P_257 of the port's results."""
    pts, ks = _case(257, 50)
    pa, sc = _port(pts, ks)
    total, mixed = None, [0] * 257
    for weight, n in ((1, 64), (2, 65), (4, 257)):
        got = C.projective_to_host_points(M.msm_auto(pa[:n].contiguous(), sc[:n].contiguous()))
        assert got == C.projective_to_host_points(M.msm_pippenger(pa[:n].contiguous(), sc[:n].contiguous()))
        assert got == [native.g1_msm(pts[:n], ks[:n])]
        total = hc.g1_add(total, hc.g1_mul(got[0], weight))
        mixed = [(m + weight * k) % R if i < n else m for i, (m, k) in enumerate(zip(mixed, ks))]
    jax_out = JM.msm_auto(JC.host_points_to_affine(pts), jnp.asarray(ints_to_limbs(mixed).T))
    assert JC.projective_to_host_points(jax_out) == [total]


@pytest.mark.parametrize("c", [8, 16])
def test_single_msm_needs_no_carries_and_no_fold(monkeypatch, c):
    def refuse(*_args, **_kw):
        raise AssertionError("not on the sorted path")

    monkeypatch.setattr(M, "signed_carries", refuse)
    monkeypatch.setattr(M, "fold_reduce_lanes", refuse)
    pts, ks = _case(70, 60 + c)
    got = M.msm_pippenger(*_port(pts, ks), c=c)
    assert C.projective_to_host_points(got) == [native.g1_msm(pts, ks)]
