"""The port's single MSM (verkle_kzg_tpu_torch.ops.msm over the plain
versions of K2-K4 on the CPU) against verkle_kzg_tpu.ops.msm and the
exact oracles, and the digit recodings against the JAX arrays."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from verkle_kzg_tpu import native
from verkle_kzg_tpu.hostmath import curve as hc
from verkle_kzg_tpu.ops import curve as JC
from verkle_kzg_tpu.ops import msm as JM
from verkle_kzg_tpu.ops.limbs import ints_to_limbs
from verkle_kzg_tpu.params import R
from verkle_kzg_tpu_torch.ops import cuda_msm as K
from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import msm as M

torch.set_num_threads(1)


def _scalars(n, seed):
    rng = random.Random(seed)
    ks = [rng.randrange(R) for _ in range(n)]
    edge = [0, R - 1, 1 << 253, (1 << 128) | (1 << 127), 0x80 << 8]  # zero, r-1, ties
    ks[: min(n, len(edge))] = edge[: min(n, len(edge))]
    return ks


def _points(n, seed):
    rng = random.Random(seed)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(96)) for _ in range(min(n, 16))]
    pts = [base[i % len(base)] for i in range(n)]
    if n > 2:
        pts[2] = None  # the (0, 0) sentinel
    return pts


@pytest.mark.parametrize("c", [4, 7, 8])
def test_digits_match_jax(c):
    ks = _scalars(40, 31 + c)
    js = jnp.asarray(ints_to_limbs(ks).T)
    ts = F.ints_to_words(ks, "cpu")
    assert np.array_equal(np.asarray(JM.window_digits(js, c)), M.window_digits(ts, c).numpy())
    assert np.array_equal(
        np.asarray(JM.window_digits_signed(js, c)), M.window_digits_signed(ts, c).numpy()
    )
    want = np.asarray(JM.signed_carries(js, c))  # (nwords, N) uint32
    got = M.signed_carries(ts, c).numpy().view(np.uint32).T
    assert np.array_equal(want, got)
    assert M.carry_mask_words(256 // c + (256 % c > 0)) == want.shape[0]


@pytest.mark.parametrize("n", [1, 48, 64, 257])
def test_msm_matches_jax_and_oracle(n):
    """Against JAX msm_auto (its small-N and Pippenger paths on either side
    of 64) and the exact oracles: python ints up to 64 points, the native
    C++ Pippenger at every size (the python one takes 20 s at 257)."""
    pts, ks = _points(n, 40 + n), _scalars(n, 50 + n)
    got = C.projective_to_host_points(M.msm_auto(C.host_points_to_affine(pts, "cpu"), F.ints_to_words(ks, "cpu")))[0]
    jax_out = JM.msm_auto(JC.host_points_to_affine(pts), jnp.asarray(ints_to_limbs(ks).T))
    assert got == JC.projective_to_host_points(jax_out)[0]
    assert got == native.g1_msm(pts, ks)
    if n <= 64:
        assert got == hc.g1_msm_naive(pts, ks)


@pytest.mark.slow
def test_msm_matches_pallas_interpret():
    """Against the TPU kernels K3/K4 replace, run in interpret mode."""
    from verkle_kzg_tpu.ops import pallas_msm as PM

    n, lanes = 32, 8
    pts, ks = _points(n, 60), _scalars(n, 61)
    js = jnp.asarray(ints_to_limbs(ks).T)
    steps = n // lanes
    pts_stream = jnp.moveaxis(JC.host_points_to_affine(pts).reshape(2, 16, steps, lanes), 2, 0)
    sc_stream = jnp.moveaxis(js.reshape(16, steps, lanes), 1, 0)
    masks = jnp.moveaxis(JM.signed_carries(js, 8).reshape(2, steps, lanes), 1, 0)
    want = PM.msm_single_fused_sc_signed(pts_stream, sc_stream, masks, 8, interpret=True)
    got = M.msm_auto(C.host_points_to_affine(pts, "cpu"), F.ints_to_words(ks, "cpu"))
    assert C.projective_to_host_points(got) == JC.projective_to_host_points(want)


def test_plain_kernels_agree_with_oracle():
    """K3's buckets: row i of window w is the sum of the points whose
    window-w digit is +-(i + 1), signed; K4 turns them into the MSM."""
    n = 40
    pts, ks = _points(n, 70), _scalars(n, 71)
    pa, sc = C.host_points_to_affine(pts, "cpu"), F.ints_to_words(ks, "cpu")
    buckets = KS.accumulate(pa, sc, 8)[:, 0]
    assert buckets.shape == (32, 128, 3, 8)
    digits = M.window_digits_signed(sc, 8)  # no tie in these windows
    w = 0
    for row in (0, 1, 127):
        want = None
        for pt, d in zip(pts, digits[w].tolist()):
            if abs(d) == row + 1 and pt is not None:
                want = hc.g1_add(want, pt if d > 0 else hc.g1_neg(pt))
        assert C.projective_to_host_points(buckets[w, row]) == [want]
    out = K.tail(buckets.contiguous())
    assert C.projective_to_host_points(out) == [hc.g1_msm_naive(pts, ks)]
