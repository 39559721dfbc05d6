"""The port's lane-batched MSMs (verkle_kzg_tpu_torch.ops.msm: msm_fixed_base
and msm_batched over the plain versions of K6, K2 and K7 on the CPU)
against verkle_kzg_tpu.ops.msm on the same seeded lanes, and against the
native C++ oracle for every window width the kernels take. Only the group
element is contract: the two packages' tails add in different orders, and
at a tie digit the LSB carry chain may recode differently from the single
MSM's carry mask."""

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
from verkle_kzg_tpu_torch.ops import cuda_msm_batched as KB
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import msm as M

torch.set_num_threads(1)

B = 3


def _case(n, seed):
    """B lanes over an n-point basis: lane 0 all zero, lane 1 random, lane
    2 random with tie digits (a window exactly 2^(c-1)) for c = 4 and 5."""
    rng = random.Random(seed)
    basis = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(96)) for _ in range(n)]
    ks = [[0] * n] + [[rng.randrange(R) for _ in range(n)] for _ in range(B - 1)]
    ks[2][0] = 0x88 | (0x8 << 100)
    ks[2][1] = 16 | (16 << 5) | (16 << 200)
    return basis, ks


def _jax_scalars(ks):
    return jnp.asarray(np.stack([ints_to_limbs(k).T for k in ks]))  # (B, L, n)


def _port_scalars(ks):
    return F.ints_to_words([x for k in ks for x in k], "cpu").reshape(len(ks), -1, F.WORDS)


def _check_fixed_base(n, c):
    basis, ks = _case(n, 70 + n)
    got = C.projective_to_host_points(M.msm_fixed_base(C.host_points_to_affine(basis, "cpu"), _port_scalars(ks), c=c))
    want = JC.projective_to_host_points(JM.msm_fixed_base(JC.host_points_to_affine(basis), _jax_scalars(ks), c=c))
    assert got == want
    assert got == [native.g1_msm(basis, k) for k in ks]


def _check_batched(n, c):
    basis, ks = _case(n, 80 + n)
    lanes = [basis, basis[::-1], basis[1:] + [None]]  # lane 2 ends in the (0, 0) sentinel
    pts = torch.stack([C.host_points_to_affine(p, "cpu") for p in lanes])
    got = C.projective_to_host_points(M.msm_batched(pts, _port_scalars(ks), c=c))
    jpts = jnp.stack([JC.host_points_to_affine(p) for p in lanes])
    want = JC.projective_to_host_points(JM.msm_batched(jpts, _jax_scalars(ks), c=c))
    assert got == want
    assert got == [native.g1_msm(p, k) for p, k in zip(lanes, ks)]


@pytest.mark.parametrize("c", [None, 5])
def test_fixed_base_width_64_matches_jax(c):
    assert M._auto_c_batched(64) == 4
    _check_fixed_base(64, c)


@pytest.mark.parametrize("c", [None, 5])
def test_batched_width_64_matches_jax(c):
    _check_batched(64, c)


@pytest.mark.slow
def test_fixed_base_width_256_matches_jax():
    assert M._auto_c_batched(256) == 5
    _check_fixed_base(256, None)


@pytest.mark.slow
def test_batched_width_256_matches_jax():
    _check_batched(256, None)


@pytest.mark.parametrize("c", [2, 3, 6, 7])
def test_every_window_width_matches_oracle(c):
    """K6 and K7 take c as an argument: each width the kernels accept."""
    basis, ks = _case(64, 90 + c)
    got = M.msm_fixed_base(C.host_points_to_affine(basis, "cpu"), _port_scalars(ks), c=c)
    assert C.projective_to_host_points(got) == [native.g1_msm(basis, k) for k in ks]


def test_plain_tables_hold_signed_buckets():
    """K6's rows: row i of window w, lane b, is the sum of the points whose
    window-w digit is +-(i + 1), negated for a negative digit; K7 turns the
    folded tables into each lane's MSM."""
    n, c = 64, 4
    basis, ks = _case(n, 95)
    scalars = _port_scalars(ks)
    digits = M.window_digits_signed(scalars, c).to(torch.int32)  # (W, B, n)
    nseg, seg_len = M.segments(n)
    table = KB.accumulate(C.host_points_to_affine(basis, "cpu"), digits, nseg, seg_len, c)
    assert table.shape == (64, B, nseg, 8, 3, 8)
    folded = M.fold_reduce_lanes(table, dim=2)[:, :, 0]
    for w, b, row in ((0, 2, 7), (1, 1, 0), (63, 1, 0)):
        want = None
        for pt, d in zip(basis, digits[w, b].tolist()):
            if abs(d) == row + 1:
                want = hc.g1_add(want, pt if d > 0 else hc.g1_neg(pt))
        assert C.projective_to_host_points(folded[w, b, row]) == [want]
    out = KB.tail(folded.contiguous(), c)
    assert C.projective_to_host_points(out) == [native.g1_msm(basis, k) for k in ks]
