"""The port's lane-batched MSMs (verkle_kzg_tpu_torch.ops.msm: msm_fixed_base
and msm_batched over the plain versions of the sorted K6 and of K7 on the
CPU) against verkle_kzg_tpu.ops.msm on the same seeded lanes, and against
the native C++ oracle for every window width the kernels take; the sorted
accumulation's scratch bound (its window groups) at the verkle commit's
shape and at a patched bound. Only the group element is contract: the two
packages' tails add in different orders, and at a tie digit the LSB carry
chain may recode differently from the single MSM's carry mask."""

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
from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
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
    """The sorted accumulation's rows at 8 rows a window (K6's width), the
    basis shared by the lanes: row i of window w, lane b, is the sum of
    the points whose window-w digit is +-(i + 1), negated for a negative
    digit; K7 turns the tables into each lane's MSM."""
    n, c = 64, 4
    basis, ks = _case(n, 95)
    scalars = _port_scalars(ks)
    digits = M.window_digits_signed(scalars, c).to(torch.int32)  # (W, B, n)
    assert KS.launch_key(c, True, tensor=True) == "K6"
    pts = C.host_points_to_affine(basis, "cpu")
    table = KS.accumulate_digits(pts.expand(B, n, 2, 8), digits, c)
    assert table.shape == (64, B, 8, 3, 8)
    for w, b, row in ((0, 2, 7), (1, 1, 0), (63, 1, 0), (5, 0, 3)):
        want = None
        for pt, d in zip(basis, digits[w, b].tolist()):
            if abs(d) == row + 1:
                want = hc.g1_add(want, pt if d > 0 else hc.g1_neg(pt))
        assert C.projective_to_host_points(table[w, b, row]) == [want]
    out = KB.tail(table, c)
    assert C.projective_to_host_points(out) == [native.g1_msm(basis, k) for k in ks]


class _StopBeforeAccumulating(Exception):
    pass


def test_tree_chunk_tables_stay_under_cap(monkeypatch):
    """The dense verkle commit's chunk (COMMIT_CHUNK lanes over the
    width-256 basis, c = 5): the sorted accumulation gets the basis as an
    expand (lane stride 0) and the (W, B, 256) digits, and its window
    groups keep the scratch under SCRATCH_BYTES: one group of 52 windows,
    52 x 2048 x 256 entries of 16 bytes (about 436 MB). The kernel is
    stopped before it runs."""
    from verkle_kzg_tpu_torch.verkle.tree import VerkleTree

    b, n = VerkleTree.COMMIT_CHUNK, 256
    seen = {}

    def spy(points, digits, c, signed=True, key=None):
        seen.update(c=c, digits=tuple(digits.shape), stride=points.stride()[:2], key=key)
        raise _StopBeforeAccumulating

    monkeypatch.setattr(KS, "accumulate_digits", spy)
    basis = torch.zeros((n, 2, F.WORDS), dtype=torch.int32)
    with pytest.raises(_StopBeforeAccumulating):
        M.msm_fixed_base(basis, torch.zeros((b, n, F.WORDS), dtype=torch.int32))
    assert seen == {"c": 5, "digits": (KS.windows(5), b, n), "stride": (0, 16), "key": None}
    assert KS.launch_key(5, True, tensor=True) == "K6"
    groups = KS.window_groups(b * n, 5, b)
    assert groups == [(0, KS.windows(5))]
    scratch = KS.entry_bytes(5) * KS.windows(5) * b * n
    assert scratch <= KS.SCRATCH_BYTES and scratch == 436_207_616
    assert KS.windows(5) * b * KS.rows(5) * 96 == 163_577_856  # the buckets


def test_table_cap_cuts_batched_segments(monkeypatch):
    """A SCRATCH_BYTES that bites at a small shape: the windows of a
    batched MSM go in groups of 10, and the result still equals the native
    oracle and the JAX values."""
    n, c = 64, 4
    basis, ks = _case(n, 97)
    monkeypatch.setattr(KS, "SCRATCH_BYTES", KS.entry_bytes(c) * B * n * 10)
    groups = KS.window_groups(B * n, c, B)
    assert len(groups) == 7 and groups[0] == (0, 10) and groups[-1] == (60, 4)
    seen = []
    run = KS._sums
    monkeypatch.setattr(KS, "_sums", lambda out, *a: seen.append(out.shape[0]) or run(out, *a))
    got = C.projective_to_host_points(M.msm_fixed_base(C.host_points_to_affine(basis, "cpu"), _port_scalars(ks), c=c))
    assert seen == [10 * B * KS.rows(c)] * 6 + [4 * B * KS.rows(c)]
    want = JC.projective_to_host_points(JM.msm_fixed_base(JC.host_points_to_affine(basis), _jax_scalars(ks), c=c))
    assert got == want == [native.g1_msm(basis, k) for k in ks]
