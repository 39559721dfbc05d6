"""K6 and K13 on the bucket-sorted kernels (``cuda_msm_sorted.accumulate_digits``,
its plain version on the CPU), and the batched tail K7 at c = 1: the
lane-batched MSMs at c = 1 against JAX ``msm_fixed_base`` / ``msm_batched``
and the native oracle; the strides the digits kernel reads a shared basis
and a lane stream at; a shared basis giving the words of the basis
repeated per lane; and every MSM of 64 points or more that took K6's or
K13's table walk now on the sorted kernels, with no point segments and
no K2 (``curve.add``) fold on its path."""

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
from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import msm as M
from verkle_kzg_tpu_torch.ops import msm_stream as MS

torch.set_num_threads(1)


def _case(b, n, seed):
    """An n-point basis (the (0, 0) sentinel at 3) and b lanes of scalars:
    a zero, r - 1 and a tie at c = 1 (bits 0 and 1 set) in lane 0."""
    rng = random.Random(seed)
    basis = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(96)) for _ in range(n)]
    basis[3] = None
    ks = [[rng.randrange(R) for _ in range(n)] for _ in range(b)]
    ks[0][:3] = [0, R - 1, 0b11 | (1 << 130)]
    return basis, ks


def _port_scalars(ks):
    return F.ints_to_words([x for k in ks for x in k], "cpu").reshape(len(ks), -1, F.WORDS)


def _jax_scalars(ks):
    return jnp.asarray(np.stack([ints_to_limbs(k).T for k in ks]))  # (B, L, n)


def test_fixed_base_at_c1_matches_jax_and_oracle():
    """c = 1: 256 windows of one row. The batched tail K7 takes it, as K4
    does for the single MSM, where the JAX package returns the MSM."""
    basis, ks = _case(2, 64, 1200)
    got = C.projective_to_host_points(M.msm_fixed_base(C.host_points_to_affine(basis, "cpu"), _port_scalars(ks), c=1))
    want = JC.projective_to_host_points(JM.msm_fixed_base(JC.host_points_to_affine(basis), _jax_scalars(ks), c=1))
    assert got == want == [native.g1_msm(basis, k) for k in ks]


def test_batched_at_c1_matches_jax_and_oracle():
    basis, ks = _case(1, 64, 1201)
    lane = basis[::-1]
    got = M.msm_batched(C.host_points_to_affine(lane, "cpu")[None], _port_scalars(ks), c=1)
    want = JM.msm_batched(JC.host_points_to_affine(lane)[None], _jax_scalars(ks), c=1)
    assert C.projective_to_host_points(got) == JC.projective_to_host_points(want) == [native.g1_msm(lane, ks[0])]


def test_batched_bucket_tail_at_c1():
    """msm_stream.batched_bucket_tail at c = 1 (one signed row a window)."""
    lanes, steps = 4, 16
    basis, ks = _case(1, lanes * steps, 1202)
    pts = C.host_points_to_affine(basis, "cpu").reshape(steps, lanes, 2, 8)
    sc = F.ints_to_words(ks[0], "cpu")
    masks = M.signed_carries(sc, 1).reshape(steps, lanes, -1)
    buckets = MS.bucket_accumulate_from_scalars_signed(pts, sc.reshape(steps, lanes, 8), masks, 1)
    got = MS.batched_bucket_tail(buckets, 1, nbuckets=MS.signed_table_size(1), shifted=True)
    want = [native.g1_msm(basis[b::lanes], ks[0][b::lanes]) for b in range(lanes)]
    assert C.projective_to_host_points(got) == want


@pytest.mark.parametrize("layout", ["lanes", "shared", "stream"])
def test_tensor_layout_strides(layout):
    """The strides the digits kernel gets, in points and in digits: a
    (B S, 2, 8) array, a basis every lane shares (lane stride 0, no copy)
    and a lane stream (S, B) read through its transpose."""
    b, s, w = 4, 8, 3
    if layout == "lanes":
        pts, digits = torch.zeros((b * s, 2, 8), dtype=torch.int32), torch.zeros((w, b, s), dtype=torch.int32)
        want = (s, 1, b * s, s, 1)
    elif layout == "shared":
        pts, digits = torch.zeros((s, 2, 8), dtype=torch.int32).expand(b, s, 2, 8), torch.zeros((w, b, s))
        want = (0, 1, b * s, s, 1)
    else:
        pts = torch.zeros((s, b, 2, 8), dtype=torch.int32).transpose(0, 1)
        digits = torch.zeros((w, s, b), dtype=torch.int32).permute(0, 2, 1)
        want = (1, b, b * s, 1, b)
    view = KS.point_lanes(pts, b, s)
    assert view.shape == (b, s, 2, 8) and view.data_ptr() == pts.data_ptr()
    assert KS.tensor_layout(view, digits) == want
    odd = torch.zeros((b, s, 8, 2), dtype=torch.int32).transpose(2, 3)  # words not contiguous: copied
    assert KS.point_lanes(odd, b, s).is_contiguous()


def test_shared_basis_gives_the_repeated_basis_words():
    """A basis expanded to B lanes (the kernel's lane stride 0) and the
    same basis copied into each lane: the same bucket words, and the same
    MSM words from msm_fixed_base and msm_batched."""
    b, n, c = 2, 64, 5
    basis, ks = _case(b, n, 1203)
    pa, sc = C.host_points_to_affine(basis, "cpu"), _port_scalars(ks)
    digits = M.window_digits_signed(sc, c).to(torch.int32)
    shared = KS.accumulate_digits(pa.expand(b, n, 2, 8), digits, c)
    repeated = KS.accumulate_digits(pa.repeat(b, 1, 1), digits, c)
    assert torch.equal(shared, repeated)
    got = M.msm_fixed_base(pa, sc)
    assert torch.equal(got, M.msm_batched(pa.expand(b, n, 2, 8).contiguous(), sc))
    assert C.projective_to_host_points(got) == [native.g1_msm(basis, k) for k in ks]


def _refuse(*_args, **_kw):
    raise AssertionError("a K2 fold on the sorted path")


@pytest.fixture
def sorted_calls(monkeypatch):
    """No point segments and no K2 fold; each digit-tensor accumulation's
    count key (K6, K10 or K13) and lane count, recorded."""
    assert not hasattr(M, "segments") and not hasattr(M, "TABLE_BYTES")
    monkeypatch.setattr(C, "add", _refuse)
    calls = []
    run = KS.accumulate_digits

    def spy(pts, digits, c, signed=True, key=None):
        calls.append((key or KS.launch_key(c, signed, tensor=True), digits.shape[1]))
        return run(pts, digits, c, signed, key)

    monkeypatch.setattr(KS, "accumulate_digits", spy)
    return calls


@pytest.mark.parametrize("c", [3, 5, 6, 7])
def test_single_msm_at_k6_widths_sorts(sorted_calls, c):
    basis, ks = _case(1, 64, 1210 + c)
    got = M.msm_pippenger(*(C.host_points_to_affine(basis, "cpu"), F.ints_to_words(ks[0], "cpu")), c=c)
    assert C.projective_to_host_points(got) == [native.g1_msm(basis, ks[0])]
    assert sorted_calls == [("K6", 1)]


@pytest.mark.parametrize("entry", ["fixed_base", "batched"])
def test_batched_msms_sort(sorted_calls, entry):
    b, n = 2, 64
    basis, ks = _case(b, n, 1220)
    pa, sc = C.host_points_to_affine(basis, "cpu"), _port_scalars(ks)
    if entry == "fixed_base":
        got = M.msm_fixed_base(pa, sc)
    else:
        got = M.msm_batched(pa.expand(b, n, 2, 8), sc)
    assert C.projective_to_host_points(got) == [native.g1_msm(basis, k) for k in ks]
    assert sorted_calls == [("K6", b)]


@pytest.mark.parametrize("group,fused", [(2, False), (4, True)])
def test_grouped_stream_msm_sorts(sorted_calls, group, fused):
    """msm_single_fused with ``wgroup``: K13's count, the whole stream as
    one lane, then K4."""
    lanes, steps, c = 8, 8, 6
    basis, ks = _case(1, lanes * steps, 1230)
    stream = C.host_points_to_affine(basis, "cpu").reshape(steps, lanes, 2, 8)
    digits = M.window_digits_signed(F.ints_to_words(ks[0], "cpu"), c).reshape(-1, steps, lanes)
    got = MS.msm_single_fused(stream, digits, c, signed=True, wgroup=group, fused=fused)
    assert C.projective_to_host_points(got) == [native.g1_msm(basis, ks[0])]
    assert sorted_calls == [("K13", 1)]
