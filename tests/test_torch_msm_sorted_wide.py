"""K8 and K10, the bucket-sorted accumulation with unsigned digits from the
scalar words and with digits from a digit tensor (``cuda_msm_sorted``, its
plain version on the CPU): every bucket against the host sum of its points
(zero scalars, r - 1, a tie, (0, 0) sentinels, a point twice in a bucket,
P and -P in one), in one lane and in four, at windows of 15 to 65,535 rows;
and the single MSM at unsigned c = 16 and signed c = 12 against the native
oracle, without a K2 fold on its path. The digits are
recomputed here from the integers; the JAX package's digit recodings are
held against the port's in tests/test_torch_msm_windows.py. No JAX
compile."""

import random

import pytest
import torch

from verkle_kzg_tpu.hostmath import curve as hc
from verkle_kzg_tpu.params import R
from verkle_kzg_tpu_torch import native
from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import msm as M

torch.set_num_threads(1)


def _case(n, c, seed):
    """n points over 16 multiples of G and n scalars: the (0, 0) sentinel
    at 2, a zero scalar, r - 1 and a tie (windows 0 and 1 exactly 2^(c-1));
    P twice with one scalar (every bucket of P's doubles it) and P, -P with
    one scalar (they cancel in every window)."""
    rng = random.Random(seed)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(96)) for _ in range(16)]
    pts = [base[i % 16] for i in range(n)]
    ks = [rng.randrange(R) for _ in range(n)]
    h = 1 << (c - 1)
    ks[:4] = [0, R - 1, 0, h | (h << c) | (1 << 200)]
    pts[5], ks[5] = pts[4], ks[4]
    pts[7], ks[7] = hc.g1_neg(pts[6]), ks[6]
    pts[2] = None
    return pts, ks


def _port(pts, ks):
    return C.host_points_to_affine(pts, "cpu"), F.ints_to_words(ks, "cpu")


def _digits(k, c, signed):
    """Scalar k's W = ceil(256 / c) digits: raw, or balanced by the LSB-first
    carry chain of window_digits_signed (a digit above 2^(c-1) carries)."""
    out, carry, h = [], 0, 1 << (c - 1)
    for w in range(-(-256 // c)):
        d = ((k >> (w * c)) & ((1 << c) - 1)) + carry
        carry = int(signed and d > h)
        out.append(d - (carry << c))
    return out


def _check_buckets(pts, digits, c, signed, lanes, buckets):
    """Each touched row is the host sum of its lane's points whose digit is
    +-(row + 1), y negated for a negative digit; every other row holds the
    identity's words."""
    n = len(pts)
    w, rows = KS.windows(c), KS.rows(c, signed)
    assert buckets.shape == (w, lanes, rows, 3, 8)
    want = {}
    for p, (pt, ds) in enumerate(zip(pts, digits)):
        for win, d in enumerate(ds):
            if d and pt is not None:
                key = (win * lanes + p // (n // lanes)) * rows + abs(d) - 1
                want[key] = hc.g1_add(want.get(key), pt if d > 0 else hc.g1_neg(pt))
    flat = buckets.reshape(-1, 3, 8)
    keys = sorted(want)
    assert C.projective_to_host_points(flat[keys]) == [want[k] for k in keys]
    other = ~(flat == C.infinity((), "cpu")).flatten(1).all(1)
    other[keys] = False
    assert not bool(other.any())


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("c", [4, 8, 16])
def test_unsigned_word_buckets_are_host_sums(c, lanes):
    """K8: unsigned digits from the scalar words, 2^c - 1 rows a window."""
    pts, ks = _case(64, c, 800 + c)
    pa, sc = _port(pts, ks)
    assert KS.launch_key(c, False) == "K8"
    buckets = KS.accumulate(pa, sc, c, lanes, signed=False)
    _check_buckets(pts, [_digits(k, c, False) for k in ks], c, False, lanes, buckets)


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("c,signed", [(9, True), (12, True), (9, False), (13, False)])
def test_digit_tensor_buckets_are_host_sums(c, signed, lanes):
    """K10: the (W, B, S) digit tensor of window_digits_signed or
    window_digits, more than 128 rows a window, two sort passes above 256."""
    pts, ks = _case(64, c, 900 + c + signed)
    pa, sc = _port(pts, ks)
    assert KS.launch_key(c, signed, tensor=True) == "K10"
    digits = [_digits(k, c, signed) for k in ks]
    tensor = (M.window_digits_signed if signed else M.window_digits)(sc, c).to(torch.int32)
    assert tensor.T.tolist() == digits
    buckets = KS.accumulate_digits(pa, tensor.reshape(-1, lanes, 64 // lanes), c, signed)
    _check_buckets(pts, digits, c, signed, lanes, buckets)


@pytest.mark.parametrize("c,signed", [(16, False), (12, True)])
def test_wide_msm_needs_no_segments_and_no_fold(monkeypatch, c, signed):
    """msm_pippenger at unsigned c = 16 (K8) and signed c = 12 (K10) sorts:
    no point segments and no K2 (``curve.add``) fold."""
    def refuse(*_args, **_kw):
        raise AssertionError("not on the sorted path")

    assert not hasattr(M, "segments")
    monkeypatch.setattr(C, "add", refuse)
    pts, ks = _case(66, c, 1000 + c)
    got = M.msm_pippenger(*_port(pts, ks), c=c, signed=signed)
    assert C.projective_to_host_points(got) == [native.g1_msm(pts, ks)]


def test_batched_msm_at_a_wide_c_sorts(monkeypatch):
    """A fixed-base batch given c = 9 (256 rows a window) runs K10 with the
    batch's lanes as its lanes, the basis shared at lane stride 0, then K7:
    no K2 fold."""
    def refuse(*_args, **_kw):
        raise AssertionError("not on the sorted path")

    monkeypatch.setattr(C, "add", refuse)
    b, n, c = 2, 64, 9
    pts, ks = _case(b * n, c, 1100)
    pa, sc = _port(pts[:n], ks)
    got = M.msm_fixed_base(pa, sc.reshape(b, n, 8), c=c)
    assert C.projective_to_host_points(got) == [native.g1_msm(pts[:n], ks[i * n : (i + 1) * n]) for i in range(b)]
