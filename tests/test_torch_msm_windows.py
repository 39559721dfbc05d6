"""The port's single MSM at every window width c in [1, 16] and either digit
sign (verkle_kzg_tpu_torch.ops.msm.msm_pippenger over the plain versions of
K3, K8, K9, K6, K10 and K4 on the CPU) against the native C++ oracle
and against verkle_kzg_tpu.ops.msm on the same inputs; the digit recodings
against the JAX arrays. Only the group element is contract."""

import random

import jax
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

WIDTHS = [1, 2, 3, 4, 5, 8, 9, 12, 15, 16]


def _case(n, c, seed):
    """n points over 16 multiples of G with the (0, 0) sentinel at index 2;
    scalars with a zero, and ties (a window exactly 2^(c-1)) at window 0,
    above a nonzero window and at the top of the scalar's low half."""
    rng = random.Random(seed)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(96)) for _ in range(16)]
    pts = [base[i % 16] for i in range(n)]
    pts[2] = None
    h = 1 << (c - 1)
    ks = [rng.randrange(R) for _ in range(n)]
    ks[0] = 0
    ks[1] = h | (h << c)
    ks[3] = 1 | (h << c) | (rng.getrandbits(64) << 130)
    ks[4] = (h << (c * (128 // c))) | h
    return pts, ks


def _port(pts, ks):
    return C.host_points_to_affine(pts, "cpu"), F.ints_to_words(ks, "cpu")


def _jax(pts, ks):
    return JC.host_points_to_affine(pts), jnp.asarray(ints_to_limbs(ks).T)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("c", WIDTHS)
def test_every_width_and_sign_matches_oracle(c, signed):
    """n = 66: two points past a power of two, a ragged last sort tile."""
    n = 66
    pts, ks = _case(n, c, 100 + c)
    got = M.msm_pippenger(*_port(pts, ks), c=c, lanes=128, signed=signed)
    assert C.projective_to_host_points(got) == [native.g1_msm(pts, ks)]


@pytest.mark.parametrize(
    "n,c,lanes,signed",
    [(40, 8, 8, False), (33, 5, 8, True), (64, 12, 4, True)],
    ids=["K8-unsigned-c8", "K6-signed-c5", "K10-signed-c12"],
)
def test_matches_jax_pippenger(n, c, lanes, signed):
    """One case per new family against JAX msm_pippenger on its XLA path;
    the first two are the shapes tests/test_ops_msm.py compiles."""
    pts, ks = _case(n, c, 200 + n)
    fn = jax.jit(lambda p, k: JM.msm_pippenger(p, k, c=c, lanes=lanes, signed=signed))
    want = JC.projective_to_host_points(fn(*_jax(pts, ks)))
    if n >= 64:  # msm_auto takes the same route from 64 points on
        got = M.msm_auto(*_port(pts, ks), c=c, lanes=lanes)
    else:
        got = M.msm_pippenger(*_port(pts, ks), c=c, lanes=lanes, signed=signed)
    assert C.projective_to_host_points(got) == want == [native.g1_msm(pts, ks)]


@pytest.mark.parametrize("c,signed,key", [(4, False, "K8"), (9, True, "K10"), (9, False, "K10"),
                                          (5, False, "K6"), (7, True, "K6")])
def test_plain_tables_hold_buckets(c, signed, key):
    """Row i of window w is the sum of the points whose window-w digit is
    +-(i + 1), negated for a negative digit, in the buckets of the sorted
    accumulation (K8 from the scalar words, K6 and K10 from the digit
    tensor, at most and more than 128 rows a window); K4 turns them into
    the MSM."""
    n = 40
    pts, ks = _case(n, c, 300 + c)
    pa, sc = _port(pts, ks)
    if key == "K8":
        assert KS.launch_key(c, signed) == key
        digits = K.scalar_digits(sc, None, c, False).T  # (W, n)
        buckets = KS.accumulate(pa, sc, c, signed=False)
    else:
        assert KS.launch_key(c, signed, tensor=True) == key
        digits = (M.window_digits_signed if signed else M.window_digits)(sc, c)
        buckets = KS.accumulate_digits(pa, digits.to(torch.int32)[:, None], c, signed)
    assert buckets.shape == (K.windows(c), 1, K.rows(c, signed), 3, 8)
    buckets = buckets[:, 0].contiguous()
    for w in (0, 1, K.windows(c) - 2):
        for row in sorted({abs(d) - 1 for d in digits[w, :n].tolist() if d})[:3]:
            want = None
            for pt, d in zip(pts, digits[w, :n].tolist()):
                if abs(d) == row + 1 and pt is not None:
                    want = hc.g1_add(want, pt if d > 0 else hc.g1_neg(pt))
            assert C.projective_to_host_points(buckets[w, row]) == [want]
    out = K.tail(buckets, c)
    assert C.projective_to_host_points(out) == [native.g1_msm(pts, ks)]


@pytest.mark.parametrize("c", [1, 12, 16])
def test_digits_match_jax(c):
    pts, ks = _case(40, c, 400 + c)
    js, ts = _jax(pts, ks)[1], _port(pts, ks)[1]
    assert np.array_equal(np.asarray(JM.window_digits(js, c)), M.window_digits(ts, c).numpy())
    assert np.array_equal(np.asarray(JM.window_digits_signed(js, c)), M.window_digits_signed(ts, c).numpy())
    want = np.asarray(JM.signed_carries(js, c))  # (nwords, N) uint32
    assert np.array_equal(want, M.signed_carries(ts, c).numpy().view(np.uint32).T)
    if 16 % c == 0:
        masks = M.signed_carries(ts, c)
        digits = K.scalar_digits(ts, masks, c, True).T  # the kernel's recoding
        weights = [1 << (c * w) for w in range(K.windows(c))]
        assert [sum(int(d) * x for d, x in zip(col, weights)) for col in digits.T.tolist()] == ks


@pytest.mark.parametrize("c", [0, 17, -1])
def test_auto_c_rejects_widths_outside_1_16(c):
    with pytest.raises(ValueError) as jax_err:
        JM._auto_c(64, c)
    with pytest.raises(ValueError) as port_err:
        M._auto_c(64, c)
    assert str(port_err.value) == str(jax_err.value)
    pts, ks = _case(64, 4, 500)
    with pytest.raises(ValueError):
        M.msm_pippenger(*_port(pts, ks), c=c)
    assert M._auto_c(64, None) == 8


def test_small_msm_ignores_c():
    """Below 64 points msm_auto multiplies and folds (K5, K2) whatever c is."""
    pts, ks = _case(5, 12, 600)
    got = M.msm_auto(*_port(pts, ks), c=12, lanes=4)
    assert C.projective_to_host_points(got) == [native.g1_msm(pts, ks)]


@pytest.mark.slow
def test_unsigned_matches_pallas_interpret():
    """K8's mode against the TPU kernel it replaces, ``_accum_kernel_sc``,
    run in interpret mode (c = 4, 32 points, 8 lanes)."""
    from verkle_kzg_tpu.ops import pallas_msm as PM

    n, lanes, c = 32, 8, 4
    pts, ks = _case(n, c, 700)
    jp, js = _jax(pts, ks)
    steps = n // lanes
    pts_stream = jnp.moveaxis(jp.reshape(2, 16, steps, lanes), 2, 0)
    sc_stream = jnp.moveaxis(js.reshape(16, steps, lanes), 1, 0)
    want = PM.msm_single_fused_sc(pts_stream, sc_stream, c, interpret=True)
    got = M.msm_pippenger(*_port(pts, ks), c=c, signed=False)
    assert C.projective_to_host_points(got) == JC.projective_to_host_points(want)
