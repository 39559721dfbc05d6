"""The port's lane-stream MSM entry points (verkle_kzg_tpu_torch.ops.msm_stream
over the plain versions of K13, K6/K10, K3/K8/K9, K2, K4 and K7 on the CPU)
against the host sums of each bucket, the native C++ oracle and, in
interpret mode, the TPU kernel K13 replaces (pallas_msm._accum_kernel_group).
Both packages take the same streams, made from a seed; exact on group
elements (canonical affine).

The checks of each digit sign (the single MSMs at every (c, G, fused)
against the native oracle and JAX msm_pippenger at the same c and sign,
the bucket rows, the batched tail) are defined here and run from
tests/test_torch_msm_stream_signed.py and tests/test_torch_msm_stream_unsigned.py:
each sign's three XLA MSM compiles (20-30 s each, cold) would not fit one
file's time beside the interpret-mode case (120-190 s on one core)."""

import functools
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
from verkle_kzg_tpu_torch import convert as V
from verkle_kzg_tpu_torch import native
from verkle_kzg_tpu_torch.ops import cuda_msm as K
from verkle_kzg_tpu_torch.ops import cuda_msm_group as KG
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import msm_stream as MS

torch.set_num_threads(1)

N, LANES = 64, 8


def _case(n, seed):
    """n points over 16 multiples of G with the (0, 0) sentinel at index 5;
    scalars with a zero, r - 1 and ties (a window exactly 2^(c-1)) at
    c = 4 and 8."""
    rng = random.Random(seed)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(96)) for _ in range(16)]
    pts = [base[i % 16] for i in range(n)]
    pts[5] = None
    ks = [rng.randrange(R) for _ in range(n)]
    ks[:4] = [0, R - 1, 0x88 | (0x80 << 16), (1 << 7) | (1 << 200)]
    return pts, ks


def _streams(pts, ks, lanes):
    """JAX's (S, 2, 16, B) point and (S, 16, B) scalar streams, their
    (N,) arrays, and the port's streams converted from them."""
    steps = len(pts) // lanes
    jp = JC.host_points_to_affine(pts)
    js = jnp.asarray(ints_to_limbs(ks).T)
    pts_stream = jnp.moveaxis(jp.reshape(2, 16, steps, lanes), 2, 0)
    sc_stream = jnp.moveaxis(js.reshape(16, steps, lanes), 1, 0)
    port = (V.pts_stream_from_jax(pts_stream, "cpu"), V.sc_stream_from_jax(sc_stream, "cpu"))
    return (jp, js, pts_stream, sc_stream), port


@functools.lru_cache(maxsize=None)
def _data():
    pts, ks = _case(N, 90)
    jax_side, port = _streams(pts, ks, LANES)
    return pts, ks, jax_side, port, native.g1_msm(pts, ks)


def _digits(js, c, signed, lanes):
    """JAX's (W, S, B) digit tensor and the port's copy of it."""
    dig = (JM.window_digits_signed if signed else JM.window_digits)(js, c)
    dig = dig.reshape(-(-256 // c), -1, lanes).astype(jnp.int32)
    return dig, torch.from_numpy(np.asarray(dig))


def _host(p):
    return C.projective_to_host_points(p.reshape(-1, 3, 8))


@functools.lru_cache(maxsize=None)
def _jax_msm(c, signed):
    """JAX msm_pippenger on its XLA path at this c and sign, canonical affine."""
    _, _, (jp, js, _, _), _, _ = _data()
    fn = jax.jit(lambda p, k: JM.msm_pippenger(p, k, c=c, lanes=LANES, signed=signed))
    return JC.projective_to_host_points(fn(jp, js))


#: (wgroup, fused): the K6/K10 branch, then K13 at every G and fused
ROUTES = [(None, False)] + [(g, f) for g in (1, 2, 3, 4) for f in (False, True)]
ROUTE_IDS = ["K6-K10"] + [f"G{g}-{'fused' if f else 'unfused'}" for g, f in ROUTES[1:]]


def check_single_fused(c, group, fused, signed):
    """msm_single_fused through K13 (or K6/K10 without ``wgroup``) equals the
    native oracle and JAX msm_pippenger at the same c and sign."""
    _, _, (_, js, _, _), (pts_stream, _), want = _data()
    _, digits = _digits(js, c, signed, LANES)
    got = MS.msm_single_fused(pts_stream, digits, c, chunk=4, signed=signed, wgroup=group, fused=fused)
    assert _host(got) == [want] == _jax_msm(c, signed)


def _masks(js, c):
    """JAX's signed carry masks as a (S, nwords, B) stream, and the port's."""
    steps = N // LANES
    jmasks = jnp.moveaxis(JM.signed_carries(js, c).reshape(-1, steps, LANES), 1, 0)
    masks = V.masks_from_jax(jmasks, "cpu")
    assert masks.shape == (steps, LANES, K.mask_words(c))
    return masks


def check_scalar_stream(c, signed):
    """The in-kernel-digit single MSM (K3 signed, with the carry masks
    converted from JAX's; K8 unsigned) against the native oracle and JAX
    msm_pippenger at the same c and sign; its buckets equal
    bucket_accumulate's on the digits the kernel derives (signed: the carry
    rule of signed_carries, which may differ from window_digits_signed at a
    tie)."""
    _, _, (_, js, _, _), (pts_stream, sc_stream), want = _data()
    if signed:
        masks = _masks(js, c)
        got = MS.msm_single_fused_sc_signed(pts_stream, sc_stream, masks, c)
        buckets = MS.bucket_accumulate_from_scalars_signed(pts_stream, sc_stream, masks, c)
        dig = K.scalar_digits(sc_stream.reshape(-1, 8), masks.reshape(-1, masks.shape[-1]), c, True)
        digits = dig.T.reshape(256 // c, N // LANES, LANES).to(torch.int32)
    else:
        got = MS.msm_single_fused_sc(pts_stream, sc_stream, c)
        buckets = MS.bucket_accumulate_from_scalars(pts_stream, sc_stream, c)
        _, digits = _digits(js, c, False, LANES)
    assert _host(got) == [want] == _jax_msm(c, signed)
    assert torch.equal(buckets, MS.bucket_accumulate(pts_stream, digits, c, signed=signed, wgroup=2, fused=True))


def _row_sums(pts, digits, c, signed, lanes):
    """The host sum of each bucket: {(window, row, lane): point}, row |d| - 1
    signed (y negated for d < 0), row d unsigned; digit 0 adds nothing."""
    sums = {}
    w, steps, _ = digits.shape
    for win in range(w):
        for i in range(steps):
            for b in range(lanes):
                d, p = int(digits[win, i, b]), pts[i * lanes + b]
                if d == 0 or p is None:
                    continue
                key = (win, abs(d) - 1 if signed else d, b)
                sums[key] = hc.g1_add(sums.get(key), p if d > 0 else hc.g1_neg(p))
    return sums


def check_bucket_rows(c, signed):
    """Each row of bucket_accumulate(wgroup=G, fused=f) is the host sum of
    its points, and the rows are word for word equal across every (G,
    fused), a G above 4 (run as groups of at most 4) and the K6/K10
    branch. Unsigned row 0 (the TPU's trash bucket) is the identity."""
    pts, _, (_, js, _, _), (pts_stream, _), _ = _data()
    _, digits = _digits(js, c, signed, LANES)
    ref = MS.bucket_accumulate(pts_stream, digits, c, signed=signed)
    rows = MS.signed_table_size(c) if signed else 1 << c
    assert ref.shape == (-(-256 // c), rows, LANES, 3, 8)
    for group in (1, 2, 3, 4, 6):
        for fused in (False, True):
            got = MS.bucket_accumulate(pts_stream, digits, c, signed=signed, wgroup=group, fused=fused)
            assert torch.equal(got, ref), (group, fused)
    sums = _row_sums(pts, digits, c, signed, LANES)
    host = _host(ref)
    w = ref.shape[0]
    want = [sums.get((win, r, b)) for win in range(w) for r in range(rows) for b in range(LANES)]
    assert host == want
    if not signed:
        assert torch.equal(ref[:, 0], C.infinity((w, LANES), "cpu"))


def check_batched_tail(signed):
    """batched_bucket_tail (K7) turns the lane buckets of the in-kernel-digit
    accumulation into each lane's own MSM, at c = 4: signed rows shifted,
    unsigned with row 0 dropped (2^c - 1 rows into K7)."""
    c = 4
    pts, ks, (_, js, _, _), (pts_stream, sc_stream), _ = _data()
    if signed:
        buckets = MS.bucket_accumulate_from_scalars_signed(pts_stream, sc_stream, _masks(js, c), c)
        got = MS.batched_bucket_tail(buckets, c, nbuckets=MS.signed_table_size(c), shifted=True)
    else:
        got = MS.batched_bucket_tail(MS.bucket_accumulate_from_scalars(pts_stream, sc_stream, c), c)
    assert _host(got) == [native.g1_msm(pts[b::LANES], ks[b::LANES]) for b in range(LANES)]


def test_group_width():
    assert [KG.group_width(g) for g in range(1, 10)] == [1, 2, 3, 4, 3, 3, 4, 4, 3]
    with pytest.raises(ValueError):
        KG.group_width(0)


def test_lane_count_must_be_a_power_of_two():
    pts, ks = _case(24, 91)
    _, (pts_stream, sc_stream) = _streams(pts, ks, 6)
    digits = torch.zeros((64, 4, 6), dtype=torch.int32)
    masks = torch.zeros((4, 6, 3), dtype=torch.int32)
    for call in (
        lambda: MS.msm_single_fused(pts_stream, digits, 4, wgroup=2),
        lambda: MS.msm_single_fused_sc(pts_stream, sc_stream, 4),
        lambda: MS.msm_single_fused_sc_signed(pts_stream, sc_stream, masks, 4),
    ):
        with pytest.raises(ValueError, match="power of two"):
            call()


def _pallas_case(n, lanes, c, seed):
    pts, ks = _case(n, seed)
    (_, js, jax_stream, _), (pts_stream, _) = _streams(pts, ks, lanes)
    return pts, ks, js, jax_stream, pts_stream


def test_matches_pallas_group_kernel_interpret():
    """Against the TPU kernel itself: pallas_msm.msm_single_fused through
    _accum_kernel_group (G = 3, so one window pads; fused table pass) in
    interpret mode, signed, at 16 points and 4 lanes."""
    from verkle_kzg_tpu.ops import pallas_msm as PM

    c = 4
    pts, ks, js, jax_stream, pts_stream = _pallas_case(16, 4, c, 92)
    jdig, digits = _digits(js, c, True, 4)
    want = PM.msm_single_fused(jax_stream, jdig, c, chunk=4, interpret=True, signed=True, wgroup=3, fused=True)
    got = MS.msm_single_fused(pts_stream, digits, c, chunk=4, signed=True, wgroup=3, fused=True)
    assert _host(got) == JC.projective_to_host_points(want) == [hc.g1_msm_naive(pts, ks)]


@pytest.mark.slow
@pytest.mark.parametrize("signed,group,fused", [
    (False, 2, True), (True, 2, False), (True, 2, True), (True, 4, True), (True, 3, True),
])
def test_matches_pallas_group_grid_interpret(signed, group, fused):
    """tests/test_pallas.py's grid for the TPU kernel (48 points, 8 lanes,
    c = 4, chunk 4): the port's msm_single_fused gives the same group
    element, and each bucket row of PM.bucket_accumulate, as canonical
    affine per (window, row, lane), equals the port's (unsigned: rows 1
    and up; JAX's row 0 collects the zero digits)."""
    from verkle_kzg_tpu.ops import pallas_msm as PM

    c, lanes = 4, 8
    pts, ks, js, jax_stream, pts_stream = _pallas_case(48, lanes, c, 93)
    jdig, digits = _digits(js, c, signed, lanes)
    want = PM.msm_single_fused(jax_stream, jdig, c, chunk=4, interpret=True, signed=signed, wgroup=group,
                               fused=fused)
    got = MS.msm_single_fused(pts_stream, digits, c, chunk=4, signed=signed, wgroup=group, fused=fused)
    assert _host(got) == JC.projective_to_host_points(want) == [native.g1_msm(pts, ks)]

    jb = PM.bucket_accumulate(jax_stream, jdig, c, chunk=4, interpret=True, signed=signed, wgroup=group,
                              fused=fused)
    pb = MS.bucket_accumulate(pts_stream, digits, c, signed=signed, wgroup=group, fused=fused)
    first = 0 if signed else 1
    jrows = jnp.moveaxis(jb[:, first:], (2, 3), (0, 1)).reshape(3, 16, -1)
    assert _host(pb[:, first:]) == JC.projective_to_host_points(jrows)
