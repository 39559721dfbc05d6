"""The last public names of ops/field, ops/curve, ops/msm and IPAParams that
the port had no counterpart of, each against its JAX twin on the CPU: the
same values in, the same words out (the port's (..., B, 8) rows against
the JAX package's (..., 16, B) limb planes)."""

import random

import numpy as np
import pytest
import torch

from verkle_kzg_tpu_torch.hostmath import curve as hc
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import msm as M
from verkle_kzg_tpu_torch.params import R

torch.set_num_threads(1)


def _words(planes) -> torch.Tensor:
    """JAX (..., 16, B) uint32 limb planes -> the port's (..., B, 8) int32 words."""
    a = np.asarray(planes, dtype=np.uint32)
    w = a[..., 0::2, :] | (a[..., 1::2, :] << np.uint32(16))
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(w, -1, -2)).view(np.int32))


def _planes(words: torch.Tensor):
    """The port's (..., B, 8) words -> JAX (..., 16, B) uint32 planes."""
    import jax.numpy as jnp

    w = np.swapaxes(np.ascontiguousarray(words.numpy()).view(np.uint32), -1, -2)
    out = np.empty(w.shape[:-2] + (16, w.shape[-1]), dtype=np.uint32)
    out[..., 0::2, :] = w & np.uint32(0xFFFF)
    out[..., 1::2, :] = w >> np.uint32(16)
    return jnp.asarray(out)


def _mont(vals, spec, shape):
    return F.ints_to_mont(vals, spec, "cpu").reshape(shape + (F.WORDS,))


@pytest.mark.parametrize("spec", ["fr", "fq"])
def test_constructors_match_jax(spec):
    from verkle_kzg_tpu.ops import field as JF

    assert torch.equal(F.zeros((2,), 3, device="cpu"), _words(JF.zeros((2,), 3)))
    assert F.zeros((2,), device="cpu").shape == (2, F.WORDS) and not F.zeros((2,), device="cpu").any()
    assert torch.equal(F.one_mont(spec, (2,), 3, device="cpu"), _words(JF.one_mont(spec, (2,), 3)))
    assert torch.equal(F.one_mont(spec, device="cpu"), _words(np.asarray(JF.one_mont(spec))[:, None])[0])
    for v in (0, 1, 1 << 192, F.SPECS[spec].modulus - 1):
        assert torch.equal(F.const_mont(v, spec, "cpu"), _words(JF.const_mont(v, spec)[:, None])[0])


@pytest.mark.parametrize("spec", ["fr", "fq"])
def test_predicates_select_double_and_square_match_jax(spec):
    from verkle_kzg_tpu.ops import field as JF

    m = F.SPECS[spec].modulus
    rng = random.Random(len(spec))
    vals = [0, 1, m - 1, 0] + [rng.randrange(m) for _ in range(4)]
    other = list(vals[:3]) + [rng.randrange(m) for _ in range(5)]
    a, b = _mont(vals, spec, (2, 4)), _mont(other, spec, (2, 4))
    ja, jb = _planes(a), _planes(b)
    assert np.array_equal(F.is_zero(a).numpy(), np.asarray(JF.is_zero(ja)))
    assert np.array_equal(F.eq(a, b).numpy(), np.asarray(JF.eq(ja, jb)))
    mask = torch.tensor([[True, False, True, False], [False, False, True, True]])
    assert torch.equal(F.select(mask, a, b), _words(JF.select(mask.numpy(), ja, jb)))
    assert torch.equal(F.double(a, spec), _words(JF.double(ja, spec)))
    assert torch.equal(F.mont_sq(a, spec), _words(JF.mont_sq(ja, spec)))
    assert F.mont_to_ints(F.mont_sq(a, spec), spec) == [v * v % m for v in vals]


def test_batch_inv_mont_axis_matches_jax():
    """The default axis (the elements, JAX's lanes) and a leading batch axis,
    zeros among the entries."""
    from verkle_kzg_tpu.ops import field as JF

    rng = random.Random(5)
    vals = [rng.randrange(R) for _ in range(3 * 4)]
    vals[0] = vals[7] = 0
    a = _mont(vals, "fr", (3, 4))
    ja = _planes(a)
    assert torch.equal(F.batch_inv_mont(a, "fr"), _words(JF.batch_inv_mont(ja, "fr")))
    got = F.batch_inv_mont(a, "fr", axis=0)
    assert torch.equal(got, _words(JF.batch_inv_mont(ja, "fr", axis=0)))
    assert F.mont_to_ints(got, "fr") == [pow(v, -1, R) if v else 0 for v in vals]
    with pytest.raises(ValueError):
        F.batch_inv_mont(a, "fr", axis=-1)


def _projective(seed, n):
    """n projective points with Z != 1 (sums of multiples of G), the
    identity at slot 1."""
    rng = random.Random(seed)
    g = hc.g1_generator()
    ps = [hc.g1_mul(g, rng.getrandbits(64)) for _ in range(n)]
    qs = [hc.g1_mul(g, rng.getrandbits(64)) for _ in range(n)]
    qs[1] = hc.g1_neg(ps[1])
    p = C.from_affine(C.host_points_to_affine(ps, "cpu"))
    q = C.from_affine(C.host_points_to_affine(qs, "cpu"))
    return C.add(p, q), [hc.g1_add(x, y) for x, y in zip(ps, qs)]


def _point_planes(p: torch.Tensor):
    """(..., B, 3, 8) projective words -> JAX (..., 3, 16, B)."""
    return _planes(p.movedim(-3, -2))


def _point_words(planes) -> torch.Tensor:
    """JAX (..., 3, 16, B) -> the port's (..., B, 3, 8)."""
    return _words(planes).movedim(-3, -2)


def test_curve_predicates_select_neg_and_eq_match_jax():
    from verkle_kzg_tpu.ops import curve as JC

    p, host = _projective(1, 4)
    jp = _point_planes(p)
    assert torch.equal(_point_words(jp), p)
    assert np.array_equal(C.is_infinity(p).numpy(), np.asarray(JC.is_infinity(jp)))
    assert C.is_infinity(p).tolist() == [h is None for h in host]
    q = p.flip(0)
    mask = torch.tensor([True, False, False, True])
    assert torch.equal(C.select(mask, p, q), _point_words(JC.select(mask.numpy(), jp, _point_planes(q))))
    # the same points with Z scaled by 5: equal as points, not as words
    five = F.const_mont(5, "fq", "cpu")
    scaled = F.mont_mul(p, five.expand_as(p), "fq")
    for other in (scaled, q, C.neg(p)):
        want = np.asarray(JC.eq(jp, _point_planes(other)))
        assert np.array_equal(C.eq(p, other).numpy(), want)
    assert C.eq(p, scaled).all() and not C.eq(p, C.neg(p))[0]
    aff = C.to_affine(p)
    assert torch.equal(C.affine_neg(aff), _point_words(JC.affine_neg(_point_planes(aff))))
    assert C.affine_to_host_points(C.affine_neg(aff)) == [hc.g1_neg(h) for h in host]


def test_host_point_conversions_match_jax():
    from verkle_kzg_tpu.ops import curve as JC

    p, host = _projective(2, 4)
    aff = C.to_affine(p)
    assert C.affine_to_host_points(aff) == host == JC.affine_to_host_points(_point_planes(aff))
    for pt in host[:2]:
        got = C.host_point_to_projective(pt, "cpu")
        assert got.shape == (1, 3, F.WORDS)
        assert torch.equal(got, _point_words(JC.host_point_to_projective(pt)))


def test_tree_reduce_and_suffix_scan_match_jax():
    """Both over a leading axis of 5 rows x 2 lanes: the same halving tree
    and the same Hillis-Steele steps, so the same projective words."""
    from verkle_kzg_tpu.ops import msm as JM

    p, host = _projective(3, 10)
    p = p.reshape(5, 2, 3, F.WORDS)
    jp = _point_planes(p)
    red = M.tree_reduce_points(p, axis=0)
    assert red.shape == (2, 3, F.WORDS)
    assert torch.equal(red, _point_words(JM.tree_reduce_points(jp, axis=0)))
    scan = M.suffix_scan_points(p, axis=0)
    assert torch.equal(scan, _point_words(JM.suffix_scan_points(jp, axis=0)))
    for lane in range(2):
        acc, want = None, []
        for row in range(4, -1, -1):
            acc = hc.g1_add(acc, host[2 * row + lane])
            want.append(acc)
        assert C.projective_to_host_points(scan[:, lane]) == want[::-1]


def test_msm_naive_matches_jax():
    from verkle_kzg_tpu.ops import msm as JM

    p, host = _projective(4, 3)
    ks = [0, R - 1, 2**200 + 3]
    sc = F.ints_to_words(ks, "cpu")
    got = M.msm_naive(p, sc)
    assert got.shape == (3, F.WORDS)
    want = JM.msm_naive(_point_planes(p), _planes(sc))
    assert torch.equal(got, _point_words(want)[0])
    assert C.projective_to_host_points(got) == [hc.g1_msm_naive(host, ks)]


def test_ipa_params_projective_basis_matches_jax():
    from verkle_kzg_tpu.schemes import ipa_setup as jax_ipa_setup
    from verkle_kzg_tpu_torch import convert

    jcrs = jax_ipa_setup(4)
    crs = convert.ipa_params_from_jax(jcrs, "cpu")
    assert crs.g_proj.shape == (4, 3, F.WORDS) and crs.q_proj.shape == (1, 3, F.WORDS)
    assert torch.equal(crs.g_proj, _point_words(jcrs.g_proj))
    assert torch.equal(crs.q_proj, _point_words(jcrs.q_proj))
    assert C.projective_to_host_points(crs.q_proj) == [crs.q_host]
