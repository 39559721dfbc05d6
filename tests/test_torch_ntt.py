"""The port's NTTs (verkle_kzg_tpu_torch.ops.ntt) and the group law they run
on (curve.double, kernel K11; curve.mixed_add, K12; curve.neg; the
double-and-add curve.scalar_mul) against the JAX package on the same
seeded inputs, through the plain kernel versions on the CPU. Fr outputs and
G1 projective coordinates must be identical, not only the group elements:
the two packages run the same operations in the same order."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from verkle_kzg_tpu.hostmath import curve as hc
from verkle_kzg_tpu.ops import curve as JC
from verkle_kzg_tpu.ops import field as JF
from verkle_kzg_tpu.ops import ntt as JN
from verkle_kzg_tpu.ops.limbs import ints_to_limbs
from verkle_kzg_tpu.params import R, fr_root_of_unity
from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import ntt as N

torch.set_num_threads(1)


def _to_port(arr) -> torch.Tensor:
    """JAX (k, 16, N) coordinate planes -> port (N, k, 8) words."""
    arr = np.asarray(arr)
    return torch.stack([convert.limb_planes_to_tensor(arr[k], "cpu") for k in range(arr.shape[0])], dim=1)


def _naive_dft(coeffs, n):
    w = fr_root_of_unity(n)
    return [sum(c * pow(w, i * j, R) for j, c in enumerate(coeffs)) % R for i in range(n)]


def _points(n, seed):
    """n host points: seeded multiples of G, with infinity at slot 1."""
    rng = random.Random(seed)
    pts = [hc.g1_mul(hc.g1_generator(), rng.randrange(R)) for _ in range(n)]
    pts[1] = None
    return pts


@pytest.mark.parametrize("n", [8, 16])
def test_plan_matches_jax(n):
    for inverse in (False, True):
        want, got = JN._Plan(n, inverse), N._Plan(n, inverse)
        assert got.bitrev == want.bitrev.tolist()
        assert got.n_inv == want.n_inv
        for (u, v, tw), (ju, jv, jtw) in zip(got.stages, want.stages, strict=True):
            assert (u, v) == (ju.tolist(), jv.tolist())
            assert np.array_equal(ints_to_limbs(tw).T, jtw)


@pytest.mark.parametrize("n", [8, 16])
def test_ntt_fr_matches_jax(n):
    rng = random.Random(0x17A0 + n)
    coeffs = [rng.randrange(R) for _ in range(n)]
    coeffs[0], coeffs[1] = 0, R - 1
    jx = JF.to_mont(jnp.asarray(ints_to_limbs(coeffs).T), "fr")
    x = F.ints_to_mont(coeffs, "fr", "cpu")
    assert torch.equal(x, convert.limb_planes_to_tensor(jx, "cpu"))

    evals = N.ntt_fr(x)
    jevals = JN.ntt_fr(jx)
    assert torch.equal(evals, convert.limb_planes_to_tensor(jevals, "cpu"))
    assert F.mont_to_ints(evals, "fr") == _naive_dft(coeffs, n)

    back = N.intt_fr(evals)
    assert torch.equal(back, convert.limb_planes_to_tensor(JN.intt_fr(jevals), "cpu"))
    assert F.mont_to_ints(back, "fr") == coeffs


def test_ntt_g1_matches_jax():
    """G1 NTT and INTT at n = 8, infinity among the inputs: the projective
    coordinates of both packages, and the group elements [DFT(c)_i G]."""
    n = 8
    rng = random.Random(0x61)
    coeffs = [rng.randrange(R) for _ in range(n)]
    coeffs[1] = 0
    pts = [None if c == 0 else hc.g1_mul(hc.g1_generator(), c) for c in coeffs]
    jx = JC.from_affine(JC.host_points_to_affine(pts))
    x = C.from_affine(C.host_points_to_affine(pts, "cpu"))
    assert torch.equal(x, _to_port(jx))

    evals = N.ntt_g1(x)
    jevals = JN.ntt_g1(jx)
    assert torch.equal(evals, _to_port(jevals))
    want = [hc.g1_mul(hc.g1_generator(), e) for e in _naive_dft(coeffs, n)]
    assert C.projective_to_host_points(evals) == want

    back = N.intt_g1(evals)
    assert torch.equal(back, _to_port(JN.intt_g1(jevals)))
    assert C.projective_to_host_points(back) == pts


def test_group_law_matches_jax():
    """double (K11), mixed_add (K12) and neg on projective points with
    Z != 1 and the identity, the affine operand with the (0, 0) sentinel."""
    p_host = _points(8, 0x62)
    q_host = _points(8, 0x63)
    q_host[2], q_host[3] = None, p_host[3]  # sentinel against a point, P + P
    q_host[4] = hc.g1_neg(p_host[4])  # P + (-P)
    jp = JC.add(*(JC.from_affine(JC.host_points_to_affine(h)) for h in (p_host, _points(8, 0x64))))
    p = _to_port(jp)  # Z != 1 except where both summands were the identity
    jq = JC.host_points_to_affine(q_host)
    q = C.host_points_to_affine(q_host, "cpu")
    assert torch.equal(q, _to_port(jq))

    assert torch.equal(C.double(p), _to_port(JC.double(jp)))
    assert torch.equal(C.mixed_add(p, q), _to_port(JC.mixed_add(jp, jq)))
    assert torch.equal(C.neg(p), _to_port(JC.neg(jp)))
    sums = C.projective_to_host_points(p)
    assert C.projective_to_host_points(C.double(p)) == [hc.g1_add(a, a) for a in sums]
    assert C.projective_to_host_points(C.mixed_add(p, q)) == [hc.g1_add(a, b) for a, b in zip(sums, q_host)]
    assert C.projective_to_host_points(C.neg(p)) == [hc.g1_neg(a) for a in sums]
    # the identity's words through each operation, as JAX gives them
    inf = C.infinity((2,), "cpu")
    jinf = JC.infinity((), 2)
    assert torch.equal(C.double(inf), _to_port(JC.double(jinf)))
    assert torch.equal(C.mixed_add(inf, q[2:4]), _to_port(JC.mixed_add(jinf, jq[..., 2:4])))


def test_scalar_mul_matches_jax():
    """The double-and-add of the G1 butterflies, on points with Z != 1,
    with a zero scalar, r - 1 and the identity among the lanes."""
    pts = _points(8, 0x65)
    jp = JC.double(JC.from_affine(JC.host_points_to_affine(pts)))
    rng = random.Random(0x66)
    ks = [rng.randrange(R) for _ in range(8)]
    ks[0], ks[2] = 0, R - 1
    want = JC.scalar_mul(jp, jnp.asarray(ints_to_limbs(ks).T))
    got = C.scalar_mul(_to_port(jp), F.ints_to_words(ks, "cpu"))
    assert torch.equal(got, _to_port(want))
    assert C.projective_to_host_points(got) == [
        None if p is None else hc.g1_mul(p, 2 * k % R) for p, k in zip(pts, ks)
    ]
