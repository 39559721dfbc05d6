"""Kernel K5's plain version (verkle_kzg_tpu_torch.ops.cuda_scalar_mul)
against the JAX package's XLA double-and-add (ops/curve.py::scalar_mul) on
the same seeded lanes: the projective coordinates must be identical, not
only the group elements. And the port's small-N msm_auto (K5 plus a K2
fold) against JAX msm_auto."""

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
from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.ops import cuda_scalar_mul as K5
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import msm as M

torch.set_num_threads(1)


def _to_port(arr) -> torch.Tensor:
    """JAX (k, 16, N) coordinate planes -> port (N, k, 8) words."""
    arr = np.asarray(arr)
    return torch.stack([convert.limb_planes_to_tensor(arr[k], "cpu") for k in range(arr.shape[0])], dim=1)


def _lanes(n, seed):
    rng = random.Random(seed)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(128)) for _ in range(16)]
    pts = [base[i % 16] for i in range(n)]
    ks = [rng.randrange(R) for _ in range(n)]
    ks[:4] = [0, 1, R - 1, 1 << 253]
    pts[4], pts[5] = None, None  # (0, 0) lanes, one with a zero scalar
    ks[5] = 0
    return pts, ks


@pytest.fixture(scope="module")
def lanes():
    pts, ks = _lanes(64, 51)
    return pts, ks, K5.plain(C.host_points_to_affine(pts, "cpu"), F.ints_to_words(ks, "cpu"))


def test_plain_k5_coordinates_match_jax_scalar_mul(lanes):
    pts, ks, got = lanes
    want = JC.scalar_mul(JC.from_affine(JC.host_points_to_affine(pts)), jnp.asarray(ints_to_limbs(ks).T))
    assert torch.equal(got, _to_port(want))
    assert C.projective_to_host_points(got) == [None if p is None else hc.g1_mul(p, k) for p, k in zip(pts, ks)]


def test_port_scalar_mul_coordinates(lanes):
    """The port's reduced-domain scalar_mul (the XLA path's sequence) gives
    K5's coordinates too."""
    pts, ks, got = lanes
    proj = C.from_affine(C.host_points_to_affine(pts[:8], "cpu"))
    assert torch.equal(C.scalar_mul(proj, F.ints_to_words(ks[:8], "cpu")), got[:8])


def test_bits_and_sentinel_match_jax():
    pts, ks = _lanes(8, 52)
    jbits = np.asarray(JC.scalar_bits_msb(jnp.asarray(ints_to_limbs(ks).T)))
    assert np.array_equal(C.scalar_bits_msb(F.ints_to_words(ks, "cpu")).numpy(), jbits)
    jinf = np.asarray(JC.affine_is_infinity(JC.host_points_to_affine(pts)))
    assert np.array_equal(C.affine_is_infinity(C.host_points_to_affine(pts, "cpu")).numpy(), jinf)


@pytest.mark.parametrize("n", [1, 5, 48])
def test_small_msm_auto_matches_jax(n):
    pts, ks = _lanes(max(n, 6), 60 + n)
    pts, ks = pts[:n], ks[:n]
    got = M.msm_auto(C.host_points_to_affine(pts, "cpu"), F.ints_to_words(ks, "cpu"))
    want = JM.msm_auto(JC.host_points_to_affine(pts), jnp.asarray(ints_to_limbs(ks).T))
    assert C.projective_to_host_points(got) == JC.projective_to_host_points(want)
    assert C.projective_to_host_points(got) == [hc.g1_msm_naive(pts, ks)]
