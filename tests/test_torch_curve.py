"""The port's group law (verkle_kzg_tpu_torch.ops.curve: add is the plain
version of kernel K2 on the CPU) against verkle_kzg_tpu.ops.curve on the
same seeded points, including infinity, P + P and P + (-P). The formula
sequences are the same, so the projective representatives must match bit
for bit."""

import random

import numpy as np
import pytest
import torch

from verkle_kzg_tpu.hostmath import curve as hc
from verkle_kzg_tpu.ops import curve as JC
from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F

torch.set_num_threads(1)


def _to_port(arr) -> torch.Tensor:
    """JAX (k, 16, N) coordinate planes -> port (N, k, 8) words."""
    arr = np.asarray(arr)
    return torch.stack([convert.limb_planes_to_tensor(arr[k], "cpu") for k in range(arr.shape[0])], dim=1)


@pytest.fixture(scope="module")
def pairs():
    rng = random.Random(21)
    pts = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(128)) for _ in range(8)]
    p = [pts[0], pts[1], None, pts[2], pts[3], None, pts[4], pts[5]]
    q = [pts[6], pts[1], pts[7], None, hc.g1_neg(pts[3]), None, pts[0], pts[2]]
    return p, q


def test_add_matches_jax(pairs):
    p, q = pairs
    jp = JC.from_affine(JC.host_points_to_affine(p))
    jq = JC.from_affine(JC.host_points_to_affine(q))
    jsum = JC.add(jp, jq)
    got = C.add(_to_port(jp), _to_port(jq))
    assert torch.equal(got, _to_port(jsum))
    assert C.projective_to_host_points(got) == [hc.g1_add(a, b) for a, b in zip(p, q)]
    # Z != 1 here, and slot 5 (None + None) is at infinity
    assert torch.equal(C.to_affine(got), _to_port(JC.to_affine(jsum)))


def test_double_matches_jax(pairs):
    p, _ = pairs
    jp = JC.from_affine(JC.host_points_to_affine(p))
    got = C.double(_to_port(jp))
    assert torch.equal(got, _to_port(JC.double(jp)))
    assert C.projective_to_host_points(got) == [hc.g1_add(a, a) for a in p]


def test_mixed_add_matches_jax(pairs):
    p, q = pairs
    jp = JC.from_affine(JC.host_points_to_affine(p))
    jq = JC.host_points_to_affine(q)
    got = C.mixed_add(_to_port(jp), _to_port(jq))
    assert torch.equal(got, _to_port(JC.mixed_add(jp, jq)))


def test_affine_conversions(pairs):
    p, _ = pairs
    aff = C.host_points_to_affine(p, "cpu")
    assert torch.equal(aff, _to_port(JC.host_points_to_affine(p)))
    proj = C.from_affine(aff)
    assert torch.equal(proj, _to_port(JC.from_affine(JC.host_points_to_affine(p))))
    assert C.projective_to_host_points(proj) == p
    assert C.projective_to_host_points(C.infinity((2,), "cpu")) == [None, None]


@pytest.mark.parametrize("op", ["add", "mixed_add", "double"])
def test_lazy_group_law(pairs, op):
    """The lazy-domain formulas K3/K4 inline give the same group elements
    once reduced."""
    p, q = pairs
    lp = F.to_limbs(C.from_affine(C.host_points_to_affine(p, "cpu")))
    if op == "add":
        out = C.add16(lp, F.to_limbs(C.from_affine(C.host_points_to_affine(q, "cpu"))), lazy=True)
        want = [hc.g1_add(a, b) for a, b in zip(p, q)]
    elif op == "mixed_add":
        out = C.mixed_add16(lp, F.to_limbs(C.host_points_to_affine(q, "cpu")), lazy=True)
        want = [hc.g1_add(a, b) for a, b in zip(p, q)]
    else:
        out = C.double16(lp, lazy=True)
        want = [hc.g1_add(a, a) for a in p]
    assert C.projective_to_host_points(F.from_limbs(C.reduce16(out))) == want
