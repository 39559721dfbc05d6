"""The plain versions of G1SMUL and G1BFLY (verkle_kzg_tpu_torch.ops.cuda_g1_chain)
against the JAX package's XLA ``scalar_mul`` scan and its ``ntt._g1_stage``,
word for word, on the CPU: the kernels skip rounds that leave the words as
they are, and these tests hold that the projective coordinates stay the
scan's."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from verkle_kzg_tpu.hostmath import curve as hc
from verkle_kzg_tpu.ops import curve as JC
from verkle_kzg_tpu.ops import ntt as JN
from verkle_kzg_tpu.ops.limbs import ints_to_limbs
from verkle_kzg_tpu.params import R
from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.ops import cuda_g1_chain as G
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import ntt as N

torch.set_num_threads(1)


def _to_port(arr) -> torch.Tensor:
    """JAX (k, 16, N) coordinate planes -> port (N, k, 8) words."""
    arr = np.asarray(arr)
    return torch.stack([convert.limb_planes_to_tensor(arr[k], "cpu") for k in range(arr.shape[0])], dim=1)


def _jax_scalars(ks):
    return jnp.asarray(ints_to_limbs(ks).T)  # (L, N)


def _points(n, seed):
    """JAX projective points with Z != 1 (doubled), the identity at slot 1."""
    rng = random.Random(seed)
    pts = [hc.g1_mul(hc.g1_generator(), rng.randrange(R)) for _ in range(n)]
    pts[1] = None
    return pts, JC.double(JC.from_affine(JC.host_points_to_affine(pts)))


def _edge_scalars(n, seed):
    """0, 1, r - 1, a scalar with 200 leading zero bits, the rest random."""
    rng = random.Random(seed)
    ks = [rng.randrange(R) for _ in range(n)]
    ks[:4] = [0, 1, R - 1, rng.getrandbits(56) | 1 << 55]
    return ks


def test_skips_leave_the_identity_as_it_is():
    """The premise of the skips: doubling the identity, and adding the
    identity to itself, give the identity's words (0 : R mod q : 0)."""
    inf = C.infinity16((3,), "cpu")
    assert torch.equal(C.double16(inf), inf)
    assert torch.equal(C.add16(inf, inf), inf)


def test_plain_scalar_mul_matches_jax_scan():
    """Lanes: Z != 1, the identity point (with a nonzero scalar), scalars
    0, 1, r - 1 and one with 200 leading zero bits."""
    pts, jp = _points(8, 0x51)
    ks = _edge_scalars(8, 0x52)
    ks[1] = R - 1  # the identity times a nonzero scalar
    want = _to_port(JC.scalar_mul(jp, _jax_scalars(ks)))
    got = G.plain_scalar_mul(_to_port(jp), F.ints_to_words(ks, "cpu"))
    assert torch.equal(got, want)
    assert torch.equal(C.scalar_mul(_to_port(jp), F.ints_to_words(ks, "cpu")), want)
    assert C.projective_to_host_points(got) == [
        None if p is None else hc.g1_mul(p, 2 * k % R) for p, k in zip(pts, ks)
    ]


def test_plain_scalar_mul_with_no_set_bit_is_the_identity():
    _, jp = _points(4, 0x53)
    got = G.plain_scalar_mul(_to_port(jp), torch.zeros((4, F.WORDS), dtype=torch.int32))
    assert torch.equal(got, C.infinity((4,), "cpu"))


def _jax_stage(jx, n, stage, tw_ints):
    """JAX's _g1_stage with butterfly k of the plan taking tw_ints[j]."""
    plan = JN._Plan(n, False)
    u_idx, v_idx, _ = plan.stages[stage]
    half = 1 << stage
    per_pair = [tw_ints[k % half] for k in range(n // 2)]
    return _to_port(JN._g1_stage(jx, jnp.asarray(u_idx), jnp.asarray(v_idx), _jax_scalars(per_pair)))


@pytest.mark.parametrize("stage", [0, 1, 3])
def test_plain_butterfly_matches_jax_stage(stage):
    """Each stage of the size-16 forward transform with its own twiddles:
    stage 0 (every twiddle 1), a uniform-twiddle stage and the last one."""
    n = 16
    _, jx = _points(n, 0x54 + stage)
    plan = N._Plan(n, False)
    tw = plan.stages[stage][2][: 1 << stage]
    got = G.plain_butterfly(_to_port(jx), F.ints_to_words(tw, "cpu"), stage)
    assert torch.equal(got, _jax_stage(jx, n, stage, tw))


def test_plain_butterfly_edge_twiddles_match_jax_stage():
    """The last stage at 16 with twiddles 0, 1, r - 1 and a 56-bit one
    among random ones, and the identity among the points."""
    n, stage = 16, 3
    _, jx = _points(n, 0x58)
    tw = _edge_scalars(1 << stage, 0x59)
    got = G.plain_butterfly(_to_port(jx), F.ints_to_words(tw, "cpu"), stage)
    assert torch.equal(got, _jax_stage(jx, n, stage, tw))
