"""Kernel K1AFF (verkle_kzg_tpu_torch.ops.cuda_curve.affine_words) and
curve.projective_to_host_points: the plain version, which CPU tensors take,
and the CPU conversion (python ints, the exact oracle) against the JAX
package's to_affine followed by affine_to_host_points, on the same seeded
projective points: Z not 1, points at infinity (Z = 0 with any X and Y),
N = 1 and N across K1AFF's rows and JAX's 128-lane chunks; and, on a card,
the kernel against its plain version and the host-int path, exact.

The card cases import no JAX (the card's machine has none):

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu tests/test_torch_affine.py
"""

import random

import numpy as np
import pytest
import torch

from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.hostmath import curve as hc
from verkle_kzg_tpu_torch.ops import cuda_curve, cuda_lib
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.params import Q, R

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_curve():
    import jax.numpy as jnp

    from verkle_kzg_tpu.ops import curve as JC

    return jnp, JC


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _projective(n, seed, device):
    """n projective points (X l, Y l, l) of seeded multiples of G with a
    random l, so Z is not 1; points 0 mod 7 at infinity, (0, 1, 0) or
    (X, Y, 0) with X and Y left as they were -> (host points, (n, 3, 8)
    Montgomery words)."""
    rng = random.Random(seed)
    g = hc.g1_generator()
    host, coords = [], []
    for i in range(n):
        x, y = hc.g1_mul(g, rng.randrange(1, R))
        lam = rng.randrange(1, Q)
        if i % 7 == 0:
            host.append(None)
            coords += [0, 1, 0] if i % 14 == 0 else [x, y, 0]
        else:
            host.append((x, y))
            coords += [x * lam % Q, y * lam % Q, lam]
    return host, F.ints_to_mont(coords, "fq", device).reshape(n, 3, F.WORDS)


def _pairs(words) -> list:
    xy = F.words_to_ints(words)
    return [None if x == 0 and y == 0 else (x, y) for x, y in zip(xy[0::2], xy[1::2])]


@pytest.mark.parametrize("n", [1, 2, 130])
def test_plain_and_cpu_conversion_match_jax(jax_curve, n):
    jnp, JC = jax_curve
    host, p = _projective(n, 300 + n, "cpu")
    planes = np.stack([convert.tensor_to_limb_planes(p[:, k]) for k in range(3)])  # (3, 16, n)
    aff = JC.to_affine(jnp.asarray(planes))
    want = JC.affine_to_host_points(aff)
    assert want == host
    assert C.projective_to_host_points(p) == want
    words = cuda_curve.plain_affine_words(p)
    assert _pairs(words) == want
    # the plain words are JAX's Montgomery affine words out of Montgomery form
    jwords = torch.stack([convert.limb_planes_to_tensor(np.asarray(aff)[k], "cpu") for k in range(2)], dim=1)
    rinv = pow(1 << 256, -1, Q)
    assert F.words_to_ints(words) == [v * rinv % Q for v in F.words_to_ints(jwords)]


def test_leading_axes_flatten():
    host, p = _projective(12, 9, "cpu")
    assert C.projective_to_host_points(p.reshape(3, 4, 3, F.WORDS)) == host
    assert torch.equal(cuda_curve.plain_affine_words(p.reshape(2, 6, 3, F.WORDS)), cuda_curve.plain_affine_words(p))


def test_cpu_takes_plain_and_counts_no_launch():
    _, p = _projective(9, 4, "cpu")
    cuda_lib.reset_launches()
    assert torch.equal(cuda_curve.affine_words(p), cuda_curve.plain_affine_words(p))
    C.projective_to_host_points(p)
    assert cuda_lib.launches["K1AFF"] == 0 and cuda_lib.launches["K1"] == 0 and cuda_lib.launches["K1INV"] == 0


@pytest.mark.parametrize("n,row", [(1, 1), (2, 1), (262, 1), (263, 2), (8384, 32), (8385, 64), (30_000, 128),
                                   (1 << 20, 256)])
def test_rows_fill_the_card(n, row):
    assert cuda_curve.affine_row(n, 132) == row  # an H100's SMs


# N: a KZG proof's one point, the IPA round's two, 256 and 257 (rows of one
# and two points), about the verkle commit's 30,000 (rows of 128) and
# 40,000 (rows of 256)
CARD_SIZES = [1, 2, 256, 257, 30_000, 40_000]


@pytest.mark.gpu
@pytest.mark.parametrize("n", CARD_SIZES)
def test_kernel_matches_plain_and_host_on_card(cuda, n):
    host, p = _projective(min(n, 512), 60 + n, cuda)
    if n > 512:
        p = p.repeat(-(-n // 512), 1, 1)[:n]
        host = (host * -(-n // 512))[:n]
    cuda_lib.reset_launches()
    words = cuda_curve.affine_words(p)
    torch.cuda.synchronize()
    assert cuda_lib.launches["K1AFF"] == 1 and cuda_lib.launches["K1"] == 0 and cuda_lib.launches["K1INV"] == 0
    assert torch.equal(words, cuda_curve.plain_affine_words(p))
    cuda_lib.reset_launches()
    got = C.projective_to_host_points(p)
    assert cuda_lib.launches["K1AFF"] == 1
    assert got == C.projective_to_host_points(p.cpu()) == host
