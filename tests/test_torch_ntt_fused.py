"""Kernel K1NTT (verkle_kzg_tpu_torch.ops.cuda_ntt): the entry points'
plain version, which CPU tensors take (ntt_fr, intt_fr, ntt_fr_segments),
against the JAX package's ntt_fr / intt_fr at 16 and 256 and on 4 segments
of 16, word for word; its twiddle table; and, on a card, the kernel against
its plain version at the paths' shapes and above the shared-memory tile,
exact, with one launch a transform up to the tile and one more a stage
above it.

The card cases import no JAX (the card's machine has none):

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu tests/test_torch_ntt_fused.py
"""

import random

import numpy as np
import pytest
import torch

from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.ops import cuda_lib, cuda_ntt
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import ntt as N
from verkle_kzg_tpu_torch.params import R, fr_root_of_unity

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_ntt():
    import jax.numpy as jnp

    from verkle_kzg_tpu.ops import ntt as JN

    return jnp, JN


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _vec(n, seed, device="cpu"):
    rng = random.Random(seed)
    vals = [rng.randrange(R) for _ in range(n)]
    vals[0], vals[-1] = 0, R - 1
    return F.ints_to_mont(vals, "fr", device)


def _jax(jnp, fn, x):
    return convert.limb_planes_to_tensor(np.asarray(fn(jnp.asarray(convert.tensor_to_limb_planes(x)))), "cpu")


@pytest.mark.parametrize("n", [16, 256])
def test_transforms_match_jax(jax_ntt, n):
    jnp, JN = jax_ntt
    x = _vec(n, 40 + n)
    ev = N.ntt_fr(x)
    assert torch.equal(ev, _jax(jnp, JN.ntt_fr, x))
    assert torch.equal(N.intt_fr(x), _jax(jnp, JN.intt_fr, x))
    assert torch.equal(N.intt_fr(ev), x)
    assert torch.equal(cuda_ntt.plain(x, n), ev)


@pytest.mark.parametrize("inverse", [False, True])
def test_segments_match_jax(jax_ntt, inverse):
    jnp, JN = jax_ntt
    x = _vec(64, 7)
    got = N.ntt_fr_segments(x, 16, inverse)
    fn = JN.intt_fr if inverse else JN.ntt_fr
    want = torch.cat([_jax(jnp, fn, x[16 * b : 16 * (b + 1)]) for b in range(4)])
    assert torch.equal(got, want)
    assert torch.equal(cuda_ntt.plain(x, 16, inverse), got)


@pytest.mark.parametrize("n", [2, 16, 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_table(n, inverse):
    w = fr_root_of_unity(n)
    if inverse:
        w = pow(w, -1, R)
    want = [pow(w, k, R) for k in range(n // 2)] + [pow(n, -1, R) if inverse else 1]
    assert F.mont_to_ints(N._Plan(n, inverse).k1ntt_table("cpu"), "fr") == want


def test_cpu_takes_plain_and_counts_no_launch():
    x = _vec(32, 3)
    cuda_lib.reset_launches()
    assert torch.equal(N.ntt_fr_segments(x, 8, True), cuda_ntt.plain(x, 8, True))
    assert torch.equal(N.ntt_fr(x), cuda_ntt.ntt(x, 32))
    assert cuda_lib.launches["K1NTT"] == 0 and cuda_lib.launches["K1"] == 0


# (N, segment, tile): the paths' transforms at 256 and 512, the four-step's
# 16 segments of 16 and 32 of 16, a size above the 4,096-element tile, and
# a small tile that sends 256 through the stage launches
CARD_SHAPES = [(256, 256, None), (512, 512, None), (256, 16, None), (512, 16, None), (1 << 14, 1 << 14, None),
               (256, 256, 16), (512, 64, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,seg,tile", CARD_SHAPES)
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_plain_on_card(cuda, monkeypatch, n, seg, tile, inverse):
    if tile is not None:
        monkeypatch.setattr(cuda_ntt, "TILE", tile)
    x = _vec(n, n + seg, cuda)
    cuda_lib.reset_launches()
    got = N.ntt_fr_segments(x, seg, inverse)
    torch.cuda.synchronize()
    log_seg, log_tile = seg.bit_length() - 1, min(seg, cuda_ntt.TILE).bit_length() - 1
    assert cuda_lib.launches["K1NTT"] == 1 + log_seg - log_tile and cuda_lib.launches["K1"] == 0
    assert torch.equal(got, cuda_ntt.plain(x, seg, inverse))
    assert torch.equal(N.ntt_fr_segments(got, seg, not inverse), x)
