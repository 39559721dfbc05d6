"""Kernel K1INV (verkle_kzg_tpu_torch.ops.cuda_field.inverse): its plain
version, which CPU tensors take, against the JAX package's inv_mont and
batch_inv_mont word for word, over Fr and Fq, N = 1, 8 and 256, with rows
holding zeros, 1, m - 1 and a row of zeros only; and, on a card, the kernel
against its plain version at the shapes of the port's paths.

The card cases import no JAX (the card's machine has none):

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu tests/test_torch_field_inv.py
"""

import random

import numpy as np
import pytest
import torch

from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.ops import cuda_field, cuda_lib
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.params import FQ, FR

torch.set_num_threads(1)

SPECS = {"fr": FR, "fq": FQ}


@pytest.fixture(scope="module")
def jax_field():
    import jax.numpy as jnp

    from verkle_kzg_tpu.ops import field as JF

    return jnp, JF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(spec, rows, n, seed, device):
    """(rows, n) field values with 0, 1 and m - 1 in every row, row 1 all
    zero when there are two rows or more -> (values, (rows, n, 8) Montgomery
    words)."""
    m = SPECS[spec].modulus
    rng = random.Random(seed)
    vals = [[rng.randrange(m) for _ in range(n)] for _ in range(rows)]
    for r, row in enumerate(vals):
        for j, v in enumerate((0, 1, m - 1)):
            row[(r + 5 * j) % n] = v
    if rows > 1:
        vals[1] = [0] * n
    flat = [v for row in vals for v in row]
    return flat, F.ints_to_mont(flat, spec, device).reshape(rows, n, F.WORDS)


def _host_inv(vals, m):
    return [pow(v, -1, m) if v else 0 for v in vals]


@pytest.mark.parametrize("spec", ["fr", "fq"])
@pytest.mark.parametrize("n", [1, 8, 256])
def test_plain_batch_inv_matches_jax(jax_field, spec, n):
    jnp, JF = jax_field
    rows = 3 if n < 256 else 2
    vals, words = _rows(spec, rows, n, 100 + n, "cpu")
    got = F.batch_inv_mont(words, spec)
    planes = np.stack([convert.tensor_to_limb_planes(w) for w in words])  # (rows, 16, n)
    want = np.asarray(JF.batch_inv_mont(jnp.asarray(planes), spec))
    assert np.array_equal(np.stack([convert.tensor_to_limb_planes(g) for g in got]), want)
    assert F.mont_to_ints(got, spec) == _host_inv(vals, SPECS[spec].modulus)


@pytest.mark.parametrize("spec", ["fr", "fq"])
def test_plain_inv_matches_jax(jax_field, spec):
    jnp, JF = jax_field
    vals, words = _rows(spec, 1, 24, 7, "cpu")
    flat = words.reshape(-1, F.WORDS)
    got = F.inv_mont(flat, spec)
    want = np.asarray(JF.inv_mont(jnp.asarray(convert.tensor_to_limb_planes(flat)), spec))
    assert np.array_equal(convert.tensor_to_limb_planes(got), want)
    assert F.mont_to_ints(got, spec) == _host_inv(vals, SPECS[spec].modulus)
    # any leading shape: (2, 3, 4, 8) element-wise
    assert torch.equal(F.inv_mont(flat.reshape(2, 3, 4, F.WORDS), spec), got.reshape(2, 3, 4, F.WORDS))


def test_cpu_takes_plain_and_counts_no_launch():
    _, words = _rows("fr", 2, 16, 9, "cpu")
    cuda_lib.reset_launches()
    assert torch.equal(cuda_field.inverse(words, "fr", batch=True), cuda_field.plain_batch_inv(words, "fr"))
    assert torch.equal(cuda_field.inverse(words, "fr", batch=False), cuda_field.plain_inv(words, "fr"))
    assert cuda_lib.launches["K1INV"] == 0 and cuda_lib.launches["K1"] == 0


# (spec, rows, n, batch): the out-of-domain quotient (1 x 256), invdiff_rows
# (19 x 256), to_affine's Z (2^12 Fq, N = 1), runs of several elements a
# thread (2 x 300, 1 x 1,000), short rows (3 x 8, 5 x 2) and no rows.
CARD_SHAPES = [
    ("fr", 1, 256, True), ("fr", 19, 256, True), ("fq", 4096, 1, False), ("fr", 2, 300, True),
    ("fq", 1, 1000, True), ("fr", 3, 8, True), ("fq", 5, 2, True), ("fr", 0, 256, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("spec,rows,n,batch", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda, spec, rows, n, batch):
    vals, words = _rows(spec, max(rows, 1), n, 40 + rows + n, cuda)
    words = words[:rows]
    if not batch:
        words = words.reshape(-1, F.WORDS)
    cuda_lib.reset_launches()
    got = cuda_field.inverse(words, spec, batch)
    torch.cuda.synchronize()
    assert cuda_lib.launches["K1INV"] == (1 if rows else 0) and cuda_lib.launches["K1"] == 0
    plain = cuda_field.plain_batch_inv if batch else cuda_field.plain_inv
    assert torch.equal(got, plain(words, spec))
    if rows:
        assert F.mont_to_ints(got, spec) == _host_inv(vals, SPECS[spec].modulus)
