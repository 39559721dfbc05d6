"""The three public signatures that once differed from the JAX package's
take JAX's keywords and defaults: ``field.powers_of_mont(x_mont=...)``,
``curve.mixed_add(p, q_affine=...)`` and ``curve.infinity()`` /
``infinity(lead=...)``, called so on the CPU against the JAX functions.
JAX's ``b`` (a lane count) is the port's trailing axis of b points,
keyword only, since the port's second position is the device; the old
positional calls keep working."""

import random

import numpy as np
import pytest
import torch

from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.hostmath import curve as hc
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.params import R

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_ops():
    import jax.numpy as jnp

    from verkle_kzg_tpu.ops import curve as JC
    from verkle_kzg_tpu.ops import field as JF

    return jnp, JC, JF


def _to_port(arr) -> torch.Tensor:
    """JAX (k, 16, N) coordinate planes -> port (N, k, 8) words."""
    arr = np.asarray(arr)
    return torch.stack([convert.limb_planes_to_tensor(arr[k], "cpu") for k in range(arr.shape[0])], dim=1)


@pytest.mark.parametrize("spec", ["fr", "fq"])
def test_powers_of_mont_by_keyword(jax_ops, spec):
    jnp, _, JF = jax_ops
    x = F.ints_to_mont([random.Random(5).randrange(R)], spec, "cpu")[0]
    got = F.powers_of_mont(x_mont=x, n=11, spec=spec)
    want = JF.powers_of_mont(x_mont=jnp.asarray(convert.tensor_to_limb_planes(x[None])[:, 0]), n=11, spec=spec)
    assert torch.equal(got, convert.limb_planes_to_tensor(np.asarray(want), "cpu"))
    assert torch.equal(F.powers_of_mont(x, 11, spec), got)  # positional, as every caller passes it


def test_mixed_add_by_keyword(jax_ops):
    _, JC, _ = jax_ops
    rng = random.Random(6)
    ps = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(64)) for _ in range(4)] + [None]
    qs = [None] + [hc.g1_mul(hc.g1_generator(), rng.getrandbits(64)) for _ in range(4)]
    jp, jq = JC.from_affine(JC.host_points_to_affine(ps)), JC.host_points_to_affine(qs)
    got = C.mixed_add(_to_port(jp), q_affine=_to_port(jq))
    assert torch.equal(got, _to_port(JC.mixed_add(jp, q_affine=jq)))
    assert torch.equal(C.mixed_add(p=_to_port(jp), q_affine=_to_port(jq)), got)


def test_infinity_defaults_and_keywords(jax_ops):
    _, JC, _ = jax_ops
    one = _to_port(JC.infinity())  # JAX: (3, 16, 1), one point
    assert C.infinity(device="cpu").shape == (3, F.WORDS)
    assert torch.equal(C.infinity(device="cpu"), one[0])
    assert torch.equal(C.infinity(lead=(2, 3), device="cpu"), one[0].expand(2, 3, 3, F.WORDS))
    # JAX's b lanes are b points on a trailing axis
    jb = _to_port(JC.infinity(lead=(), b=4))  # (4, 3, 8)
    assert torch.equal(C.infinity(device="cpu", b=4), jb)
    assert C.infinity(lead=(2,), device="cpu", b=1).shape == (2, 1, 3, F.WORDS)
    # the port's positional form, as its callers use it
    assert torch.equal(C.infinity((5,), "cpu"), one[0].expand(5, 3, F.WORDS))
    assert C.projective_to_host_points(C.infinity((2,), "cpu", b=3)) == [None] * 6


def test_infinity_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.infinity()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.infinity(lead=(2,))
