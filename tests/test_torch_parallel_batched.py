"""The port's batch-sharded MSMs (``parallel.msm_batched_sharded`` and
``msm_fixed_base_sharded``) on gloo groups of 2 and 4 CPU ranks against the
JAX package's single-device ``msm_batched``/``msm_fixed_base`` and the
native oracle on the same seeded lanes, as group elements: batches that the
mesh does not divide (padded lanes), lanes under 64 points (K5 and a
K2FOLD fold a lane) and of 64 (the sorted accumulation and K7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_ranks import replicated, seeded_basis, seeded_scalars, start_groups
from verkle_kzg_tpu.ops import curve as JC
from verkle_kzg_tpu.ops import msm as JM
from verkle_kzg_tpu.ops.limbs import ints_to_limbs
from verkle_kzg_tpu_torch import native
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F

torch.set_num_threads(1)

WORLDS = (2, 4)
BATCHED = (("b3x20", 3, 20), ("b3x64", 3, 64))  # (name, lanes, points a lane)
FIXED = (("f5x16", 5, 16), ("f3x64", 3, 64))


def _words(ks) -> np.ndarray:
    return np.stack([F.ints_to_words(k, "cpu").numpy() for k in ks])


def _jax_scalars(ks):
    return jnp.asarray(np.stack([ints_to_limbs(k).T for k in ks]))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0x13B)
    basis = seeded_basis(rng, 66)
    ints, arrays, msm = {}, {}, []
    for name, b, n in BATCHED:
        lanes = [basis[i : i + n] for i in range(b)]
        ints[name] = (lanes, [seeded_scalars(rng, n) for _ in range(b)])
        arrays[f"{name}.points"] = np.stack([C.host_points_to_affine(p, "cpu").numpy() for p in lanes])
        arrays[f"{name}.scalars"] = _words(ints[name][1])
        msm.append(("batched", name))
    for name, b, n in FIXED:
        ints[name] = (basis[:n], [seeded_scalars(rng, n) for _ in range(b)])
        arrays[f"{name}.points"] = C.host_points_to_affine(basis[:n], "cpu").numpy()
        arrays[f"{name}.scalars"] = _words(ints[name][1])
        msm.append(("fixed", name))
    return {"ints": ints, "arrays": arrays, "config": {"msm": msm}}


@pytest.fixture(scope="module")
def started(case, tmp_path_factory):
    return start_groups(dict.fromkeys(WORLDS, "msm"), tmp_path_factory.mktemp("mesh"), case["arrays"], case["config"])


@pytest.fixture(scope="module")
def ranks(started, jax_msm):
    return {w: f.result() for w, f in started.items()}


@pytest.fixture(scope="module")
def jax_msm(started, case):
    """The JAX package's single-device result of each case, computed once."""
    ints, out = case["ints"], {}
    for name, _, _ in BATCHED:
        lanes, ks = ints[name]
        out[name] = JC.projective_to_host_points(
            JM.msm_batched(jnp.stack([JC.host_points_to_affine(p) for p in lanes]), _jax_scalars(ks)))
    for name, _, _ in FIXED:
        basis, ks = ints[name]
        out[name] = JC.projective_to_host_points(JM.msm_fixed_base(JC.host_points_to_affine(basis), _jax_scalars(ks)))
    return out


def _got(ranks, world, name) -> list:
    return C.projective_to_host_points(torch.from_numpy(replicated(ranks[world], name)))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,b,n", BATCHED)
def test_msm_batched_sharded_matches_jax(ranks, case, jax_msm, world, name, b, n):
    lanes, ks = case["ints"][name]
    got = _got(ranks, world, name)
    assert len(got) == b
    assert got == jax_msm[name]
    assert got == [native.g1_msm(p, k) for p, k in zip(lanes, ks)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,b,n", FIXED)
def test_msm_fixed_base_sharded_matches_jax(ranks, case, jax_msm, world, name, b, n):
    basis, ks = case["ints"][name]
    got = _got(ranks, world, name)
    assert len(got) == b
    assert got == jax_msm[name]
    assert got == [native.g1_msm(basis, k) for k in ks]
