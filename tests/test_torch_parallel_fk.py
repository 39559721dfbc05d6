"""FK all-points proofs with a mesh (``fk.prove_all_points(params, data,
mesh=)``: every Fr and G1 transform, at N and 2N, the four-step across the
ranks) on gloo groups of 2 and 4 CPU ranks, at domain 16 over 13 seeded
values, against the JAX package's single-device proof list."""

import numpy as np
import pytest
import torch

from torch_mesh_ranks import seeded_scalars, start_groups
from verkle_kzg_tpu.poly import FrVector as JFrVector
from verkle_kzg_tpu.schemes import kzg_setup as jax_kzg_setup
from verkle_kzg_tpu.schemes.fk import prove_all_points as jax_prove_all_points

torch.set_num_threads(1)

WORLDS = (2, 4)
N = 16


@pytest.fixture(scope="module")
def values():
    return seeded_scalars(np.random.default_rng(0xF16), N - 3)


@pytest.fixture(scope="module")
def started(values, tmp_path_factory):
    return start_groups(dict.fromkeys(WORLDS, "fk"), tmp_path_factory.mktemp("mesh"), {}, {"fk_n": N, "fk_data": values})


@pytest.fixture(scope="module")
def ranks(started, jax_proofs):
    return {w: f.result() for w, f in started.items()}


@pytest.fixture(scope="module")
def jax_proofs(started, values):
    crs = jax_kzg_setup(N)
    return [[list(p.proof), p.y] for p in jax_prove_all_points(crs, JFrVector.from_ints(values, crs.domain))]


@pytest.mark.parametrize("world", WORLDS)
def test_fk_with_mesh_matches_jax(ranks, jax_proofs, world):
    for _, vals in ranks[world]:
        assert vals["fk"] == jax_proofs


def test_fk_with_mesh_verifies(ranks, values):
    from verkle_kzg_tpu_torch.poly import FrVector
    from verkle_kzg_tpu_torch.schemes import KZG, KZGProof, kzg_setup

    crs = kzg_setup(N, device="cpu")
    data = FrVector.from_ints(values, crs.domain, device="cpu")
    commit = KZG.commit(crs, data)
    proofs = ranks[4][0][1]["fk"]
    for i in (0, N - 1):
        proof, y = proofs[i]
        assert y == (values + [0] * 3)[i]
        assert KZG.verify(crs, commit, i, KZGProof(proof=tuple(proof), y=y))
