"""The mesh= paths of the protocols on a gloo group of 2 CPU ranks, the
analogue of ``__graft_entry__.dryrun_multichip``: a key-length-3, width-8
IPA verkle tree whose dense node commits are batch-sharded
(``VerkleTree(mesh=)``), ``IPA.commit(mesh=)``, and a multiproof's D and
its verify with the mesh (the D and E commits and verify's E aggregation
through ``msm_sharded``), each equal to the JAX package's single-device
result, and a wrong claimed value rejected on the mesh."""

import pytest
import torch

from torch_mesh_ranks import start_groups
from verkle_kzg_tpu.poly import FrVector as JFrVector
from verkle_kzg_tpu.schemes import IPA as JIPA
from verkle_kzg_tpu.schemes import ipa_setup as jax_ipa_setup
from verkle_kzg_tpu.schemes.multiproof import ProverQuery as JProverQuery
from verkle_kzg_tpu.schemes.multiproof import prove_multiproof as jax_prove_multiproof
from verkle_kzg_tpu.verkle import VerkleTree as JVerkleTree

torch.set_num_threads(1)

CONFIG = {
    "n": 8,
    "keys": [(0, 1, 2), (0, 1, 3), (2, 5, 7), (6, 1, 2), (6, 1, 4), (6, 3, 0)],
    "data": [3, 1, 4, 1, 5, 9, 2, 6],
    "zs": [2, 5],
}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return start_groups({2: "protocols"}, tmp_path_factory.mktemp("mesh"), {}, CONFIG)


@pytest.fixture(scope="module")
def ranks(started, jax_results):
    return started[2].result()


@pytest.fixture(scope="module")
def jax_results(started):
    crs = jax_ipa_setup(CONFIG["n"])
    tree = JVerkleTree(JIPA, crs, key_len=3, internal_width=CONFIG["n"])
    for i, k in enumerate(CONFIG["keys"]):
        tree.insert_single(k, 1000 + i)
    data = JFrVector.from_ints(CONFIG["data"], crs.domain)
    commit = JIPA.commit(crs, data)
    queries = [JProverQuery(data=data, commit=commit, z=z, y=CONFIG["data"][z]) for z in CONFIG["zs"]]
    return {"tree_root": list(tree.commitment()), "commit": list(commit),
            "multiproof_d": list(jax_prove_multiproof(JIPA, crs, queries).d)}


@pytest.mark.parametrize("key", ["tree_root", "commit", "multiproof_d"])
def test_mesh_paths_match_jax(ranks, jax_results, key):
    for _, vals in ranks:
        assert vals[key] == jax_results[key]


def test_multiproof_verifies_on_the_mesh(ranks):
    for _, vals in ranks:
        assert vals["verify"] is True
        assert vals["verify_wrong_y"] is False
