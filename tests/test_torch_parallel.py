"""The port's parallel package (verkle_kzg_tpu_torch.parallel) on gloo
groups of 1, 2 and 4 CPU ranks against the JAX package on the same seeded
inputs: the Fr four-step NTT word for word against JAX's
``ntt_fr_sharded``/``intt_fr_sharded`` with ``mesh=None`` and the same n1,
and the sharded single MSM as a group element against JAX's ``msm_auto``
and the native oracle (N that the mesh does not divide, shards on both
sides of 64 points); and what ``make_mesh`` refuses. Each group of ranks
runs once per module, as subprocesses of ``torch_mesh_ranks.py`` with a
timeout. The batched MSMs are in ``test_torch_parallel_batched.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_ranks import replicated, seeded_basis, seeded_scalars, start_groups
from verkle_kzg_tpu.hostmath import curve as hc
from verkle_kzg_tpu.ops import curve as JC
from verkle_kzg_tpu.ops import field as JF
from verkle_kzg_tpu.ops import msm as JM
from verkle_kzg_tpu.ops.limbs import ints_to_limbs
from verkle_kzg_tpu.parallel.ntt import intt_fr_sharded, ntt_fr_sharded
from verkle_kzg_tpu.params import R
from verkle_kzg_tpu_torch import convert, native
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
FR = (("fr16", 4), ("fr32", None))  # n1 = 4 both; N = 32 through the default split
SINGLE = (101, 130, 257)  # shards of 51 / 26, 65 / 33, 129 / 65 points at d = 2 / 4
WEIGHTS = (1, 2, 4)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0x13D)
    ints, arrays = {}, {}
    for name, n in (("fr16", 16), ("fr32", 32)):
        ints[name] = seeded_scalars(rng, n)
        arrays[name] = F.ints_to_mont(ints[name], "fr", "cpu").numpy()
    basis = seeded_basis(rng, max(SINGLE))
    for n in SINGLE:
        ints[n] = seeded_scalars(rng, n)
        arrays[f"s{n}.points"] = C.host_points_to_affine(basis[:n], "cpu").numpy()
        arrays[f"s{n}.scalars"] = F.ints_to_words(ints[n], "cpu").numpy()
    config = {"fr": FR, "msm": [("single", f"s{n}") for n in SINGLE]}
    return {"ints": ints, "arrays": arrays, "config": config, "basis": basis}


@pytest.fixture(scope="module")
def started(case, tmp_path_factory):
    """The Fr NTTs at d = 1, 2 and 4, the MSMs and make_mesh's refusals at
    d = 2 and 4: every group at once."""
    groups = {1: "fr", 2: "fr,msm,mesh", 4: "fr,msm,mesh"}
    return start_groups(groups, tmp_path_factory.mktemp("mesh"), case["arrays"], case["config"])


@pytest.fixture(scope="module")
def ranks(started, jax_msm):
    """world -> every rank's (arrays, values), once the JAX reference is made."""
    return {w: f.result() for w, f in started.items()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,n1", FR)
def test_fr_four_step_words_match_jax(ranks, case, world, name, n1):
    jx = JF.to_mont(jnp.asarray(ints_to_limbs(case["ints"][name]).T), "fr")
    assert torch.equal(convert.limb_planes_to_tensor(jx, "cpu"), torch.from_numpy(case["arrays"][name]))
    for op, jax_op in (("ntt", ntt_fr_sharded), ("intt", intt_fr_sharded)):
        got = torch.from_numpy(replicated(ranks[world], f"{name}.{op}"))
        assert torch.equal(got, convert.limb_planes_to_tensor(jax_op(jx, mesh=None, n1=n1), "cpu")), op
    assert all(vals[f"{name}.roundtrip"] for _, vals in ranks[world])


@pytest.fixture(scope="module")
def jax_msm(started, case):
    """One JAX ``msm_auto`` at 257 points over k_101 + 2 k_130 + 4 k_257
    (zero past each prefix): P_101 + 2 P_130 + 4 P_257 of the three MSMs."""
    ks = case["ints"]
    mixed = [sum(w * ks[n][i] for w, n in zip(WEIGHTS, SINGLE) if i < n) % R for i in range(max(SINGLE))]
    out = JM.msm_auto(JC.host_points_to_affine(case["basis"]), jnp.asarray(ints_to_limbs(mixed).T))
    return JC.projective_to_host_points(out)[0]


@pytest.mark.parametrize("world", (2, 4))
def test_msm_sharded_matches_jax(ranks, case, jax_msm, world):
    """Each size against the native oracle, and the three together against
    JAX's ``msm_auto`` (:func:`jax_msm`)."""
    total = None
    for w, n in zip(WEIGHTS, SINGLE):
        got = C.projective_to_host_points(torch.from_numpy(replicated(ranks[world], f"s{n}"))[None])[0]
        assert got == native.g1_msm(case["basis"][:n], case["ints"][n]), n
        total = hc.g1_add(total, hc.g1_mul(got, w))
    assert total == jax_msm


@pytest.mark.parametrize("world", (2, 4))
def test_make_mesh_refuses(ranks, world):
    """A CUDA mesh on a gloo group, the card by default on a box without
    one, more ranks than the world and an input off the mesh's device all
    raise; a one-rank mesh holds rank 0 and leaves the others out."""
    for rank, (_, vals) in enumerate(ranks[world]):
        assert "needs nccl" in vals["cuda_on_gloo"]
        assert "no CUDA device" in vals["default"]
        assert "n_devices must be in" in vals["too_many"]
        assert "the mesh's device is cpu" in vals["wrong_device"]
        assert vals["one"] == [1, 0 if rank == 0 else -1]


def test_make_mesh_needs_a_process_group():
    from verkle_kzg_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        make_mesh(device="cpu")


def test_four_step_checks_its_split():
    from verkle_kzg_tpu_torch.parallel import ntt_fr_sharded as port_ntt

    x = F.ints_to_mont(list(range(16)), "fr", "cpu")
    with pytest.raises(ValueError, match="power of two"):
        port_ntt(x[:12], None, 4)
    with pytest.raises(ValueError, match="both above 1"):
        port_ntt(x, None, 16)
