"""The port's G1 four-step NTT (``parallel.ntt_g1_sharded`` and
``intt_g1_sharded``) on gloo groups of 1, 2 and 4 CPU ranks, word for word
against the JAX package's ``ntt_g1_sharded``/``intt_g1_sharded`` with
``mesh=None`` and the same n1, on seeded points with the identity among
them; and the sub-NTTs' launches: one G1BFLY a stage over all of a rank's
columns. Its own file because JAX's G1 four-step compiles slowly on the CPU."""

import numpy as np
import pytest
import torch

from torch_mesh_ranks import replicated, seeded_basis, start_groups
from verkle_kzg_tpu.ops import curve as JC
from verkle_kzg_tpu.parallel.ntt import intt_g1_sharded, ntt_g1_sharded
from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.ops import cuda_g1_chain as G
from verkle_kzg_tpu_torch.ops import curve as C

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
N, N1 = 16, 4


def _to_port(arr) -> torch.Tensor:
    """JAX (3, 16, N) coordinate planes -> port (N, 3, 8) words."""
    arr = np.asarray(arr)
    return torch.stack([convert.limb_planes_to_tensor(arr[k], "cpu") for k in range(3)], dim=1)


@pytest.fixture(scope="module")
def points():
    pts = seeded_basis(np.random.default_rng(0x61), N)
    pts[3] = None  # the identity among the inputs
    return pts


@pytest.fixture(scope="module")
def started(points, tmp_path_factory):
    arrays = {"g16": C.from_affine(C.host_points_to_affine(points, "cpu")).numpy()}
    return start_groups(dict.fromkeys(WORLDS, "g1"), tmp_path_factory.mktemp("mesh"), arrays, {"g1": [("g16", N1)]})


@pytest.fixture(scope="module")
def ranks(started, jax_out):
    return {w: f.result() for w, f in started.items()}


@pytest.fixture(scope="module")
def jax_out(started, points):
    x = JC.from_affine(JC.host_points_to_affine(points))
    return {"ntt": _to_port(ntt_g1_sharded(x, mesh=None, n1=N1)), "intt": _to_port(intt_g1_sharded(x, mesh=None, n1=N1))}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", ["ntt", "intt"])
def test_g1_four_step_words_match_jax(ranks, jax_out, world, op):
    got = torch.from_numpy(replicated(ranks[world], f"g16.{op}"))
    assert torch.equal(got, jax_out[op])


def test_g1_four_step_is_the_g1_ntt(ranks, points):
    """As group elements, the four-step forward is ``ntt_g1`` and the
    inverse takes it back to the input."""
    from verkle_kzg_tpu_torch.ops import ntt as N_
    from verkle_kzg_tpu_torch.parallel.ntt import intt_g1_sharded as port_intt

    fwd = torch.from_numpy(replicated(ranks[2], "g16.ntt"))
    x = C.from_affine(C.host_points_to_affine(points, "cpu"))
    assert C.projective_to_host_points(fwd) == C.projective_to_host_points(N_.ntt_g1(x))
    assert C.projective_to_host_points(port_intt(fwd, None, N1)) == points


def test_sub_ntts_take_one_butterfly_launch_a_stage(points, monkeypatch):
    """log2(n1) + log2(n2) G1BFLY calls in all, each over every column of
    the rank at once, and one G1SMUL for the twiddles (three with the
    inverse's 1/n1 and 1/n2)."""
    from verkle_kzg_tpu_torch.parallel.ntt import intt_g1_sharded as port_intt
    from verkle_kzg_tpu_torch.parallel.ntt import ntt_g1_sharded as port_ntt

    calls = {"bfly": [], "smul": 0}
    bfly, smul = G.plain_butterfly, G.plain_scalar_mul

    def counted_bfly(x, tw, stage):
        calls["bfly"].append((x.shape[0], stage))
        return bfly(x, tw, stage)

    def counted_smul(p, k):
        calls["smul"] += 1
        return smul(p, k)

    monkeypatch.setattr(G, "plain_butterfly", counted_bfly)
    monkeypatch.setattr(G, "plain_scalar_mul", counted_smul)
    x = C.from_affine(C.host_points_to_affine(points, "cpu"))
    port_ntt(x, None, N1)
    assert calls == {"bfly": [(N, 0), (N, 1), (N, 0), (N, 1)], "smul": 1}
    calls["bfly"], calls["smul"] = [], 0
    port_intt(x, None, N1)
    assert len(calls["bfly"]) == 4 and calls["smul"] == 3
