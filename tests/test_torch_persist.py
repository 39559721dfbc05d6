"""The port's persistence (``utils/persist.py``) against the JAX package's in
both directions: a ``.npz`` written by JAX's ``save_ipa_params``,
``save_kzg_params`` or ``save_tree`` loads in the port with equal points
and an equal root commitment, and a file the port writes loads in JAX the
same way; and the profiling hooks (``utils/profiling.py``) write a trace
on the CPU."""

import pytest
import torch

from verkle_kzg_tpu.schemes import IPA as JIPA
from verkle_kzg_tpu.schemes import ipa_setup as jax_ipa_setup
from verkle_kzg_tpu.schemes import kzg_setup as jax_kzg_setup
from verkle_kzg_tpu.utils import persist as JP
from verkle_kzg_tpu.verkle import VerkleTree as JVerkleTree
from verkle_kzg_tpu_torch import utils as U
from verkle_kzg_tpu_torch.schemes import IPA, ipa_setup, kzg_setup
from verkle_kzg_tpu_torch.verkle import VerkleTree

torch.set_num_threads(1)

KEYS = [(0, 1, 2), (0, 1, 3), (2, 5, 7), (6, 1, 2), (6, 1, 4), (6, 3, 0)]


def _g2(params) -> list:
    return [c for f in params.g2 for c in (f.c0, f.c1)]


def _commits(node) -> list:
    """Every cached commitment of a tree, depth first, children in key order."""
    if hasattr(node, "stem"):
        return [("ext", node.stem, node.commit, node.c1_commit, node.c2_commit, sorted(node.leaves.items()))]
    out = [("int", node.commit)]
    for k in sorted(node.children):
        out += _commits(node.children[k])
    return out


@pytest.fixture(scope="module")
def jax_ipa():
    return jax_ipa_setup(8)


@pytest.fixture(scope="module")
def jax_tree(jax_ipa):
    tree = JVerkleTree(JIPA, jax_ipa, key_len=3, internal_width=8)
    for i, k in enumerate(KEYS):
        tree.insert_single(k, 1000 + i)
    tree.commitment()
    return tree


def test_ipa_params_both_ways(jax_ipa, tmp_path):
    JP.save_ipa_params(str(tmp_path / "jax.npz"), jax_ipa)
    got = U.load_ipa_params(str(tmp_path / "jax.npz"), device="cpu")
    assert (got.n, got.g_host, got.q_host, got.domain.size) == (8, jax_ipa.g_host, jax_ipa.q_host, 8)
    assert got.device == torch.device("cpu")
    U.save_ipa_params(str(tmp_path / "port.npz"), ipa_setup(8, device="cpu"))
    back = JP.load_ipa_params(str(tmp_path / "port.npz"))
    assert (back.n, back.g_host, back.q_host) == (8, jax_ipa.g_host, jax_ipa.q_host)


def test_kzg_params_both_ways(tmp_path):
    want = jax_kzg_setup(8)
    JP.save_kzg_params(str(tmp_path / "jax.npz"), want)
    got = U.load_kzg_params(str(tmp_path / "jax.npz"), device="cpu")
    assert (got.size, got.lagrange_host, _g2(got)) == (8, want.lagrange_host, _g2(want))
    U.save_kzg_params(str(tmp_path / "port.npz"), kzg_setup(8, device="cpu"))
    back = JP.load_kzg_params(str(tmp_path / "port.npz"))
    assert (back.size, back.lagrange_host, _g2(back)) == (8, want.lagrange_host, _g2(want))


def test_tree_from_jax_loads_in_the_port(jax_tree, tmp_path):
    """The cached commitments come back, the root is served from the cache,
    and an insert after the load recomputes the path to the root as the
    JAX tree does."""
    JP.save_tree(str(tmp_path / "jax.npz"), jax_tree)
    crs = ipa_setup(8, device="cpu")
    tree = U.load_tree(str(tmp_path / "jax.npz"), IPA, crs)
    assert (tree.key_len, tree.ext_width, tree.internal_width) == (3, 3, 8)
    assert _commits(tree.root) == _commits(jax_tree.root)
    assert tree.commitment() == jax_tree.commitment()
    tree.insert_single((4, 2, 2), 77)  # a new child of the root
    jax_tree.insert_single((4, 2, 2), 77)
    assert tree.commitment() == jax_tree.commitment()


def test_tree_from_the_port_loads_in_jax(jax_ipa, tmp_path):
    crs = ipa_setup(8, device="cpu")
    tree = VerkleTree(IPA, crs, key_len=3, internal_width=8)
    for i, k in enumerate(KEYS):
        tree.insert_single(k, 1000 + i)
    root = tree.commitment()
    U.save_tree(str(tmp_path / "port.npz"), tree)
    back = JP.load_tree(str(tmp_path / "port.npz"), JIPA, jax_ipa)
    assert _commits(back.root) == _commits(tree.root)
    assert back.commitment() == root


def test_load_checks_the_kind(tmp_path):
    U.save_ipa_params(str(tmp_path / "ipa.npz"), ipa_setup(4, device="cpu"))
    with pytest.raises(ValueError, match="not kzg"):
        U.load_kzg_params(str(tmp_path / "ipa.npz"), device="cpu")


def test_loads_default_to_the_card(tmp_path, monkeypatch):
    U.save_ipa_params(str(tmp_path / "ipa.npz"), ipa_setup(4, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        U.load_ipa_params(str(tmp_path / "ipa.npz"))


def test_device_trace_writes_a_trace(tmp_path):
    from verkle_kzg_tpu_torch.utils.profiling import annotate, device_trace

    with device_trace(str(tmp_path)) as prof:
        with annotate("vkzg.sum"):
            torch.arange(1000).sum()
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert "vkzg.sum" in traces[0].read_text()
    assert any(e.key == "vkzg.sum" for e in prof.key_averages())


def test_utils_exports_what_jax_does():
    from verkle_kzg_tpu import utils as JU

    assert U.__all__ == JU.__all__
    assert all(callable(getattr(U, name)) for name in U.__all__)
