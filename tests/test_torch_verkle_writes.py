"""A block of writes into a committed verkle tree, committed again: the
port's tree (``verkle_kzg_tpu_torch.verkle``, on the plain kernel versions
on the CPU) against the JAX package's after the same writes, over the IPA
and over KZG at domain 16, in ``tests/test_torch_verkle.py``'s geometry.
The port's tree starts as the committed JAX tree, converted with its
commitments. The writes update values, add units to present extensions
(one of them until its c2 vector turns dense), split a root-level
extension into a new internal node and add a root child. After the commit
that follows, every node commitment must equal the JAX tree's and a fresh
port tree's of the final contents, and that commit must visit only the
nodes on the written paths."""

import random

import pytest
import torch

from verkle_kzg_tpu.schemes import IPA as JIPA
from verkle_kzg_tpu.schemes import KZG as JKZG
from verkle_kzg_tpu.schemes import ipa_setup as jax_ipa_setup
from verkle_kzg_tpu.schemes import kzg_setup as jax_kzg_setup
from verkle_kzg_tpu.verkle import VerkleTree as JVerkleTree
from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.utils import metrics
from verkle_kzg_tpu_torch.verkle import VerkleTree
from verkle_kzg_tpu_torch.verkle.tree import InternalNode

torch.set_num_threads(1)

SIZE = 16
KEY_LEN = 3
K_L = (14, 1, 1)  # a root-level extension holding only unit 9


def _tree_keys():
    """About 40 keys: 12 under first unit 0 (an internal node of 12 children,
    past SPARSE_NNZ_MAX = 8, so it takes the dense path), two under each of
    the first units 1..13 (a root of 14 children, dense too), distinct
    (unit 0, unit 1) pairs throughout (``tests/test_torch_verkle.py``'s)."""
    rng = random.Random(0x7EE)
    keys = [(0, j, rng.randrange(SIZE)) for j in range(12)]
    for u in range(1, 14):
        a, b = rng.sample(range(SIZE), 2)
        keys += [(u, a, rng.randrange(SIZE)), (u, b, rng.randrange(SIZE))]
    values = {k: rng.randrange(1 << 256) for k in keys}
    return keys, values


def _start_keys():
    """The tree before the writes, cut from those keys to keep the plain
    versions' time down: 9 under unit 0 (still a dense internal node) and
    the first under each of 1..7 (root-level extensions), so that with K_L's
    the root has 9 children (dense)."""
    keys, values = _tree_keys()
    keys = [k for k in keys if k[0] == 0][:9] + [next(k for k in keys if k[0] == u) for u in range(1, 8)]
    return keys, {k: values[k] for k in keys}


def _writes(keys):
    """(stem, unit, value) inserts: 4 new values of present keys; a new unit
    in one extension (in the half its key's unit is not in) and five above
    unit 7 in another (10 or more nonzero slots of its c2 vector: the dense
    path); a stem under root child 14 that splits K_L's extension into a
    new internal node; a stem under the new root child 15."""
    rng = random.Random(19)
    out = [(k, k[-1], rng.randrange(1 << 256)) for k in rng.sample(keys, 4)]
    out.append((keys[1], (keys[1][-1] + SIZE // 2) % SIZE, rng.randrange(1 << 256)))
    dense = keys[7]
    out += [(dense, u, rng.randrange(1 << 256)) for u in [u for u in range(8, SIZE) if u != dense[-1]][:5]]
    out += [((14, 5, 3), 3, rng.randrange(1 << 256)), ((15, 2, 7), 7, rng.randrange(1 << 256))]
    return out


def _node_commits(tree):
    out = []

    def walk(node, path):
        if hasattr(node, "stem"):
            out.append((path, node.commit, node.c1_commit, node.c2_commit))
            return
        out.append((path, node.commit))
        for unit in sorted(node.children):
            walk(node.children[unit], path + (unit,))

    walk(tree.root, ())
    return out


def _take_commits(tree, jtree):
    """Give the converted tree the committed JAX tree's commitments, node by
    node: the committed starting tree on the port's side. (The port's own
    commit of such a tree is held to JAX's in ``tests/test_torch_verkle.py``
    and ``tests/test_torch_kzg.py``; here every port commit is the one
    after the writes.)"""

    def walk(node, jnode):
        node.commit = jnode.commit
        if hasattr(node, "stem"):
            node.c1_commit, node.c2_commit = jnode.c1_commit, jnode.c2_commit
            return
        assert node.children.keys() == jnode.children.keys()
        for unit, child in node.children.items():
            walk(child, jnode.children[unit])

    walk(tree.root, jtree.root)


def _written_paths(tree, stems):
    """The internal nodes and the extensions on the paths of ``stems``, each once."""
    internal, exts = set(), set()
    for stem in stems:
        node, depth = tree.root, 0
        while isinstance(node, InternalNode):
            internal.add(id(node))
            node, depth = node.children[stem[depth]], depth + 1
        assert node.stem == stem
        exts.add(id(node))
    return len(internal), len(exts)


SCHEMES = {"ipa": (JIPA, jax_ipa_setup, convert.ipa_params_from_jax),
           "kzg": (JKZG, jax_kzg_setup, convert.kzg_params_from_jax)}


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_block_of_writes_recommits_as_jax_and_a_fresh_tree(scheme):
    jscheme, setup, params_from_jax = SCHEMES[scheme]
    jparams = setup(SIZE)
    params = params_from_jax(jparams, "cpu")
    keys, values = _start_keys()
    jtree = JVerkleTree(jscheme, jparams, KEY_LEN, ext_width=SIZE, internal_width=SIZE)
    for k in keys:
        jtree.insert_single(k, values[k])
    jtree._insert(jtree.root, K_L, [(9, 12345)], 0)
    jtree.commitment()
    tree = convert.verkle_tree_from_jax(jtree, params)
    _take_commits(tree, jtree)
    dense_before = metrics.counters().get("span.orchestration.msm_fixed_base.calls", 0)

    writes = _writes(keys)
    for t in (jtree, tree):
        for stem, unit, v in writes:
            t._insert(t.root, stem, [(unit, v)], 0)
    assert isinstance(tree.root.children[14], InternalNode)  # the split
    stems = list(dict.fromkeys(stem for stem, _, _ in writes))
    n_internal, n_ext = _written_paths(tree, stems)
    before = metrics.counters()
    root = tree.commitment()
    after = metrics.counters()
    dirty = {k: after.get(f"verkle.commit.{k}", 0) - before.get(f"verkle.commit.{k}", 0)
             for k in ("dirty_ext", "dirty_internal")}
    assert dirty == {"dirty_ext": n_ext, "dirty_internal": n_internal} and n_ext == len(stems)
    assert after.get("span.orchestration.msm_fixed_base.calls", 0) > dense_before  # the root and the dense c2 vector
    assert root == jtree.commitment()
    assert _node_commits(tree) == _node_commits(jtree)

    contents = {}  # stem -> its leaves, in insertion order
    for k in keys:
        contents[k] = {k[-1]: values[k]}
    contents[K_L] = {9: 12345}
    for stem, unit, v in writes:
        contents.setdefault(stem, {})[unit] = v
    fresh = VerkleTree(tree.scheme, params, KEY_LEN, ext_width=SIZE, internal_width=SIZE)
    for stem, leaves in contents.items():
        fresh._insert(fresh.root, stem, list(leaves.items()), 0)
    assert fresh.commitment() == root
    assert _node_commits(fresh) == _node_commits(tree)
