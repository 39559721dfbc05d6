"""The port's multiproof and verkle tree (verkle_kzg_tpu_torch.schemes.multiproof,
verkle_kzg_tpu_torch.verkle, on the plain kernel versions on the CPU)
against the JAX package at domain 16 on the same CRS, data and tree:
commitments, proofs, commitment streams, modes and transcript states must
be bit-identical. Each package runs once, in a module fixture."""

import contextlib
import random

import pytest
import torch

import verkle_kzg_tpu.schemes.multiproof as jax_mp
import verkle_kzg_tpu_torch.schemes.multiproof as port_mp
from verkle_kzg_tpu.hostmath.curve import g1_add, g1_generator
from verkle_kzg_tpu.params import R
from verkle_kzg_tpu.poly import FrVector as JFrVector
from verkle_kzg_tpu.schemes import IPA as JIPA
from verkle_kzg_tpu.schemes import ProverQuery as JProverQuery
from verkle_kzg_tpu.schemes import ipa_setup as jax_ipa_setup
from verkle_kzg_tpu.verkle import VerkleTree as JVerkleTree
from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.schemes import IPA, VerifierQuery, prove_multiproof, verify_multiproof
from verkle_kzg_tpu_torch.utils import metrics
from verkle_kzg_tpu_torch.verkle import VerkleVerifier

torch.set_num_threads(1)

SIZE = 16
KEY_LEN = 3


@contextlib.contextmanager
def _recording(module):
    """Record every Transcript the module's multiproof makes."""
    made = []
    base = module.Transcript

    class Recording(base):
        def __init__(self, label):
            super().__init__(label)
            made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "Transcript", Recording)
        yield made


def _tree_keys():
    """About 40 keys: 12 under first unit 0 (an internal node of 12 children,
    past SPARSE_NNZ_MAX = 8, so it takes the dense path), two under each of
    the first units 1..13 (a root of 14 children, dense too), distinct
    (unit 0, unit 1) pairs throughout."""
    rng = random.Random(0x7EE)
    keys = [(0, j, rng.randrange(SIZE)) for j in range(12)]
    for u in range(1, 14):
        a, b = rng.sample(range(SIZE), 2)
        keys += [(u, a, rng.randrange(SIZE)), (u, b, rng.randrange(SIZE))]
    values = {k: rng.randrange(1 << 256) for k in keys}
    return keys, values


K_L = (14, 1, 1)  # an extension with this stem holding only unit 9: mode "L"


def _absent_keys(keys):
    o_key = (0, 3, (keys[3][2] + 1) % SIZE)  # k1's extension, another stem: "O"
    e_root = (15, 0, 0)  # no root child 15: ("E", 0)
    used = {k[1] for k in keys if k[0] == 1}
    e_inner = (1, min(set(range(SIZE)) - used), 2)  # ("E", 1)
    return [o_key, e_root, e_inner, K_L]


def _build(tree_cls, *args, **kw):
    keys, values = _tree_keys()
    tree = tree_cls(*args, KEY_LEN, ext_width=SIZE, internal_width=SIZE, **kw)
    for k in keys:
        tree.insert_single(k, values[k])
    tree._insert(tree.root, K_L, [(9, 12345)], 0)
    return tree


def _mp_inputs(rng):
    vecs = [[rng.randrange(R) for _ in range(SIZE)] for _ in range(3)]
    picks = [(rng.randrange(3), rng.randrange(SIZE)) for _ in range(24)]
    return vecs, picks


@pytest.fixture(scope="module")
def jax_side():
    jcrs = jax_ipa_setup(SIZE)
    vecs, picks = _mp_inputs(random.Random(24))
    data = [JFrVector.from_ints(v, jcrs.domain) for v in vecs]
    commits = [JIPA.commit(jcrs, d) for d in data]
    queries = [JProverQuery(data=data[k], commit=commits[k], z=z, y=vecs[k][z]) for k, z in picks]
    with _recording(jax_mp) as made:
        mproof = jax_mp.prove_multiproof(JIPA, jcrs, queries)
    tree = _build(JVerkleTree, JIPA, jcrs)
    tree.commitment()
    keys, _ = _tree_keys()
    prove = keys[:3] + keys[20:23] + _absent_keys(keys)
    return {
        "crs": jcrs, "queries": queries, "mproof": mproof, "state": bytes(made[0]._state),
        "tree": tree, "prove": prove, "kproof": tree.prove_keys(prove),
    }


@pytest.fixture(scope="module")
def port_side(jax_side):
    crs = convert.ipa_params_from_jax(jax_side["crs"], "cpu")
    queries = convert.prover_queries_from_jax(jax_side["queries"], "cpu")
    with _recording(port_mp) as made:
        mproof = prove_multiproof(IPA, crs, queries)
    tree = convert.verkle_tree_from_jax(jax_side["tree"], crs)
    metrics.reset_counters()
    tree.commitment()
    dense_calls = metrics.counters().get("span.orchestration.msm_fixed_base.calls", 0)
    return {
        "crs": crs, "queries": queries, "mproof": mproof, "state": bytes(made[0]._state),
        "tree": tree, "dense_calls": dense_calls, "kproof": tree.prove_keys(jax_side["prove"]),
    }


def _fields(mp):
    return (mp.d, mp.proof.l, mp.proof.r, mp.proof.tip, mp.proof.y)


def test_multiproof_matches_jax(jax_side, port_side):
    assert _fields(port_side["mproof"]) == _fields(jax_side["mproof"])
    assert port_side["state"] == jax_side["state"]


def test_multiproof_verifies_and_rejects(jax_side, port_side):
    crs, mproof = port_side["crs"], port_side["mproof"]
    vq = [VerifierQuery(q.commit, q.z, q.y) for q in port_side["queries"]]
    assert verify_multiproof(IPA, crs, vq, mproof)
    assert verify_multiproof(IPA, crs, vq, jax_side["mproof"])  # a JAX proof under the port
    bad_y = [VerifierQuery(q.commit, q.z, (q.y + (i == 5)) % R) for i, q in enumerate(vq)]
    assert not verify_multiproof(IPA, crs, bad_y, mproof)
    bad_c = [VerifierQuery(g1_add(q.commit, g1_generator()) if i == 0 else q.commit, q.z, q.y) for i, q in enumerate(vq)]
    assert not verify_multiproof(IPA, crs, bad_c, mproof)


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


def test_tree_commitments_match_jax(jax_side, port_side):
    jtree, tree = jax_side["tree"], port_side["tree"]
    assert len(tree.root.children) > tree.SPARSE_NNZ_MAX  # the root is dense
    assert len(tree.root.children[0].children) > tree.SPARSE_NNZ_MAX
    assert port_side["dense_calls"] >= 2  # the depth-1 level and the root level
    assert tree.root.commit == jtree.root.commit is not None
    assert _node_commits(tree) == _node_commits(jtree)


def test_prove_keys_matches_jax(jax_side, port_side):
    want, got = jax_side["kproof"], port_side["kproof"]
    assert got.commitments == want.commitments
    assert got.modes == want.modes
    assert sorted(m[0] for m in got.modes.values()) == ["E", "E", "L", "O"] + ["P"] * 6
    assert _fields(got.multiproof) == _fields(want.multiproof)


def test_verifier_accepts_and_rejects(jax_side, port_side):
    tree, proof, keys = port_side["tree"], port_side["kproof"], jax_side["prove"]
    values = {k: tree.get_single(k) for k in keys}
    assert sum(v is None for v in values.values()) == 4
    verifier = VerkleVerifier(scheme=IPA, params=port_side["crs"], key_len=KEY_LEN, ext_width=SIZE)
    assert verifier.verify(tree.root.commit, keys, values, proof)
    assert tree.verify_keys(keys, values, jax_side["kproof"])  # a JAX proof under the port
    bad = dict(values)
    bad[keys[1]] += 1
    assert not verifier.verify(tree.root.commit, keys, bad, proof)
