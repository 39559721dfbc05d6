"""The port's KZG slice (verkle_kzg_tpu_torch.schemes.kzg and .fk, the KZG
SRS generators, the Lagrange quotients and the multiproof and verkle tree
over KZG) against the JAX package on the same SRS and seeded data, through
the plain kernel versions on the CPU. SRS points, commitments, proofs,
verification results, FK proofs, multiproof fields, transcript states and
tree node commitments must be identical."""

import contextlib
import random

import pytest
import torch

import verkle_kzg_tpu.schemes.multiproof as jax_mp
import verkle_kzg_tpu_torch.schemes.multiproof as port_mp
from verkle_kzg_tpu.errors import KZGError as JKZGError
from verkle_kzg_tpu.hostmath.curve import g1_add, g1_generator
from verkle_kzg_tpu.params import R
from verkle_kzg_tpu.poly import FrVector as JFrVector
from verkle_kzg_tpu.schemes import KZG as JKZG
from verkle_kzg_tpu.schemes import ProverQuery as JProverQuery
from verkle_kzg_tpu.schemes import kzg_setup as jax_kzg_setup
from verkle_kzg_tpu.schemes.generators import kzg_generate_monomial_srs as jax_monomial_srs
from verkle_kzg_tpu.verkle import VerkleTree as JVerkleTree
from verkle_kzg_tpu_torch import convert, native
from verkle_kzg_tpu_torch.errors import KZGError
from verkle_kzg_tpu_torch.hostmath import pairing
from verkle_kzg_tpu_torch.hostmath.curve import g2_generator
from verkle_kzg_tpu_torch.poly import FrVector
from verkle_kzg_tpu_torch.schemes import (
    KZG,
    VerifierQuery,
    kzg_generate_monomial_srs,
    kzg_setup,
    prove_multiproof,
    verify_multiproof,
)

torch.set_num_threads(1)

SIZE = 8
DATA = 5  # shorter than the domain: the zero-padded tail
MP_SIZE = 16  # the multiproof and the tree
KEY_LEN = 3


@pytest.fixture(scope="module")
def crs():
    jcrs = jax_kzg_setup(SIZE)
    return jcrs, convert.kzg_params_from_jax(jcrs, "cpu")


@pytest.fixture(scope="module")
def data(crs):
    jcrs, pcrs = crs
    vals = [random.Random(0xFE15).randrange(1, 2**63) for _ in range(DATA)]
    return vals, JFrVector.from_ints(vals, jcrs.domain), FrVector.from_ints(vals, pcrs.domain, device="cpu")


def test_setup_matches_jax(crs):
    jcrs, _ = crs
    own = kzg_setup(SIZE, device="cpu")
    assert own.size == jcrs.size == SIZE
    assert own.lagrange_host == jcrs.lagrange_host
    assert own.g2 == jcrs.g2
    assert own.domain.omegas == jcrs.domain.omegas
    assert own.lagrange_affine.device == torch.device("cpu")
    assert kzg_generate_monomial_srs(SIZE, device="cpu") == jax_monomial_srs(SIZE)


def test_commit_prove_verify_match_jax(crs, data):
    jcrs, pcrs = crs
    vals, jdata, pdata = data
    commit = KZG.commit(pcrs, pdata)
    assert commit == JKZG.commit(jcrs, jdata)
    for point in (0, DATA - 1, DATA + 1, SIZE - 1, 3 * SIZE):  # stored, padded, outside
        got = KZG.prove(pcrs, commit, point, pdata)
        want = JKZG.prove(jcrs, commit, point, jdata)
        assert (got.proof, got.y) == (want.proof, want.y), point
        assert got.y == (vals[point] if point < DATA else got.y)
        assert KZG.verify(pcrs, commit, point, got)
    bad = g1_add(commit, g1_generator())
    assert not KZG.verify(pcrs, bad, 0, KZG.prove(pcrs, commit, 0, pdata))
    assert not JKZG.verify(jcrs, bad, 0, KZG.prove(pcrs, commit, 0, pdata))
    with pytest.raises(KZGError):
        KZG.prove(pcrs, commit, SIZE, pdata)
    with pytest.raises(JKZGError):
        JKZG.prove(jcrs, commit, SIZE, jdata)
    with pytest.raises(NotImplementedError):
        KZG.prove_batch(pcrs, commit, [0], pdata)


def test_batch_stubs_and_max_size_match_jax(crs, data):
    """prove_batch/verify_batch raise JAX's NotImplementedError messages,
    and max_size() is the domain size in both packages."""
    jcrs, pcrs = crs
    _, jdata, pdata = data
    assert pcrs.max_size() == jcrs.max_size() == SIZE
    calls = (("prove_batch", (None, [0, 1]), (jdata,), (pdata,)), ("verify_batch", (None, None), (), ()))
    for name, args, jextra, pextra in calls:
        with pytest.raises(NotImplementedError) as want:
            getattr(JKZG, name)(jcrs, *args, *jextra)
        with pytest.raises(NotImplementedError) as got:
            getattr(KZG, name)(pcrs, *args, *pextra)
        assert str(got.value) == str(want.value), name


def test_fk_matches_jax(crs, data):
    """FK all-points proofs against JAX prove_all_points and against the
    port's own single proofs (SIZE 8, DATA 5)."""
    jcrs, pcrs = crs
    _, jdata, pdata = data
    got = KZG.prove_all_points(pcrs, pdata)
    want = JKZG.prove_all_points(jcrs, jdata)
    assert [(p.proof, p.y) for p in got] == [(p.proof, p.y) for p in want]
    commit = KZG.commit(pcrs, pdata)
    singles = [KZG.prove(pcrs, commit, i, pdata) for i in range(SIZE)]
    assert [(p.proof, p.y) for p in got] == [(p.proof, p.y) for p in singles]
    assert KZG.verify(pcrs, commit, DATA + 1, got[DATA + 1])


def test_verify_through_python_pairing(crs, data, monkeypatch):
    """KZG verify where the native pairing library is unavailable: the
    port's Python Miller loop and final exponentiation give the native
    product bit for bit, and verify stays true, and false when tampered."""
    _, pcrs = crs
    _, _, pdata = data
    commit = KZG.commit(pcrs, pdata)
    proof = KZG.prove(pcrs, commit, 1, pdata)
    pairs = [(proof.proof, pcrs.g2), (commit, g2_generator())]
    native_value = pairing.multi_pairing(pairs)
    monkeypatch.setattr(native, "multi_pairing", lambda pairs: None)
    assert pairing.multi_pairing(pairs) == native_value
    assert KZG.verify(pcrs, commit, 1, proof)
    assert not KZG.verify(pcrs, g1_add(commit, g1_generator()), 1, proof)


def test_lagrange_helpers_match_jax(crs, data):
    jcrs, _ = crs
    vals, jdata, pdata = data
    for z in (2, 3 * SIZE + 1):
        fn = "divide_by_vanishing" if z < SIZE else "divide_by_vanishing_outside"
        got, want = getattr(pdata, fn)(z), getattr(jdata, fn)(z)
        assert got.to_ints() == want.to_ints() and got.max == want.max == SIZE, fn
    assert pdata.interpolate() == jdata.interpolate()
    assert pdata.get_all() == jdata.get_all()
    other = [random.Random(3).randrange(R) for _ in range(SIZE)]
    assert pdata.inner_product_ints(other) == jdata.inner_product_ints(other)
    raw = bytes(range(40))
    assert FrVector.bytes_to_item(raw) == JFrVector.bytes_to_item(raw)
    assert pdata.domain.element(SIZE + 3) == jcrs.domain.element(SIZE + 3)


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


@pytest.fixture(scope="module")
def crs16():
    jcrs = jax_kzg_setup(MP_SIZE)
    return jcrs, convert.kzg_params_from_jax(jcrs, "cpu")


def test_multiproof_matches_jax(crs16):
    """The KZG multiproof at domain 16: D, the final proof and its y, and
    the transcript state; the proof verifies, a wrong y does not."""
    jcrs, pcrs = crs16
    rng = random.Random(24)
    vecs = [[rng.randrange(R) for _ in range(MP_SIZE)] for _ in range(3)]
    picks = [(rng.randrange(3), rng.randrange(MP_SIZE)) for _ in range(24)]
    jdata = [JFrVector.from_ints(v, jcrs.domain) for v in vecs]
    commits = [JKZG.commit(jcrs, d) for d in jdata]
    jq = [JProverQuery(data=jdata[k], commit=commits[k], z=z, y=vecs[k][z]) for k, z in picks]
    pq = convert.prover_queries_from_jax(jq, "cpu")
    with _recording(jax_mp) as jmade:
        want = jax_mp.prove_multiproof(JKZG, jcrs, jq)
    with _recording(port_mp) as made:
        got = prove_multiproof(KZG, pcrs, pq)
    assert (got.d, got.proof.proof, got.proof.y) == (want.d, want.proof.proof, want.proof.y)
    assert bytes(made[0]._state) == bytes(jmade[0]._state)
    vq = [VerifierQuery(q.commit, q.z, q.y) for q in pq]
    assert verify_multiproof(KZG, pcrs, vq, got)
    bad = [VerifierQuery(q.commit, q.z, (q.y + (i == 5)) % R) for i, q in enumerate(vq)]
    assert not verify_multiproof(KZG, pcrs, bad, got)


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


def test_tree_matches_jax(crs16):
    """A KZG verkle tree at domain 16 with a dense internal node and a dense
    root: every node commitment equal to the JAX tree's, and a proof of
    present and absent keys that verifies."""
    jcrs, pcrs = crs16
    rng = random.Random(0x7EE)
    keys = [(0, j, rng.randrange(MP_SIZE)) for j in range(10)] + [(u, 1, rng.randrange(MP_SIZE)) for u in range(1, 11)]
    values = {k: rng.randrange(1 << 256) for k in keys}
    jtree = JVerkleTree(JKZG, jcrs, KEY_LEN, ext_width=MP_SIZE, internal_width=MP_SIZE)
    for k in keys:
        jtree.insert_single(k, values[k])
    jtree.commitment()
    tree = convert.verkle_tree_from_jax(jtree, pcrs)
    assert tree.scheme is KZG
    tree.commitment()
    assert len(tree.root.children) > tree.SPARSE_NNZ_MAX  # the root is dense
    assert _node_commits(tree) == _node_commits(jtree)
    sample = keys[:2] + [(12, 0, 0), (0, 11, 3)]
    proof = tree.prove_keys(sample)
    claims = {k: values.get(k) for k in sample}
    assert tree.verify_keys(sample, claims, proof)
    claims[keys[0]] += 1
    assert not tree.verify_keys(sample, claims, proof)
