"""The port's IPA (verkle_kzg_tpu_torch.schemes.ipa, on the plain kernel
versions on the CPU) against verkle_kzg_tpu.schemes.ipa at domain 8 (the
SIZE of tests/test_schemes.py): the same CRS and data go to both, and
commitments, proofs and transcript states must be bit-identical."""

import random

import pytest
import torch

from verkle_kzg_tpu import native
from verkle_kzg_tpu.fiatshamir.transcript import Transcript
from verkle_kzg_tpu.hostmath.curve import g1_add, g1_generator
from verkle_kzg_tpu.poly import FrVector as JFrVector
from verkle_kzg_tpu.schemes import IPA as JIPA
from verkle_kzg_tpu.schemes import ipa_setup as jax_ipa_setup
from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.poly import FrVector
from verkle_kzg_tpu_torch.schemes import IPA, ipa_setup

torch.set_num_threads(1)

SIZE = 8


def _fields(proof):
    return (proof.l, proof.r, proof.tip) + ((proof.y,) if hasattr(proof, "y") else ())


@pytest.fixture(scope="module")
def setup():
    """Both packages on one CRS and one data vector, with the port's
    commitment and proofs made once for the tests below."""
    jcrs = jax_ipa_setup(SIZE)
    crs = convert.ipa_params_from_jax(jcrs, "cpu")
    rng = random.Random(0x1A)
    vals = [rng.randrange(1, 2**64) for _ in range(SIZE - 2)]  # watermark 6: padded
    jdata = JFrVector.from_ints(vals, jcrs.domain)
    data = convert.frvector_from_jax(jdata, "cpu")
    commit = IPA.commit(crs, data)
    proofs = {}
    for point in (5, 2 * SIZE):
        t = Transcript("ipa")
        proofs[point] = (IPA.prove_point(crs, commit, point, data, t), bytes(t._state))
    return jcrs, crs, jdata, data, vals, commit, proofs


def test_commit_matches_jax(setup):
    jcrs, crs, jdata, data, vals, commit, _ = setup
    assert commit == JIPA.commit(jcrs, jdata)
    assert commit == native.g1_msm(crs.g_host[: len(vals)], vals)
    assert FrVector.from_ints(vals, crs.domain, "cpu").to_ints() == jdata.to_ints()


@pytest.mark.parametrize("point", [5, 2 * SIZE])
def test_prove_matches_jax(setup, point):
    """In-domain index and out-of-domain point: the same L, R, tip and y,
    and the same final transcript state."""
    jcrs, crs, jdata, data, vals, commit, proofs = setup
    proof, state = proofs[point]
    t = Transcript("ipa")
    want = JIPA.prove_point(jcrs, commit, point, jdata, t)
    assert _fields(proof) == _fields(want)
    assert state == bytes(t._state)
    assert proof.y == (vals[point] if point < SIZE else jdata.evaluate(point))


def test_verify_both_ways_and_rejects(setup):
    jcrs, crs, jdata, data, vals, commit, proofs = setup
    inside, _ = proofs[5]
    outside, _ = proofs[2 * SIZE]
    assert IPA.verify(crs, commit, 2 * SIZE, outside)
    assert JIPA.verify(jcrs, commit, 5, inside)
    assert JIPA.verify(jcrs, commit, 2 * SIZE, outside)
    jax_inside = JIPA.prove(jcrs, commit, 5, jdata)
    assert IPA.verify(crs, commit, 5, jax_inside)  # a JAX proof under the port
    assert not IPA.verify(crs, g1_add(commit, g1_generator()), 5, inside)
    assert not IPA.verify(crs, commit, 5, outside)  # cross proof


def test_commitment_proof_matches_jax(setup):
    jcrs, crs, jdata, data, vals, commit, _ = setup
    proof = IPA.prove_commitment(crs, commit, data)
    assert len(proof.l) == 3  # watermark 6 zero-padded to 8 (COMPAT quirk 10)
    assert _fields(proof) == _fields(JIPA.prove_commitment(jcrs, commit, jdata))
    assert IPA.verify_commitment_proof(crs, commit, proof)
    assert not IPA.verify_commitment_proof(crs, g1_add(commit, g1_generator()), proof)


def test_batch_stubs_and_max_size_match_jax(setup):
    """The reference leaves prove_batch/verify_batch as todo!(): both
    packages raise NotImplementedError with the same message; max_size()
    is the CRS width in both."""
    jcrs, crs, jdata, data, vals, commit, proofs = setup
    assert crs.max_size() == jcrs.max_size() == SIZE
    calls = (("prove_batch", (commit, [0, 1], None)), ("verify_batch", (commit, proofs[5][0])))
    for name, args in calls:
        with pytest.raises(NotImplementedError) as want:
            getattr(JIPA, name)(jcrs, *args)
        with pytest.raises(NotImplementedError) as got:
            getattr(IPA, name)(crs, *args)
        assert str(got.value) == str(want.value), name


@pytest.mark.slow
def test_domain_256_round_trip():
    """The slice's main path at the width of an Ethereum verkle node, port
    only, on the CPU: commit (against the native oracle), prove, verify."""
    crs = ipa_setup(256, device="cpu")
    rng = random.Random(256)
    vals = [rng.randrange(1 << 250) for _ in range(256)]
    data = FrVector.from_ints(vals, crs.domain, "cpu")
    commit = IPA.commit(crs, data)
    assert commit == native.g1_msm(crs.g_host, vals)
    proof = IPA.prove(crs, commit, 17, data)
    assert proof.y == vals[17] and len(proof.l) == 8
    assert IPA.verify(crs, commit, 17, proof)
    assert not IPA.verify(crs, g1_add(commit, g1_generator()), 17, proof)
