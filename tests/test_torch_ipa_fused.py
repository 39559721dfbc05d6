"""The port's device-resident IPA prove (verkle_kzg_tpu_torch.schemes.ipa:
``_low_level_ipa``, every challenge drawn by kernel FSX, one read of the
proof) on the kernels' plain versions, against the port's host loop
(``_low_level_ipa_hostloop``) and the JAX package's ``_low_level_ipa`` at
domain 8: proofs and the caller's transcript state bit-identical, for
prove_point (also after a foreign transcript) and prove_commitment, and one
small multiproof unchanged. On a card, the device loop against the host
loop at domain 16.

The card cases import no JAX (the card's machine has none):

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu tests/test_torch_ipa_fused.py
"""

import random

import pytest
import torch

from verkle_kzg_tpu_torch.fiatshamir.transcript import Transcript
from verkle_kzg_tpu_torch.ops import cuda_fiat_shamir as FSX
from verkle_kzg_tpu_torch.ops import cuda_ipa as KI
from verkle_kzg_tpu_torch.ops import cuda_lib
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.poly import FrVector
from verkle_kzg_tpu_torch.schemes import IPA, ipa_setup
from verkle_kzg_tpu_torch.schemes import ipa as I

torch.set_num_threads(1)

SIZE = 8
PREFIX = 77  # transcript bytes before the IPA: the first digest's message crosses a block edge


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup():
    """Both packages on one CRS and one data vector of watermark 6."""
    from verkle_kzg_tpu.poly import FrVector as JFrVector
    from verkle_kzg_tpu.schemes import ipa_setup as jax_ipa_setup
    from verkle_kzg_tpu_torch import convert

    jcrs = jax_ipa_setup(SIZE)
    crs = convert.ipa_params_from_jax(jcrs, "cpu")
    rng = random.Random(0xF5)
    vals = [rng.randrange(1, 2**64) for _ in range(SIZE - 2)]
    jdata = JFrVector.from_ints(vals, jcrs.domain)
    data = convert.frvector_from_jax(jdata, "cpu")
    return jcrs, crs, jdata, data, IPA.commit(crs, data)


def _transcript(cls, label="multiproof"):
    t = cls(label)
    t.append_bytes(bytes(range(PREFIX - 1)), "p")
    return t


def _fields(p):
    return (p.l, p.r, p.tip) + ((p.y,) if hasattr(p, "y") else ())


def _proves(crs, data, commit, point, transcript):
    """The device loop's and the host loop's proofs and final states, each
    from a fresh ``transcript()``."""
    b = F.ints_to_mont(crs.domain.barycentric_coefficients(point), "fr", "cpu")
    t_dev, t_host = transcript(), transcript()
    got = IPA.prove_point(crs, commit, point, data, t_dev)
    host = I._low_level_ipa_hostloop(crs, data.vals, b, commit, point, t_host)
    return (got, bytes(t_dev._state)), (host, bytes(t_host._state))


@pytest.mark.parametrize("point", [5, 2 * SIZE])
def test_device_loop_matches_host_loop_and_jax(setup, point):
    """In-domain index and out-of-domain point: the same proof and final
    state from the device loop, the host loop and JAX's fused loop (the
    program tests/test_torch_ipa.py compiles too)."""
    from verkle_kzg_tpu.fiatshamir.transcript import Transcript as JTranscript
    from verkle_kzg_tpu.schemes import IPA as JIPA

    jcrs, crs, jdata, data, commit = setup
    (got, state), (host, host_state) = _proves(crs, data, commit, point, lambda: Transcript("ipa"))
    t_jax = JTranscript("ipa")
    want = JIPA.prove_point(jcrs, commit, point, jdata, t_jax)
    assert _fields(got) == _fields(host) == _fields(want)
    assert state == host_state == bytes(t_jax._state)
    assert IPA.verify(crs, commit, point, got)


def test_device_loop_after_a_foreign_transcript(setup):
    """A transcript of another label with PREFIX bytes before the IPA, as a
    multiproof hands it over: the device loop's first digest streams a state
    of another length; proof and final state equal the host loop's."""
    _, crs, _, data, commit = setup
    (got, state), (host, host_state) = _proves(crs, data, commit, 5, lambda: _transcript(Transcript))
    assert _fields(got) == _fields(host) and state == host_state
    assert IPA.verify_point(crs, commit, 5, got, _transcript(Transcript))


def test_device_loop_runs_fsx_and_k1ipa_in_order(monkeypatch):
    """A prove at 4: <a, b>, the challenge w, then per round one K1IPA round
    and one FSX challenge over its L and R, then the last fold; the
    transcript state goes up once."""
    crs = ipa_setup(4, device="cpu")
    data = FrVector.from_ints([3, 1, 4, 1], crs.domain, "cpu")
    commit = IPA.commit(crs, data)
    calls = []
    for mod, name in ((FSX, "plain_challenge"), (KI, "plain_round"), (KI, "plain_inner")):
        inner = getattr(mod, name)

        def counted(*args, _inner=inner, _name=name):
            calls.append(_name if _name != "plain_round" else (_name,) + tuple(args[-2:]))
            return _inner(*args)

        monkeypatch.setattr(mod, name, counted)
    uploads = []
    monkeypatch.setattr(I, "_state_to_device", lambda t, dev, _f=I._state_to_device: uploads.append(1) or _f(t, dev))
    proof = IPA.prove_point(crs, commit, 3, data, Transcript("ipa"))
    rounds = [("plain_round", 0, 4), ("plain_round", 2, 2)]
    want = ["plain_inner", "plain_challenge"]
    for r in rounds:
        want += [r, "plain_challenge"]
    assert calls == want + [("plain_round", 1, 0)]
    assert uploads == [1] and proof.y == 1 and IPA.verify(crs, commit, 3, proof)


@pytest.mark.parametrize("watermark", [6, 1])
def test_commitment_proof_matches_host_loop_and_jax(setup, watermark):
    """Watermark 6 is zero-padded to 8 (COMPAT quirk 10); watermark 1 has no
    round."""
    from verkle_kzg_tpu.poly import FrVector as JFrVector
    from verkle_kzg_tpu.schemes import IPA as JIPA

    jcrs, crs, _, _, _ = setup
    vals = [random.Random(watermark).randrange(1, 2**64) for _ in range(watermark)]
    jdata = JFrVector.from_ints(vals, jcrs.domain)
    data = FrVector.from_ints(vals, crs.domain, "cpu")
    commit = IPA.commit(crs, data)
    got = IPA.prove_commitment(crs, commit, data)
    assert len(got.l) == (watermark - 1).bit_length()
    assert _fields(got) == _fields(I._commitment_proof(crs, commit, data, hostloop=True))
    assert _fields(got) == _fields(JIPA.prove_commitment(jcrs, commit, jdata))
    assert IPA.verify_commitment_proof(crs, commit, got)


def test_small_multiproof_unchanged(setup):
    """Three queries on two vectors: the multiproof's D and IPA proof, which
    run the device loop with the multiproof's transcript, equal those of the
    host loop, the parent's path (JAX's multiproof is held to the port in
    tests/test_torch_verkle.py)."""
    from verkle_kzg_tpu_torch.schemes import ProverQuery, VerifierQuery, prove_multiproof, verify_multiproof

    _, crs, _, data, commit = setup
    other = FrVector.from_ints([7, 1, 2, 9, 4, 4, 0, 3], crs.domain, "cpu")
    c2 = IPA.commit(crs, other)
    y = data.to_ints()
    pq = [ProverQuery(data=data, commit=commit, z=1, y=y[1]), ProverQuery(data=other, commit=c2, z=1, y=1),
          ProverQuery(data=data, commit=commit, z=4, y=y[4])]
    got = prove_multiproof(IPA, crs, pq)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(I, "_low_level_ipa", I._low_level_ipa_hostloop)
        host = prove_multiproof(IPA, crs, pq)
    assert got.d == host.d and _fields(got.proof) == _fields(host.proof)
    vq = [VerifierQuery(commit=q.commit, z=q.z, y=q.y) for q in pq]
    assert verify_multiproof(IPA, crs, vq, got)


# -- on a card: the device loop against the host loop ---------------------


@pytest.mark.gpu
@pytest.mark.parametrize("point", [3, 40])
def test_device_loop_matches_host_loop_on_card(cuda, point):
    n = 16
    crs = ipa_setup(n, device=cuda)
    rng = random.Random(point)
    data = FrVector.from_ints([rng.randrange(1 << 253) for _ in range(n)], crs.domain, device=cuda)
    commit = IPA.commit(crs, data)
    b = F.ints_to_mont(crs.domain.barycentric_coefficients(point), "fr", cuda)
    t_dev, t_host = _transcript(Transcript), _transcript(Transcript)
    cuda_lib.reset_launches()
    got = IPA.prove_point(crs, commit, point, data, t_dev)
    torch.cuda.synchronize()
    assert cuda_lib.launches["FSX"] == 5 and cuda_lib.launches["K1IPA"] == 6, cuda_lib.launches
    host = I._low_level_ipa_hostloop(crs, data.vals, b, commit, point, t_host)
    assert _fields(got) == _fields(host) and bytes(t_dev._state) == bytes(t_host._state)
    cproof = IPA.prove_commitment(crs, commit, data)
    assert _fields(cproof) == _fields(I._commitment_proof(crs, commit, data, hostloop=True))
