"""The port's own copies of the JAX package's host modules (params,
hostmath, the transcript, the IPA generator) against the originals, on the
same seeded inputs: every value must be identical."""

import dataclasses
import random

import numpy as np
import pytest

from verkle_kzg_tpu import params as JP
from verkle_kzg_tpu.fiatshamir.transcript import Transcript as JTranscript
from verkle_kzg_tpu.hostmath import curve as jhc
from verkle_kzg_tpu.hostmath import field as jhf
from verkle_kzg_tpu.hostmath import serialize as jhs
from verkle_kzg_tpu.schemes.generators import ipa_generate_points as jax_generate
from verkle_kzg_tpu_torch import params as P
from verkle_kzg_tpu_torch.fiatshamir.transcript import Transcript
from verkle_kzg_tpu_torch.hostmath import curve as hc
from verkle_kzg_tpu_torch.hostmath import field as hf
from verkle_kzg_tpu_torch.hostmath import serialize as hs
from verkle_kzg_tpu_torch.schemes.generators import ipa_generate_points

R, Q = JP.R, JP.Q


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


def test_params_constants_equal():
    names = [n for n in vars(JP) if not n.startswith("_") and n.isupper()]
    assert {"Q", "R", "B", "G1_GENERATOR", "FQ", "FR", "NLIMBS"} <= set(names)
    assert names == [n for n in vars(P) if not n.startswith("_") and n.isupper()]
    for name in names:
        want, got = getattr(JP, name), getattr(P, name)
        if isinstance(want, JP.FieldSpec):
            for f in ("name", "modulus", "modulus_limbs", "n0inv", "r_mod", "r2_mod", "r_mod_limbs", "r2_mod_limbs", "inv_exponent"):
                assert _same(getattr(want, f), getattr(got, f)), (name, f)
            assert [f.name for f in dataclasses.fields(want)] == [f.name for f in dataclasses.fields(got)]
        else:
            assert _same(want, got), name
    for size in (1, 2, 16, 256, 1 << 20):
        assert P.fr_root_of_unity(size) == JP.fr_root_of_unity(size)
    x = random.Random(1).randrange(Q)
    assert np.array_equal(P.int_to_limbs(x), JP.int_to_limbs(x))
    assert P.limbs_to_int(JP.int_to_limbs(x)) == x


def test_hostmath_equal():
    rng = random.Random(2)
    xs = [0, 1, R - 1] + [rng.randrange(R) for _ in range(20)]
    assert [hf.fr_inv(x) for x in xs[1:]] == [jhf.fr_inv(x) for x in xs[1:]]
    assert hf.fr_batch_inverse(xs) == jhf.fr_batch_inverse(xs)
    ys = [rng.randrange(Q) for _ in range(20)]
    assert hf.fq_batch_inverse(ys) == jhf.fq_batch_inverse(ys)
    assert [hf.fq_sqrt(y) for y in ys] == [jhf.fq_sqrt(y) for y in ys]
    pts = [jhc.g1_mul(jhc.g1_generator(), rng.getrandbits(128)) for _ in range(6)] + [None]
    ks = [rng.randrange(R) for _ in pts]
    for p, q, k in zip(pts, pts[::-1], ks):
        assert hc.g1_add(p, q) == jhc.g1_add(p, q)
        assert hc.g1_mul(p, k) == jhc.g1_mul(p, k)
        assert hc.g1_neg(p) == jhc.g1_neg(p)
        assert hs.g1_to_data_item(p) == jhs.g1_to_data_item(p)
        assert hs.g1_to_compressed_bytes(p) == jhs.g1_to_compressed_bytes(p)
    assert hc.g1_msm_naive(pts, ks) == jhc.g1_msm_naive(pts, ks)
    assert hc.g2_mul(hc.g2_generator(), 7) == jhc.g2_mul(jhc.g2_generator(), 7)
    for raw in (bytes(16), bytes(range(32)), bytes([255]) * 32, rng.randbytes(48)):
        assert hs.fr_from_le_bytes_mod_order(raw) == jhs.fr_from_le_bytes_mod_order(raw)


def test_transcript_equal():
    rng = random.Random(3)
    t, jt = Transcript("multiproof"), JTranscript("multiproof")
    pt = jhc.g1_mul(jhc.g1_generator(), 99)
    for tr in (t, jt):
        tr.append_point(pt, "C")
        tr.append_point(None, "C")
        tr.append_usize(17, "z")
        tr.append_scalar(R - 5, "y")
    assert bytes(t._state) == bytes(jt._state)
    assert t.digest("r", True) == jt.digest("r", True)
    assert bytes(t._state) == bytes(jt._state)
    s = rng.randrange(R)
    for tr in (t, jt):
        tr.append_scalar(s, "x")
    assert t.digest("t", False) == jt.digest("t", False)
    assert bytes(t._state) == bytes(jt._state)


@pytest.mark.parametrize("num", [1, 17])
def test_ipa_generator_equal(num):
    assert ipa_generate_points(num) == jax_generate(num)
