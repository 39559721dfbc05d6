"""The port's field layer (verkle_kzg_tpu_torch.ops.field, the plain
version of kernel K1 on the CPU) against verkle_kzg_tpu.ops.field, on the
same seeded inputs, bit for bit; and the conversions between the two
packages' layouts."""

import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from verkle_kzg_tpu.ops import field as JF
from verkle_kzg_tpu.ops.limbs import ints_to_limbs
from verkle_kzg_tpu.params import FQ, FR
from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.ops import cuda_lib
from verkle_kzg_tpu_torch.ops import field as F

torch.set_num_threads(1)

SPECS = [("fq", FQ), ("fr", FR)]


def _batch(fs, n, seed):
    rng = random.Random(seed)
    xs = [rng.randrange(fs.modulus) for _ in range(n)]
    # edge values: 0, 1, m - 1, Montgomery one, and a long carry chain
    xs[:5] = [0, 1, fs.modulus - 1, fs.r_mod, int("ffff" * 15, 16) % fs.modulus]
    return xs


def _both(xs):
    """The same ints as JAX limb planes and as port word rows."""
    planes = np.asarray(ints_to_limbs(xs).T)
    return jnp.asarray(planes), convert.limb_planes_to_tensor(planes, "cpu")


@pytest.mark.parametrize("spec,fs", SPECS)
def test_field_ops_match_jax(spec, fs):
    xs, ys = _batch(fs, 64, 11), _batch(fs, 64, 12)[::-1]
    ja, ta = _both(xs)
    jb, tb = _both(ys)

    def same(j, t):
        assert np.array_equal(np.asarray(j), convert.tensor_to_limb_planes(t))

    same(JF.mont_mul(ja, jb, spec), F.mont_mul(ta, tb, spec))
    same(JF.add(ja, jb, spec), F.add(ta, tb, spec))
    same(JF.sub(ja, jb, spec), F.sub(ta, tb, spec))
    same(JF.sub(jb, ja, spec), F.sub(tb, ta, spec))
    same(JF.neg(ja, spec), F.neg(ta, spec))
    same(JF.to_mont(ja, spec), F.to_mont(ta, spec))
    same(JF.from_mont(ja, spec), F.from_mont(ta, spec))
    same(JF.inv_mont(ja, spec), F.inv_mont(ta, spec))
    same(JF.lazy_sum_lanes(ja, spec), F.sum_lanes(ta, spec))


@pytest.mark.parametrize("spec,fs", SPECS)
def test_lazy_domain_ops(spec, fs):
    """The lazy [0, 2m) forms that K3/K4 inline: a Montgomery product
    below 2m congruent to a*b/R; add/sub subtract (add) 2m exactly when
    the JAX kernels' k_add_lazy / k_sub_lazy do."""
    m = fs.modulus
    rng = random.Random(13)
    xs = [0, 2 * m - 1, m, 5] + [rng.randrange(2 * m) for _ in range(60)]
    ys = [0, 2 * m - 1, m - 1, 5] + [rng.randrange(2 * m) for _ in range(60)]
    a, b = F.to_limbs(F.ints_to_words(xs, "cpu")), F.to_limbs(F.ints_to_words(ys, "cpu"))
    rinv = pow(1 << 256, -1, m)

    def ints(t):
        return F.words_to_ints(F.from_limbs(t))

    prod = ints(F.mont_mul16(a, b, spec, lazy=True))
    assert all(p < 2 * m and p % m == x * y * rinv % m for p, x, y in zip(prod, xs, ys))
    assert ints(F.add16(a, b, spec, lazy=True)) == [
        x + y - 2 * m if x + y >= 2 * m else x + y for x, y in zip(xs, ys)
    ]
    assert ints(F.sub16(a, b, spec, lazy=True)) == [
        x - y if x >= y else x - y + 2 * m for x, y in zip(xs, ys)
    ]


@pytest.mark.parametrize("spec,fs", SPECS)
def test_int_path_matches_limb_path(spec, fs, monkeypatch):
    """Batches of at most F.SMALL elements take Python ints, larger ones the
    limb tensors: both must give the same limbs, in both domains."""
    m = fs.modulus
    rng = random.Random(14)
    xs = [0, 2 * m - 1, m, m - 1, 1] + [rng.randrange(2 * m) for _ in range(59)]
    ys = [2 * m - 1, 0, m - 1, m, 1] + [rng.randrange(2 * m) for _ in range(59)]
    a, b = F.to_limbs(F.ints_to_words(xs, "cpu")), F.to_limbs(F.ints_to_words(ys, "cpu"))
    ops = [(fn, lazy) for fn in (F.add16, F.sub16, F.mont_mul16) for lazy in (False, True)]
    small = [fn(a, b, spec, lazy) for fn, lazy in ops] + [F.cond_sub16(a, spec)]
    monkeypatch.setattr(F, "SMALL", 0)
    large = [fn(a, b, spec, lazy) for fn, lazy in ops] + [F.cond_sub16(a, spec)]
    for s, t in zip(small, large):
        assert torch.equal(s, t)


def test_convert_round_trips():
    xs = _batch(FR, 33, 14)
    planes = np.asarray(ints_to_limbs(xs).T)
    t = convert.limb_planes_to_tensor(planes, "cpu")
    assert t.shape == (33, 8) and t.dtype == torch.int32
    assert F.words_to_ints(t) == xs
    assert np.array_equal(convert.tensor_to_limb_planes(t), planes)
    assert F.mont_to_ints(F.ints_to_mont(xs, "fr", "cpu"), "fr") == xs


def test_frvector_from_jax():
    from verkle_kzg_tpu.poly import FrVector as JFrVector

    vals = [random.Random(15).randrange(FR.modulus) for _ in range(6)]
    jv = JFrVector.from_ints(vals)
    tv = convert.frvector_from_jax(jv, "cpu")
    assert tv.to_ints() == jv.to_ints() and tv.max == jv.max == 6
    assert tv.domain.size == jv.domain.size == 8
    assert tv.evaluate(3) == jv.evaluate(3) and tv.evaluate(7) == jv.evaluate(7)
    assert tv.evaluate(20) == jv.evaluate(20)
    assert tv.set_evaluation(2, 99).get(2) == jv.set_evaluation(2, 99).get(2) == 99
    k = FR.modulus - 3
    for got, want in ((tv + tv, jv + jv), (tv - tv.scale(k), jv - jv.scale(k)), (tv.scale(k), jv.scale(k))):
        assert got.to_ints() == want.to_ints() and got.max == want.max
    zero, jzero = type(tv).zero(tv.domain, "cpu"), JFrVector.zero(jv.domain)
    assert zero.to_ints() == jzero.to_ints() and zero.max == jzero.max == 8


def test_domain_mirrors_match_jax():
    from verkle_kzg_tpu.poly import Domain as JDomain
    from verkle_kzg_tpu_torch.poly import Domain

    jd, td = JDomain(8), Domain(8)
    for name in ("d_omegas", "d_vanishing", "d_vanishing_inv"):
        got = getattr(td, name)("cpu")
        assert got is getattr(td, name)("cpu")  # made once per device
        assert np.array_equal(convert.tensor_to_limb_planes(got), np.asarray(getattr(jd, name)))


def test_cuda_header_constants():
    """The moduli, 2m, Montgomery one and -m^-1 mod 2^32 written into the
    CUDA header, and the inverse's closing factor 2^INV_OUTER R^3 mod m in
    ``field_inv.cuh`` (its rounds' 2^(32 - 31) each, and (a R)^-1 to
    a^-1 R), equal the ones derived in params.py (the headers cannot be
    compiled here)."""

    def words(blk):
        return sum(int(w, 16) << (32 * i) for i, w in enumerate(re.findall(r"0x([0-9a-f]{8})u", blk)))

    src = (cuda_lib.CSRC / "bn254_field.cuh").read_text()
    inv = (cuda_lib.CSRC / "field_inv.cuh").read_text()
    outer = int(re.search(r"INV_OUTER = (\d+);", inv).group(1))
    for name, fs in (("Fq", FQ), ("Fr", FR)):
        body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
        arrays = [words(blk) for blk in re.findall(r"\{(0x[^}]*)\}", body)]
        assert arrays == [fs.modulus, 2 * fs.modulus, fs.r_mod]
        n0 = int(re.search(r"n0 = 0x([0-9a-f]+)u", body).group(1), 16)
        assert n0 == (-pow(fs.modulus, -1, 1 << 32)) % (1 << 32)
        fix = re.search(r"inv_fix<%s>\(int i\) \{\n\s*const uint32_t v\[8\] = \{([^}]*)\}" % name, inv).group(1)
        assert words(fix) == pow(2, outer, fs.modulus) * pow(fs.r_mod, 3, fs.modulus) % fs.modulus
