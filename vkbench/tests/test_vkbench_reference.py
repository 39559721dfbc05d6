"""The benchmark's plain reference against published known answers, and
its pieces against their definitions at small sizes."""

import hashlib
import random

import pytest

from vkbench.reference import bn254 as E
from vkbench.reference import ipa as ref_ipa
from vkbench.reference import kzg as ref_kzg

# RFC 9380, appendix K.1: expand_message_xmd(SHA-256)
_DST = b"QUUX-V01-CS02-with-expander-SHA256-128"
_XMD_32 = [
    (b"", "68a985b87eb6b46952128911f2a4412bbc302a9d759667f87f7a21d803f07235"),
    (b"abc", "d8ccab23b5985ccea865c6c97b6e5b8350e794e603b4b97902f53a8a0d605615"),
    (b"abcdef0123456789", "eff31487c770a893cfb36f912fbfcbff40d5661771ca4b2cb4eafe524333f5c1"),
    (b"q128_" + b"q" * 128, "b23a1d2b4d97b2ef7785562a7e8bac7eed54ed6e97e29aa51bfe3f12ddad1ff9"),
    (b"a512_" + b"a" * 512, "4623227bcc01293b8c130bf771da8c298dede7383243dc0993d2d94823958c4c"),
]
_XMD_128_EMPTY = (
    "af84c27ccfd45d41914fdff5df25293e221afc53d8ad2ac06d5e3e29485dadbe"
    "e0d121587713a3e0dd4d5e69e93eb7cd4f5df4cd103e188cf60cb02edc3edf18"
    "eda8576c412b18ffb658e3dd6ec849469b979d444cf7b26911a08e63cf31f9dc"
    "c541708d3491184472c2c29bb749d4286b004ceb5ee6b9a7fa5b646c993f0ced"
)

# alt_bn128 multiples of the generator (EIP-196 / py_ecc)
_2G = (
    1368015179489954701390400359078579693043519447331113978918064868415326638035,
    9918110051302171585080402603319702774565515993150576347155970296011118125764,
)
_3G = (
    3353031288059533942658390886683067124040920775575537747144343083137631628272,
    19321533766552368860946552437480515441416830039777911637913418824951667761761,
)


@pytest.mark.parametrize("msg,expect", _XMD_32)
def test_xmd_rfc9380(msg, expect):
    assert E.expand_message_xmd(msg, _DST, 32).hex() == expect


def test_xmd_rfc9380_len128():
    assert E.expand_message_xmd(b"", _DST, 128).hex() == _XMD_128_EMPTY


@pytest.mark.parametrize("msg,digest", [
    (b"", "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    (b"abc", "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad"),
    (b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
     "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1"),
])
def test_sha256_fips180(msg, digest):
    assert hashlib.sha256(msg).hexdigest() == digest


def test_g1_published_multiples():
    assert E.add(E.G1, E.G1) == _2G
    assert E.add(_2G, E.G1) == _3G
    assert E.smul(E.G1, 2) == _2G
    assert E.smul(E.G1, 3) == _3G
    assert E.smul(E.G1, E.R) is None
    assert E.smul(E.G1, E.R - 1) == (1, E.Q - 2)
    fb = E.FixedBase(E.G1)
    assert fb.mul_many([2, 3, E.R - 1]) == [_2G, _3G, (1, E.Q - 2)]


def test_msm_and_fixed_base_agree_with_scalar_mul():
    rng = random.Random(5)
    pts = [E.smul(E.G1, rng.randrange(1, E.R)) for _ in range(40)]
    ks = [rng.randrange(E.R) for _ in range(40)]
    want = None
    for p, k in zip(pts, ks):
        want = E.add(want, E.smul(p, k))
    assert E.msm(pts, ks) == want
    assert E.msm(pts[:5], ks[:5]) == E.msm(pts[:5] + [None], ks[:5] + [7])
    k = rng.randrange(E.R)
    assert E.FixedBase(E.G1).mul_many([k]) == [E.smul(E.G1, k)]


def test_compress_encoding():
    assert E.compress(None) == bytes(31) + b"\x40"
    assert E.compress(E.G1) == (1).to_bytes(32, "little")
    assert E.compress(E.neg(E.G1))[31] & 0x80


def test_domain_is_a_root_of_unity():
    for n in (2, 8, 256, 4096):
        w = E.root_of_unity(n)
        assert pow(w, n, E.R) == 1 and pow(w, n // 2, E.R) != 1


def _interpolate(evals, omegas):
    """Coefficients of the polynomial through (w^i, f_i), O(n^2)."""
    n = len(evals)
    inv_n = pow(n, E.R - 2, E.R)
    return [sum(f * pow(w, (E.R - 1 - j) % (E.R - 1), E.R) for f, w in zip(evals, omegas)) * inv_n % E.R
            for j in range(n)]


def _horner(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % E.R
    return acc


def test_quotient_and_evaluation_match_polynomial_division():
    rng = random.Random(11)
    n = 8
    omegas = E.domain(n)
    f = [rng.randrange(E.R) for _ in range(n)]
    coeffs = _interpolate(f, omegas)
    assert [_horner(coeffs, w) for w in omegas] == f
    x = rng.randrange(n + 1, E.R)
    assert ref_kzg.evaluate(f, x, omegas) == _horner(coeffs, x)
    z = 3
    q = ref_ipa._quotient(f, z, omegas)
    # q(X)(X - w^z) = f(X) - f(w^z) at a point off the domain
    assert _horner(_interpolate(q, omegas), x) * (x - omegas[z]) % E.R == (_horner(coeffs, x) - f[z]) % E.R


def test_try_and_increment_matches_the_port():
    from verkle_kzg_tpu_torch.hostmath.hashing import eth_try_and_increment

    assert E.try_and_increment(b"eth_verkle_oct_2021", 6) == eth_try_and_increment(b"eth_verkle_oct_2021", 6)


def test_kzg_proofs_satisfy_the_opening_identity():
    rng = random.Random(3)
    n, s = 8, rng.randrange(9, E.R)
    omegas = E.domain(n)
    vals = [rng.randrange(E.R) for _ in range(n)]
    c, pi, y = ref_kzg.blob_sidecar(vals, s, omegas)
    z = ref_kzg.compute_challenge(ref_kzg.blob_bytes(vals), n, c)
    # [q(s)] (s - z) + [y] = [f(s)]
    assert E.add(E.smul(pi, s - z), E.smul(E.G1, y)) == c
    for (p, yi), w in zip(ref_kzg.all_proofs(vals, s, omegas), omegas):
        assert yi == vals[omegas.index(w)]
        assert E.add(E.smul(p, s - w), E.smul(E.G1, yi)) == c
