"""The port's SHA-256 and hash-to-field (verkle_kzg_tpu_torch.ops.sha256) and
kernel FSX's plain version (ops.cuda_fiat_shamir.plain_challenge), on the
CPU: byte for byte against hashlib and hostmath at every SHA-256 padding
edge, and against the JAX package's ops/sha256.py on XLA:CPU at a few
lengths. On a card, FSX against its plain version and hashlib.

The card cases import no JAX (the card's machine has none):

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu tests/test_torch_sha256.py
"""

import ctypes
import hashlib
import random

import numpy as np
import pytest
import torch

from verkle_kzg_tpu_torch.errors import TranscriptError
from verkle_kzg_tpu_torch.fiatshamir.transcript import Transcript
from verkle_kzg_tpu_torch.hostmath import curve as hc
from verkle_kzg_tpu_torch.hostmath.hashing import expand_message_xmd as host_xmd
from verkle_kzg_tpu_torch.hostmath.hashing import hash_to_fr as host_hash_to_fr
from verkle_kzg_tpu_torch.hostmath.serialize import fr_to_bytes as host_fr_to_bytes
from verkle_kzg_tpu_torch.hostmath.serialize import g1_to_compressed_bytes
from verkle_kzg_tpu_torch.ops import cuda_curve as KC
from verkle_kzg_tpu_torch.ops import cuda_fiat_shamir as FSX
from verkle_kzg_tpu_torch.ops import cuda_lib
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import sha256 as S
from verkle_kzg_tpu_torch.params import Q, R

torch.set_num_threads(1)

# every SHA-256 padding edge: one block up to 55 bytes, two from 56; 64 a
# whole block; 119 / 120 the same edge in the second block
EDGES = [0, 55, 56, 63, 64, 100, 119, 120, 200]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _msg(n, seed=0):
    rng = random.Random(1000 * seed + n)
    return bytes(rng.randrange(256) for _ in range(n))


def _raw(t) -> bytes:
    return bytes(t.cpu().to(torch.int64).tolist())


def _jax_bytes(raw: bytes):
    from verkle_kzg_tpu.ops import sha256 as JS

    return JS.const_bytes(raw)


@pytest.mark.parametrize("n", EDGES)
def test_sha256_matches_hashlib(n):
    msg = _msg(n)
    assert _raw(S.sha256_bytes(S.const_bytes(msg, "cpu"))) == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("n, dst, length", [(0, b"ipa", 48), (56, b"multiproof", 48), (120, b"ipa", 100),
                                             (200, b"x" * 255, 32)])
def test_expand_and_hash_to_fr_match_host(n, dst, length):
    msg = _msg(n, 1)
    assert _raw(S.expand_message_xmd(S.const_bytes(msg, "cpu"), dst, length)) == host_xmd(msg, dst, length)
    x = S.hash_to_fr(S.const_bytes(msg, "cpu"), dst)
    assert x.shape == (F.WORDS,) and F.words_to_ints(x) == host_hash_to_fr(msg, dst, 1)


@pytest.mark.parametrize("n", [55, 100])
def test_sha256_expand_hash_to_fr_match_jax(n):
    """The JAX package's device SHA-256 (static lengths: one XLA:CPU
    compile each) on the same bytes."""
    from verkle_kzg_tpu.ops import sha256 as JS
    from verkle_kzg_tpu.ops.limbs import limbs_to_ints

    msg = _msg(n, 2)
    got = S.const_bytes(msg, "cpu")
    assert _raw(S.sha256_bytes(got)) == bytes(np.asarray(JS.sha256_bytes(_jax_bytes(msg))).astype(np.uint8))
    assert _raw(S.expand_message_xmd(got, b"ipa", 48)) == bytes(
        np.asarray(JS.expand_message_xmd(_jax_bytes(msg), b"ipa", 48)).astype(np.uint8))
    want = limbs_to_ints(np.asarray(JS.hash_to_fr(_jax_bytes(msg), b"ipa")).T)[0]
    assert F.words_to_ints(S.hash_to_fr(got, b"ipa")) == [want]


def test_fr_to_bytes_matches_host_and_jax():
    from verkle_kzg_tpu.ops import sha256 as JS
    from verkle_kzg_tpu.ops.limbs import ints_to_limbs

    rng = random.Random(3)
    for v in [0, 1, R - 1] + [rng.randrange(R) for _ in range(3)]:
        got = _raw(S.fr_to_bytes(F.ints_to_words([v], "cpu")[0]))
        assert got == host_fr_to_bytes(v)
        assert got == bytes(np.asarray(JS.fr_to_bytes(np.asarray(ints_to_limbs([v]).T))).astype(np.uint8))


def _points():
    """Hash-to-curve-free points: multiples of G, the identity, and a point
    with each sign of y."""
    g = hc.g1_generator()
    pts = [hc.g1_mul(g, k) for k in (1, 2, 3, 2**200 + 7)]
    pts += [None, (pts[0][0], (Q - pts[0][1]) % Q), (pts[3][0], (Q - pts[3][1]) % Q)]
    return pts


def test_g1_compressed_bytes_matches_host_and_jax():
    from verkle_kzg_tpu.ops import curve as JC
    from verkle_kzg_tpu.ops import sha256 as JS

    pts = _points()
    signs = {g1_to_compressed_bytes(p)[31] >> 7 for p in pts if p is not None}
    assert signs == {0, 1}  # both signs of y among them
    got = S.g1_compressed_bytes(C.host_points_to_affine(pts, "cpu"))
    assert got.shape == (len(pts), 32) and got.dtype == torch.uint8
    assert [_raw(r) for r in got] == [g1_to_compressed_bytes(p) for p in pts]
    assert _raw(got[4]) == bytes(31) + b"\x40"  # infinity: the flag alone
    want = np.asarray(JS.g1_compressed_bytes(JC.host_points_to_affine(pts))).astype(np.uint8)
    assert np.array_equal(got.numpy(), want)


def _pair(seed):
    """Two projective points with Z != 1 (sums of multiples of G)."""
    rng = random.Random(seed)
    g = hc.g1_generator()
    base = [hc.g1_mul(g, rng.getrandbits(128)) for _ in range(4)]
    p = C.from_affine(C.host_points_to_affine(base, "cpu"))
    return KC.plain(p[:2], p[2:])


@pytest.mark.parametrize("case", ["plain", "left_infinity", "negated", "both_infinity"])
def test_plain_challenge_matches_transcript(case):
    """FSX's plain version on a halving round's message against the host
    Transcript: the challenge, the new state and the affine pair."""
    pair = _pair(7)
    inf = C.infinity((), "cpu")
    l, r = {"plain": (pair[0], pair[1]), "left_infinity": (inf, pair[1]),
            "negated": (C.neg(pair[0]), pair[1]), "both_infinity": (inf, inf)}[case]
    st = _msg(33 if case != "negated" else 150, 4)
    pairs = torch.zeros((3, 2, 2, F.WORDS), dtype=torch.int32)
    x, state = FSX.plain_challenge(S.const_bytes(st, "cpu"), b"ipa", [b"L", l, b"R", r], b"x", pairs, 1)
    hl, hr = C.projective_to_host_points(torch.stack([l, r]))
    t = Transcript("ipa")
    t._state = bytearray(st)
    t.append_point(hl, "L")
    t.append_point(hr, "R")
    want = t.digest("x", True)
    assert F.words_to_ints(x[0]) == [want] and F.mont_to_ints(x[1], "fr") == [want]
    assert _raw(state) == bytes(t._state)
    assert C.affine_to_host_points(pairs[1]) == [hl, hr]
    assert not pairs[0].any() and not pairs[2].any()


@pytest.mark.parametrize("n", [0, 150])
def test_plain_challenge_of_a_scalar(n):
    """The challenge before the loop: state || "output point" || y || "w"."""
    st, y = _msg(n, 5), random.Random(n).randrange(R)
    x, state = FSX.plain_challenge(S.const_bytes(st, "cpu"), b"multiproof",
                                   [b"output point", F.ints_to_mont([y], "fr", "cpu")], b"w")
    t = Transcript("multiproof")
    t._state = bytearray(st)
    t.append_scalar(y, "output point")
    assert F.words_to_ints(x[0]) == [t.digest("w", True)] and _raw(state) == bytes(t._state)


def test_cpu_takes_plain_and_counts_no_launch():
    cuda_lib.reset_launches()
    msg = S.const_bytes(_msg(70), "cpu")
    assert torch.equal(S.sha256_bytes(msg), S.plain_sha256(msg))
    assert torch.equal(S.hash_to_fr(msg, b"ipa"), S.plain_hash_to_fr(msg, b"ipa"))
    aff = C.host_points_to_affine(_points(), "cpu")
    assert torch.equal(S.g1_compressed_bytes(aff), S.plain_g1_compressed_bytes(aff))
    pair = _pair(9)
    got = FSX.challenge(msg, b"ipa", [b"L", pair[0], b"R", pair[1]], b"x")
    want = FSX.plain_challenge(msg, b"ipa", [b"L", pair[0], b"R", pair[1]], b"x")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(v == 0 for v in cuda_lib.launches.values()), cuda_lib.launches


def test_bounds_and_layouts_raise():
    msg = S.const_bytes(b"abc", "cpu")
    with pytest.raises(TranscriptError):
        S.expand_message_xmd(msg, b"x" * 256, 48)
    with pytest.raises(TranscriptError):
        S.expand_message_xmd(msg, b"ipa", 256 * 32)
    with pytest.raises(ValueError):
        S.sha256_bytes(msg.to(torch.int32))
    with pytest.raises(ValueError):
        S.g1_compressed_bytes(torch.zeros((2, 3, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        FSX.plain_challenge(msg, b"ipa", [torch.zeros(5, dtype=torch.int32)], b"x")


def test_args_struct_matches_the_kernel_layout():
    """``_Args`` mirrors csrc/fiat_shamir.cu's Args on a 64-bit host: eight
    24-byte segments, eight int32 fields, the constant pool."""
    assert ctypes.sizeof(FSX._Seg) == 24 and FSX._Seg.ptr.offset == 16
    assert FSX._Args.nseg.offset == 8 * 24 and FSX._Args.pool.offset == 8 * 24 + 8 * 4
    assert ctypes.sizeof(FSX._Args) == 8 * 24 + 8 * 4 + FSX.POOL
    src = (cuda_lib.CSRC / "fiat_shamir.cu").read_text()
    for name, value in (("MAX_SEGS", FSX.MAX_SEGS), ("MAX_POINTS", FSX.MAX_POINTS), ("POOL", FSX.POOL)):
        assert f"constexpr int {name} = {value};" in src


# -- on a card: FSX against its plain version and hashlib ------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n", EDGES + [5000])
def test_kernel_digest_and_hash_match_host_on_card(cuda, n):
    msg = _msg(n, 6)
    t = S.const_bytes(msg, cuda)
    cuda_lib.reset_launches()
    assert _raw(S.sha256_bytes(t)) == hashlib.sha256(msg).digest()
    assert _raw(S.expand_message_xmd(t, b"ipa", 100)) == host_xmd(msg, b"ipa", 100)
    assert F.words_to_ints(S.hash_to_fr(t, b"multiproof")) == host_hash_to_fr(msg, b"multiproof", 1)
    assert cuda_lib.launches["FSX"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["plain", "left_infinity", "negated", "both_infinity"])
def test_kernel_challenge_matches_plain_on_card(cuda, case):
    pair = _pair(11)
    inf = C.infinity((), "cpu")
    l, r = {"plain": (pair[0], pair[1]), "left_infinity": (inf, pair[1]),
            "negated": (C.neg(pair[0]), pair[1]), "both_infinity": (inf, inf)}[case]
    st = _msg(33, 8)
    want_pairs = torch.zeros((2, 2, 2, F.WORDS), dtype=torch.int32)
    want = FSX.plain_challenge(S.const_bytes(st, "cpu"), b"ipa", [b"L", l, b"R", r], b"x", want_pairs, 1)
    pairs = want_pairs.new_zeros(want_pairs.shape).to(cuda)
    got = FSX.challenge(S.const_bytes(st, cuda), b"ipa", [b"L", l.to(cuda), b"R", r.to(cuda)], b"x", pairs, 1)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert torch.equal(pairs.cpu(), want_pairs)
    aff = C.host_points_to_affine(_points(), "cpu")
    assert torch.equal(S.g1_compressed_bytes(aff.to(cuda)).cpu(), S.plain_g1_compressed_bytes(aff))
