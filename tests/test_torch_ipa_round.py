"""Kernels K1IPA (verkle_kzg_tpu_torch.ops.cuda_ipa: an IPA halving round and
the prove's inner product) and K2FOLD (cuda_curve.fold behind
msm.fold_reduce_lanes): their plain versions, which CPU tensors take,
against Python-int references (hostmath) and the chains they replace; the
port's halving loop on them against the JAX package at domain 8; and, on a
card, each kernel against its plain version.

The card cases import no JAX (the card's machine has none):

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu tests/test_torch_ipa_round.py
"""

import random

import pytest
import torch

from verkle_kzg_tpu_torch.fiatshamir.transcript import Transcript
from verkle_kzg_tpu_torch.hostmath import curve as hc
from verkle_kzg_tpu_torch.ops import cuda_curve as KC
from verkle_kzg_tpu_torch.ops import cuda_ipa as KI
from verkle_kzg_tpu_torch.ops import cuda_lib
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import msm as M
from verkle_kzg_tpu_torch.params import R

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _field(n, seed):
    """n values mod r with 0 and r - 1 among them."""
    rng = random.Random(seed)
    vals = [rng.randrange(R) for _ in range(n)]
    vals[seed % n] = 0
    vals[(seed + 1) % n] = R - 1
    return vals


def _stages(n):
    """(half, ln) of the calls a prove at n makes: the first round, a later
    one, the final fold; and a fold into a full-length scalar build."""
    out = [(0, n), (1, 0)]
    if n >= 4:
        out += [(n // 2, n // 2), (n // 4, n)]
    return out


def _inputs(n, with_b, half, device):
    """Round inputs as host ints and as Montgomery words on ``device``; wts
    None before the first fold, as the prove passes it."""
    a, b, wts = _field(n, 3 * n + half), _field(n, 5 * n + half + 1), _field(n, 7 * n + half + 2)
    rng = random.Random(n + half)
    x, w = rng.randrange(R), rng.randrange(R)
    ints = (a, b if with_b else None, wts if half else None, x, w)
    words = tuple(None if v is None else F.ints_to_mont(v, "fr", device) for v in ints[:3])
    return ints, words + (x, w)


def _ref_round(a, b, wts, x, w, half, ln):
    """The round on host ints: the fold of x at ``half``, then the scalars
    of a round of length ``ln`` (standard form, slot n from b)."""
    n = len(a)
    wts = [1] * n if wts is None else list(wts)
    if half:
        a = [(a[j] + x * a[j + half]) % R if j < half else a[j] for j in range(n)]
        if b is not None:
            b = [(b[j + half] + x * b[j]) % R if j < half else b[j] for j in range(n)]
        wts = [v * x % R if i % (2 * half) < half else v for i, v in enumerate(wts)]
    if not ln:
        return a, b, None, None
    h = ln // 2
    sc_l, sc_r = [], []
    for i in range(n):
        pos = i % ln
        g = wts[i] * a[pos - h if pos >= h else pos + h] % R
        sc_l.append(g if pos >= h else 0)
        sc_r.append(0 if pos >= h else g)
    if b is not None:
        sc_l.append(w * sum(a[j] * b[j + h] for j in range(h)) % R)
        sc_r.append(w * sum(a[j + h] * b[j] for j in range(h)) % R)
    return a, b, wts, [sc_l, sc_r]


def _as_ints(out):
    a, b, wts, sc = out
    mont = [None if t is None else F.mont_to_ints(t, "fr") for t in (a, b, wts)]
    return (*mont, None if sc is None else [F.words_to_ints(row) for row in sc])


@pytest.mark.parametrize("n", [2, 8, 16, 64])
@pytest.mark.parametrize("with_b", [True, False])
def test_plain_round_matches_host_ints(n, with_b):
    """Every stage of a prove at n, dead slots included: they keep their
    words, as the kernel's do."""
    for half, ln in _stages(n):
        ints, (a, b, wts, x, w) = _inputs(n, with_b, half, "cpu")
        got = _as_ints(KI.plain_round(a, b, wts, x, w, half, ln))
        assert got == tuple(_ref_round(*ints, half, ln)), (half, ln)
        if ln:
            assert KI.plain_round(a, b, wts, x, w, half, ln)[3].shape == (2, n + with_b, F.WORDS)


@pytest.mark.parametrize("n", [1, 2, 8, 16, 64])
def test_plain_inner_matches_host_ints(n):
    a, b = _field(n, n), _field(n, n + 9)
    got = KI.plain_inner(F.ints_to_mont(a, "fr", "cpu"), F.ints_to_mont(b, "fr", "cpu"))
    assert got.shape == (1, F.WORDS)
    assert F.mont_to_ints(got, "fr") == [sum(x * y for x, y in zip(a, b)) % R]


def test_cpu_takes_plain_and_counts_no_launch():
    n = 16
    _, (a, b, wts, x, w) = _inputs(n, True, n // 2, "cpu")
    cuda_lib.reset_launches()
    got = KI.halving_round(a, b, wts, x, w, n // 2, n // 2)
    want = KI.plain_round(a, b, wts, x, w, n // 2, n // 2)
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    assert torch.equal(KI.inner(a, b), KI.plain_inner(a, b))
    pts = _points(2, 5, 4)
    assert torch.equal(M.fold_reduce_lanes(pts, dim=1), KC.plain_fold(pts))
    assert all(v == 0 for v in cuda_lib.launches.values()), cuda_lib.launches


def test_halving_loop_on_plain_round_matches_jax():
    """IPA prove_point and prove_commitment at domain 8 go through one round
    call a round and one final fold, and give the JAX package's proofs and
    transcript states."""
    from verkle_kzg_tpu.fiatshamir.transcript import Transcript as JTranscript
    from verkle_kzg_tpu.poly import FrVector as JFrVector
    from verkle_kzg_tpu.schemes import IPA as JIPA
    from verkle_kzg_tpu.schemes import ipa_setup as jax_ipa_setup
    from verkle_kzg_tpu_torch import convert
    from verkle_kzg_tpu_torch.schemes import IPA

    jcrs = jax_ipa_setup(8)
    crs = convert.ipa_params_from_jax(jcrs, "cpu")
    vals = _field(8, 21)
    jdata = JFrVector.from_ints(vals, jcrs.domain)
    data = convert.frvector_from_jax(jdata, "cpu")
    commit = IPA.commit(crs, data)
    calls = []
    inner = KI.plain_round

    def counted(*args):
        calls.append(args[-2:])
        return inner(*args)

    KI.plain_round = counted
    try:
        t = Transcript("ipa")
        proof = IPA.prove_point(crs, commit, 3, data, t)
        cproof = IPA.prove_commitment(crs, commit, data)
    finally:
        KI.plain_round = inner
    assert calls == [(0, 8), (4, 4), (2, 2), (1, 0)] * 2
    jt = JTranscript("ipa")
    want = JIPA.prove_point(jcrs, commit, 3, jdata, jt)
    assert (proof.l, proof.r, proof.tip, proof.y) == (want.l, want.r, want.tip, want.y)
    assert bytes(t._state) == bytes(jt._state)
    jc = JIPA.prove_commitment(jcrs, commit, jdata)
    assert (cproof.l, cproof.r, cproof.tip) == (jc.l, jc.r, jc.tip)
    assert IPA.verify(crs, commit, 3, proof) and IPA.verify_commitment_proof(crs, commit, cproof)


def _points(rows, n, seed, device="cpu"):
    """(rows, n, 3, 8) projective points with Z != 1: sums of two multiples
    of G, with the identity, P + P and P + (-P) among them."""
    rng = random.Random(seed)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(64)) for _ in range(8)]
    ps = [base[rng.randrange(8)] for _ in range(rows * n)]
    qs = [base[rng.randrange(8)] for _ in range(rows * n)]
    ps[0] = qs[0] = None
    if rows * n > 3:
        qs[1], qs[2] = ps[1], hc.g1_neg(ps[2])
    p = C.from_affine(C.host_points_to_affine(ps, device))
    q = C.from_affine(C.host_points_to_affine(qs, device))
    return KC.plain(p, q).reshape(rows, n, 3, F.WORDS)


def _k2_chain(p, dim):
    """fold_reduce_lanes as it ran before K2FOLD: a K2 add a level."""
    dim = dim % p.dim()
    while p.shape[dim] > 1:
        n = p.shape[dim]
        half = n // 2
        folded = C.add(p.narrow(dim, 0, half), p.narrow(dim, half, half))
        if n % 2:
            folded = torch.cat([folded, p.narrow(dim, 2 * half, 1)], dim=dim)
        p = folded
    return p


# dim -> (the points' layout from (rows, n, 3, 8), rows)
LAYOUTS = {0: (lambda p: p.transpose(0, 1), 2), 1: (lambda p: p, 3), -3: (lambda p: p.reshape(2, 2, *p.shape[1:]), 4)}


@pytest.mark.parametrize("n", [1, 2, 3, 5, 51, 63])
@pytest.mark.parametrize("dim", [0, 1, -3])
def test_plain_fold_matches_host_sums_and_k2_chain(n, dim):
    layout, rows = LAYOUTS[dim]
    base = _points(rows, n, 100 + n)
    p = layout(base)
    got = M.fold_reduce_lanes(p, dim=dim)
    want = _k2_chain(p, dim)
    assert got.shape == want.shape and torch.equal(got, want)
    sums = C.projective_to_host_points(got.movedim(dim, -3))
    host = C.projective_to_host_points(base)
    expect = []
    for r in range(rows):
        acc = None
        for v in host[r * n : (r + 1) * n]:
            acc = hc.g1_add(acc, v)
        expect.append(acc)
    assert sums == expect


# -- on a card: each kernel against its plain version --------------------


def _to(t, device):
    return None if t is None else t.to(device)


def _equal(got, want):
    return all((g is None and v is None) or torch.equal(g.cpu(), v) for g, v in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 8, 256, 1024])
@pytest.mark.parametrize("with_b", [True, False])
def test_round_kernel_matches_plain_on_card(cuda, n, with_b):
    for half, ln in _stages(n):
        _, (a, b, wts, x, w) = _inputs(n, with_b, half, "cpu")
        cuda_lib.reset_launches()
        got = KI.halving_round(_to(a, cuda), _to(b, cuda), _to(wts, cuda), x, w, half, ln)
        torch.cuda.synchronize()
        assert cuda_lib.launches["K1IPA"] == 1 and cuda_lib.launches["K1"] == 0
        assert _equal(got, KI.plain_round(a, b, wts, x, w, half, ln)), (half, ln)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 8, 256, 300, 1024])
def test_inner_kernel_matches_plain_on_card(cuda, n):
    a, b = (F.ints_to_mont(_field(n, n + k), "fr", "cpu") for k in (0, 9))
    cuda_lib.reset_launches()
    got = KI.inner(a.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    assert cuda_lib.launches["K1IPA"] == 1
    assert torch.equal(got.cpu(), KI.plain_inner(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(1, 51), (1, 63), (2, 2), (3, 3), (5, 5), (300, 8), (2, 100)])
def test_fold_kernel_matches_plain_on_card(cuda, rows, n):
    p = _points(rows, n, rows + n)
    cuda_lib.reset_launches()
    got = M.fold_reduce_lanes(p.to(cuda), dim=1)
    torch.cuda.synchronize()
    assert cuda_lib.launches["K2FOLD"] == 1 and cuda_lib.launches["K2"] == 0
    assert torch.equal(got.cpu(), KC.plain_fold(p))
