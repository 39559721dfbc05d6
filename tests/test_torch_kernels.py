"""K1-K13, G1SMUL and G1BFLY on a CUDA card against their plain versions,
bit for bit, and the port's IPA, a width-16 verkle tree, the G1 scalar
multiplication, the NTTs and KZG with FK on the card against their CPU path.

These tests need a card and skip without one. They import no JAX, since
the card's machine has none; run them there without the JAX conftest:

    python -m pytest -o addopts= --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import random

import pytest
import torch

from verkle_kzg_tpu_torch import native
from verkle_kzg_tpu_torch.fiatshamir.transcript import Transcript
from verkle_kzg_tpu_torch.hostmath import curve as hc
from verkle_kzg_tpu_torch.params import R
from verkle_kzg_tpu_torch.ops import cuda_curve, cuda_field, cuda_lib, cuda_scalar_mul
from verkle_kzg_tpu_torch.ops import cuda_g1_chain as G
from verkle_kzg_tpu_torch.ops import cuda_msm as K
from verkle_kzg_tpu_torch.ops import cuda_msm_batched as KB
from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import msm as M
from verkle_kzg_tpu_torch.ops import ntt as N
from verkle_kzg_tpu_torch.poly import FrVector
from verkle_kzg_tpu_torch.schemes import IPA, KZG, IPAParams, KZGParams, ipa_setup, kzg_setup
from verkle_kzg_tpu_torch.verkle import VerkleTree

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(n, seed):
    rng = random.Random(seed)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(96)) for _ in range(16)]
    pts = [base[i % 16] for i in range(n)]
    pts[2] = None  # the (0, 0) sentinel
    ks = [rng.randrange(R) for _ in range(n)]
    ks[:3] = [0, R - 1, 1 << 253]
    return pts, ks


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda):
    n = 257
    pts, ks = _inputs(n, 80)
    a = F.ints_to_words(ks, cuda)
    for op in ("mul", "add", "sub"):
        assert torch.equal(cuda_field.binop(op, a, a.flip(0), "fr"), cuda_field.plain(op, a, a.flip(0), "fr"))
    p = C.from_affine(C.host_points_to_affine(pts, cuda))
    assert torch.equal(cuda_curve.add(p, p.flip(0)), cuda_curve.plain(p, p.flip(0)))
    pa = C.host_points_to_affine(pts, cuda)
    table = KS.accumulate(pa, a, 8)
    assert torch.equal(table, KS.plain_accumulate(pa, a, 8))
    buckets = table[:, 0].contiguous()
    out = K.tail(buckets)
    assert torch.equal(out, K.plain_tail(buckets))
    assert C.projective_to_host_points(out) == [native.g1_msm(pts, ks)]
    # to_affine: the inverses of Z in one K1INV launch, then two K1 products
    assert torch.equal(C.to_affine(p), C.host_points_to_affine(pts, cuda))
    # K5 on the same lanes, (0, 0) and zero scalars among them
    assert torch.equal(cuda_scalar_mul.scalar_mul_affine(pa, a), cuda_scalar_mul.plain(pa, a))
    # K6 (the sorted accumulation, the basis shared at lane stride 0) and
    # K7 at c = 1, 4 and 5 over a 64-point basis, three lanes
    basis = pa[:64].contiguous()
    scalars = torch.stack([a[:64], a[64:128], a[128:192]])
    for c in (1, 4, 5):
        digits = M.window_digits_signed(scalars, c).to(torch.int32).contiguous()
        shared = basis.expand(3, 64, 2, 8)
        table = KS.accumulate_digits(shared, digits, c)
        assert torch.equal(table, KS.plain_accumulate_digits(shared, digits, c))
        assert torch.equal(table, KS.accumulate_digits(basis.repeat(3, 1, 1), digits, c))
        assert torch.equal(KB.tail(table, c), KB.plain_tail(table, c))
        got = C.projective_to_host_points(M.msm_fixed_base(basis, scalars, c=c))
        assert got == [native.g1_msm(pts[:64], ks[64 * i : 64 * i + 64]) for i in range(3)]
    torch.cuda.synchronize()
    assert min(cuda_lib.launches[f"K{i}"] for i in range(1, 8)) > 0


@pytest.mark.gpu
@pytest.mark.parametrize(
    "c,signed,key",
    [(16, False, "K8"), (4, False, "K8"), (16, True, "K9"), (12, True, "K10"), (9, False, "K10"), (5, False, "K6"),
     (3, True, "K6"), (7, True, "K6")],
)
def test_window_modes_match_plain_on_card(cuda, c, signed, key):
    """The single MSM's other widths and signs: the accumulation (K8, K9
    and K10 sorted, K6 the same kernels up to 128 rows a window) and K4 on
    its buckets, against their plain versions, and the whole MSM against
    the native oracle, with its launches: the sorted routes one count and no
    K2 fold."""
    n = 300
    pts, ks = _inputs(n, 90 + c)
    pa, sc = C.host_points_to_affine(pts, cuda), F.ints_to_words(ks, cuda)
    cuda_lib.reset_launches()
    if c in K.IN_KERNEL_C:
        table = KS.accumulate(pa, sc, c, signed=signed)
        assert torch.equal(table, KS.plain_accumulate(pa, sc, c, signed=signed))
    else:
        digits = (M.window_digits_signed if signed else M.window_digits)(sc, c).to(torch.int32)[:, None].contiguous()
        table = KS.accumulate_digits(pa, digits, c, signed)
        assert torch.equal(table, KS.plain_accumulate_digits(pa, digits, c, signed))
    buckets = table[:, 0].contiguous()
    assert cuda_lib.launches[key] == 1
    out = K.tail(buckets, c)
    assert torch.equal(out, K.plain_tail(buckets, c))
    assert C.projective_to_host_points(out) == [native.g1_msm(pts, ks)]
    cuda_lib.reset_launches()
    got = M.msm_pippenger(pa, sc, c=c, signed=signed)
    assert C.projective_to_host_points(got) == [native.g1_msm(pts, ks)]
    assert {k: v for k, v in cuda_lib.launches.items() if v} == {key: 1, "K4": 1, "K1AFF": 1}  # and the read
    assert cuda_lib.cuda_launches[key] >= 5  # digits, scan, scatter, sums, combine at least


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,c,signed,lanes,tensor,equal",
    [(1 << 12, 8, False, 128, False, False), (1 << 12, 16, False, 1, False, True), (600, 1, False, 2, False, False),
     (1 << 12, 12, True, 4, True, False), (1 << 12, 13, False, 1, True, True), (1 << 10, 9, True, 1, True, False)],
)
def test_wide_sorted_accumulation_matches_plain_on_card(cuda, n, c, signed, lanes, tensor, equal):
    """K8 and K10 word for word against their plain version: 128 lanes
    (the lane-stream shape), all scalars equal at 65,535 and 8,191 rows a
    window (one bucket a window over every chunk), a digit tensor in four
    lanes; one count a call, 5-12 CUDA launches."""
    pts, ks = _inputs(n, 170 + c)
    if equal:
        ks = [ks[5]] * n
    pa, sc = C.host_points_to_affine(pts, cuda), F.ints_to_words(ks, cuda)
    key = KS.launch_key(c, signed, tensor)
    cuda_lib.reset_launches()
    if tensor:
        digits = (M.window_digits_signed if signed else M.window_digits)(sc, c).to(torch.int32)
        digits = digits.reshape(-1, lanes, n // lanes).contiguous()
        got = KS.accumulate_digits(pa, digits, c, signed)
        assert torch.equal(got, KS.plain_accumulate_digits(pa, digits, c, signed))
    else:
        got = KS.accumulate(pa, sc, c, lanes, signed=signed)
        assert torch.equal(got, KS.plain_accumulate(pa, sc, c, lanes, signed=signed))
    assert cuda_lib.launches[key] == 1 and 5 <= cuda_lib.cuda_launches[key] <= 12


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,c,lanes,equal,given",
    [(257, 8, 1, False, False), (257, 8, 1, True, False), (1 << 12, 16, 1, False, False),
     (1 << 12, 16, 1, True, False), (1 << 12, 1, 1, False, False), (1 << 12, 8, 128, False, True),
     (1 << 10, 16, 4, False, True), (600, 2, 2, False, False)],
)
def test_sorted_accumulation_matches_plain_on_card(cuda, n, c, lanes, equal, given):
    """K3 / K9, the sorted accumulation, word for word against its plain
    version: the IPA's 257 points, 2^12 points at c = 16, all scalars equal
    (one bucket a window over every chunk), lanes with the caller's carry
    words; and the single MSM's launch counts: one K3 or K9, one K4, no K2."""
    pts, ks = _inputs(n, 110 + c)
    if equal:
        ks = [ks[5]] * n
    pa, sc = C.host_points_to_affine(pts, cuda), F.ints_to_words(ks, cuda)
    masks = M.signed_carries(sc, c).contiguous() if given else None
    got = KS.accumulate(pa, sc, c, lanes, masks)
    assert torch.equal(got, KS.plain_accumulate(pa, sc, c, lanes, masks))
    if lanes == 1:
        cuda_lib.reset_launches()
        out = M.msm_auto(pa, sc, c=c)
        counts = {k: v for k, v in cuda_lib.launches.items() if v}
        assert counts == {KS.launch_key(c): 1, "K4": 1}
        assert cuda_lib.cuda_launches[KS.launch_key(c)] >= 5  # digits, scan, scatter, sums, combine at least
        assert C.projective_to_host_points(out) == [native.g1_msm(pts, ks)]


def _tail_buckets(c, signed, lanes, seed):
    """(W, lanes, rows, 3, 8) reduced buckets on the card: sums of two
    points (Z != 1), the identity in a share of the rows (most of them at
    c >= 12, whose windows are 2,048-65,535 rows), lane 0 all identity when
    there are several lanes."""
    w, rows = K.windows(c), K.rows(c, signed)
    g = torch.Generator().manual_seed(seed)
    pts, _ = _inputs(32, seed)
    pool = C.from_affine(C.host_points_to_affine(pts, "cuda"))
    pool = cuda_curve.add(pool, pool.roll(3, 0))
    idx = torch.randint(0, 32, (w, lanes, rows), generator=g)
    dead = torch.rand((w, lanes, rows), generator=g) > (0.9 if rows <= 256 else 200 / rows)
    if lanes > 1:
        dead[:, 0] = True
    bk = pool[idx.cuda()]
    bk[dead.cuda()] = C.infinity((), "cuda")
    return bk.contiguous()


TAIL_CASES = ([(c, s, 1) for c in (1, 4, 8, 12, 16) for s in (True, False)]
              + [(c, s, 3) for c in (4, 8, 12, 16) for s in (True, False)]
              + [(4, True, 40), (5, True, 40), (8, True, 40)])


@pytest.mark.gpu
@pytest.mark.parametrize("c,signed,lanes", TAIL_CASES)
def test_tail_matches_plain_on_card(cuda, c, signed, lanes):
    """The tail of K4 (one lane) and K7 (3 or 40 lanes) against its plain
    version at c in {1, 4, 8, 12, 16}, both signs: one count a tail, one
    CUDA launch up to 1,024 rows a window (c = 8 among them); where the
    window sums take their own launches, the sums and Horner run apart give
    the same words."""
    bk = _tail_buckets(c, signed, lanes, 160 + 7 * c + lanes + signed)
    key = "K4" if lanes == 1 else "K7"
    cuda_lib.reset_launches()
    out = K.tail(bk[:, 0].contiguous(), c)[None] if lanes == 1 else KB.tail(bk, c)
    assert cuda_lib.launches[key] == 1 and cuda_lib.launches["K4" if key == "K7" else "K7"] == 0
    assert torch.equal(out, K.plain_tail(bk, c))
    assert (K.tail_launches(bk.shape[2]) == 1) == (bk.shape[2] <= 1024)
    if c == 8:
        assert K.tail_launches(bk.shape[2]) == 1
    if K.tail_launches(bk.shape[2]) > 1:
        _, sums = K.launch_tail(bk, c, key, parts=1)
        assert torch.equal(K.launch_tail(bk, c, key, parts=2, sums=sums)[0], out)


@pytest.mark.gpu
def test_tails_on_two_streams_match_plain(cuda):
    """One-launch tails of K4 and K7 (c = 8) launched in turn on two streams
    with no sync between them each give their plain version's words: the
    per-lane counters that pick the warp running Horner are a call's own."""
    b1, b3 = _tail_buckets(8, True, 1, 301)[:, 0].contiguous(), _tail_buckets(8, True, 3, 302)
    want1, want3 = K.plain_tail(b1, 8), K.plain_tail(b3, 8)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for i in range(16):
        with torch.cuda.stream(streams[i % 2]):
            outs.append((K.tail(b1, 8), KB.tail(b3, 8)) if i % 2 else (KB.tail(b3, 8), K.tail(b1, 8)))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(outs):
        got1, got3 = (a, b) if i % 2 else (b, a)
        assert torch.equal(got1, want1) and torch.equal(got3, want3)


@pytest.mark.gpu
def test_ipa_on_card_matches_cpu(cuda):
    n = 8
    crs = ipa_setup(n)
    cpu = IPAParams(n=n, g_host=crs.g_host, q_host=crs.q_host, domain=crs.domain, device="cpu")
    rng = random.Random(16)
    vals = [rng.randrange(R) for _ in range(n)]
    commit = IPA.commit(crs, FrVector.from_ints(vals, crs.domain, device=cuda))
    assert commit == IPA.commit(cpu, FrVector.from_ints(vals, crs.domain, device="cpu"))
    for point in (3, 2 * n):
        t_gpu, t_cpu = Transcript("ipa"), Transcript("ipa")
        proof = IPA.prove_point(crs, commit, point, FrVector.from_ints(vals, crs.domain, device=cuda), t_gpu)
        want = IPA.prove_point(cpu, commit, point, FrVector.from_ints(vals, crs.domain, device="cpu"), t_cpu)
        assert (proof.l, proof.r, proof.tip, proof.y) == (want.l, want.r, want.tip, want.y)
        assert bytes(t_gpu._state) == bytes(t_cpu._state)
        assert IPA.verify(crs, commit, point, proof)


@pytest.mark.gpu
def test_verkle_tree_on_card_matches_cpu(cuda):
    """A width-16 tree with a dense internal node and a dense root, on the
    card and on the CPU: the same commitment at every node, and a proof of
    present and absent keys from the card that verifies on both."""
    n = 16
    crs = ipa_setup(n)
    cpu = IPAParams(n=n, g_host=crs.g_host, q_host=crs.q_host, domain=crs.domain, device="cpu")
    rng = random.Random(17)
    keys = [(0, j, rng.randrange(n)) for j in range(10)] + [(u, 1, rng.randrange(n)) for u in range(1, 11)]
    values = {k: rng.randrange(1 << 256) for k in keys}
    trees = [VerkleTree(IPA, p, key_len=3, ext_width=n, internal_width=n) for p in (crs, cpu)]
    for t in trees:
        for k in keys:
            t.insert_single(k, values[k])
    cuda_lib.reset_launches()
    root = trees[0].commitment()
    assert min(cuda_lib.launches[k] for k in ("K2FOLD", "K5")) > 0 and cuda_lib.launches["K2"] == 0
    assert root == trees[1].commitment()
    for u in range(11):
        assert trees[0].root.children[u].commit == trees[1].root.children[u].commit
    sample = keys[:2] + [(12, 0, 0), (0, 11, 3)]
    proof = trees[0].prove_keys(sample)
    claims = {k: values.get(k) for k in sample}
    assert trees[0].verify_keys(sample, claims, proof)
    assert trees[1].verify_keys(sample, claims, proof)
    claims[keys[0]] += 1
    assert not trees[0].verify_keys(sample, claims, proof)


@pytest.mark.gpu
def test_group_law_kernels_match_plain_on_card(cuda):
    """K11 (double) and K12 (mixed add, the (0, 0) sentinel and the
    identity among the lanes) against their plain versions; scalar_mul,
    one G1SMUL launch and no K11 or K2, on the card against the CPU."""
    pts, ks = _inputs(300, 110)
    p = C.from_affine(C.host_points_to_affine(pts, cuda))
    p = cuda_curve.add(p, p.roll(1, 0))  # Z != 1, and the identity where both are
    q = C.host_points_to_affine(pts[::-1], cuda)
    cuda_lib.reset_launches()
    assert torch.equal(cuda_curve.double(p), cuda_curve.plain_double(p))
    assert torch.equal(cuda_curve.mixed_add(p, q), cuda_curve.plain_mixed_add(p, q))
    assert cuda_lib.launches["K11"] == 1 and cuda_lib.launches["K12"] == 1
    host = C.projective_to_host_points(p)
    assert C.projective_to_host_points(C.mixed_add(p, q)) == [hc.g1_add(a, b) for a, b in zip(host, pts[::-1])]
    assert torch.equal(C.neg(p).cpu(), C.neg(p.cpu()))
    sc = F.ints_to_words(ks[:64], cuda)
    cuda_lib.reset_launches()
    got = C.scalar_mul(p[:64], sc)
    assert cuda_lib.launches["G1SMUL"] == 1 and cuda_lib.launches["K11"] == cuda_lib.launches["K2"] == 0
    assert torch.equal(got.cpu(), C.scalar_mul(p[:64].cpu(), sc.cpu()))
    assert C.projective_to_host_points(got) == [
        None if a is None else hc.g1_mul(a, k) for a, k in zip(host[:64], ks[:64])
    ]


@pytest.mark.gpu
def test_ntt_and_kzg_on_card_match_cpu(cuda):
    """ntt_g1 and intt_g1 at n = 16 and the Fr NTT, then KZG at domain 8
    (setup, commit, in- and out-of-domain proofs, FK), on the card against
    the CPU path, bit for bit."""
    rng = random.Random(120)
    pts = [hc.g1_mul(hc.g1_generator(), rng.randrange(R)) for _ in range(16)]
    pts[3] = None
    x = C.from_affine(C.host_points_to_affine(pts, cuda))
    cuda_lib.reset_launches()
    evals = N.ntt_g1(x)
    assert cuda_lib.launches["G1BFLY"] == 4 and cuda_lib.launches["K11"] == 0
    assert torch.equal(evals.cpu(), N.ntt_g1(x.cpu()))
    back = N.intt_g1(evals)
    assert torch.equal(back.cpu(), N.intt_g1(evals.cpu()))
    assert C.projective_to_host_points(back) == pts
    a = F.ints_to_mont([rng.randrange(R) for _ in range(32)], "fr", cuda)
    assert torch.equal(N.ntt_fr(a).cpu(), N.ntt_fr(a.cpu()))
    assert torch.equal(N.intt_fr(N.ntt_fr(a)), a)

    crs = kzg_setup(8)
    cpu = KZGParams(size=8, lagrange_host=crs.lagrange_host, g2=crs.g2, domain=crs.domain, device="cpu")
    assert crs.lagrange_host == kzg_setup(8, device="cpu").lagrange_host
    vals = [rng.randrange(R) for _ in range(5)]
    data = FrVector.from_ints(vals, crs.domain, device=cuda)
    cdata = FrVector.from_ints(vals, crs.domain, device="cpu")
    commit = KZG.commit(crs, data)
    assert commit == KZG.commit(cpu, cdata) == native.g1_msm(crs.lagrange_host[:5], vals)
    for point in (2, 6, 40):
        proof = KZG.prove(crs, commit, point, data)
        want = KZG.prove(cpu, commit, point, cdata)
        assert (proof.proof, proof.y) == (want.proof, want.y)
        assert KZG.verify(crs, commit, point, proof)
    fk = KZG.prove_all_points(crs, data)
    assert [(p.proof, p.y) for p in fk] == [(p.proof, p.y) for p in KZG.prove_all_points(cpu, cdata)]


@pytest.mark.gpu
@pytest.mark.parametrize("c,group,fused,signed", [(6, 2, False, True), (6, 2, True, True), (8, 4, True, True),
                                                  (4, 3, True, False), (5, 6, True, True)])
def test_group_kernel_matches_plain_on_card(cuda, c, group, fused, signed):
    """K13, the sorted accumulation over a lane stream read in place (its
    (W, S, B) digits and (S, B) points at their strides), against its plain
    version over 1,024 points in 32 lanes, one count each (G and fused
    change nothing: a G that padded a window, a G above 4, unsigned); its
    single MSM through msm_stream against the native oracle, and its rows
    equal to the K6/K10 branch's."""
    from verkle_kzg_tpu_torch.ops import msm_stream as MS

    n, lanes = 1024, 32
    pts, ks = _inputs(n, 130 + c)
    pa, sc = C.host_points_to_affine(pts, cuda), F.ints_to_words(ks, cuda)
    digits = (M.window_digits_signed if signed else M.window_digits)(sc, c).to(torch.int32)
    stream, digits = pa.reshape(n // lanes, lanes, 2, 8), digits.reshape(-1, n // lanes, lanes).contiguous()
    view, dview = stream.transpose(0, 1), digits.permute(0, 2, 1)
    cuda_lib.reset_launches()
    table = KS.accumulate_digits(view, dview, c, signed, key="K13")
    assert cuda_lib.launches["K13"] == 1 and cuda_lib.cuda_launches["K13"] >= 5
    assert torch.equal(table, KS.plain_accumulate_digits(view, dview, c, signed))
    assert torch.equal(table, KS.accumulate_digits(view.contiguous(), dview.contiguous(), c, signed))
    got = MS.msm_single_fused(stream, digits, c, signed=signed, wgroup=group, fused=fused)
    assert C.projective_to_host_points(got) == [native.g1_msm(pts, ks)]
    assert torch.equal(MS.bucket_accumulate(stream, digits, c, signed=signed, wgroup=group, fused=fused),
                       MS.bucket_accumulate(stream, digits, c, signed=signed))


def _chain_scalar_mul(p, k):
    """The K11 + K2 + select chain G1SMUL replaced, one bit at a time."""
    acc = C.infinity(p.shape[:-2], p.device)
    for bit in C.scalar_bits_msb(k) != 0:
        acc = cuda_curve.double(acc)
        acc = torch.where(bit[..., None, None], cuda_curve.add(acc, p), acc)
    return acc


def _chain_points(n, seed):
    """n card points with Z != 1 and the identity at slot 2, and scalars 0,
    1, r - 1 and one with 200 leading zero bits among random ones (r - 1
    alone for one lane)."""
    pts, ks = _inputs(n + 3, seed)
    p = C.from_affine(C.host_points_to_affine(pts, "cuda"))
    p = cuda_curve.add(p, p.roll(1, 0))[:n].contiguous()
    if n > 2:
        p[2] = C.infinity((), "cuda")
    ks[:4] = [0, 1, R - 1, random.Random(seed).getrandbits(56) | 1 << 55] if n > 1 else [R - 1] * 4
    return p, F.ints_to_words(ks[:n], "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 33, 256, 512])
def test_g1_scalar_mul_kernel_matches_plain_and_chain(cuda, lanes):
    """G1SMUL at every block size against its plain version and against the
    K11 + K2 + select chain, one launch."""
    p, k = _chain_points(lanes, 140 + lanes)
    cuda_lib.reset_launches()
    got = G.scalar_mul(p, k)
    assert cuda_lib.launches["G1SMUL"] == 1
    assert torch.equal(got, G.plain_scalar_mul(p, k))
    assert torch.equal(got, _chain_scalar_mul(p, k))
    for block in (32, 64, 128):
        assert torch.equal(G.scalar_mul(p, k, block), got)


@pytest.mark.gpu
@pytest.mark.parametrize("n,stage", [(2, 0), (64, 0), (64, 2), (64, 5), (512, 3), (512, 8)])
def test_g1_butterfly_kernel_matches_plain_and_chain(cuda, n, stage):
    """G1BFLY against its plain version and against the butterfly the chain
    ran (K11 + K2 + select, then K2, a K1 negation and K2): stage 0 (every
    twiddle 1), stages whose warps share a twiddle and mixed ones, with the
    plan's twiddles and with edge twiddles."""
    x, k = _chain_points(n, 150 + n + stage)
    half = 1 << stage
    plan_tw = F.ints_to_words(N._Plan(n, False).stages[stage][2][:half], "cuda")
    for tw in (plan_tw, k[:half].contiguous()):
        cuda_lib.reset_launches()
        got = G.butterfly(x, tw, stage)
        assert cuda_lib.launches["G1BFLY"] == 1
        assert torch.equal(got, G.plain_butterfly(x, tw, stage))
        j, u_idx = G._pairs(n, stage, x.device)
        v = _chain_scalar_mul(x[u_idx + half], tw[j])
        assert torch.equal(got[u_idx], cuda_curve.add(x[u_idx], v))
        assert torch.equal(got[u_idx + half], cuda_curve.add(x[u_idx], C.neg(v)))
        for block in (32, 128):
            assert torch.equal(G.butterfly(x, tw, stage, block), got)
