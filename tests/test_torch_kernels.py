"""K1-K10 on a CUDA card against their plain versions, bit for bit, and the
port's IPA and a width-16 verkle tree on the card against their CPU path.

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
from verkle_kzg_tpu_torch.ops import cuda_msm as K
from verkle_kzg_tpu_torch.ops import cuda_msm_batched as KB
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import msm as M
from verkle_kzg_tpu_torch.poly import FrVector
from verkle_kzg_tpu_torch.schemes import IPA, IPAParams, ipa_setup
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
    nseg, seg_len = M.segments(n)
    pad = nseg * seg_len - n
    pa = torch.nn.functional.pad(C.host_points_to_affine(pts, cuda), (0, 0, 0, 0, 0, pad)).contiguous()
    sc = torch.nn.functional.pad(a, (0, 0, 0, pad)).contiguous()
    masks = M.signed_carries(sc, 8).contiguous()
    table = K.accumulate(pa, sc, masks, nseg, seg_len)
    assert torch.equal(table, K.plain_accumulate(pa, sc, masks, nseg, seg_len))
    buckets = M.fold_reduce_lanes(table, dim=1)[:, 0].contiguous()
    out = K.tail(buckets)
    assert torch.equal(out, K.plain_tail(buckets))
    assert C.projective_to_host_points(out) == [native.g1_msm(pts, ks)]
    # to_affine runs K1 only: Fermat inversion, then two products
    assert torch.equal(C.to_affine(p), C.host_points_to_affine(pts, cuda))
    # K5 on the same lanes, (0, 0) and zero scalars among them
    pa, sc = C.host_points_to_affine(pts, cuda), a
    assert torch.equal(cuda_scalar_mul.scalar_mul_affine(pa, sc), cuda_scalar_mul.plain(pa, sc))
    # K6 and K7 at c = 4 and 5 over a 64-point basis, three lanes
    basis = pa[:64].contiguous()
    scalars = torch.stack([a[:64], a[64:128], a[128:192]])
    for c in (4, 5):
        digits = M.window_digits_signed(scalars, c).to(torch.int32).contiguous()
        nseg, seg_len = M.segments(64)
        table = KB.accumulate(basis, digits, nseg, seg_len, c)
        assert torch.equal(table, KB.plain_accumulate(basis, digits, nseg, seg_len, c))
        buckets = M.fold_reduce_lanes(table, dim=2)[:, :, 0].contiguous()
        assert torch.equal(KB.tail(buckets, c), KB.plain_tail(buckets, c))
        got = C.projective_to_host_points(M.msm_fixed_base(basis, scalars, c=c))
        assert got == [native.g1_msm(pts[:64], ks[64 * i : 64 * i + 64]) for i in range(3)]
    torch.cuda.synchronize()
    assert min(cuda_lib.launches[f"K{i}"] for i in range(1, 8)) > 0


@pytest.mark.gpu
@pytest.mark.parametrize(
    "c,signed,key",
    [(16, False, "K8"), (4, False, "K8"), (16, True, "K9"), (12, True, "K10"), (9, False, "K10"), (5, False, "K6")],
)
def test_window_modes_match_plain_on_card(cuda, c, signed, key):
    """The single MSM's other widths and signs: the accumulation (K8, K9,
    K10, K6 unsigned) and K4 on its folded tables, against their plain
    versions, and the whole MSM against the native oracle."""
    n = 300
    pts, ks = _inputs(n, 90 + c)
    nseg, seg_len = M.segments(n, K.windows(c) * K.rows(c, signed))
    pad = nseg * seg_len - n
    pa = torch.nn.functional.pad(C.host_points_to_affine(pts, cuda), (0, 0, 0, 0, 0, pad)).contiguous()
    sc = torch.nn.functional.pad(F.ints_to_words(ks, cuda), (0, 0, 0, pad)).contiguous()
    cuda_lib.reset_launches()
    if c in K.IN_KERNEL_C:
        masks = M.signed_carries(sc, c).contiguous() if signed else None
        table = K.accumulate(pa, sc, masks, nseg, seg_len, c, signed)
        assert torch.equal(table, K.plain_accumulate(pa, sc, masks, nseg, seg_len, c, signed))
    else:
        digits = (M.window_digits_signed if signed else M.window_digits)(sc, c).to(torch.int32)[:, None].contiguous()
        table = KB.accumulate(pa, digits, nseg, seg_len, c, signed)
        assert torch.equal(table, KB.plain_accumulate(pa, digits, nseg, seg_len, c, signed))
        table = table[:, 0]
    assert cuda_lib.launches[key] == 1
    buckets = M.fold_reduce_lanes(table, dim=1)[:, 0].contiguous()
    out = K.tail(buckets, c)
    assert torch.equal(out, K.plain_tail(buckets, c))
    assert C.projective_to_host_points(out) == [native.g1_msm(pts, ks)]
    got = M.msm_pippenger(pa[:n], sc[:n], c=c, signed=signed)
    assert C.projective_to_host_points(got) == [native.g1_msm(pts, ks)]


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
    assert min(cuda_lib.launches[k] for k in ("K2", "K5")) > 0
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
