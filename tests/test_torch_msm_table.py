"""Kernel FBMSM, the single MSM over a fixed-base table
(``verkle_kzg_tpu_torch.ops.cuda_msm_table``), and its table
(``ops/msm.py::build_table``): on the CPU the plain versions against the
native oracle's sums (``native.g1_msm``) and against ``msm_auto`` without a
table (K3 + K4, or K5 below 64 points), over g || q and over prefixes
g[:n], at widths 4 and 16, on edge scalars; the table's entries against
m 2^(c w) P_i on host integers (``hostmath``); and a
width-16 multiproof on the table path against the plain reference, with
every MSM of the prove counted on it. On a card, the kernel against its
plain version at 256 and 257 points, at TABLE_C, the one width it is built
for, and the table built on the card against the host.

The plain version takes any width, so the CPU builds its table at c = 4
(its 8 multiples a window are a sixteenth of c = 8's), once at width 16,
whose first five rows are width 4's g || q, and sets it on the parameters;
and at c = 8 over a one-point basis. The card cases
import no JAX (the card's machine has none):

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu tests/test_torch_msm_table.py
"""

import random

import pytest
import torch

from verkle_kzg_tpu_torch import native
from verkle_kzg_tpu_torch.hostmath import curve as hc
from verkle_kzg_tpu_torch.ops import cuda_msm_table as KT
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.ops import msm as M
from verkle_kzg_tpu_torch.params import R
from verkle_kzg_tpu_torch.schemes import ipa_setup
from verkle_kzg_tpu_torch.utils import metrics

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def crs():
    """CPU parameters at width 16 with their c = 4 table. Width 4's basis is
    its first five points (g_0..g_3, then q = g_4), so width-4 calls take
    rows 0..3 and row 4 of the same table."""
    p = ipa_setup(16, device="cpu")
    p.table = M.build_table(torch.cat([p.g_affine, p.q_affine]), 4)
    return p


@pytest.fixture(scope="module")
def single():
    """A one-point basis (q of width 16) and its c = 8 table."""
    p = ipa_setup(16, device="cpu")
    return [p.q_host], p.q_affine, M.build_table(p.q_affine, 8)


def _host_msm(pts, ks):
    return native.g1_msm(pts, ks)


def _kernel_calls() -> dict:
    """The kernel wrappers' spans since the counters' reset: on the CPU the
    plain versions count no launch, but their wrappers' spans count calls."""
    return {k[len("span.kernels."):-len(".calls")]: v for k, v in metrics.counters().items()
            if k.startswith("span.kernels.") and k.endswith(".calls")}


def _edge(kind, n, c):
    """n scalars of one kind, at width c."""
    w = 256 // c
    rng = random.Random(n * 31 + c)
    if kind == "zero":
        return [0] * n
    if kind == "one":
        return [1] * n
    if kind == "r-1":
        return [R - 1] * n
    if kind == "equal":
        return [rng.randrange(R)] * n
    if kind == "top-carry":  # window W - 2 above half carries into the top window
        return [((1 << c) - 1 - i % 3) << (c * (w - 2)) | rng.getrandbits(c * (w - 2)) for i in range(n)]
    # every window below the top at three quarters of 2^c: all digits there negative
    neg = sum((3 << (c - 2)) << (c * i) for i in range(w - 1))
    return [neg - i for i in range(n)]


def _basis(p, n, kind):
    """(points, host points, table rows) of width n's g || q, or of the
    prefix g[:n / 2 + 1]."""
    host = list(p.g_host) + [p.q_host]
    k = n + 1 if kind == "q" else n // 2 + 1
    pts = torch.cat([p.g_affine, p.q_affine])[:k]
    rows = p.basis(n, q=True) if kind == "q" and n == p.n else p.table.rows(k)
    return pts, host[:k], rows


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("kind", ["q", "prefix"])
def test_table_msm_matches_sorted_and_host(crs, n, kind):
    """Random scalars with 0 and r - 1 among them: the table path, the MSM
    without a table and the host sum agree, and only FBMSM's wrapper ran."""
    pts, host, rows = _basis(crs, n, kind)
    rng = random.Random(n + len(kind))
    ks = [rng.randrange(R) for _ in range(len(host))]
    ks[0], ks[-1] = 0, R - 1
    sc = F.ints_to_words(ks, "cpu")
    metrics.reset_counters()
    got = C.projective_to_host_points(M.msm_auto(rows, sc))
    assert _kernel_calls() == {"FBMSM": 1} and metrics.counters()["msm.table.calls"] == 1
    assert got == C.projective_to_host_points(M.msm_auto(pts, sc)) == [_host_msm(host, ks)]


@pytest.mark.parametrize("kind", ["zero", "one", "r-1", "equal", "top-carry", "negative"])
def test_table_msm_edge_scalars(crs, single, kind):
    """Edge scalars at c = 4 (width 4, g || q) and c = 8 (one point)."""
    _, host, rows = _basis(crs, 4, "q")
    for host_, rows_ in ((host, rows), (single[0], single[2].rows(1))):
        ks = _edge(kind, len(host_), rows_.table.c)
        assert all(0 <= k < R for k in ks)
        got = M.msm_auto(rows_, F.ints_to_words(ks, "cpu"))
        assert C.projective_to_host_points(got) == [_host_msm(host_, ks)]


def test_table_entries_match_host(crs, single):
    """T[i][w][m - 1] = m 2^(c w) P_i at the corners and inside, c = 4 and 8."""
    cases = [(list(crs.g_host) + [crs.q_host], crs.table), (single[0], single[2])]
    for host, table in cases:
        c, (rows, w, h) = table.c, table.points.shape[:3]
        assert (rows, w, h) == (len(host), 256 // c, 1 << (c - 1))
        for i, wi, m in ((0, 0, 1), (rows - 1, w - 1, h), (rows // 2, w // 3, h // 2 + 1), (rows - 1, w - 2, 3)):
            got = C.affine_to_host_points(table.points[i, wi, m - 1])
            assert got == [hc.g1_mul(host[i], m << (c * wi))], (c, i, wi, m)


def test_table_rows_are_checked(crs):
    """Scalars of another count than the rows, rows past the table, or a
    width the plain version cannot take, raise; CPU parameters with no
    table set give the basis as points."""
    with pytest.raises(ValueError):
        M.msm_auto(crs.basis(4, q=True), F.ints_to_words([1] * 4, "cpu"))
    with pytest.raises(ValueError):
        crs.table.rows(18)
    with pytest.raises(ValueError):
        M.build_table(crs.q_affine, 3)
    p = ipa_setup(4, device="cpu")
    assert torch.equal(p.basis(4, q=True), torch.cat([p.g_affine, p.q_affine])) and p.table is None


def test_multiproof_on_the_table(crs):
    """A width-16 multiproof on the table path: every MSM of the prove (the
    two commits and the 4 rounds' 8) runs FBMSM and is counted, no K3, K4 or
    K5 wrapper ran, and the proof equals the plain reference's
    (``vkbench/reference``, Python integers)."""
    from vkbench.reference import bn254 as E
    from vkbench.reference import ipa as ref
    from verkle_kzg_tpu_torch.poly import FrVector
    from verkle_kzg_tpu_torch.schemes import IPA, ProverQuery, prove_multiproof
    from verkle_kzg_tpu_torch.schemes.generators import DEFAULT_IPA_SEED

    g, q = ref.basis(16, DEFAULT_IPA_SEED)
    assert (g, q) == (crs.g_host, crs.q_host)
    rng = random.Random(0x7AB)
    vals = [rng.randrange(R) for _ in range(16)]
    zs = [rng.randrange(16) for _ in range(5)]
    commit = ref.commit(g, vals)
    fv = FrVector.from_ints(vals, crs.domain, device="cpu")
    queries = [ProverQuery(fv, commit, z, vals[z]) for z in zs]
    metrics.reset_counters()
    mp = prove_multiproof(IPA, crs, queries)
    counts, kernels = metrics.counters(), _kernel_calls()
    assert counts["msm.table.calls"] == counts["span.orchestration.msm_auto.calls"] == 10
    assert kernels["FBMSM"] == 10 and not any(k in kernels for k in ("K3", "K4", "K5"))
    d, (ls, rs, tip, y) = ref.multiproof(g, q, [(vals, commit, z, vals[z]) for z in zs], E.domain(16))
    assert (mp.d, mp.proof.l, mp.proof.r, mp.proof.tip, mp.proof.y) == (d, ls, rs, tip, y)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda):
    """FBMSM against its plain version word for word, and against K3 + K4,
    at 257 points (g || q) and 256 (g), with 0 and r - 1 among the scalars;
    a table at another width than TABLE_C is refused on the card."""
    p = ipa_setup(256, device=cuda)
    rng = random.Random(8)
    for rows, pts in ((p.basis(256, q=True), torch.cat([p.g_affine, p.q_affine])), (p.basis(256), p.g_affine)):
        ks = [rng.randrange(R) for _ in range(rows.count)]
        ks[3], ks[7] = 0, R - 1
        sc = F.ints_to_words(ks, cuda)
        got = KT.msm(rows, sc)
        assert torch.equal(got.cpu(), KT.plain_msm(rows, sc).cpu())
        assert C.projective_to_host_points(got) == C.projective_to_host_points(M.msm_auto(pts, sc))
    with pytest.raises(ValueError):
        KT.msm(M.build_table(p.q_affine, 4).rows(1), sc[:1])


@pytest.mark.gpu
def test_table_built_on_card_matches_host(cuda):
    """The width-256 table, built on the card at TABLE_C, at sampled entries."""
    p = ipa_setup(256, device=cuda)
    c = KT.TABLE_C
    table = p.basis(256).table
    host = list(p.g_host) + [p.q_host]
    assert table.c == c and table.points.shape == (257, 256 // c, 1 << (c - 1), 2, 8)
    rng = random.Random(5)
    for _ in range(24):
        i, w, m = rng.randrange(257), rng.randrange(256 // c), rng.randrange(1, (1 << (c - 1)) + 1)
        assert C.affine_to_host_points(table.points[i, w, m - 1]) == [hc.g1_mul(host[i], m << (c * w))]
