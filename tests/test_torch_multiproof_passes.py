"""Kernels K1QUO (the in-domain quotient, ``poly/lagrange.py::quotient_in_domain``)
and K1MP (the multiproof's grouped sums and h, ``ops/cuda_multiproof.py``):
their plain versions, which CPU tensors take, word for word against the JAX
package's ``_quotient_in_domain`` (vmapped, as ``_quotients_sum_impl`` runs
it), ``_scale_and_group``, ``_quotients_sum`` and ``_h_accumulate`` at
domains 8 and 16, tolerance 0; the host's segment plan; and, on a card, each
kernel against its plain version.

The card cases import no JAX (the card's machine has none):

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu tests/test_torch_multiproof_passes.py
"""

import functools
import random

import numpy as np
import pytest
import torch

from verkle_kzg_tpu_torch.ops import cuda_lib
from verkle_kzg_tpu_torch.ops import cuda_multiproof as KM
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.params import R
from verkle_kzg_tpu_torch.poly import Domain, FrVector
from verkle_kzg_tpu_torch.poly.lagrange import _quotient_in_domain, _quotient_in_domain_table, quotient_in_domain
from verkle_kzg_tpu_torch.schemes import multiproof as MP

torch.set_num_threads(1)

# name -> (domain, vectors, zero vector, queries as (vector, z)): every
# query at z = N - 1 (one distinct point, M = 5); 13 queries over points
# with 0 and N - 1 among them. Each case has a repeated vector and a zero
# vector, so zero rows reach the grouped sums and the quotients.
CASES = {
    "n8_one_point": (8, 2, 1, [(0, 7), (1, 7), (0, 7), (0, 7), (1, 7)]),
    "n16_mixed": (16, 3, 2, [(0, 0), (1, 15), (2, 4), (0, 15), (2, 0), (1, 9), (0, 4), (2, 4), (1, 0),
                             (0, 11), (2, 15), (0, 9), (1, 4)]),
}


def _words(planes) -> torch.Tensor:
    """JAX (..., 16, N) uint32 limb planes -> the port's (..., N, 8) int32 words."""
    a = np.asarray(planes, dtype=np.uint32)
    w = a[..., 0::2, :] | (a[..., 1::2, :] << np.uint32(16))
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(w, -1, -2)).view(np.int32))


def _planes(words: torch.Tensor):
    """The port's (..., N, 8) words -> JAX (..., 16, N) uint32 planes."""
    import jax.numpy as jnp

    w = np.swapaxes(np.ascontiguousarray(words.numpy()).view(np.uint32), -1, -2)
    out = np.empty(w.shape[:-2] + (16, w.shape[-1]), dtype=np.uint32)
    out[..., 0::2, :] = w & np.uint32(0xFFFF)
    out[..., 1::2, :] = w >> np.uint32(16)
    return jnp.asarray(out)


def _mont(vals, device="cpu") -> torch.Tensor:
    return F.ints_to_mont(vals, "fr", device)


def _inputs(name, device="cpu"):
    """The case's (U, N, 8) vectors, per-query vector indices and points,
    r and t, from a seed; the zero vector stays zero."""
    n, u, zero, queries = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    vecs = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)] for _ in range(u)]
    vecs[zero] = [0] * n
    r, t = (int.from_bytes(rng.bytes(32), "little") % R for _ in range(2))
    stack = torch.stack([_mont(v, device) for v in vecs])
    return stack, [q[0] for q in queries], [q[1] for q in queries], r, t


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX package's three passes on the case, as its prove_multiproof
    calls them, in the port's word layout."""
    import jax
    import jax.numpy as jnp
    from verkle_kzg_tpu.poly import Domain as JDomain
    from verkle_kzg_tpu.poly import lagrange as jlag
    from verkle_kzg_tpu.schemes import multiproof as jmp

    stack, sel, zs, r, t = _inputs(name)
    n, m = stack.shape[1], len(zs)
    jdom = JDomain(n)
    distinct = sorted(set(zs))
    zp = 1 << (len(distinct) - 1).bit_length() if len(distinct) > 1 else 1
    z_vals = jnp.asarray(distinct + [0] * (zp - len(distinct)), dtype=jnp.int32)
    data = _planes(stack)[jnp.asarray(sel, dtype=jnp.int32)]  # (M, 16, N)
    r_pows = _planes(_mont([pow(r, k, R) for k in range(m)])[:, None])  # (M, 16, 1)
    z_compact = jnp.asarray([distinct.index(z) for z in zs], dtype=jnp.int32)
    scaled, grouped = jmp._scale_and_group(data, r_pows, z_compact, zp=zp)
    invdiff = jdom.invdiff_rows(z_vals)
    g = jmp._quotients_sum(grouped, invdiff, jdom.d_vanishing, jdom.d_vanishing_inv, z_vals)
    # the ratio rows A'(w^z) / A'(w^i) of _quotients_sum_impl, from host ints
    ratio = [[jdom.vanishing[z] * vi % R for vi in jdom.vanishing_inv] for z in np.asarray(z_vals).tolist()]
    ratio_words = _mont([v for row in ratio for v in row]).reshape(zp, n, F.WORDS)
    rows = jax.vmap(jlag._quotient_in_domain)(grouped, invdiff, _planes(ratio_words), z_vals)
    inversions = [pow((t - z) % R, -1, R) for z in range(n)]
    h = jmp._h_accumulate(scaled, _planes(_mont([inversions[z] for z in zs])[:, None]))
    k = len(distinct)
    return {
        "distinct": distinct, "grouped": _words(grouped)[:k], "g": _words(g), "rows": _words(rows)[:k],
        "invdiff": _words(invdiff)[:k], "ratio": ratio_words[:k], "h": _words(h),
        "inv": _mont([inversions[z] for z in distinct]),
    }


@pytest.mark.parametrize("name", list(CASES))
def test_scale_and_group_matches_jax(name):
    stack, sel, zs, r, _ = _inputs(name)
    want = _jax(name)
    distinct, grouped = MP._scale_and_group(stack, sel, _mont([r])[0], zs)
    assert distinct == want["distinct"]
    assert torch.equal(grouped, want["grouped"])


@pytest.mark.parametrize("name", list(CASES))
def test_quotients_sum_matches_jax(name):
    """K1QUO's summed mode (the multiproof's g), fed JAX's grouped rows."""
    want = _jax(name)
    dom = Domain(want["grouped"].shape[1])
    assert torch.equal(MP._quotients_sum(want["grouped"], dom, want["distinct"]), want["g"])


@pytest.mark.parametrize("name", list(CASES))
def test_quotient_rows_match_vmapped_jax(name):
    """K1QUO's per-row mode and its two plain versions (the table form and
    JAX's per-row form on JAX's own inverse and ratio rows) against JAX's
    _quotient_in_domain vmapped over the grouped rows."""
    want = _jax(name)
    grouped, distinct = want["grouped"], want["distinct"]
    dom = Domain(grouped.shape[1])
    index = torch.tensor(distinct)
    assert torch.equal(quotient_in_domain(grouped, distinct, dom), want["rows"])
    table = _quotient_in_domain_table(grouped, index, dom.d_omegas("cpu"), dom.d_invdiff_table("cpu"))
    assert torch.equal(table, want["rows"])
    assert torch.equal(_quotient_in_domain(grouped, want["invdiff"], want["ratio"], index), want["rows"])
    summed = _quotient_in_domain_table(grouped, index, dom.d_omegas("cpu"), dom.d_invdiff_table("cpu"), True)
    assert torch.equal(summed, want["g"])


@pytest.mark.parametrize("name", list(CASES))
def test_h_accumulate_matches_jax(name):
    """h over the distinct points (Zq products a column) equals JAX's sum
    over the queries, and h - g comes with it."""
    want = _jax(name)
    h, h_minus_g = MP._h_accumulate(want["grouped"], want["inv"], want["g"])
    assert torch.equal(h, want["h"])
    assert torch.equal(h_minus_g, F.sub(want["h"], want["g"], "fr"))


@pytest.mark.parametrize("n,z", [(8, 0), (8, 7), (16, 15)])
def test_divide_by_vanishing_matches_jax(n, z):
    """The KZG prove's in-domain quotient (one row) at the domain's edges,
    a zero entry at z and elsewhere, against JAX's FrVector."""
    from verkle_kzg_tpu.poly import Domain as JDomain
    from verkle_kzg_tpu.poly import FrVector as JFrVector

    rng = random.Random(n + z)
    vals = [rng.randrange(R) for _ in range(n)]
    vals[z], vals[(z + 3) % n] = 0, 0
    got = FrVector.from_ints(vals, Domain(n), device="cpu").divide_by_vanishing(z)
    want = JFrVector.from_ints(vals, JDomain(n)).divide_by_vanishing(z)
    assert got.to_ints() == want.to_ints() and got.max == want.max == n


def test_invdiff_table_gives_invdiff_rows():
    """w^-z T[(i - z) mod N] is 1 / (w^i - w^z), 0 at i = z, for every (z, i)."""
    n = 16
    dom = Domain(n)
    for z in range(n):
        for i in range(n):
            want = pow((dom.omegas[i] - dom.omegas[z]) % R, -1, R) if i != z else 0
            assert dom.omegas[(n - z) % n] * dom.invdiff_table[(i - z) % n] % R == want
    assert Domain(1).invdiff_table == [0]


@pytest.mark.parametrize("m,points", [(1, 1), (31, 1), (33, 1), (1024, 1), (1000, 251), (77, 9)])
def test_plan_segments_cuts_chunks(m, points):
    """Positions in the stable order by key; each segment cut into chunks of
    at most CHUNK positions that tile it; a skewed point takes many chunks."""
    rng = random.Random(m + points)
    keys = [rng.randrange(points) * 3 for _ in range(m)]
    rows = [rng.randrange(5) for _ in range(m)]
    distinct, plan = KM.plan_segments(keys, rows)
    assert distinct == sorted(set(keys))
    order = sorted(range(m), key=keys.__getitem__)
    assert plan.pos_e.tolist() == order and plan.pos_row.tolist() == [rows[k] for k in order]
    assert (plan.chunk_len >= 1).all() and (plan.chunk_len <= KM.CHUNK).all()
    for j in range(len(distinct)):
        first, count = plan.seg_first[j], plan.seg_count[j]
        assert (plan.chunk_seg[first : first + count] == j).all()
        covered = [p for c in range(first, first + count)
                   for p in range(plan.chunk_start[c], plan.chunk_start[c] + plan.chunk_len[c])]
        assert covered == list(range(plan.seg_start[j], plan.seg_start[j] + plan.seg_len[j]))
        assert {keys[plan.pos_e[p]] for p in covered} == {distinct[j]}
    assert plan.packed().dtype == np.int32 and plan.packed().size == 2 * m + 3 * plan.chunk_seg.size + 2 * len(distinct)


def test_segment_sum_skewed_matches_host_ints():
    """A thousand queries at one point and a few elsewhere, both modes, on
    the plain version, against sums of host ints."""
    rng = random.Random(15)
    n, m = 8, 1000
    vecs = [[rng.randrange(R) for _ in range(n)] for _ in range(2)]
    keys = [0 if k % 50 else 5 for k in range(m)]
    rows = [k % 2 for k in range(m)]
    r = rng.randrange(R)
    distinct, plan = KM.plan_segments(keys, rows)
    stack = torch.stack([_mont(v) for v in vecs])
    got = KM.segment_sum(stack, _mont([r])[0], plan, 0)
    want = {z: [0] * n for z in distinct}
    for k, (z, row) in enumerate(zip(keys, rows)):
        want[z] = [(a + pow(r, k, R) * b) % R for a, b in zip(want[z], vecs[row])]
    assert [F.mont_to_ints(got[j], "fr") for j in range(len(distinct))] == [want[z] for z in distinct]
    inv = [rng.randrange(R) for _ in distinct]
    g = [rng.randrange(R) for _ in range(n)]
    _, one = KM.plan_segments([0] * len(distinct), range(len(distinct)))
    h, h_minus_g = KM.segment_sum(got, _mont(inv), one, 1, g=_mont(g))
    h_ints = [sum(want[z][i] * w for z, w in zip(distinct, inv)) % R for i in range(n)]
    assert F.mont_to_ints(h[0], "fr") == h_ints
    assert F.mont_to_ints(h_minus_g, "fr") == [(a - b) % R for a, b in zip(h_ints, g)]


def test_cpu_takes_plain_and_counts_no_launch():
    """CPU tensors run the plain versions and count no K1QUO or K1MP
    launch; the K1QUO launcher refuses them."""
    cuda_lib.reset_launches()
    stack, sel, zs, r, t = _inputs("n16_mixed")
    distinct, grouped = MP._scale_and_group(stack, sel, _mont([r])[0], zs)
    dom = Domain(stack.shape[1])
    g = MP._quotients_sum(grouped, dom, distinct)
    MP._h_accumulate(grouped, _mont([1] * len(distinct)), g)
    FrVector.from_ints([1, 2, 3], dom, device="cpu").divide_by_vanishing(1)
    assert cuda_lib.launches["K1QUO"] == cuda_lib.launches["K1MP"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        KM.quotient(grouped, distinct, dom.d_omegas("cpu"), dom.d_invdiff_table("cpu"), True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,zs", [(256, [17]), (256, [0]), (256, [255]), (16, list(range(16))), (512, [3, 300, 511])])
@pytest.mark.parametrize("sum_rows", [False, True])
def test_quotient_kernel_matches_plain_on_card(cuda, n, zs, sum_rows):
    rng = random.Random(n + len(zs))
    vals = torch.stack([_mont([rng.randrange(R) for _ in range(n)]) for _ in zs])
    vals[0, 5] = 0
    dom = Domain(n)
    want = quotient_in_domain(vals, zs, dom, sum_rows)
    cuda_lib.reset_launches()
    got = quotient_in_domain(vals.to(cuda), zs, dom, sum_rows)
    torch.cuda.synchronize()
    assert cuda_lib.launches["K1QUO"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,points", [(256, 1024, 256), (256, 1024, 1), (16, 77, 5), (8, 3, 2), (256, 40, 40)])
def test_segment_sum_kernel_matches_plain_on_card(cuda, n, m, points):
    """Both K1MP modes: spread and skewed points (1,024 queries at one)."""
    rng = random.Random(n * m + points)
    stack = torch.stack([_mont([rng.randrange(R) for _ in range(n)]) for _ in range(3)])
    stack[1] = 0
    zs = [rng.randrange(points) for _ in range(m)]
    sel = [rng.randrange(3) for _ in range(m)]
    r = _mont([rng.randrange(R)])[0]
    distinct, plan = KM.plan_segments(zs, sel)
    want = KM.segment_sum(stack, r, plan, 0)
    cuda_lib.reset_launches()
    got = KM.segment_sum(stack.to(cuda), r.to(cuda), plan, 0)
    inv = _mont([rng.randrange(R) for _ in distinct])
    g = _mont([rng.randrange(R) for _ in range(n)])
    _, one = KM.plan_segments([0] * len(distinct), range(len(distinct)))
    h = KM.segment_sum(got, inv.to(cuda), one, 1, g=g.to(cuda))
    torch.cuda.synchronize()
    assert cuda_lib.launches["K1MP"] == 2
    assert torch.equal(got.cpu(), want)
    want_h = KM.segment_sum(want, inv, one, 1, g=g)
    assert torch.equal(h[0].cpu(), want_h[0]) and torch.equal(h[1].cpu(), want_h[1])
