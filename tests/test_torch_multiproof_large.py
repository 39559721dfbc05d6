"""The multiproof at query counts past 1,024 (``benchmarks/bench_all.py:111-113``
runs 4,096-32,768): the port's grouped and h passes (kernel K1MP's plain
version, which CPU tensors take) against the JAX package's ``_scale_and_group``
and ``_h_accumulate`` at 33,000 queries over domain 8, past JAX's 2^15-query
scatter block (``verkle_kzg_tpu/schemes/multiproof.py:75``), where the JAX
package changes path and the port does not; one whole IPA multiproof of
1,100 queries at domain 8 against JAX's proof fields and transcript state;
and, on a card, K1MP against its plain version where the power tables take
3 and 4 levels and every segment several chunks. Tolerance 0 throughout.

The card cases import no JAX (the card's machine has none):

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu tests/test_torch_multiproof_large.py
"""

import contextlib
import random

import numpy as np
import pytest
import torch

from verkle_kzg_tpu_torch.ops import cuda_lib
from verkle_kzg_tpu_torch.ops import cuda_multiproof as KM
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.params import R
from verkle_kzg_tpu_torch.schemes import multiproof as MP

torch.set_num_threads(1)

M_LARGE, N_LARGE = 33_000, 8  # past JAX's _SCATTER_BLOCK of 2^15 queries
M_PROOF, N_PROOF = 1_100, 8  # a whole multiproof past 1,024 queries


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


def _powers(r: int, m: int) -> list:
    out, p = [], 1
    for _ in range(m):
        out.append(p)
        p = p * r % R
    return out


def test_grouped_and_h_past_the_scatter_block_match_jax():
    """33,000 queries of 3 vectors (one all zero) over the 8 points of
    domain 8: the grouped rows equal JAX's two scatter blocks collapsed and
    added, h over the 8 points equals JAX's sum over the 33,000 queries,
    and the plan takes 4 levels of power tables."""
    from verkle_kzg_tpu.schemes import multiproof as jmp

    rng = np.random.default_rng(33_000)
    vecs = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(N_LARGE)] for _ in range(3)]
    vecs[1] = [0] * N_LARGE
    sel = rng.integers(0, 3, M_LARGE).tolist()
    zs = rng.integers(0, N_LARGE, M_LARGE).tolist()
    r, t = (int.from_bytes(rng.bytes(32), "little") % R for _ in range(2))
    stack = torch.stack([_mont(v) for v in vecs])

    distinct, grouped = MP._scale_and_group(stack, sel, _mont([r])[0], zs)
    _, plan = KM.plan_segments(zs, sel)
    assert distinct == list(range(N_LARGE)) and KM.power_levels(plan) == 4
    assert (plan.seg_count > 1).all()

    import jax.numpy as jnp

    z_compact = jnp.asarray(zs, dtype=jnp.int32)
    data = _planes(stack)[jnp.asarray(sel, dtype=jnp.int32)]  # (M, 16, N)
    r_pows = _planes(_mont(_powers(r, M_LARGE))[:, None])  # (M, 16, 1)
    scaled, jgrouped = jmp._scale_and_group(data, r_pows, z_compact, zp=N_LARGE)
    assert torch.equal(grouped, _words(jgrouped))

    inversions = [pow((t - z) % R, -1, R) for z in range(N_LARGE)]
    g = _mont([int.from_bytes(rng.bytes(32), "little") % R for _ in range(N_LARGE)])
    h, h_minus_g = MP._h_accumulate(grouped, _mont(inversions), g)
    jh = _words(jmp._h_accumulate(scaled, _planes(_mont([inversions[z] for z in zs])[:, None])))
    assert torch.equal(h, jh)
    assert torch.equal(h_minus_g, F.sub(jh, g, "fr"))


@contextlib.contextmanager
def _recording(module):
    """Record every Transcript the module's multiproof makes."""
    made = []
    base = module.Transcript

    class Recording(base):
        def __init__(self, label):
            super().__init__(label)
            made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "Transcript", Recording)
        yield made


def test_ipa_multiproof_of_1100_queries_matches_jax():
    """One IPA multiproof of 1,100 queries over 3 vectors at domain 8 (3
    levels of power tables, segments of some 140 queries): D, L, R, the tip,
    y and the transcript state equal JAX's; the port verifies it and
    rejects a wrong y."""
    import verkle_kzg_tpu.schemes.multiproof as jax_mp
    from verkle_kzg_tpu.poly import FrVector as JFrVector
    from verkle_kzg_tpu.schemes import IPA as JIPA
    from verkle_kzg_tpu.schemes import ProverQuery as JProverQuery
    from verkle_kzg_tpu.schemes import ipa_setup as jax_ipa_setup
    from verkle_kzg_tpu_torch import convert
    from verkle_kzg_tpu_torch.schemes import IPA, VerifierQuery, prove_multiproof, verify_multiproof

    rng = random.Random(1_100)
    jcrs = jax_ipa_setup(N_PROOF)
    vecs = [[rng.randrange(R) for _ in range(N_PROOF)] for _ in range(3)]
    picks = [(rng.randrange(3), rng.randrange(N_PROOF)) for _ in range(M_PROOF)]
    jdata = [JFrVector.from_ints(v, jcrs.domain) for v in vecs]
    commits = [JIPA.commit(jcrs, d) for d in jdata]
    jqueries = [JProverQuery(data=jdata[k], commit=commits[k], z=z, y=vecs[k][z]) for k, z in picks]
    with _recording(jax_mp) as made:
        jproof = jax_mp.prove_multiproof(JIPA, jcrs, jqueries)
    jstate = bytes(made[0]._state)

    crs = convert.ipa_params_from_jax(jcrs, "cpu")
    queries = convert.prover_queries_from_jax(jqueries, "cpu")
    with _recording(MP) as made:
        proof = prove_multiproof(IPA, crs, queries)
    fields = (proof.d, proof.proof.l, proof.proof.r, proof.proof.tip, proof.proof.y)
    assert fields == (jproof.d, jproof.proof.l, jproof.proof.r, jproof.proof.tip, jproof.proof.y)
    assert bytes(made[0]._state) == jstate

    _, plan = KM.plan_segments([q.z for q in queries], [0] * M_PROOF)
    assert KM.power_levels(plan) == 3 and (plan.seg_count > 1).all()
    vq = [VerifierQuery(q.commit, q.z, q.y) for q in queries]
    assert verify_multiproof(IPA, crs, vq, proof)
    vq[M_PROOF // 2].y = (vq[M_PROOF // 2].y + 1) % R
    assert not verify_multiproof(IPA, crs, vq, proof)


@pytest.mark.parametrize("m,levels", [(1, 1), (32, 1), (33, 2), (1024, 2), (1025, 3), (32768, 3), (32769, 4),
                                      (40000, 4), (1 << 20, 4), ((1 << 20) + 1, 5)])
def test_power_levels(m, levels):
    """Base-32 digits of the largest exponent, m - 1: the levels K1MP's
    power tables take at m queries."""
    _, plan = KM.plan_segments([0] * m, [0] * m)
    assert KM.power_levels(plan) == levels


def test_plain_segment_sum_in_pieces_matches_whole(monkeypatch):
    """The plain version's products in pieces of PLAIN_ELEMENTS elements
    (here 3 positions at N = 8, so pieces cut segments apart) give the
    words of one product over all positions."""
    rng = random.Random(7)
    n, m = 8, 101
    stack = torch.stack([_mont([rng.randrange(R) for _ in range(n)]) for _ in range(2)])
    zs, sel = [rng.randrange(5) for _ in range(m)], [rng.randrange(2) for _ in range(m)]
    r = _mont([rng.randrange(R)])[0]
    _, plan = KM.plan_segments(zs, sel)
    whole = KM.plain_segment_sum(stack, r, plan, 0)
    monkeypatch.setattr(KM, "PLAIN_ELEMENTS", 3 * n)
    assert torch.equal(KM.plain_segment_sum(stack, r, plan, 0), whole)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,points,levels,chunks", [(4096, 256, 3, 1), (32768, 256, 3, 2), (40000, 16, 4, 70)])
def test_segment_sum_kernel_matches_plain_on_card_large(cuda, m, points, levels, chunks):
    """Both K1MP modes at N = 256 against the plain version on the card's
    tensors: 3 levels of power tables with segments of some 16 queries (one
    chunk each) and of some 128 (several chunks each), and 4 levels with
    some 80 chunks a segment."""
    rng = random.Random(m + points)
    n = 256
    stack = torch.stack([_mont([rng.randrange(R) for _ in range(n)], cuda) for _ in range(3)])
    stack[1] = 0
    zs = [rng.randrange(points) for _ in range(m)]
    sel = [rng.randrange(3) for _ in range(m)]
    r = _mont([rng.randrange(R)], cuda)[0]
    distinct, plan = KM.plan_segments(zs, sel)
    assert KM.power_levels(plan) == levels and plan.seg_count.min() >= chunks
    cuda_lib.reset_launches()
    got = KM.segment_sum(stack, r, plan, 0)
    inv = _mont([rng.randrange(R) for _ in distinct], cuda)
    g = _mont([rng.randrange(R) for _ in range(n)], cuda)
    _, one = KM.plan_segments([0] * len(distinct), range(len(distinct)))
    h = KM.segment_sum(got, inv, one, 1, g=g)
    torch.cuda.synchronize()
    assert cuda_lib.launches["K1MP"] == 2
    want = KM.plain_segment_sum(stack, r, plan, 0)
    assert torch.equal(got, want)
    want_h = KM.plain_segment_sum(want, inv, one, 1, g=g)
    assert torch.equal(h[0], want_h[0]) and torch.equal(h[1], want_h[1])
