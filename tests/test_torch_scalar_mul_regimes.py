"""Kernel K5's two regimes (verkle_kzg_tpu_torch.ops.cuda_scalar_mul): the
many-lane regime's lane grouping (lanes by bit length, dead lanes last) and
its return to lane order, as plain torch, against the ungrouped plain
version and the JAX package's XLA scalar_mul coordinates; the schedule the
kernel runs on such groups (rounds from the group's top bit, the mixed add
on every round kept where the lane's bit is set), emulated on the plain
limb arithmetic; and, on a card, the kernel against its plain version at
phase 2's shapes, at 0 lanes and at the regime switch +- 1.

The card cases import no JAX (the card's machine has none):

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu tests/test_torch_scalar_mul_regimes.py
"""

import random

import numpy as np
import pytest
import torch

from verkle_kzg_tpu_torch import convert
from verkle_kzg_tpu_torch.hostmath import curve as hc
from verkle_kzg_tpu_torch.ops import cuda_lib
from verkle_kzg_tpu_torch.ops import cuda_scalar_mul as K5
from verkle_kzg_tpu_torch.ops import curve as C
from verkle_kzg_tpu_torch.ops import field as F
from verkle_kzg_tpu_torch.params import R

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lanes(n, seed):
    """Host points and scalars: zero scalars, (0, 0) sentinels (one with a
    zero scalar), and 1-, 2-, 128- and 254-bit scalars among random ones."""
    rng = random.Random(seed)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(100)) for _ in range(8)]
    pts = [base[i % 8] for i in range(n)]
    ks = [rng.randrange(R) for _ in range(n)]
    special = [0, 1, 3, (1 << 127) | rng.getrandbits(127), R - 1, 1 << 253, 0, rng.getrandbits(128), 2]
    ks[: len(special)] = special[:n]
    for i in (5, 6):
        if i < n:
            pts[i] = None
    return pts, ks


def _tensors(pts, ks, device="cpu"):
    return C.host_points_to_affine(pts, device), F.ints_to_words(ks, device)


@pytest.fixture(scope="module")
def lanes():
    pts, ks = _lanes(24, 81)
    pa, sc = _tensors(pts, ks)
    return pts, ks, pa, sc, K5.plain(pa, sc)


def test_bit_lengths_and_order(lanes):
    pts, ks, pa, sc, _ = lanes
    want = [0 if p is None else k.bit_length() for p, k in zip(pts, ks)]
    assert K5.bit_lengths(pa, sc).tolist() == want
    order = K5.lane_order(pa, sc).tolist()
    assert sorted(order) == list(range(len(ks)))
    lengths = [want[i] for i in order]
    assert lengths == sorted(want, reverse=True)
    dead = [i for i, w in enumerate(want) if w == 0]
    assert order[-len(dead):] == dead  # dead lanes last, in lane order


def test_grouped_lanes_return_to_lane_order(lanes):
    """The plain version over the lanes as the many-lane regime orders
    them, put back in lane order, is the ungrouped plain version."""
    _, _, pa, sc, want = lanes
    order = K5.lane_order(pa, sc)
    out = torch.empty_like(want)
    out[order] = K5.plain(pa[order], sc[order])
    assert torch.equal(out, want)


def test_plain_matches_jax_scalar_mul_coordinates(lanes):
    import jax.numpy as jnp

    from verkle_kzg_tpu.ops import curve as JC

    pts, ks, pa, sc, got = lanes
    planes = np.stack([convert.tensor_to_limb_planes(pa[:, k]) for k in range(2)])
    want = JC.scalar_mul(JC.from_affine(jnp.asarray(planes)), jnp.asarray(convert.tensor_to_limb_planes(sc)))
    want = np.asarray(want)
    port = torch.stack([convert.limb_planes_to_tensor(want[k], "cpu") for k in range(3)], dim=1)
    assert torch.equal(got, port)
    assert C.projective_to_host_points(got) == [None if p is None else hc.g1_mul(p, k) for p, k in zip(pts, ks)]


def test_lazy_double_of_identity_keeps_its_words():
    """What the kernel's skipped rounds rest on: the lazy doubling of the
    identity (0 : R : 0) gives the same words."""
    inf = C.infinity16((4,), "cpu")
    assert torch.equal(C.double16(inf, lazy=True), inf)


def _emulate_groups(pa, sc, per_warp):
    """The many-lane regime's schedule on the plain limb arithmetic: lanes in
    lane_order, ``per_warp`` of them a warp; a warp's rounds run from its
    top bit, with no doubling at the top; every round computes the mixed add
    and a lane keeps it where its bit is set; outputs back in lane order."""
    order = K5.lane_order(pa, sc)
    p, k = F.to_limbs(pa[order]), sc[order]
    n = p.shape[0]
    lengths = K5.bit_lengths(pa[order], k)
    warp_top = torch.zeros(n, dtype=torch.int64)
    for w in range(0, n, per_warp):
        warp_top[w : w + per_warp] = lengths[w : w + per_warp].max() - 1
    bits = C.scalar_bits_msb(k) != 0  # (256, n), MSB first
    bits &= lengths[None] > 0
    acc = C.infinity16((n,), "cpu")
    for r in range(255, -1, -1):
        bit = bits[255 - r]
        run = warp_top >= r
        if not bool(run.any()):
            continue
        dbl = run & (warp_top > r)
        acc = torch.where(dbl[:, None, None], C.double16(acc, lazy=True), acc)
        acc = torch.where((run & bit)[:, None, None], C.mixed_add16(acc, p, lazy=True), acc)
    out = torch.empty((n, 3, F.WORDS), dtype=torch.int32)
    out[order] = F.from_limbs(C.reduce16(acc))
    return out


# 4 and 32 threads a lane are the path's regimes; 8, a variant that
# tools/k5_regimes.py builds and times.
@pytest.mark.parametrize("group", [4, 8, 32])
def test_group_schedule_emulation_matches_plain(lanes, group):
    _, _, pa, sc, want = lanes
    assert torch.equal(_emulate_groups(pa, sc, 32 // group), want)


# K5 on the card: phase 2's shapes (2^12 edge lanes, the commit's 40,000
# lanes with 128-bit scalars on half, one 254-bit lane, 19, 32 and 51 lanes),
# 0 lanes and the switch +- 1; each in the regime the switch picks and in
# the other one (SWITCH set for the call).
CARD_LANES = [0, 1, 19, 32, 51, K5.SWITCH - 1, K5.SWITCH, K5.SWITCH + 1, 1 << 12, 40000]


@pytest.mark.gpu
@pytest.mark.parametrize("n", CARD_LANES)
def test_kernel_matches_plain_on_card(cuda, monkeypatch, n):
    rng = random.Random(n)
    pts, ks = _lanes(max(n, 9), 90 + n)
    pts, ks = pts[:n], ks[:n]
    if n == 40000:
        ks = [rng.getrandbits(128) if i % 2 == 0 else 0 for i in range(n)]
    if n == 1:
        ks = [R - 1]
    pa, sc = _tensors(pts, ks, cuda)
    K5.reset_regimes()
    cuda_lib.reset_launches()
    got = K5.scalar_mul_affine(pa, sc)
    torch.cuda.synchronize()
    assert cuda_lib.launches["K5"] == (1 if n else 0)
    regime = "few" if n <= K5.SWITCH else "many"
    assert K5.regime_launches[regime] == (1 if n else 0)
    want = K5.plain(pa, sc)
    assert torch.equal(got, want)
    monkeypatch.setattr(K5, "SWITCH", n - 1 if regime == "few" else n)
    assert torch.equal(K5.scalar_mul_affine(pa, sc), want)
    other = "many" if regime == "few" else "few"
    assert K5.regime_launches[other] == (1 if n else 0)
    if n:
        assert C.projective_to_host_points(got[:9]) == [
            None if p is None else hc.g1_mul(p, k) for p, k in zip(pts[:9], ks[:9])
        ]
