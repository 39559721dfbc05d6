"""work.py's counts: functions of the inputs' shapes and scalar bits, never
of the window, regime or launch shape that the program picks."""

import random

import pytest
import torch

from vkbench import work
from vkbench.probes import Probes


def _words(ks):
    return torch.tensor([[(k >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for k in ks],
                        dtype=torch.int64).to(torch.int32)


def test_scalar_word_steps_count_each_scalars_bits():
    rng = random.Random(1)
    ks = [0, 1, 2, 3, 2**200 + 1, work.R - 1] + [rng.randrange(work.R) for _ in range(50)]
    live, dbl, add = work.scalar_word_steps(_words(ks))
    steps = [work.scalar_steps(k) for k in ks]
    assert int(live) == sum(1 for k in ks if k)
    assert int(dbl) == sum(s[0] for s in steps)
    assert int(add) == sum(s[1] for s in steps)


def test_msm_count_is_the_best_window_and_grows_with_points():
    counts = [work.msm_fmuls(n) for n in (1, 64, 257, 4096, 2**20)]
    assert counts == sorted(counts) and counts[0] > 0
    assert work.msm_fmuls(0) == 0
    assert work.least_seconds(work.msm_fmuls(4096), work.msm_bytes(4096))[1] == "int_mul"


def test_g1_ntt_count_follows_the_twiddles():
    n = 16
    fwd, inv = work.g1_ntt_fmuls(n, False), work.g1_ntt_fmuls(n, True)
    # stage 0's twiddles are all 1: those butterflies cost their two adds only
    assert fwd >= (n // 2) * 4 * 2 * work.FMUL_ADD
    scale = n * work.scalar_mul_fmuls(*work.scalar_steps(pow(n, work.R - 2, work.R)))
    assert 0.8 * fwd < inv - scale < 1.2 * fwd


@pytest.mark.parametrize("c", [4, 8, 12])
def test_msm_yardstick_ignores_the_programs_window(c):
    """The least work read for msm_auto's calls is the same whatever window
    the program runs them at."""
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import msm as M
    from verkle_kzg_tpu_torch.schemes.generators import generator_multiples

    rng = random.Random(2)
    pts = C.host_points_to_affine(generator_multiples([rng.randrange(1, work.R) for _ in range(64)], "cpu"), "cpu")
    ks = [rng.randrange(work.R) for _ in range(63)] + [0]
    sc = F.ints_to_words(ks, "cpu")
    spec = {"module": "verkle_kzg_tpu_torch.ops.msm", "attr": "msm_auto", "tag": "msm", "events": True,
            "keep": lambda points, scalars, *a, **k: (scalars != 0).any(-1).sum()}
    with Probes([spec], cuda=False) as probes:
        M.msm_auto(pts, sc, c=c)
    (call,) = probes.by_tag("msm")
    assert int(call.kept) == 63
    assert work.msm_fmuls(int(call.kept)) == work.msm_fmuls(63)


def test_g1_yardstick_ignores_the_programs_regime(monkeypatch):
    """G1SMUL / G1BFLY change thread groups at cuda_g1_chain.SWITCH; the
    count of a transform does not read it."""
    from verkle_kzg_tpu_torch.ops import cuda_g1_chain as G

    before = work.g1_ntt_fmuls.__wrapped__(64, False)
    monkeypatch.setattr(G, "SWITCH", 1)
    assert work.g1_ntt_fmuls.__wrapped__(64, False) == before
