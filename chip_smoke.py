#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (verkle_kzg_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (the kernels are built from
verkle_kzg_tpu_torch/csrc/ into the git-ignored verkle_kzg_tpu_torch/_build/),
and no JAX. Phases, each of which raises on failure:

  1. the card's name and power limit, and the kernels' build (one nvcc per
     source, in parallel);
  2. each kernel (K1-K13, K1INV, K1IPA, K1QUO, K1MP, K1AFF, K1NTT, K2FOLD,
     G1SMUL, G1BFLY, FSX) against its plain PyTorch version on the card, at the shapes the
     main paths give it, exact, with its time and the least time the card
     could take for the same work; K1INV, K1IPA, K1QUO, K1MP and K2FOLD also
     against the K1 or K2 chain each replaces, timed in the same run (K1QUO
     and K1MP at phase 6's shape (the grouped pass, g, each row's quotient,
     h and h - g), the KZG prove's one row at index 17 and 1,024 queries at
     one point; K1MP's grouped pass also at 32,768 queries over 256 points
     (3 levels of power tables, several chunks a segment) and 40,000 over
     16 (4 levels), against its plain version only; K1INV with its dependent chain:
     products and the inverse's loop steps; K1IPA a round at 8, 256 and
     1,024 elements with and without b, x and w read from device memory,
     and <a, b> at 256; FSX, a Fiat-Shamir challenge, in each mode at
     message lengths across SHA-256's padding edges (0-200 bytes), with the
     identity and both signs of y among its points, against its plain
     version on CPU copies, hashlib and the host Transcript, and timed at a
     halving round's and w's shapes with its dependent chain in
     compressions and inversion steps; K2FOLD at 1 x 51,
     1 x 63 points and the sparse commits' 20,002 x 2 and 10,001 x 4; K1AFF
     at about the verkle commit's 30,000 points, a tenth at infinity, and at
     1, 2 and 256, its host points also against the host-int conversion it
     replaced, on the CPU copy; K1NTT at 256 and 512 both ways, the
     four-step's 16 segments of 16 and 2^14, above its shared-memory tile,
     against the K1 chain it replaced); K2, K11 and K12 at 1, 32, 256,
     4,096, 32,768 and 2^20 points and at their regime switch +- 1 (the
     identity, P + P and P + (-P) among the lanes, and K12's (0, 0)
     sentinels in warps with live lanes), each in the regime the wrapper
     picks and beside the one-thread kernel (K12 also beside its
     reduced-domain one-thread design of before, built from
     tools/point_probe.cu beside the library), with the kernel alone from
     the profiler, both bounds and the dependent chain in products; K5
     in both regimes, with ptxas's registers and spills for each: many
     lanes (2^12 edge lanes, the commit's 40,000) and few (1, 19, 32 and
     51 lanes), and at the regime switch +- 1 both regimes timed, each
     few-lane record with its dependent chain in point operations;
     G1SMUL and G1BFLY also against the K11 + K2 + select chain they
     replace and the one-thread design before their groups (built from
     tools/point_probe.cu), both timed in the same run, and in every group
     size, with the path's group's registers and spills, the kernel alone
     and the dependent chain in point operations;
     each K4 and K7 tail with its CUDA launches and dependent chain, and
     where its window sums take launches of their own, the sums and Horner
     timed apart; each call of the bucket-sorted accumulation (K3 at 257
     points, c = 8, at 2^16, c = 1 and 4, and at 2^12, c = 8, with all
     scalars equal; K9 at 2^12; K8, unsigned, at 2^16, c = 8, and 2^12,
     c = 16; from a digit tensor K10 at 2^12, c = 12 signed, and 2^16,
     c = 9 unsigned, K6 at 2^16, c = 5 unsigned, and over the width-256
     basis shared by 40 lanes at c = 5 and by 3 lanes of 64 at c = 1, with
     K7 on those lanes, and K13 over a lane stream of 2^12 points in 128
     lanes) with its CUDA launches as its C entry point counted them,
     live entries, chunk length and the times of its four stages (digits,
     sort, sums, combine) from CUDA events recorded between them in one
     call;
  3. IPA at domain 256 (commit, prove, verify, commitment proof) with its
     checks, launch counts (the prove, the device loop: 9 FSX, 10 K1IPA, 16
     K3, 16 K4, no K1) and timings; the device loop with no host sync
     between its one upload and its one read (set_sync_debug_mode("error"))
     and bit for bit equal to the host loop (proofs at index 17 and the
     point 512 with their transcript states, and the commitment proof);
     both loops timed by CUDA events, 5 calls each in turns, with their 16
     K4 tails; and a proof at domain 32 on the card against the CPU plain
     path;
  4. one MSM of 2^20 points through msm_auto, against an exact oracle, and
     its rate, with K3's four stages and K4 timed apart;
  5. the verkle tree at Ethereum geometry (BASELINE.json config 4: 32-unit
     keys, width-256 nodes, 10,000 leaves): insert, commit, prove 16
     present and 3 absent keys with one multiproof, verify statelessly;
     sampled commitments against the native C++ oracle, a 150-leaf tree on
     the card against the CPU plain path, a profile of the commit and a
     cProfile of another (the host's share, by function);
  6. the multiproof at domain 256 (BASELINE.json config 3) at 1,024 queries
     and at the reference harness's 4,096, 16,384 and 32,768, each proved
     and verified with its launches, a wrong y rejected, the grouped pass's
     plan and the transcript's host time recorded, each also against its
     twin made through the plain versions of K1MP and K1QUO;
  7. the single-MSM sweep of BASELINE.json config 5, 2^16-2^22 points, at
     c = 8, 4, 12 and 16 signed, and at 2^20 also unsigned c = 8 and 16 and
     signed c = 5, 10 and 13, each run exact against an oracle, with the
     digit recoding's time where c does not divide 16;
  8. KZG at domain 256 (BASELINE.json config 1): setup, commit against the
     native oracle, proofs in and out of the domain with their pairings;
     FK all-points proofs against the 256 single proofs; FK at domain 16
     on the card against the CPU path; and the 1,024-query multiproof over
     KZG (config 3, the KZG half); the in-domain prove, the 256 single
     proves and the multiproof against twins made through the plain
     versions of K1QUO and K1MP; then, off that path, one G1 scalar
     multiplication and the Fr and G1 NTT round trips with their launches,
     and one G1 NTT with each stage timed by CUDA events;
  9. benchmarks/tune_group.py's default grid on the port: the signed
     single MSM of 2^20 points in 128 lanes through the lane-stream entry
     point msm_stream.msm_single_fused with wgroup/fused (K13, the sorted
     accumulation, and K4), against the c = 8 msm_pippenger (K3), each run
     exact, with K13 alone and its stages; then every other entry point
     of msm_stream once at 2^12 points against the native oracle, with
     their launches (K3, K4, K6, K7, K8 and K10 among them);
 10. the parallel package (verkle_kzg_tpu_torch.parallel) at world size 1
     over NCCL, with a file store in a temporary directory: msm_sharded on
     phase 4's points, the batch-sharded MSMs at the dense commit's shape
     (width 256, 40 lanes), the Fr and G1 four-step NTTs and their inverses
     at 256 and 512, FK at 256, phase 5's tree and phase 6's multiproof,
     each with mesh=, against its unsharded twin and the earlier phase's
     result, and timed beside its twin (what the mesh costs at d = 1);
 11. config 4 over KZG as benchmarks/bench_all.py builds it: kzg_setup(256)
     on the card, 10,000 leaves at key_len 3 (the harness's default) and 32
     (the Ethereum geometry), each tree committed, 16 present and 3 absent
     keys proved with one KZG multiproof and verified (the shares of the
     host's verify_point and of its pairing timed apart), sampled commitments against the native C++ oracle
     over the Lagrange SRS, at key_len 3 a 150-leaf tree on the card against
     the CPU path;
 12. the re-commit's branches: a seeded set of writes that reaches each
     branch of an insert into a committed tree (1,000 updates, 100 new
     units in present extensions, 100 new stems splitting an extension, 50
     new root children; a coverage mix, not a measured block of a public
     chain) into phase 5's committed tree and phase 11's key_len-32 one,
     each committed again:
     only the nodes on the written paths (the dirty counters), every node
     equal to a tree built from scratch with the final contents, sampled
     re-committed nodes against the native oracle, a proof of 16 written
     and 3 absent keys verified.

Each of phases 2, 3, 5, 8, 10 and 12, each size of phase 6, each tree of
phase 11, and each run of phases 7 and 9, sets the launch counts to 0 just
before its path and reads them just after; phases
5, 6 and 8 print K1's, K1INV's, K1IPA's, K1QUO's, K1MP's and FSX's launches
stage by stage and assert those of the proves exactly (a multiproof: 2
K1MP, 1 K1QUO, 2 K1 for the commits, no K1INV over the IPA; over KZG, as
in phases 8 and 11, also 4 K1 and 1 K1INV for the prove at t),
phases 5 and 6 assert that no K2 ran (K2FOLD sums the folds), and phases 5
and 6 the launches of each K5 regime and the lanes of each K5 call;
phases 5, 8 and 10 assert one K1AFF launch a conversion of card points to
host points, and 8 and 10 one K1NTT a Fr transform or sub-NTT pass (FK:
one K1, for y's standard form). The
IPA proves of phases 3, 5, 6 and 10 run the device loop (FSX). The last
two lines of standard output are the card's name and power limit and a JSON
object {"ok": true, "device": {...}}; the line before them holds the
per-kernel JSON record.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import pathlib
import random
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
POINTS_CACHE = REPO / ".msm_points_20.npz"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    from CUDA events on the current stream."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds of kernel time on the card per call over ``reps``
    calls after one warm-up, from a torch.profiler trace (the union of the
    calls' kernel intervals): what the kernel takes when the host's cost
    of a call, which back-to-back CUDA-event timing includes, is set apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return _device_busy_ms(prof)[0] / reps


def max_abs_err(a, b) -> int:
    import torch

    assert a.shape == b.shape, (a.shape, b.shape)
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


# The least time one H100 SXM could take for a kernel's work: the larger of
# the bytes it must move (each input read once, each output written once)
# over the HBM rate, and its 32-bit integer multiplies over the SMs' integer
# rate (64 INT32 lanes per SM per clock, the Hopper white paper's unit count,
# at the 1,980 MHz boost clock; no published peak exists for this type).
HBM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_S = 132 * 64 * 1.98e9
# 32-bit multiplies in one 8-word CIOS Montgomery product: 8 rounds of
# 8 wide a*b products (low and high halves), one q = t0 * n0, 8 wide q*m.
FMUL_MULS = 8 * (2 * 8 + 1 + 2 * 8)
ADD_FMULS, MIXED_FMULS, DOUBLE_FMULS = 12, 11, 8  # RCB16 algorithms 7, 8, 9


def bound(nbytes: float, fmuls: float) -> dict:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = fmuls * FMUL_MULS / INT32_MULS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def phase_kernels(dev, crs, probe=None) -> dict:
    """K1-K13 against their plain versions on the card, exact; ``probe``
    the built ``tools/point_probe.cu`` (K12's one-thread design before its
    lazy regimes), built here when not given."""
    import torch

    from verkle_kzg_tpu_torch.tools import point_regimes as PR

    from verkle_kzg_tpu_torch.hostmath import curve as hc
    from verkle_kzg_tpu_torch.params import FQ, FR, R
    from verkle_kzg_tpu_torch.ops import cuda_curve, cuda_field
    from verkle_kzg_tpu_torch.ops import cuda_msm as K
    from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import msm as M

    rng = random.Random(1)
    rec = {}

    # K1: 2^16 Fr and Fq elements with edge values, mul / add / sub.
    errs = []
    for spec, fs in (("fr", FR), ("fq", FQ)):
        m = fs.modulus
        xs = [0, 1, m - 1, fs.r_mod] + [rng.randrange(m) for _ in range((1 << 16) - 4)]
        a = F.ints_to_words(xs, dev)
        b = F.ints_to_words(xs[::-1], dev)
        for op in ("mul", "add", "sub"):
            plain_out, plain_ms = timed_once(lambda: cuda_field.plain(op, a, b, spec))
            errs.append(max_abs_err(cuda_field.binop(op, a, b, spec), plain_out))
            assert errs[-1] == 0, (spec, op)
            if (spec, op) == ("fq", "mul"):
                k1_plain_ms = plain_ms
    rec["K1"] = {
        "max_abs_err": max(errs),
        "ms": cuda_ms(lambda: cuda_field.binop("mul", a, b, "fq"), 50),
        "plain_ms": k1_plain_ms,
        "shape": "2^16 Fq mont_mul",
        **bound(a.numel() * 4 * 3, a.shape[0]),
    }

    rec.update(_kernels_k1inv(dev, random.Random(2)))  # its own seed: the other shapes' draws stay as they were

    # K2: the IPA MSM's first segment fold, 32 x 8 x 128 point pairs, with
    # infinity, P + P and P + (-P) among them; pz, their sums (Z is not 1;
    # the identity at slot 3), feeds K11, K12 and the records below.
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(128)) for _ in range(64)]
    n2 = 32 * 8 * 128
    ps = [base[i % 64] for i in range(n2)]
    qs = [base[(7 * i + 3) % 64] for i in range(n2)]
    ps[0], qs[1], ps[2], qs[2], qs[3] = None, None, base[5], base[5], hc.g1_neg(ps[3])
    p = C.from_affine(C.host_points_to_affine(ps, dev))
    q = C.from_affine(C.host_points_to_affine(qs, dev))
    pz = cuda_curve.add(p, q)
    assert C.projective_to_host_points(pz[:4]) == [hc.g1_add(a_, b_) for a_, b_ in zip(ps[:4], qs[:4])]
    sums = C.projective_to_host_points(pz[:6])
    assert C.projective_to_host_points(cuda_curve.double(pz)[:6]) == [hc.g1_add(a_, a_) for a_ in sums]
    # K12 at K2's shape: the affine qs added to the K2 sums (the (0, 0)
    # sentinel at slot 1, identity + (-P) at slot 3).
    qa = C.host_points_to_affine(qs, dev)
    got = cuda_curve.mixed_add(pz, qa)
    assert C.projective_to_host_points(got[:6]) == [hc.g1_add(a_, b_) for a_, b_ in zip(sums, qs[:6])]
    probe = probe or PR.Probe(PR.probe_build())
    rec.update(_kernels_group_law(dev, p, q, pz, qa, probe))

    # K3 + K4: the 257-point IPA basis shape and 2^12 points, with zero
    # scalars, r - 1 and a (0, 0) point.
    k3_err = k4_err = 0
    for n in (257, 1 << 12):
        pts = [base[i % 64] for i in range(n)]
        pts[1] = None
        ks = [rng.randrange(R) for _ in range(n)]
        ks[0], ks[2], ks[3] = 0, R - 1, 0
        pa, sc = C.host_points_to_affine(pts, dev), F.ints_to_words(ks, dev)
        table = KS.accumulate(pa, sc, 8)
        plain_table, plain_ms = timed_once(lambda: KS.plain_accumulate(pa, sc, 8))
        k3_err = max(k3_err, max_abs_err(table, plain_table))
        buckets = table[:, 0].contiguous()
        out = K.tail(buckets)
        plain_out, plain_tail_ms = timed_once(lambda: K.plain_tail(buckets))
        k4_err = max(k4_err, max_abs_err(out, plain_out))
        assert k3_err == 0 and k4_err == 0, n
        assert C.projective_to_host_points(out) == C.projective_to_host_points(plain_out)
        if n == 257:
            want = hc.g1_msm_naive(pts, ks)
            assert C.projective_to_host_points(M.msm_auto(pa, sc)) == [want]
            rec["K3"] = {**_sorted_record(pa, sc, 8, table, plain_ms, 20), "shape": "257 points, c = 8"}
            rec["K4"] = {**_tail_record("K4", buckets, 8, (plain_out, plain_tail_ms), 20),
                         "shape": "32 x 128 buckets"}
            rec["msm257"] = {
                "ms": cuda_ms(lambda: M.msm_auto(pa, sc), 20),
                "plain_k3_k4_ms": rec["K3"]["plain_ms"] + rec["K4"]["plain_ms"],
            }
    rec["K3"]["max_abs_err"] = k3_err
    rec["K4"]["max_abs_err"] = max(k4_err, rec["K4"]["max_abs_err"])
    rec.update(_kernels_k5_k7(dev, crs, rng))
    rec.update(_kernels_windows(dev, base, rng))
    rec.update(_kernels_k13(dev, base, rng))
    rec.update(_kernels_g1_chain(dev, pz, rng, probe))
    rec.update(_kernels_k1ipa(dev, random.Random(12)))  # own seeds: the draws above stay as they were
    rec.update(_kernels_k2fold(dev, pz, random.Random(13)))
    rec.update(_kernels_fsx(dev, random.Random(14)))
    rec.update(_kernels_k1quo_k1mp(dev, random.Random(15)))
    rec.update(_kernels_k1aff(dev, crs, random.Random(16)))
    rec.update(_kernels_k1ntt(dev, random.Random(17)))
    rec.update(_kernels_fbmsm(dev, crs, random.Random(18)))
    return rec


# K2's, K11's and K12's shapes in phase 2: one point, a warp's, one G1 NTT
# stage at domain 256, 4,096, the IPA MSM's fold (32,768, the "K2" / "K11"
# / "K12" records) and 2^20; with the regime switch +- 1 beside them.
GROUP_LAW_POINTS = (1, 32, 256, 4096, 32768, 1 << 20)
#: Points of the strided slice held against the plain version above it.
PLAIN_SLICE = 1 << 15
# Montgomery products a level of each operation's group schedule, and on
# one thread.
GROUP_LAW_LEVELS = {"K2": (6, 6), "K11": (4, 4), "K12": (5, 6)}
GROUP_LAW_FMULS = {"K2": ADD_FMULS, "K11": DOUBLE_FMULS, "K12": MIXED_FMULS}


def _k2_k11_pairs(pz, n: int) -> tuple:
    """(p, q), n points each from the K2 sums ``pz`` (Z != 1), repeated
    past their count, q rolled by 7; lane 0 the identity + q, lane 1 p + the
    identity, lane 2 P + P, lane 3 P + (-P), where n reaches them."""
    import torch

    from verkle_kzg_tpu_torch.ops import curve as C

    reps = -(-n // pz.shape[0])
    src = pz.roll(-4, 0)  # pz[3] is the identity
    p = src.repeat(reps, 1, 1)[:n].clone()
    q = src.roll(7, 0).repeat(reps, 1, 1)[:n].clone()
    inf = C.infinity((), pz.device)
    p[0] = inf
    if n > 1:
        q[1] = inf
    if n > 3:
        q[2] = p[2]
        q[3] = C.neg(p[3])
    return p.contiguous(), q.contiguous()


def _k12_pairs(pz, qa, n: int) -> tuple:
    """(p, q): p as :func:`_k2_k11_pairs` makes it (lane 0 the identity), q
    n affine points of ``qa`` repeated past their count, with the (0, 0)
    sentinel at lane 1 and every 37 lanes from lane 9 (in warps whose other
    groups are live), P + P at lane 2 and P + (-P) at lane 3, where n
    reaches them."""
    from verkle_kzg_tpu_torch.hostmath import curve as hc
    from verkle_kzg_tpu_torch.ops import curve as C

    p = _k2_k11_pairs(pz, n)[0]
    q = qa.roll(-5, 0).repeat(-(-n // qa.shape[0]), 1, 1)[:n].clone()
    q[1:2] = 0
    q[9::37] = 0
    if n > 3:
        h2, h3 = C.projective_to_host_points(p[2:4])
        q[2:4] = C.host_points_to_affine([h2, hc.g1_neg(h3)], p.device)
    return p, q.contiguous()


def point_chain(key: str, group: int) -> int:
    """Montgomery products on one point's dependent chain: each level's
    independent products on separate threads of a group (two passes a
    level on 4 threads), all of them on one thread."""
    if group == 1:
        return GROUP_LAW_FMULS[key]
    return sum(-(-k // group) for k in GROUP_LAW_LEVELS[key])


def _kernels_group_law(dev, p, q, pz, qa, probe, points=GROUP_LAW_POINTS) -> dict:
    """K2, K11 and K12 at ``points`` and at the regime switch +- 1, in the
    regime the wrapper picks, exact against their plain versions (above
    PLAIN_SLICE points a strided slice of that many) and against the
    one-thread kernel on the whole output (K12 also against its one-thread
    design before its lazy regimes, ``probe``'s reduced variant). K2 at
    32,768 adds (p, q) (the host edge lanes), K11 doubles pz, K12 adds the
    affine ``qa`` to pz; the other shapes come from pz (and qa) with the
    edge lanes of ``_k2_k11_pairs`` / ``_k12_pairs``. Each record: the
    regime and its group, the ms a call by CUDA events, the kernel alone
    (profiler), the one-thread kernel's both (K12: also the old design's
    both), the bound by bytes and by operations (K12: live lanes, those
    whose q is not the sentinel), and the dependent chain in products."""
    import torch

    from verkle_kzg_tpu_torch.ops import cuda_curve as KC
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.tools import point_regimes as PR

    entries = {"K2": ("vkzg_point_add", KC.add, KC.plain, "adds"),
               "K11": ("vkzg_point_double", KC.double, lambda x: KC.plain_double(x), "doublings"),
               "K12": ("vkzg_point_mixed_add", KC.mixed_add, KC.plain_mixed_add, "mixed adds")}
    rec = {}
    for n in PR.with_switch(points):
        for key, (fn, wrapper, plain_fn, what) in entries.items():
            if key == "K2":
                ins = (p, q) if n == p.shape[0] else _k2_k11_pairs(pz, n)
            elif key == "K11":
                ins = (pz if n == pz.shape[0] else _k2_k11_pairs(pz, n)[0],)
            else:
                ins = (pz, qa) if n == pz.shape[0] else _k12_pairs(pz, qa, n)
            a = ins[0]
            run = lambda ins=ins, wrapper=wrapper: wrapper(*ins)  # noqa: E731
            mode = KC.regime(n)
            KC.reset_regimes()
            out = run()
            assert KC.regime_launches[key][mode] == 1, (key, n, KC.regime_launches)
            one = lambda a=a, ins=ins, fn=fn, key=key: KC._launch(fn, key, torch.empty_like(a), *ins, group=1)  # noqa: E731
            idx = torch.arange(0, n, max(1, n // PLAIN_SLICE), device=a.device)
            plain_out, plain_ms = timed_once(lambda: plain_fn(*(t[idx] for t in ins)))
            err = max(max_abs_err(out[idx], plain_out), max_abs_err(out, one()))
            group = KC.GROUP[mode]
            live = n if key != "K12" else int((~C.affine_is_infinity(ins[1])).sum())
            nbytes, fmuls = 4 * (sum(t.numel() for t in ins) + a.numel()), live * GROUP_LAW_FMULS[key]
            name = key if n == 32768 else f"{key}@{n}"
            (kernel, seen), (one_kernel, one_seen) = PR.kernel_ms(run), PR.kernel_ms(one)
            r = rec[name] = {
                "max_abs_err": err,
                "ms": cuda_ms(run, 20),
                "kernel_ms": kernel,
                "one_thread_ms": cuda_ms(one, 20),
                "one_thread_kernel_ms": one_kernel,
                "kernel_records": [seen, one_seen],
                "plain_ms": plain_ms,
                "plain_points": len(idx),
                "library_ms": None,
                "regime": mode,
                "group": group,
                "chain_products": point_chain(key, group),
                "one_thread_chain_products": point_chain(key, 1),
                "bound_bytes_ms": bound(nbytes, 0)["bound_ms"],
                "bound_ops_ms": bound(0, fmuls)["bound_ms"],
                "shape": f"{n} point {what}",
                **bound(nbytes, fmuls),
            }
            if key == "K12":
                old_design = lambda ins=ins: probe("mixed", 0, 1, 1, *ins)  # noqa: E731
                r["max_abs_err"] = err = max(err, max_abs_err(out, old_design()))
                old_kernel, old_seen = PR.kernel_ms(old_design)
                r["kernel_records"].append(old_seen)
                r.update({"live_lanes": live, "old_design_ms": cuda_ms(old_design, 20),
                          "old_design_kernel_ms": old_kernel,
                          "ptxas": ptxas_of(f"point_group_kernelILi2ELi{group}E" if group > 1
                                            else "point_mixed_add_kernel")})
            assert err == 0, (key, n)
            print("phase 2 group law:", name, json.dumps(r), flush=True)
    return rec


# The inverse's dependent chain (``csrc/field_inv.cuh``), the same for every
# input: 18 outer iterations of 31 binary GCD steps on 64-bit registers, each
# iteration ending in one update of the 256-bit values and their cofactors.
INVERSE_STEPS = 18 * 31


def _k1_chain(fn, *args):
    """``fn`` (one of K1INV's plain versions) with each of its products a K1
    launch: the chain that K1INV replaced, the same-run yardstick."""
    from verkle_kzg_tpu_torch.ops import cuda_field

    plain = cuda_field.plain
    cuda_field.plain = cuda_field.binop
    try:
        return fn(*args)
    finally:
        cuda_field.plain = plain


K1INV_CASES = (  # record, field, rows, elements a row
    ("K1INV", "fr", 19, 256),  # invdiff_rows: a row an opening point, a zero a row
    ("K1INV@1x256", "fr", 1, 256),  # the out-of-domain quotient's (w^i - z)
    ("K1INV@4096x1", "fq", 4096, 1),  # inv_mont, as curve.to_affine takes Z
)


def _kernels_k1inv(dev, rng) -> dict:
    """K1INV against its plain version and against the K1 chain it
    replaced, exact, at K1INV_CASES; every row holds 0, 1 and m - 1. Each
    record: ms, the plain version's and the chain's ms and K1 launches,
    the bound (the bytes, and Montgomery's trick's 3 (N - 1) products a
    row), and the dependent chain: products and the inverse's loop steps."""
    from verkle_kzg_tpu_torch.ops import cuda_field, cuda_lib
    from verkle_kzg_tpu_torch.ops import field as F

    rec = {}
    for name, spec, rows, n in K1INV_CASES:
        m = F.SPECS[spec].modulus
        vals = [rng.randrange(m) for _ in range(rows * n)]
        for r in range(rows):
            for j, v in enumerate((0, 1, m - 1)):
                vals[r * n + (r + 7 * j) % n] = v
        batch = n > 1
        a = F.ints_to_mont(vals, spec, dev)
        a = a.reshape(rows, n, F.WORDS) if batch else a
        plain_fn = cuda_field.plain_batch_inv if batch else cuda_field.plain_inv
        run = lambda: cuda_field.inverse(a, spec, batch)  # noqa: E731
        out = run()
        plain_out, plain_ms = timed_once(lambda: plain_fn(a, spec))
        before = cuda_lib.launches["K1"]
        chain_out, _ = timed_once(lambda: _k1_chain(plain_fn, a, spec))
        chain_launches = cuda_lib.launches["K1"] - before
        err = max(max_abs_err(out, plain_out), max_abs_err(out, chain_out))
        assert err == 0, name
        assert F.mont_to_ints(out, spec) == [pow(v, -1, m) if v else 0 for v in vals], name
        if batch:
            threads = min(256, max(32, 1 << (n - 1).bit_length()))
            run_len = -(-n // threads)
            products = 3 * (run_len - 1) + 2 * (threads.bit_length() - 1) + 3
        else:
            products = 1
        rec[name] = {
            "max_abs_err": err,
            "ms": cuda_ms(run, 20),
            "plain_ms": plain_ms,
            "chain_ms": cuda_ms(lambda: _k1_chain(plain_fn, a, spec), 2),
            "chain_k1_launches": chain_launches,
            "library_ms": None,
            "shape": f"{rows} x {n} {spec}" + ("" if batch else " (inv_mont)"),
            "chain_products": products,
            "inverse_steps": INVERSE_STEPS,
            **bound(2 * a.numel() * 4, rows * 3 * (n - 1)),
        }
        print("phase 2 k1inv:", name, json.dumps(rec[name]), flush=True)
    return rec


K1IPA_CASES = ((256, True), (256, False), (8, True), (8, False), (1024, True), (1024, False))  # n, with b


def ipa_round_work(n: int, half: int, ln: int, with_b: bool) -> tuple:
    """(bytes, products) one K1IPA round needs: each input read once, each
    output written once; the fold's products (a and b at ``half`` slots, the
    weights at n / 2 when the round goes on), and with ``ln`` the n gammas,
    the n + 1 scalars' standard form and, with b, the 2 (ln / 2) inner
    products and their two products by w."""
    vectors = 1 + with_b
    fmuls = half * vectors + (n // 2 if half and ln else 0)
    nbytes = 32 * n * (2 * vectors + (2 if ln else 0))
    if ln:
        fmuls += 2 * n + ((ln // 2) * 2 + 4 if with_b else 0)
        nbytes += 32 * 2 * (n + with_b)
    return nbytes, fmuls


def _words_err(outs, refs) -> int:
    """max_abs_err over the tensors of two output tuples (None beside None)."""
    assert [o is None for o in outs] == [r is None for r in refs]
    return max(max_abs_err(o, r) for o, r in zip(outs, refs) if o is not None)


def _kernels_k1ipa(dev, rng) -> dict:
    """K1IPA against its plain version and against the K1 chain it replaced
    (the plain version with each product and add a K1 launch), exact: a
    round with a fold at n / 2 and scalars for a round of n / 2 at each of
    K1IPA_CASES, from random a, b, wts, x and w with 0 and r - 1 in each
    vector, x and w read from device memory as in the device loop, and the
    first round and final fold at the same n (exact, not timed); then the
    inner product at 256. Each record: ms, the plain
    version's and the chain's ms and K1 launches, the kernel's own time
    (``device_ms``), K1IPA launches a call, the bound (bytes and products
    of :func:`ipa_round_work`)."""
    from verkle_kzg_tpu_torch.ops import cuda_ipa as KI
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.params import R

    def vec(n):
        vals = [rng.randrange(R) for _ in range(n)]
        vals[rng.randrange(n)], vals[rng.randrange(n)] = 0, R - 1
        return F.ints_to_mont(vals, "fr", dev)

    def record(name, fn, plain_fn, args, shape, work):
        before = dict(cuda_lib.launches)
        out = fn(*args)
        launched = cuda_lib.launches["K1IPA"] - before["K1IPA"]
        plain_out, plain_ms = timed_once(lambda: plain_fn(*args))
        before = cuda_lib.launches["K1"]
        chain_out, _ = timed_once(lambda: _k1_chain(plain_fn, *args))
        chain_launches = cuda_lib.launches["K1"] - before
        pair = (out, plain_out, chain_out) if isinstance(out, tuple) else ((out,), (plain_out,), (chain_out,))
        err = max(_words_err(pair[0], pair[1]), _words_err(pair[0], pair[2]))
        assert err == 0 and launched == 1, (name, err, launched)
        return {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: fn(*args), 50),
            "device_ms": device_ms(lambda: fn(*args), 20),
            "plain_ms": plain_ms,
            "chain_ms": cuda_ms(lambda: _k1_chain(plain_fn, *args), 3),
            "chain_k1_launches": chain_launches,
            "launches_per_call": launched,
            "library_ms": None,
            "shape": shape,
            "products": work[1],
            **bound(*work),
        }

    rec = {}
    for n, with_b in K1IPA_CASES:
        a, b, wts = vec(n), (vec(n) if with_b else None), vec(n)
        # x and w as the device loop passes them: Montgomery words on the card
        x, w = (KI.as_mont(rng.randrange(R), dev) for _ in range(2))
        half = ln = n // 2
        name = "K1IPA" if (n, with_b) == (256, True) else f"K1IPA@{n}" + ("" if with_b else "-nob")
        rec[name] = record(name, KI.halving_round, KI.plain_round, (a, b, wts, x, w, half, ln),
                           f"n = {n}, fold at {half}, round of {ln}" + (", with b" if with_b else ", no b"),
                           ipa_round_work(n, half, ln, with_b))
        for stage in ((a, b, None, None, w, 0, n), (a, None, None, x, None, 1, 0)):  # first round, final fold
            err = _words_err(KI.halving_round(*stage), KI.plain_round(*stage))
            assert err == 0, (name, stage[-2:])
        print("phase 2 k1ipa:", name, json.dumps(rec[name]), flush=True)
    a, b = vec(256), vec(256)
    rec["K1IPA@inner256"] = record("K1IPA@inner256", KI.inner, KI.plain_inner, (a, b), "<a, b> at n = 256",
                                   (2 * 256 * 32 + 32, 256))
    print("phase 2 k1ipa:", "K1IPA@inner256", json.dumps(rec["K1IPA@inner256"]), flush=True)
    return rec


def phase6_points(m: int = 1024, n: int = 256) -> list:
    """The opening points of phase 6's queries, as ``_multiproof_queries``
    draws them."""
    rng = random.Random(1024)
    return [rng.randrange(n) for _ in range(m)]


def _chain_group(stack, sel, r, zs):
    """The grouped pass as it ran before K1MP, on K1 (each op a launch):
    r's powers, the scaling, a device sort by z, the segmented scan of adds,
    a ``bincount``. Returns the grouped rows and the scaled queries."""
    import torch

    from verkle_kzg_tpu_torch.ops import field as F

    dev = stack.device
    scaled = F.mont_mul(stack[torch.tensor(sel, device=dev)], F.powers_of_mont(r, len(zs), "fr")[:, None], "fr")
    distinct = sorted(set(zs))
    rank = {z: i for i, z in enumerate(distinct)}
    seg, order = torch.sort(torch.tensor([rank[z] for z in zs], device=dev), stable=True)
    x = scaled[order]
    k = 1
    while k < x.shape[0]:
        same = (seg[k:] == seg[:-k])[:, None, None]
        x = torch.cat([x[:k], torch.where(same, F.add(x[k:], x[:-k], "fr"), x[k:])])
        k *= 2
    return x[torch.cumsum(torch.bincount(seg, minlength=len(distinct)), 0) - 1], scaled


def _chain_h(scaled, inv_q, g):
    """h and h - g as they ran before K1MP: a product a query and an add tree."""
    from verkle_kzg_tpu_torch.ops import field as F

    h = F.sum_axis(F.mont_mul(scaled, inv_q[:, None], "fr"), 0, "fr")[0]
    return h, F.sub(h, g, "fr")


def _chain_quotient(vals, zs, domain, sum_rows):
    """The in-domain quotient as it ran before K1QUO: the ratio product,
    ``Domain.invdiff_rows`` (a sub and a K1INV launch), the per-row chain
    and, summed, the add tree over the rows."""
    import torch

    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.poly.lagrange import _quotient_in_domain

    dev = vals.device
    z = torch.tensor(zs, device=dev)
    ratio = F.mont_mul(domain.d_vanishing(dev)[z][:, None], domain.d_vanishing_inv(dev)[None], "fr")
    q = _k1_chain(_quotient_in_domain, vals, domain.invdiff_rows(z), ratio, z)
    return F.sum_axis(q, 0, "fr")[0] if sum_rows else q


@contextlib.contextmanager
def plain_passes():
    """A context in which ``prove_multiproof`` and the in-domain quotient
    run the plain versions of K1MP and K1QUO (on the card's tensors, K1's
    plain arithmetic), for a twin of a proof made through the kernels."""
    import torch

    from verkle_kzg_tpu_torch.ops import cuda_multiproof as KM
    from verkle_kzg_tpu_torch.poly import lagrange as LG

    seg, quo = KM.segment_sum, KM.quotient
    KM.segment_sum = KM.plain_segment_sum
    KM.quotient = lambda vals, zs, omegas, table, sum_rows: LG._quotient_in_domain_table(
        vals, torch.tensor(list(zs), device=vals.device), omegas, table, sum_rows)
    try:
        yield
    finally:
        KM.segment_sum, KM.quotient = seg, quo


def multiproof_digest(mp) -> str:
    """SHA-256 of a multiproof's D and its final proof's fields, as JSON."""
    import dataclasses

    return hashlib.sha256(json.dumps([mp.d, dataclasses.asdict(mp.proof)]).encode()).hexdigest()


def _kernels_k1quo_k1mp(dev, rng) -> dict:
    """K1QUO and K1MP against their plain versions (on the card's tensors)
    and against the K1 chains they replaced (the passes as they ran before,
    each op a K1 launch, ``invdiff_rows`` a K1INV), exact, at phase 6's
    shape (1,024 queries of one vector at its points, N = 256: the grouped
    pass, g summed over the distinct points, each row's quotient, h and
    h - g), the KZG prove's (one row at index 17) and a skewed one (1,024
    queries at one point: the grouped pass, g of one row, h). Each record:
    ms, the kernel's own time (``kernel_ms``: the profiler's records of
    that kernel over 10 calls, divided by the records it kept, which
    ``kernel_records`` counts), the plain version's and the
    chain's ms and K1 / K1INV launches, launches a call, the bound (each
    input read once, each output written once; the products the function
    needs: 3 an element of a quotient, a product a query and column and
    a power a query for the grouped pass, a product a point and column
    for h)."""
    import torch

    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import cuda_multiproof as KM
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.poly import Domain
    from verkle_kzg_tpu_torch.poly.lagrange import _quotient_in_domain_table, quotient_in_domain
    from verkle_kzg_tpu_torch.tools import point_regimes as PR

    n = 256
    dom = Domain(n)
    omegas, table = dom.d_omegas(dev), dom.d_invdiff_table(dev)

    def vec():
        vals = [rng.randrange(R) for _ in range(n)]
        vals[rng.randrange(n)], vals[rng.randrange(n)] = 0, R - 1
        return F.ints_to_mont(vals, "fr", dev)

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    def record(kind, name, fn, plain_fn, chain_fn, shape, nbytes, products):
        before = dict(cuda_lib.launches)
        out = fn()
        launched = cuda_lib.launches[kind] - before[kind]
        plain_out, plain_ms = timed_once(plain_fn)
        err = _words_err(as_tuple(out), as_tuple(plain_out))
        chain = dict.fromkeys(("K1", "K1INV", kind))
        if chain_fn is not None:  # the shapes of before K1MP: also the chain it replaced
            before = dict(cuda_lib.launches)
            chain_out, _ = timed_once(chain_fn)
            chain = {k: cuda_lib.launches[k] - before[k] for k in chain}
            err = max(err, _words_err(as_tuple(out), as_tuple(chain_out)))
        assert err == 0 and launched == 1 and not chain[kind], (name, err, launched, chain)
        kernel, records = PR.kernel_ms(fn, 10, 1, KERNEL_NAMES[kind])
        rec = {
            "max_abs_err": err,
            "ms": cuda_ms(fn, 20),
            "kernel_ms": kernel,
            "kernel_records": records,
            "plain_ms": plain_ms,
            "chain_ms": None if chain_fn is None else cuda_ms(chain_fn, 3),
            "chain_k1_launches": chain["K1"],
            "chain_k1inv_launches": chain["K1INV"],
            "launches_per_call": launched,
            "library_ms": None,
            "shape": shape,
            "products": products,
            **bound(nbytes, products),
        }
        print(f"phase 2 {kind.lower()}:", name, json.dumps(rec), flush=True)
        return rec

    def h_pair(out):  # (h as (1, N, 8), h - g) -> (h, h - g), the chain's shapes
        return out[0][0], out[1]

    rec = {}
    r = F.ints_to_mont([rng.randrange(R)], "fr", dev)[0]
    for tag, zs in (("", phase6_points(1024, n)), ("@skew", [rng.randrange(n)] * 1024)):
        m = len(zs)
        stack = vec()[None].contiguous()
        sel = [0] * m
        distinct, plan = KM.plan_segments(zs, sel)
        zq = len(distinct)
        grouped = KM.segment_sum(stack, r, plan, 0)
        plan_bytes = 4 * plan.packed().size
        rec["K1MP" + tag] = record(
            "K1MP", "K1MP" + tag, lambda: KM.segment_sum(stack, r, plan, 0),
            lambda: KM.plain_segment_sum(stack, r, plan, 0),
            lambda: _chain_group(stack, sel, r, zs)[0],
            f"grouped pass: {m} queries of one vector at {zq} points, N = {n}, {plan.chunk_seg.size} chunks",
            stack.numel() * 4 + 32 + plan_bytes + zq * n * 32, m * n + m)
        # g: the quotients of the grouped rows, summed; and each row's
        rec["K1QUO" + tag] = record(
            "K1QUO", "K1QUO" + tag, lambda: quotient_in_domain(grouped, distinct, dom, True),
            lambda: _quotient_in_domain_table(grouped, torch.tensor(distinct, device=dev), omegas, table, True),
            lambda: _chain_quotient(grouped, distinct, dom, True),
            f"g: {zq} rows summed, N = {n}", (zq + 2) * n * 32 + 4 * zq + n * 32, 3 * zq * n)
        g = quotient_in_domain(grouped, distinct, dom, True)
        inv = F.ints_to_mont([rng.randrange(R) for _ in distinct], "fr", dev)
        inv_q = inv[torch.tensor([distinct.index(z) for z in zs], device=dev)]
        _, one = KM.plan_segments([0] * zq, range(zq))
        scaled = _chain_group(stack, sel, r, zs)[1]
        rec["K1MP@h" + tag] = record(
            "K1MP", "K1MP@h" + tag, lambda: h_pair(KM.segment_sum(grouped, inv, one, 1, g=g)),
            lambda: h_pair(KM.plain_segment_sum(grouped, inv, one, 1, g=g)),
            lambda: _chain_h(scaled, inv_q, g),
            f"h and h - g over {zq} points, N = {n}",
            (zq + 1) * n * 32 + zq * 32 + 4 * one.packed().size + 2 * n * 32, zq * n)
        if not tag:
            rec["K1QUO@rows"] = record(
                "K1QUO", "K1QUO@rows", lambda: quotient_in_domain(grouped, distinct, dom),
                lambda: _quotient_in_domain_table(grouped, torch.tensor(distinct, device=dev), omegas, table),
                lambda: _chain_quotient(grouped, distinct, dom, False),
                f"{zq} rows, each its quotient, N = {n}", (2 * zq + 2) * n * 32 + 4 * zq, 3 * zq * n)
    row = vec()[None].contiguous()
    rec["K1QUO@kzg"] = record(
        "K1QUO", "K1QUO@kzg", lambda: quotient_in_domain(row, [17], dom),
        lambda: _quotient_in_domain_table(row, torch.tensor([17], device=dev), omegas, table),
        lambda: _chain_quotient(row, [17], dom, False),
        f"one row at index 17 (the KZG prove), N = {n}", 4 * n * 32 + 4, 3 * n)
    # the grouped pass at the reference harness's largest count (3 levels of
    # power tables, every segment several chunks) and past it (4 levels,
    # 16 segments of some 80 chunks), over 4 vectors
    stack = torch.stack([vec() for _ in range(4)])
    for m, points in K1MP_LARGE:
        zs = [rng.randrange(points) for _ in range(m)]
        sel = [rng.randrange(4) for _ in range(m)]
        distinct, plan = KM.plan_segments(zs, sel)
        zq, levels = len(distinct), KM.power_levels(plan)
        name = f"K1MP@{m}x{points}"
        rec[name] = record(
            "K1MP", name, lambda: KM.segment_sum(stack, r, plan, 0), lambda: KM.plain_segment_sum(stack, r, plan, 0),
            None, f"grouped pass: {m} queries of 4 vectors at {zq} points, N = {n}, {plan.chunk_seg.size} chunks, "
            f"{levels} levels", stack.numel() * 4 + 32 + 4 * plan.packed().size + zq * n * 32, m * n + m)
        rec[name]["levels"] = levels
    return rec


#: Phase 2's K1MP records past phase 6's first count, (queries, points).
K1MP_LARGE = ((32768, 256), (40000, 16))
#: The CUDA kernel of each wrapper, as the profiler names its records.
KERNEL_NAMES = {"K1MP": "segment_sum_kernel", "K1QUO": "quotient_kernel"}


def _kernels_fbmsm(dev, crs, rng) -> dict:
    """FBMSM (``cuda_msm_table.msm``) over the IPA basis' fixed-base table
    (``crs.basis``: the table at TABLE_C) against its plain version on the
    card's tensors, exact, and against K3 + K4 as a group element, at 257
    points (g || q, an IPA round's basis; the "FBMSM" record) and 256 (g, a
    commit's), with 0 and r - 1 among the scalars. Each record: ms (the
    wrapper, CUDA events), device_ms (the kernel alone: the profiler's
    ``table_msm_kernel`` records, ``device_records`` of them, over the calls
    they cover), the plain version's ms, the K3 + K4 ``msm_auto`` it
    replaced on the IPA's path (CUDA events), the entries (the nonzero
    digits), the bound (64 bytes an entry's table point; a lazy mixed add an
    entry and an add a group but one for the tree), ptxas's registers, and
    the table's MB and the ms of one more build of it (CUDA events, warm)."""
    import torch

    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
    from verkle_kzg_tpu_torch.ops import cuda_msm_table as KT
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import msm as M
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.tools import point_regimes as PR

    basis = torch.cat([crs.g_affine, crs.q_affine])
    build_ms = cuda_ms(lambda: M.build_table(basis), 1)
    rec = {}
    for name, rows in (("FBMSM", crs.basis(crs.n, q=True)), ("FBMSM@256", crs.basis(crs.n))):
        n, c = rows.count, rows.table.c
        ks = [rng.randrange(R) for _ in range(n)]
        ks[3], ks[7] = 0, R - 1
        sc = F.ints_to_words(ks, dev)
        before = cuda_lib.launches["FBMSM"]
        out = KT.msm(rows, sc)
        launched = cuda_lib.launches["FBMSM"] - before
        plain_out, plain_ms = timed_once(lambda: KT.plain_msm(rows, sc))
        err = max_abs_err(out, plain_out)
        assert err == 0 and launched == 1, (name, err, launched)
        assert C.projective_to_host_points(out) == C.projective_to_host_points(M.msm_auto(basis[:n], sc)), name
        entries = int((KS.carry_digits(sc.cpu(), c) != 0).sum())
        groups = n * KT.segments(c)
        alone, records = PR.kernel_ms(lambda: KT.msm(rows, sc), 10, name="table_msm_kernel")
        rec[name] = {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: KT.msm(rows, sc), 20),
            "device_ms": alone,
            "device_records": records,
            "plain_ms": plain_ms,
            "k3_k4_ms": cuda_ms(lambda: M.msm_auto(basis[:n], sc), 20),
            "launches_per_call": launched,
            "library_ms": None,
            "shape": f"{n} points, c = {c}, {entries} entries, {KT.blocks(n, c)} blocks",
            "ptxas": ptxas_of("table_msm_kernel"),
            "table_mb": rows.table.points.numel() * 4 / 1e6,
            "table_build_ms": build_ms,
            **bound(64 * entries + 32 * n + 96, MIXED_FMULS * entries + ADD_FMULS * (groups - 1)),
        }
        print("phase 2 fbmsm:", name, json.dumps(rec[name]), flush=True)
    return rec


K1AFF_CASES = (  # record, points: about the verkle commit's node commitments, then a KZG proof's one
    ("K1AFF", 30_000),  # point, the host-loop IPA round's two, and a 256-point row
    ("K1AFF@1", 1),
    ("K1AFF@2", 2),
    ("K1AFF@256", 256),
)


def _kernels_k1aff(dev, crs, rng, cases=K1AFF_CASES) -> dict:
    """K1AFF against its plain version (on the card's tensors), exact, and
    the host points of ``curve.projective_to_host_points`` on the card (one
    K1AFF launch, one read) against the host-int path it replaced on
    ``p.cpu()``, equal, at ``cases``: K5 products of basis points by
    128-bit scalars (Z not 1), every tenth scalar zero (Z = 0, infinity).
    Each record: ms (the wrapper, CUDA events), device_ms (the kernel
    alone, profiler), the plain version's ms, chain_ms (the replaced
    host-int conversion of the same points, copy included, host clock) and
    host_points_ms (the conversion now: launch, read, ints; host clock),
    the rows, the infinities, and the bound (160 bytes a point; the
    Montgomery trick's 3 (N - 1) products and 4 a point for x Z^-1, y Z^-1
    and the two out of Montgomery form)."""
    import torch

    from verkle_kzg_tpu_torch.ops import cuda_curve as KC
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import cuda_scalar_mul as K5
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F

    sms = torch.cuda.get_device_properties(dev).multi_processor_count if torch.device(dev).type == "cuda" else 132
    most = max(n for _, n in cases)
    idx = torch.tensor([rng.randrange(crs.n) for _ in range(most)], device=dev)
    ks = [0 if i % 10 == 3 else rng.getrandbits(128) for i in range(most)]
    pts = K5.scalar_mul_affine(crs.g_affine[idx].contiguous(), F.ints_to_words(ks, dev))
    rec = {}
    for name, n in cases:
        p = pts[:n].contiguous()
        before = cuda_lib.launches["K1AFF"]
        out = KC.affine_words(p)
        launched = cuda_lib.launches["K1AFF"] - before
        plain_out, plain_ms = timed_once(lambda: KC.plain_affine_words(p))
        err = max_abs_err(out, plain_out)
        C.projective_to_host_points(p), C.projective_to_host_points(p.cpu())  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        now = C.projective_to_host_points(p)
        host_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        old = C.projective_to_host_points(p.cpu())
        chain_ms = (time.perf_counter() - t0) * 1e3
        infinities = sum(pt is None for pt in old)
        assert err == 0 and launched == 1 and now == old, (name, err, launched)
        assert (infinities > 0) == (n > 3), (name, infinities)
        rec[name] = {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: KC.affine_words(p), 20),
            "device_ms": device_ms(lambda: KC.affine_words(p), 10),
            "plain_ms": plain_ms,
            "chain_ms": chain_ms,
            "host_points_ms": host_ms,
            "launches_per_call": launched,
            "library_ms": None,
            "shape": f"{n} projective points, {infinities} at infinity",
            "row": (row := KC.affine_row(n, sms)),
            "blocks": -(-n // row),
            **bound(160 * n, 3 * (n - 1) + 4 * n),
        }
        print("phase 2 k1aff:", name, json.dumps(rec[name]), flush=True)
    return rec


K1NTT_CASES = (  # record, elements, segment, inverse
    ("K1NTT", 256, 256, False),  # FK's and phase 8's transforms at 256 and 512
    ("K1NTT@intt256", 256, 256, True),
    ("K1NTT@512", 512, 512, False),
    ("K1NTT@intt512", 512, 512, True),
    ("K1NTT@16x16", 256, 16, False),  # the four-step's sub-NTTs at 256
    ("K1NTT@16x16inv", 256, 16, True),
    ("K1NTT@2^14", 1 << 14, 1 << 14, False),  # above the shared-memory tile
    ("K1NTT@2^14inv", 1 << 14, 1 << 14, True),
)


def _kernels_k1ntt(dev, rng, cases=K1NTT_CASES) -> dict:
    """K1NTT against its plain version (on the card's tensors) and against
    the K1 chain it replaced (the plain stage loop with each op a K1
    launch), exact, at ``cases``; a forward transform's element 1 against
    the host's sum. Each record: ms, device_ms (the kernel alone), the plain
    version's and the chain's ms and K1 launches, the CUDA launches a call
    (one up to the tile, one more a stage above), and the bound (32 bytes an
    element each way and the table; seg / 2 products a stage a segment, and
    one an element for the inverse's 1/seg)."""
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import cuda_ntt as KN
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import ntt as N
    from verkle_kzg_tpu_torch.params import R, fr_root_of_unity

    rec = {}
    for name, n, seg, inverse in cases:
        vals = [rng.randrange(R) for _ in range(n)]
        vals[0], vals[-1] = 0, R - 1
        x = F.ints_to_mont(vals, "fr", dev)
        run = lambda: N.ntt_fr_segments(x, seg, inverse)  # noqa: E731
        before = cuda_lib.launches["K1NTT"]
        out = run()
        launched = cuda_lib.launches["K1NTT"] - before
        plain_out, plain_ms = timed_once(lambda: KN.plain(x, seg, inverse))
        before = dict(cuda_lib.launches)
        chain_out, _ = timed_once(lambda: _k1_chain(KN.plain, x, seg, inverse))
        chain = {k: cuda_lib.launches[k] - before[k] for k in ("K1", "K1NTT")}
        err = max(max_abs_err(out, plain_out), max_abs_err(out, chain_out))
        logs, tile = seg.bit_length() - 1, min(seg, KN.TILE).bit_length() - 1
        assert err == 0 and launched == 1 + logs - tile and chain["K1NTT"] == 0, (name, err, launched, chain)
        if not inverse and n == seg:
            w = fr_root_of_unity(n)
            assert F.mont_to_ints(out[1:2], "fr") == [sum(v * pow(w, j, R) for j, v in enumerate(vals)) % R]
        rec[name] = {
            "max_abs_err": err,
            "ms": cuda_ms(run, 20),
            "device_ms": device_ms(run, 10),
            "plain_ms": plain_ms,
            "chain_ms": cuda_ms(lambda: _k1_chain(KN.plain, x, seg, inverse), 3),
            "chain_k1_launches": chain["K1"],
            "launches_per_call": launched,
            "library_ms": None,
            "shape": f"{n // seg} x {seg} Fr, {'inverse' if inverse else 'forward'}",
            **bound(64 * n + 32 * (seg // 2 + 1), n // 2 * logs + (n if inverse else 0)),
        }
        print("phase 2 k1ntt:", name, json.dumps(rec[name]), flush=True)
    return rec


FSX_EDGES = (0, 55, 56, 63, 64, 100, 119, 120, 200)  # message bytes across SHA-256's padding edges


def sha_blocks(n: int) -> int:
    """SHA-256 compressions of an n-byte message."""
    return (n + 9 + 63) // 64


def fsx_compressions(msg: int, dst: int, out_len: int = 48) -> int:
    """The compressions of one hash_to_fr / expand_message_xmd launch, its
    dependent chain: b_0 over Z_pad || msg || l_i_b || 0 || DST', then one
    digest of 32 + 1 + |DST'| bytes a 32 output bytes."""
    return sha_blocks(64 + msg + 3 + dst + 1) + -(-out_len // 32) * sha_blocks(32 + 1 + dst + 1)


def _kernels_fsx(dev, rng) -> dict:
    """FSX against its plain version on CPU copies, hashlib, hostmath and the
    host Transcript, exact: the digest, expand_message_xmd and hash_to_fr
    modes and a halving round's challenge with a state of each FSX_EDGES
    length (L and R with Z != 1, both signs of y, the identity on either
    side and both), and the scalar challenge before the loop; the point
    compression over a batch with the identity. Two timed records, the
    shapes of a prove at 256: a round's challenge (33-byte state, both
    points finite) and w's (the 76-byte state of C and the input point).
    Each: ms, the kernel's own time (``device_ms``), the plain version's ms
    on the CPU, the same plain version on the card (torch ops, K1 and K1INV
    launches: the chain a launch replaces), the bound, and the dependent
    chain: SHA-256 compressions and the inversion's loop steps."""
    import torch

    from verkle_kzg_tpu_torch.fiatshamir.transcript import Transcript
    from verkle_kzg_tpu_torch.hostmath import curve as hc
    from verkle_kzg_tpu_torch.hostmath import hashing as H
    from verkle_kzg_tpu_torch.hostmath.serialize import g1_to_compressed_bytes
    from verkle_kzg_tpu_torch.ops import cuda_curve, cuda_lib
    from verkle_kzg_tpu_torch.ops import cuda_fiat_shamir as FSX
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import sha256 as S
    from verkle_kzg_tpu_torch.params import R

    def raw(t):
        return bytes(t.cpu().to(torch.int64).tolist())

    g = hc.g1_generator()
    base = C.from_affine(C.host_points_to_affine([hc.g1_mul(g, rng.getrandbits(128)) for _ in range(8)], "cpu"))
    pts = cuda_curve.plain(base[:4], base[4:])  # Z != 1
    inf = C.infinity((), "cpu")
    pairs = [(pts[0], pts[1]), (C.neg(pts[0]), pts[2]), (inf, pts[3]), (pts[3], inf), (inf, inf)]
    host = C.projective_to_host_points(torch.stack([pts[0], C.neg(pts[0])]))
    assert {g1_to_compressed_bytes(p)[31] >> 7 for p in host} == {0, 1}  # both signs of y

    def challenge_case(st: bytes, parts, label: bytes, dst: bytes, npts: int):
        """Kernel, plain version and Transcript on one message; -> the card's inputs."""
        want_pairs = torch.zeros((2, npts, 2, 8), dtype=torch.int32)
        want = FSX.plain_challenge(S.const_bytes(st, "cpu"), dst, parts, label, want_pairs if npts else None, 1)
        got_pairs = want_pairs.to(dev)
        args = (S.const_bytes(st, dev), dst, [p if isinstance(p, bytes) else p.to(dev) for p in parts], label,
                got_pairs if npts else None, 1)
        got = FSX.challenge(*args)
        assert all(torch.equal(g_.cpu(), w_) for g_, w_ in zip(got, want)) and torch.equal(got_pairs.cpu(), want_pairs)
        t = Transcript(dst.decode())
        t._state = bytearray(st)
        for p in parts:
            if isinstance(p, bytes):
                t._state += p
            elif p.shape[-2:] == (3, 8):
                t._state += g1_to_compressed_bytes(C.projective_to_host_points(p)[0])
            else:
                t.append_scalar(F.mont_to_ints(p, "fr")[0], "")
        x = t.digest(label.decode(), True)
        assert F.words_to_ints(got[0][0]) == [x] and raw(got[1]) == bytes(t._state)
        return args, want

    before = cuda_lib.launches["FSX"]
    for i, n in enumerate(FSX_EDGES):
        m = bytes(rng.randrange(256) for _ in range(n))
        t = S.const_bytes(m, dev)
        assert raw(S.sha256_bytes(t)) == hashlib.sha256(m).digest() == raw(S.plain_sha256(t.cpu())), n
        assert raw(S.expand_message_xmd(t, b"ipa", 100)) == H.expand_message_xmd(m, b"ipa", 100), n
        assert F.words_to_ints(S.hash_to_fr(t, b"multiproof")) == H.hash_to_fr(m, b"multiproof", 1), n
        l, r = pairs[i % len(pairs)]
        challenge_case(m, [b"L", l, b"R", r], b"x", b"ipa", 2)
        y = F.ints_to_mont([rng.randrange(R)], "fr", "cpu")
        challenge_case(m, [b"output point", y], b"w", b"multiproof", 0)
    aff = C.to_affine(torch.stack([p for pair in pairs for p in pair]))
    assert torch.equal(S.g1_compressed_bytes(aff.to(dev)).cpu(), S.plain_g1_compressed_bytes(aff))
    checked = cuda_lib.launches["FSX"] - before
    assert checked == 5 * len(FSX_EDGES) + 1, checked

    rec = {}
    y = F.ints_to_mont([rng.randrange(R)], "fr", "cpu")
    shapes = (  # record, state bytes, parts, label, points, products
        ("FSX", 33, [b"L", pts[0], b"R", pts[1]], b"x", 2, 15),  # a halving round's challenge
        ("FSX@w", 76, [b"output point", y], b"w", 0, 3),  # w's: the state of C and the input point
    )
    for name, n, parts, label, npts, products in shapes:
        st = bytes(rng.randrange(256) for _ in range(n))
        args, want = challenge_case(st, parts, label, b"ipa", npts)
        cpu_args = (S.const_bytes(st, "cpu"), b"ipa", parts, label, None, 0)
        _, plain_ms = timed_once(lambda: FSX.plain_challenge(*cpu_args))
        before = dict(cuda_lib.launches)
        chain_out = FSX.plain_challenge(*args[:4])
        chain_launches = {k: cuda_lib.launches[k] - before[k] for k in ("K1", "K1INV", "FSX")}
        assert all(torch.equal(c.cpu(), w_) for c, w_ in zip(chain_out, want)) and chain_launches["FSX"] == 0
        msg = n + sum(len(p) if isinstance(p, bytes) else 32 for p in parts) + len(label)
        out_bytes = 64 + 32 + len(label) + 64 * npts
        in_bytes = n + 96 * npts + (32 if not npts else 0)
        rec[name] = {
            "max_abs_err": 0,
            "ms": cuda_ms(lambda: FSX.challenge(*args), 50),
            "device_ms": device_ms(lambda: FSX.challenge(*args), 20),
            "plain_ms": plain_ms,
            "chain_ms": cuda_ms(lambda: FSX.plain_challenge(*args[:4]), 3),
            "chain_launches": chain_launches,
            "library_ms": None,
            "shape": f"{n}-byte state, {msg}-byte message" + (", L and R projective" if npts else ", y"),
            "compressions": fsx_compressions(msg, 3),
            "inverse_steps": INVERSE_STEPS if npts else 0,
            "products": products,
            "checked_launches": checked,
            **bound(in_bytes + out_bytes, products),
        }
        print("phase 2 fsx:", name, json.dumps(rec[name]), flush=True)
    return rec


def _k2_chain(fn, *args):
    """``fn`` (K2FOLD's plain version) with each level a K2 launch: the
    chain that K2FOLD replaced, the same-run yardstick."""
    from verkle_kzg_tpu_torch.ops import cuda_curve

    plain = cuda_curve.plain
    cuda_curve.plain = cuda_curve.add
    try:
        return fn(*args)
    finally:
        cuda_curve.plain = plain


K2FOLD_CASES = (  # record, rows, points a row
    ("K2FOLD", 1, 51),  # msm_auto under 64 points: the verkle verify's 51 commitments
    ("K2FOLD@1x63", 1, 63),  # msm_auto's widest
    ("K2FOLD@20002x2", 20002, 2),  # the 10k-leaf tree's sparse commits: the c1/c2 vectors
    ("K2FOLD@10001x4", 10001, 4),  # and the extensions' own vectors
)


def _kernels_k2fold(dev, pz, rng) -> dict:
    """K2FOLD against its plain version and against the K2 chain it
    replaced, exact, at K2FOLD_CASES: rows of the K2 sums ``pz`` (Z != 1,
    the identity at slot 3; row 0 adds the identity to itself and, from
    n = 4, a point to itself in its first level), and the one-row cases
    against the host sum. Each record: ms, the plain version's and the
    chain's ms and K2 launches, the kernel's own time (``device_ms``), the
    bound (the bytes, and n - 1 adds a row)."""
    import torch

    from verkle_kzg_tpu_torch.hostmath import curve as hc
    from verkle_kzg_tpu_torch.ops import cuda_curve, cuda_lib
    from verkle_kzg_tpu_torch.ops import curve as C

    rec = {}
    for name, rows, n in K2FOLD_CASES:
        idx = [rng.randrange(pz.shape[0]) for _ in range(rows * n)]
        idx[0] = idx[n // 2] = 3  # identity + identity in the first level
        if n >= 4:
            idx[1 + n // 2] = idx[1]  # P + P
        p = pz[torch.tensor(idx, device=dev)].reshape(rows, n, 3, 8).contiguous()
        before = dict(cuda_lib.launches)
        out = cuda_curve.fold(p)
        launched = cuda_lib.launches["K2FOLD"] - before["K2FOLD"]
        plain_out, plain_ms = timed_once(lambda: cuda_curve.plain_fold(p))
        before = cuda_lib.launches["K2"]
        chain_out, _ = timed_once(lambda: _k2_chain(cuda_curve.plain_fold, p))
        chain_launches = cuda_lib.launches["K2"] - before
        err = max(max_abs_err(out, plain_out), max_abs_err(out, chain_out))
        assert err == 0 and launched == 1, (name, err, launched)
        if rows == 1:
            acc = None
            for v in C.projective_to_host_points(p):
                acc = hc.g1_add(acc, v)
            assert C.projective_to_host_points(out) == [acc], name
        rec[name] = {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: cuda_curve.fold(p), 50),
            "device_ms": device_ms(lambda: cuda_curve.fold(p), 20),
            "plain_ms": plain_ms,
            "chain_ms": cuda_ms(lambda: _k2_chain(cuda_curve.plain_fold, p), 5),
            "chain_k2_launches": chain_launches,
            "launches_per_call": launched,
            "library_ms": None,
            "shape": f"{rows} x {n} points",
            **bound((p.numel() + out.numel()) * 4, rows * (n - 1) * ADD_FMULS),
        }
        print("phase 2 k2fold:", name, json.dumps(rec[name]), flush=True)
    return rec


def _combine_ops(m: int, log2_len: int) -> tuple:
    """Point adds and doublings of the tail's warp combine of m items
    (``csrc/msm_tail.cuh::combine_group``), and its depth in dependent point
    operations: per tree level h, a merge of a left node with a right one is
    log2 h doublings, S and T (2 adds), X_r + E where the right node holds
    two items or more and X_l + E from h = 2 on, which the warp runs in
    log2 h doublings and 2 adds; the root 2^log2_len X and one add."""
    if m == 1:
        return 0, 0, 0
    adds = dbls = depth = 0
    h = 1
    while h < m:
        d = h.bit_length() - 1
        for lo in range(0, m, 2 * h):
            if lo + h < m:
                dbls += d
                adds += 2 + (min(h, m - lo - h) >= 2) + (h >= 2)
        depth += d + 2
        h *= 2
    return adds + 1, dbls + log2_len, depth + log2_len + 1


def tail_fmuls(w: int, rows: int, c: int, lanes: int = 1) -> int:
    """Montgomery products that the tail's function needs, whatever the
    design: per window and lane the suffix sums, 2 (rows - 1) adds, then
    Horner's (W - 1) (c doublings + 1 add). The bound counts these."""
    adds, dbls = w * 2 * (rows - 1) + (w - 1), (w - 1) * c
    return lanes * (adds * ADD_FMULS + dbls * DOUBLE_FMULS)


def tail_work(w: int, rows: int, c: int, lanes: int = 1) -> tuple:
    """(Montgomery products, dependent point operations of one lane) of the
    tail of K4 (lanes = 1) or K7 on (W, lanes, rows) buckets: 2 (L - 1)
    adds a run of L rows, each combine level's groups (``_combine_ops``),
    Horner's (W - 1) (c doublings + 1 add). The dependent chain is a run,
    each level's combine and Horner."""
    from verkle_kzg_tpu_torch.ops import cuda_msm as K

    levels = K.tail_levels(rows)
    runs, log2_run = levels[0]
    adds, dbls = 2 * (rows - runs), 0
    depth = 2 * (min(1 << log2_run, rows) - 1)
    for n, log2_len in levels:
        for g in range(math.ceil(n / K.GROUP)):
            a, d, _ = _combine_ops(min(K.GROUP, n - K.GROUP * g), log2_len)
            adds, dbls = adds + a, dbls + d
        depth += _combine_ops(min(K.GROUP, n), log2_len)[2]
    adds, dbls = adds * w + (w - 1), dbls * w + (w - 1) * c
    depth += (w - 1) * (c + 1)
    return lanes * (adds * ADD_FMULS + dbls * DOUBLE_FMULS), depth


#: Bucket rows (windows x rows a window) above which a tail's exact
#: comparison takes the leading windows only (at least 2, so Horner runs):
#: its launches depend on the rows a window, not on the windows.
TAIL_PLAIN_ROWS = 1 << 16


def tail_plain_windows(w: int, rows: int) -> int:
    """Leading windows of a (W, rows) tail that its plain version is held to."""
    return w if w * rows <= TAIL_PLAIN_ROWS else min(w, max(2, TAIL_PLAIN_ROWS // rows))


def _tail_record(key: str, bk, c: int, plain_out_ms: tuple, reps: int, windows: int | None = None) -> dict:
    """Time and bound of one tail (K4 on (W, rows, 3, 8), K7 on (W, B, rows,
    3, 8) buckets), its CUDA launches and dependent chain; where the window
    sums take their own launches, the sums and Horner timed apart, with
    Horner's microseconds a dependent point operation. ``plain_out_ms``
    holds the plain version's output over the leading ``windows`` windows
    (all when None), which the same tail launches over those windows match;
    the timed call takes them all."""
    from verkle_kzg_tpu_torch.ops import cuda_msm as K
    from verkle_kzg_tpu_torch.ops import cuda_msm_batched as KB

    b5 = bk[:, None] if bk.dim() == 4 else bk
    w, lanes, rows = b5.shape[:3]
    run = (lambda: K.tail(bk, c)) if key == "K4" else (lambda: KB.tail(bk, c))
    out, (plain_out, plain_ms) = run(), plain_out_ms
    if windows is not None and windows < w:
        out = K.launch_tail(b5[:windows], c, key)[0]
        out = out[0] if bk.dim() == 4 else out
    design_fmuls, depth = tail_work(w, rows, c, lanes)
    rec = {
        "max_abs_err": max_abs_err(out, plain_out),
        "ms": cuda_ms(run, reps),
        "plain_ms": plain_ms,
        "plain_windows": w if windows is None else windows,
        "library_ms": None,
        "cuda_launches": K.tail_launches(rows),
        "design_fmuls": design_fmuls,
        "chain_point_ops": depth,
        "horner_point_ops": (w - 1) * (c + 1),
        **bound(4 * (b5.numel() + out.numel()), tail_fmuls(w, rows, c, lanes)),
    }
    if K.tail_launches(rows) > 1:
        _, sums = K.launch_tail(b5, c, key, parts=1)
        rec["sums_ms"] = cuda_ms(lambda: K.launch_tail(b5, c, key, parts=1, sums=sums), reps)
        rec["horner_ms"] = cuda_ms(lambda: K.launch_tail(b5, c, key, parts=2, sums=sums), reps)
        rec["horner_us_per_point_op"] = rec["horner_ms"] * 1000 / rec["horner_point_ops"]
    return rec


def sorted_stages(pa, sc, c: int, reps: int, signed: bool = True, digits=None) -> dict:
    """Milliseconds of each stage of a sorted accumulation's call (one
    window group, the digits from ``sc`` or from the (W, B, S) ``digits``
    with their (B S, 2, 8) points or (B, S, 2, 8) view): digits, sort,
    sums, combine, from CUDA events the call records between its stages;
    the median of ``reps`` calls after a warm-up, and each stage's least and
    greatest."""
    import torch

    from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS

    lanes = 1 if digits is None else digits.shape[1]
    n = pa.shape[0] if digits is None else digits.shape[1] * digits.shape[2]
    (w0, wg), = KS.window_groups(n, c, lanes, signed)
    out = torch.empty((KS.windows(c), lanes, KS.rows(c, signed), 3, 8), dtype=torch.int32, device=pa.device)
    src = (None, digits) if digits is not None else (sc, None)
    KS.launch(pa, *src, None, out, c, signed, w0, wg)
    runs = [KS.launch(pa, *src, None, out, c, signed, w0, wg, timed=True)[1] for _ in range(reps)]
    rec = {s: statistics.median(r[s] for r in runs) for s in KS.STAGES}
    rec["spread"] = {s: [min(r[s] for r in runs), max(r[s] for r in runs)] for s in KS.STAGES}
    return rec


def sorted_run(pa, sc, c: int, signed: bool = True, digits=None, key=None):
    """One call of the sorted accumulation through its wrapper: K3/K9/K8
    from the scalar words, K6/K10 (or ``key``, K13) from ``digits``."""
    from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS

    if digits is not None:
        return KS.accumulate_digits(pa, digits, c, signed, key=key)
    return KS.accumulate(pa, sc, c, signed=signed)


def sorted_cuda_launches(pa, sc, c: int, signed: bool = True, digits=None, key=None) -> int:
    """The CUDA launches of one sorted accumulation's call, as its C entry
    point counted them."""
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS

    key = key or KS.launch_key(c, signed, digits is not None)
    before = cuda_lib.cuda_launches[key]
    sorted_run(pa, sc, c, signed, digits, key)
    return cuda_lib.cuda_launches[key] - before


def point_words(pa) -> int:
    """The int32 words of distinct points in (n, 2, 8) points or a (B, S,
    2, 8) view of them: a basis every lane shares (lane stride 0) once."""
    return pa[0].numel() if pa.dim() == 4 and pa.shape[0] > 1 and pa.stride(0) == 0 else pa.numel()


def _sorted_record(pa, sc, c: int, table, plain_ms: float, reps: int, signed: bool = True, digits=None,
                   key=None) -> dict:
    """Time and bound of one sorted accumulation's call (K3/K9/K8 from the
    scalar words, K6/K10/K13 from a digit tensor), its CUDA launches, live
    entries and chunk length, and its stages' times. Bound: the points
    (a shared basis once), scalars (or digits) and buckets once, and a
    lazy mixed add (11 products) a live entry."""
    from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS

    if digits is not None:
        live, inputs = KS.live_tensor_entries(pa, digits), point_words(pa) + digits.numel()
    else:
        live, inputs = KS.live_entries(pa, sc, c, signed=signed), pa.numel() + sc.numel()
    return {
        "ms": cuda_ms(lambda: sorted_run(pa, sc, c, signed, digits, key), reps),
        "plain_ms": plain_ms,
        "library_ms": None,
        "cuda_launches": sorted_cuda_launches(pa, sc, c, signed, digits, key),
        "entries": live,
        "chunk_len": KS.chunk_len(live),
        "stages_ms": sorted_stages(pa, sc, c, reps, signed, digits),
        **bound(4 * (inputs + table.numel()), live * MIXED_FMULS),
    }


def timed_once(fn) -> tuple:
    """One call of ``fn`` and its milliseconds from CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _kernels_windows(dev, base, rng, n: int = 1 << 16, n_wide: int = 1 << 12) -> dict:
    """The single MSM's other modes (zero scalars, r - 1, ties, (0, 0)
    points), exact against their plain versions: the bucket-sorted K3 at
    c = 1 and 4, K8 (unsigned digits from the scalar words) at c = 8, and a
    digit tensor unsigned at c = 9 (K10) and c = 5 (K6) on ``n`` points,
    phase 7's smallest size; K9 (c = 16), K8 at c = 16 and
    K10 at c = 12 signed on ``n_wide`` points; and K3 at c = 8 on ``n_wide``
    points whose scalars are all equal (one bucket a window, over every
    chunk). Each sorted call with its CUDA launches, live entries, chunk
    length and four stages' times. Then K4 on every mode's buckets, signed
    and unsigned, each tail also against the native oracle. A plain version
    is timed on the one call that is compared."""
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.ops import cuda_msm as K
    from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import msm as M

    pts = [base[i % 64] for i in range(n)]
    pts[1] = None
    ks = [rng.randrange(R) for _ in range(n)]
    ks[0], ks[2], ks[3] = 0, R - 1, (1 << 15) | (1 << 31) | (1 << 200)  # ties at c = 1, 4, 8 and 16
    want = {m: native.g1_msm(pts[:m], ks[:m]) for m in (n, n_wide)}
    pa_all, sc_all = C.host_points_to_affine(pts, dev), F.ints_to_words(ks, dev)
    rec, buckets = {}, {}
    modes = [  # name, c, signed, digits (from the scalar words or a digit tensor), points
        ("K3@c1", 1, True, "words", n), ("K3@c4", 4, True, "words", n), ("K9", 16, True, "words", n_wide),
        ("K8", 8, False, "words", n), ("K8@c16", 16, False, "words", n_wide),
        ("K6@c5-unsigned", 5, False, "tensor", n),
        ("K10", 12, True, "tensor", n_wide), ("K10@c9-unsigned", 9, False, "tensor", n),
        ("K3@c8-equal-scalars", 8, True, "words", n_wide),
    ]
    for name, c, signed, source, m in modes:
        sign = "signed" if signed else "unsigned"
        pa, sc = pa_all[:m], sc_all[:m]
        if name.endswith("equal-scalars"):
            sc = sc_all[4:5].expand(m, 8).contiguous()
            want[name] = native.g1_msm(pts[:m], [ks[4]] * m)
        expect = want[name if name in want else m]
        digits = None
        if source == "words":
            table = KS.accumulate(pa, sc, c, signed=signed)
            plain_table, plain_ms = timed_once(lambda: KS.plain_accumulate(pa, sc, c, signed=signed))
        else:
            digits = (M.window_digits_signed if signed else M.window_digits)(sc, c)
            digits = digits.to(torch.int32)[:, None].contiguous()  # (W, 1 lane, m)
            table = KS.accumulate_digits(pa, digits, c, signed)
            plain_table, plain_ms = timed_once(lambda: KS.plain_accumulate_digits(pa, digits, c, signed))
        err = max_abs_err(table, plain_table)
        assert err == 0, name
        rec[name] = {"max_abs_err": err, **_sorted_record(pa, sc, c, table, plain_ms, 5, signed, digits),
                     "shape": f"{m} points, c = {c}, {sign}{', all scalars equal' if name in want else ''}"}
        buckets[name] = (table[:, 0].contiguous(), c, signed, expect)
        del table, plain_table

    for name, (bk, c, signed, expect) in buckets.items():
        out = K.tail(bk, c)
        assert C.projective_to_host_points(out) == [expect], name
        if name.endswith("equal-scalars"):
            continue
        sign = "" if signed else "-unsigned"
        part = bk[:tail_plain_windows(*bk.shape[:2])]
        rec[f"K4@c{c}{sign}"] = {
            **_tail_record("K4", bk, c, timed_once(lambda: K.plain_tail(part, c)), 5, part.shape[0]),
            "shape": f"{bk.shape[0]} x {bk.shape[1]} buckets, c = {c}{'' if signed else ', unsigned'}",
        }
        assert rec[f"K4@c{c}{sign}"]["max_abs_err"] == 0, (c, signed)
    return rec


def _k5_work(pa, ks) -> float:
    """Montgomery products a double-and-add needs for these lanes: from the
    top set bit down, a doubling per bit and a mixed add per further set
    bit; a (0, 0) or zero-scalar lane needs none."""
    from verkle_kzg_tpu_torch.ops import curve as C

    inf = C.affine_is_infinity(pa).tolist()
    total = 0
    for k, dead in zip(ks, inf):
        if k and not dead:
            total += (k.bit_length() - 1) * DOUBLE_FMULS + (bin(k).count("1") - 1) * MIXED_FMULS
    return total


#: Lanes of a K5 call above which its plain version is held to a strided
#: slice of about this many (lanes are independent).
K5_PLAIN_LANES = 1 << 12


def _kernels_k5_k7(dev, crs, rng, lanes: int = 40000, batch: int = 40) -> dict:
    """K5 on 2^12 edge-case lanes and at the shape of the verkle commit's
    c1/c2 launch (40,000 lanes over the basis, half of them zero-scalar pad
    lanes, 128-bit leaf halves in the others; the plain version on every
    ninth lane, 4,445 of them); K6 (the sorted accumulation,
    one basis shared by the lanes) and K7 at the dense verkle level (width
    256, c = 5, 40 lanes), at width 64 (c = 4) and at c = 1."""
    import torch

    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.ops import cuda_msm_batched as KB
    from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
    from verkle_kzg_tpu_torch.ops import cuda_scalar_mul as K5
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import msm as M

    rec = {}
    basis = crs.g_affine  # (256, 2, 8)

    # K5: edge lanes (zero scalars, r - 1, (0, 0) points), then the commit
    # shape; both take the many-lane regime
    K5.reset_regimes()
    errs = []
    for n, bits in ((1 << 12, 254), (lanes, 128)):
        idx = torch.tensor([rng.randrange(256) for _ in range(n)], device=dev)
        pa = basis[idx].contiguous()
        ks = [rng.getrandbits(bits) % R if i % 2 == 0 else 0 for i in range(n)]
        if n == 1 << 12:
            ks = [rng.randrange(R) for _ in range(n)]
            ks[:4] = [0, 1, R - 1, 0]
            pa[3:9] = 0  # (0, 0) lanes, one with a zero scalar
        sc = F.ints_to_words(ks, dev)
        out = K5.scalar_mul_affine(pa, sc)
        lane = torch.arange(0, n, max(1, n // K5_PLAIN_LANES), device=dev)  # lanes are independent
        plain_out, plain_ms = timed_once(lambda: K5.plain(pa[lane], sc[lane]))
        errs.append(max_abs_err(out[lane], plain_out))
        assert errs[-1] == 0, n
    hp = C.projective_to_host_points(out[:8])
    gx = [crs.g_host[i] for i in idx[:8].tolist()]
    from verkle_kzg_tpu_torch.hostmath import curve as hc

    assert hp == [hc.g1_mul(g, k) for g, k in zip(gx, ks[:8])], "K5 != host scalar mul"
    assert K5.regime_launches["many"] >= 2 and K5.regime_launches["few"] == 0, K5.regime_launches
    rec["K5"] = {
        "max_abs_err": max(errs),
        "ms": cuda_ms(lambda: K5.scalar_mul_affine(pa, sc), 5),
        "ptxas": ptxas_of("scalar_mul_kernelILi4E"),
        "plain_ms": plain_ms,
        "plain_lanes": len(lane),
        "library_ms": None,
        "regime": "many",
        "shape": f"{lanes} lanes, 128-bit scalars on half",
        **bound(4 * (pa.numel() + sc.numel() + out.numel()), _k5_work(pa, ks)),
    }
    rec.update(_kernels_k5_few(dev, basis, random.Random(5)))

    # K6 and K7: 40 lanes over the basis, shared (read at lane stride 0,
    # never copied per lane), lane 0 all zero, ties in lane 1; then both at
    # c = 1 over the width-64 lanes (256 windows of one row)
    k6_err = k7_err = 0
    b = batch
    from verkle_kzg_tpu_torch import native

    for width in (64, 256):
        c = M._auto_c_batched(width)
        ks = [[rng.randrange(R) for _ in range(width)] for _ in range(b)]
        ks[0] = [0] * width
        ks[1][0] = (1 << (c - 1)) | (1 << (c - 1)) << c
        scalars = F.ints_to_words([x for k in ks for x in k], dev).reshape(b, width, 8)
        if width == 64:
            narrow = (scalars[:3].contiguous(), ks[:3])
        digits = M.window_digits_signed(scalars, c).to(torch.int32).contiguous()
        pts = basis[:width].contiguous().expand(b, width, 2, 8)
        table = KS.accumulate_digits(pts, digits, c)
        plain_table, plain_ms = timed_once(lambda: KS.plain_accumulate_digits(pts, digits, c))
        k6_err = max(k6_err, max_abs_err(table, plain_table))
        out = KB.tail(table, c)
        k7_plain = timed_once(lambda: KB.plain_tail(table, c))
        k7_err = max(k7_err, max_abs_err(out, k7_plain[0]))
        assert k6_err == 0 and k7_err == 0, width
        got = C.projective_to_host_points(out[:3])
        assert got == [native.g1_msm(crs.g_host[:width], k) for k in ks[:3]], "K6 + K7 != native oracle"
    rec["K6"] = {"max_abs_err": k6_err, **_sorted_record(pts, None, c, table, plain_ms, 20, True, digits),
                 "shape": f"width 256, c = 5, {b} lanes, one basis shared"}
    rec["K7"] = {**_tail_record("K7", table, c, k7_plain, 20), "shape": f"width 256, c = 5, {b} lanes"}
    rec["K7"]["max_abs_err"] = max(k7_err, rec["K7"]["max_abs_err"])

    scalars, ks = narrow
    pts, digits = basis[:64].contiguous().expand(3, 64, 2, 8), M.window_digits_signed(scalars, 1).to(torch.int32)
    table = KS.accumulate_digits(pts, digits, 1)
    plain_table, plain_ms = timed_once(lambda: KS.plain_accumulate_digits(pts, digits, 1))
    rec["K6@c1"] = {"max_abs_err": max_abs_err(table, plain_table),
                    **_sorted_record(pts, None, 1, table, plain_ms, 5, True, digits),
                    "shape": "width 64, c = 1, 3 lanes, one basis shared"}
    rec["K7@c1"] = {**_tail_record("K7", table, 1, timed_once(lambda: KB.plain_tail(table, 1)), 5),
                    "shape": "width 64, c = 1, 3 lanes (256 windows of one row)"}
    assert rec["K6@c1"]["max_abs_err"] == 0 and rec["K7@c1"]["max_abs_err"] == 0
    got = C.projective_to_host_points(M.msm_fixed_base(basis[:64].contiguous(), scalars, c=1))
    assert got == [native.g1_msm(crs.g_host[:64], k) for k in ks], "msm_fixed_base at c = 1 != native oracle"
    return rec


def _k5_in(regime: str, pa, sc):
    """K5's wrapper with SWITCH set so that this call takes ``regime``."""
    from verkle_kzg_tpu_torch.ops import cuda_scalar_mul as K5

    saved = K5.SWITCH
    K5.SWITCH = pa.shape[0] if regime == "few" else pa.shape[0] - 1
    try:
        return K5.scalar_mul_affine(pa, sc)
    finally:
        K5.SWITCH = saved


def _kernels_k5_few(dev, basis, rng) -> dict:
    """K5 at few lanes, exact against its plain version: one lane with a
    254-bit scalar (the IPA multiproof verify's E aggregation), 19, 32 and
    51 lanes (the verkle verify's E at 51 in phase 5), and the regime
    switch +- 1. Each record:
    its regime, ms in both regimes, the bound, and, one warp a lane, the
    dependent chain in point operations (the longest lane's doublings below
    its top bit and mixed adds) and the microseconds of one."""
    import torch

    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.ops import cuda_scalar_mul as K5
    from verkle_kzg_tpu_torch.ops import field as F

    rec = {}
    for n in (1, 19, 32, 51, K5.SWITCH - 1, K5.SWITCH, K5.SWITCH + 1):
        idx = torch.tensor([rng.randrange(256) for _ in range(n)], device=dev)
        pa = basis[idx].contiguous()
        ks = [rng.randrange(1 << 253, R) for _ in range(n)]  # 254-bit scalars
        sc = F.ints_to_words(ks, dev)
        run = lambda: K5.scalar_mul_affine(pa, sc)  # noqa: E731
        K5.reset_regimes()
        out = run()
        regime = "few" if n <= K5.SWITCH else "many"
        assert K5.regime_launches[regime] == 1, (n, K5.regime_launches)
        plain_out, plain_ms = timed_once(lambda: K5.plain(pa, sc))
        err = max_abs_err(out, plain_out)
        assert err == 0, n
        chain = max(k.bit_length() - 1 + bin(k).count("1") for k in ks)
        ms = cuda_ms(run, 10)
        rec[f"K5@{n}"] = {
            "max_abs_err": err,
            "ms": ms,
            "ms_few": cuda_ms(lambda: _k5_in("few", pa, sc), 10),
            "ms_many": cuda_ms(lambda: _k5_in("many", pa, sc), 10),
            "ptxas": ptxas_of("scalar_mul_kernelILi32E" if regime == "few" else "scalar_mul_kernelILi4E"),
            "plain_ms": plain_ms,
            "library_ms": None,
            "regime": regime,
            "shape": f"{n} lanes, 254-bit scalars",
            "chain_point_ops": chain,
            "us_per_point_op": ms * 1e3 / chain if regime == "few" else None,
            **bound(4 * (pa.numel() + sc.numel() + out.numel()), _k5_work(pa, ks)),
        }
        print("phase 2 k5:", f"K5@{n}", json.dumps(rec[f"K5@{n}"]), flush=True)
    return rec


K13_CASES = [  # record name, c, G, fused, signed: an odd G pads a window, the last is unsigned
    ("K13", 6, 2, False, True), ("K13@c6-G2-fused", 6, 2, True, True),
    ("K13@c8-G4-fused", 8, 4, True, True), ("K13@c4-G3-fused-unsigned", 4, 3, True, False),
]


def _k13_stream(pts, sc, lanes: int, c: int, signed: bool) -> tuple:
    """(n, 2, 8) points and (n, 8) scalars -> the lane stream (S, B, 2, 8)
    and its digits (W, S, B), point i B + b at step i of lane b."""
    import torch

    from verkle_kzg_tpu_torch.ops import msm as M

    n = pts.shape[0]
    digits = (M.window_digits_signed if signed else M.window_digits)(sc, c).to(torch.int32)
    return pts.reshape(n // lanes, lanes, 2, 8), digits.reshape(-1, n // lanes, lanes).contiguous()


def _kernels_k13(dev, base, rng, n: int = 1 << 12, lanes: int = 128) -> dict:
    """K13, the sorted accumulation of a lane stream's (W, S, B) digits read
    in place (``msm_stream.bucket_accumulate`` with ``wgroup``), against its
    plain version on ``n`` points in ``lanes`` lanes (zero scalars, r - 1,
    a (0, 0) point) at each (c, G, fused, sign) of K13_CASES (G and fused
    change no word); the lane buckets of msm_stream equal to it, and the
    first case's single MSM also against the native oracle."""
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import msm_stream as MS

    pts = [base[i % 64] for i in range(n)]
    pts[1] = None
    ks = [rng.randrange(R) for _ in range(n)]
    ks[0], ks[2], ks[3] = 0, R - 1, 0
    pa, sc = C.host_points_to_affine(pts, dev), F.ints_to_words(ks, dev)
    rec = {}
    for name, c, g, fused, signed in K13_CASES:
        stream, digits = _k13_stream(pa, sc, lanes, c, signed)
        view, dview = stream.transpose(0, 1), digits.permute(0, 2, 1)  # (B, S) views, read in place
        table = KS.accumulate_digits(view, dview, c, signed, key="K13")
        plain_table, plain_ms = timed_once(lambda: KS.plain_accumulate_digits(view, dview, c, signed))
        err = max_abs_err(table, plain_table)
        assert err == 0, name
        rows = MS.bucket_accumulate(stream, digits, c, signed=signed, wgroup=g, fused=fused)
        assert torch.equal(rows[:, 0 if signed else 1:], table.permute(0, 2, 1, 3, 4)), name
        if name == "K13":
            got = MS.msm_single_fused(stream, digits, c, signed=signed, wgroup=g, fused=fused)
            assert C.projective_to_host_points(got) == [native.g1_msm(pts, ks)], "K13 MSM != native oracle"
        rec[name] = {
            "max_abs_err": err,
            **_sorted_record(view, None, c, table, plain_ms, 5, signed, dview, key="K13"),
            "shape": f"{n} points, {lanes} lanes, c = {c}, G = {g}, {'fused' if fused else 'unfused'}, "
                     f"{'signed' if signed else 'unsigned'}",
        }
    return rec


def _chain_scalar_mul(p, k):
    """The chain ``curve.scalar_mul`` ran before G1SMUL, the same-run
    yardstick of G1SMUL and G1BFLY: each of the 256 MSB-first bits is a K11
    launch, a K2 launch and a ``torch.where``."""
    import torch

    from verkle_kzg_tpu_torch.ops import cuda_curve
    from verkle_kzg_tpu_torch.ops import curve as C

    acc = C.infinity(p.shape[:-2], p.device)
    for bit in C.scalar_bits_msb(k) != 0:
        acc = cuda_curve.double(acc)
        acc = torch.where(bit[..., None, None], cuda_curve.add(acc, p), acc)
    return acc


def _chain_butterfly(x, tw, stage: int):
    """A G1 NTT stage as ``ops/ntt.py`` ran it before G1BFLY: gather, the
    chain, K2, a K1 negation, K2, scatter."""
    import torch

    from verkle_kzg_tpu_torch.ops import cuda_curve
    from verkle_kzg_tpu_torch.ops import cuda_g1_chain as G
    from verkle_kzg_tpu_torch.ops import curve as C

    half = 1 << stage
    j, u_idx = G._pairs(x.shape[0], stage, x.device)
    u, v = x[u_idx], _chain_scalar_mul(x[u_idx + half], tw[j])
    out = torch.empty_like(x)
    out[u_idx] = cuda_curve.add(u, v)
    out[u_idx + half] = cuda_curve.add(u, C.neg(v))
    return out


def _smul_fmuls(ks) -> int:
    """Montgomery products the double-and-add needs for these scalars: from
    the top set bit, a doubling per further bit and a complete add per set
    bit (the first add, onto the identity, gives the scan's words); a zero
    scalar needs none."""
    return sum((k.bit_length() - 1) * DOUBLE_FMULS + bin(k).count("1") * ADD_FMULS for k in ks if k)


def ptxas_of(kernel: str) -> dict:
    """Registers and spill bytes that the build's ptxas printed for the
    entry function whose mangled name contains ``kernel``."""
    import re

    from verkle_kzg_tpu_torch.ops import cuda_lib

    lines = (cuda_lib.BUILD / "ptxas.log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", lines[i + 1])]
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            return {"registers": int(regs.group(1)) if regs else None, "stack_bytes": nums[0],
                    "spill_store_bytes": nums[1], "spill_load_bytes": nums[2]}
    return {}


def _kernels_g1_chain(dev, pz, rng, probe, sizes=(256, 512), stages=((256, 7), (512, 0), (512, 8))) -> dict:
    """G1SMUL at 256 and 512 lanes (intt_g1's 1/N at 256; FK's pointwise
    product and 1/N at 512) and G1BFLY at stage 7 of the size-256 forward
    transform and at stages 0 and 8 of the size-512 one (FK's NTTs), on the
    K2 sums ``pz`` (Z != 1, the identity at slot 3), exact against their
    plain versions, the K11 + K2 + select chain they replace, the
    one-thread design before the groups (``probe``'s ``g1``) and every group
    size the C entry points take. Scalars: 0, 1, r - 1 and one with 200
    leading zero bits among random ones; the butterflies take the plan's
    twiddles. Each record: the path's group G, its registers and spills,
    ms by events, the kernel alone (profiler, over the records of that
    kernel kept), the one-thread design's times in the same run, the chain's,
    the bound, and the dependent chain in point operations (from the warp's
    top bit a doubling a round, an add a round where a lane of the warp has
    the bit; two more adds a butterfly) with the us an operation, and the
    regime the lane count picks."""
    import torch

    from verkle_kzg_tpu_torch.hostmath import curve as hc
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.ops import cuda_g1_chain as G
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import ntt as N
    from verkle_kzg_tpu_torch.tools import point_regimes as PR

    regs = PR.g1_ptxas((cuda_lib.BUILD / "ptxas.log").read_text())
    cases = []
    for n in sizes:
        ks = [rng.randrange(R) for _ in range(n)]
        ks[:4] = [0, 1, R - 1, rng.getrandbits(56) | 1 << 55]
        p, k = pz[:n].contiguous(), F.ints_to_words(ks, dev)
        run = (lambda g=None, p=p, k=k: G.scalar_mul(p, k) if g is None
               else G._launch_scalar_mul(p, k, g))
        cases.append((f"G1SMUL@{n}", f"{n} lanes, scalars 0, 1, r - 1, 2^55 + ... among random ones", run,
                      lambda p=p, k=k: G.plain_scalar_mul(p, k), lambda p=p, k=k: _chain_scalar_mul(p, k),
                      lambda p=p, k=k: probe.g1(p, k),
                      4 * (p.numel() + k.numel() + p.numel()), _smul_fmuls(ks), ks, 0))
        if n == sizes[0]:
            host = C.projective_to_host_points(p[:8])
            want8 = [None if a is None else hc.g1_mul(a, s) for a, s in zip(host, ks[:8])]
            assert C.projective_to_host_points(G.scalar_mul(p[:8], k[:8])) == want8, "G1SMUL != host"
    for n, stage in stages:
        x = pz[:n].contiguous()
        tw_ints = N._Plan(n, False).stages[stage][2][: 1 << stage]
        tw = F.ints_to_words(tw_ints, dev)
        pairs = [tw_ints[j] for j in range(1 << stage) for _ in range(n >> (stage + 1))]  # j-major, as launched
        run = (lambda g=None, x=x, tw=tw, s=stage: G.butterfly(x, tw, s) if g is None
               else G._launch_butterfly(x, tw, s, g))
        cases.append((f"G1BFLY@{n}-s{stage}", f"stage {stage} of the size-{n} forward G1 NTT", run,
                      lambda x=x, tw=tw, s=stage: G.plain_butterfly(x, tw, s),
                      lambda x=x, tw=tw, s=stage: _chain_butterfly(x, tw, s),
                      lambda x=x, tw=tw, s=stage: probe.g1(x, tw, s),
                      4 * (2 * x.numel() + tw.numel()), _smul_fmuls(pairs) + n * ADD_FMULS, pairs, 2))
    rec = {}
    for name, shape, run, plain, chain, thread, nbytes, fmuls, lane_ks, extra in cases:
        before = dict(cuda_lib.launches)
        out = run()
        launched = {k: cuda_lib.launches[k] - before[k] for k in ("G1SMUL", "G1BFLY", "K2", "K11")}
        kind = name.split("@")[0]
        assert launched == {k: int(k == kind) for k in launched}, (name, launched)  # one launch, no K2 or K11
        plain_out, plain_ms = timed_once(plain)
        chain_out, _ = timed_once(chain)
        errs = {"plain": max_abs_err(out, plain_out), "chain": max_abs_err(out, chain_out),
                "one-thread design": max_abs_err(thread(), out),
                **{f"G={g}": max_abs_err(run(g), out) for g in G.GROUPS}}
        assert max(errs.values()) == 0, (name, errs)
        tag = "g1_scalar_mul_" if kind == "G1SMUL" else "g1_butterfly_"
        kern_ms, records = PR.kernel_ms(run, name=tag + "kernel")
        thread_kern_ms, thread_records = PR.kernel_ms(thread, name=tag + "thread")
        mode = G.regime(len(lane_ks))
        group = G.GROUP[mode]
        ops, thread_ops = PR.dependent_chain(lane_ks, group) + extra, PR.dependent_chain(lane_ks, 1) + extra
        rec[name] = {
            "max_abs_err": max(errs.values()),
            "ms": cuda_ms(run, 10),
            "kernel_ms": kern_ms,
            "kernel_records": records,
            "regime": mode,
            "group": group,
            "ptxas": regs[f"{kind}, G={group}"],
            "dependent_chain": ops,
            "us_per_op": None if kern_ms is None or not ops else kern_ms * 1e3 / ops,
            "thread_ms": cuda_ms(thread, 10),
            "thread_kernel_ms": thread_kern_ms,
            "thread_kernel_records": thread_records,
            "thread_ptxas": probe.ptxas.get(f"{kind}, thread"),
            "thread_dependent_chain": thread_ops,
            "chain_ms": cuda_ms(chain, 3),
            "plain_ms": plain_ms,
            "library_ms": None,
            "shape": shape,
            **bound(nbytes, fmuls),
        }
        print("phase 2 g1 chain:", name, json.dumps(rec[name]), flush=True)
    return rec


def phase_ipa(dev, crs, small: int = 32):
    """IPA at domain 256 on the card: checks, launch counts, timings; the
    device loop (the prove's path) against the host loop, bit for bit, with
    no host sync between its upload and its one read; and a proof at domain
    ``small`` on the card against the CPU plain path. Also returns the data
    vector and its commitment for phase 6."""
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.fiatshamir.transcript import Transcript
    from verkle_kzg_tpu_torch.hostmath.curve import g1_add, g1_generator
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.poly import Domain, FrVector
    from verkle_kzg_tpu_torch.schemes import IPA, IPAParams
    from verkle_kzg_tpu_torch.schemes import ipa as I

    n = 256
    rng = random.Random(256)
    vals = [rng.randrange(1 << 253) for _ in range(n)]
    data = FrVector.from_ints(vals, crs.domain, device=dev)
    index, outside = 17, 2 * n

    # warm-up, then the main path with fresh launch counts
    warm = IPA.commit(crs, data)
    IPA.verify(crs, warm, index, IPA.prove(crs, warm, index, data))
    torch.cuda.synchronize()

    counts, ms = {}, {}

    def run(name, fn):
        before = dict(cuda_lib.launches)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end)
        counts[name] = {k: cuda_lib.launches[k] - before[k] for k in before}
        return out

    cuda_lib.reset_launches()
    commit = run("commit", lambda: IPA.commit(crs, data))
    t_gpu = Transcript("ipa")
    proof, reads = run("prove", lambda: no_sync_window(lambda: IPA.prove_point(crs, commit, index, data, t_gpu)))
    ok = run("verify", lambda: IPA.verify(crs, commit, index, proof))
    proof_out = IPA.prove(crs, commit, outside, data)
    ok_out = IPA.verify(crs, commit, outside, proof_out)
    bad_commit = IPA.verify(crs, g1_add(commit, g1_generator()), index, proof)
    cross = IPA.verify(crs, commit, index, proof_out)
    cproof, creads = run("prove_commitment", lambda: no_sync_window(lambda: IPA.prove_commitment(crs, commit, data)))
    cok = IPA.verify_commitment_proof(crs, commit, cproof)
    torch.cuda.synchronize()
    main_path_launches = dict(cuda_lib.launches)

    assert ok and ok_out and cok, "an honest proof was rejected"
    assert not bad_commit and not cross, "a tampered or cross proof was accepted"
    assert proof.y == vals[index] and len(proof.l) == 8
    assert commit == native.g1_msm(crs.g_host, vals), "commit != native oracle"
    # the commit and the prove's MSMs over the CRS run FBMSM on its table;
    # the verify's MSM (g, q, C and the proof's points) runs K3 + K4
    assert (counts["commit"]["FBMSM"], counts["commit"]["K3"], counts["commit"]["K4"]) == (1, 0, 0), counts
    assert (counts["verify"]["K3"], counts["verify"]["K4"], counts["verify"]["FBMSM"]) == (1, 1, 0), counts
    # the device loop: <a, b> and w, then 8 rounds of K1IPA, two MSMs
    # (FBMSM) and FSX, and the last fold; no K1, one read, no sync in between
    c = counts["prove"]
    assert (c["FSX"], c["K1IPA"], c["FBMSM"], c["K3"], c["K4"], c["K1"]) == (9, 10, 16, 0, 0, 0), c
    c = counts["prove_commitment"]
    assert (c["FSX"], c["K1IPA"], c["FBMSM"], c["K3"], c["K4"]) == (8, 9, 16, 0, 0), counts
    assert reads == creads == 1, (reads, creads)
    assert min(main_path_launches[k] for k in ("K1", "K1IPA", "K3", "K4", "FSX", "FBMSM")) > 0, main_path_launches

    # the host loop, the second implementation, on the same inputs
    same = {}
    for point, want in ((index, proof), (outside, proof_out)):
        t_dev, t_host = Transcript("ipa"), Transcript("ipa")
        got = IPA.prove_point(crs, commit, point, data, t_dev)
        b = F.ints_to_mont(crs.domain.barycentric_coefficients(point), "fr", dev)
        host = I._low_level_ipa_hostloop(crs, data.vals, b, commit, point, t_host)
        same[point] = (got.l, got.r, got.tip, got.y) == (host.l, host.r, host.tip, host.y) == (
            want.l, want.r, want.tip, want.y) and bytes(t_dev._state) == bytes(t_host._state)
    hproof = I._commitment_proof(crs, commit, data, hostloop=True)
    same["commitment"] = (cproof.l, cproof.r, cproof.tip) == (hproof.l, hproof.r, hproof.tip)
    assert all(same.values()), f"device loop != host loop: {same}"

    # both loops timed by CUDA events, 5 calls each in turns, and their FBMSM calls
    b17 = F.ints_to_mont(crs.domain.barycentric_coefficients(index), "fr", dev)
    loops = {"device": lambda: IPA.prove_point(crs, commit, index, data, Transcript("ipa")),
             "host": lambda: I._low_level_ipa_hostloop(crs, data.vals, b17, commit, index, Transcript("ipa"))}
    loop_ms = {k: [] for k in loops}
    for name in ("device", "host", "host", "device", "device", "host", "host", "device", "device", "host"):
        loop_ms[name].append(timed_once(loops[name])[1])

    # the same proof from the plain path on this machine's CPU, at domain
    # `small` (the setup ipa_setup(small) makes: the first small + 1 of the
    # same hash-to-curve points), which keeps the CPU's plain prove short
    proofs, states, secs = [], [], []
    for d in (dev, "cpu"):
        p = IPAParams(n=small, g_host=crs.g_host[:small], q_host=crs.g_host[small], domain=Domain(small), device=d)
        v = FrVector.from_ints(vals[:small], p.domain, device=d)
        t = Transcript("ipa")
        t0 = time.perf_counter()
        pr = IPA.prove_point(p, IPA.commit(p, v), index, v, t)
        secs.append(time.perf_counter() - t0)
        proofs.append((pr.l, pr.r, pr.tip, pr.y))
        states.append(bytes(t._state))
    assert proofs[0] == proofs[1], f"IPA proof at {small}: card != CPU"
    assert states[0] == states[1], f"IPA transcript at {small}: card != CPU"
    return {
        "prove_fbmsm_ms": _prove_msms(crs, loops["device"]),
        "hostloop_fbmsm_ms": _prove_msms(crs, loops["host"]),
        "loop_ms": loop_ms,
        "device_vs_host_identical": same,
        "reads_per_prove": reads,
        "ms": ms,
        "launches_per_call": counts,
        "main_path_launches": main_path_launches,
        "cpu_plain_prove_s": secs[1], "cpu_plain_prove_domain": small,
    }, (vals, data, commit)


def no_sync_window(fn) -> tuple:
    """``fn()`` with the IPA device loop watched: from the return of its one
    upload (``ipa._state_to_device``) to its one read (``ipa._read_back``)
    the card runs under ``torch.cuda.set_sync_debug_mode("error")``, so any
    host sync in between raises. -> (fn's result, the reads it made)."""
    import torch

    from verkle_kzg_tpu_torch.schemes import ipa as I

    upload, read, reads = I._state_to_device, I._read_back, []

    def watched_upload(t, device):
        out = upload(t, device)
        torch.cuda.set_sync_debug_mode("error")
        return out

    def watched_read(*parts):
        torch.cuda.set_sync_debug_mode(0)
        reads.append(1)
        return read(*parts)

    I._state_to_device, I._read_back = watched_upload, watched_read
    try:
        return fn(), len(reads)
    finally:
        I._state_to_device, I._read_back = upload, read
        torch.cuda.set_sync_debug_mode(0)


def _prove_msms(crs, prove) -> dict:
    """One more IPA prove (``prove()``) with a CUDA-event pair around each of
    its FBMSM calls (two a halving round, 16 at domain 256;
    ``cuda_msm_table.msm`` wrapped for that call): their sum and each."""
    import torch

    from verkle_kzg_tpu_torch.ops import cuda_msm_table as KT

    events, msm = [], KT.msm

    def timed_msm(rows, scalars):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = msm(rows, scalars)
        end.record()
        events.append((start, end))
        return out

    KT.msm = timed_msm
    try:
        prove()
        torch.cuda.synchronize()
    finally:
        KT.msm = msm
    each = [s.elapsed_time(e) for s, e in events]
    assert len(each) == 2 * (crs.n.bit_length() - 1), len(each)
    return {"sum": sum(each), "each": each}


def _multiples_of_g(n: int) -> list:
    """Affine k*G for k = 1..n, by doubling the range each level: the points
    m+1..2m are P_m + P_j, independent additions sharing one inversion
    (Montgomery's trick); 2m is a doubling."""
    from verkle_kzg_tpu_torch.hostmath.curve import g1_add, g1_generator
    from verkle_kzg_tpu_torch.hostmath.field import fq_batch_inverse
    from verkle_kzg_tpu_torch.params import Q

    pts = [g1_generator()]
    while len(pts) < n:
        m = len(pts)
        xm, ym = pts[-1]
        take = min(m - 1, n - m)
        invs = fq_batch_inverse([(pts[j][0] - xm) % Q for j in range(take)])
        for j in range(take):
            x, y = pts[j]
            lam = (y - ym) * invs[j] % Q
            x3 = (lam * lam - x - xm) % Q
            pts.append((x3, (lam * (xm - x3) - ym) % Q))
        if len(pts) < n:
            pts.append(g1_add(pts[m - 1], pts[m - 1]))
    return pts[:n]


def msm_points(n: int):
    """(n, 2, 8) Montgomery words of k*G, k = 1..n, cached on disk."""
    import numpy as np
    import torch

    from verkle_kzg_tpu_torch.ops import curve as C

    if POINTS_CACHE.exists():
        arr = np.load(POINTS_CACHE)["points"]
        if arr.shape[0] >= n:
            return torch.from_numpy(arr[:n])
    arr = C.host_points_to_affine(_multiples_of_g(n), "cpu").numpy()
    np.savez(POINTS_CACHE, points=arr)
    return torch.from_numpy(arr)


def phase_msm(dev) -> dict:
    """msm_auto at 2^20 points against (sum k_i s_i) G, and its rate; the
    native C++ Pippenger on a random 2^16 subset as a second oracle."""
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.hostmath.curve import g1_generator, g1_mul
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.ops import cuda_msm as K
    from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import msm as M

    n = 1 << 20
    t0 = time.perf_counter()
    pts = msm_points(n).to(dev)
    rng = random.Random(20)
    ks = [rng.randrange(R) for _ in range(n)]
    sc = F.ints_to_words(ks, dev)
    setup_s = time.perf_counter() - t0

    out = M.msm_auto(pts, sc)
    want = g1_mul(g1_generator(), sum((i + 1) * k for i, k in enumerate(ks)) % R)
    assert C.projective_to_host_points(out) == [want], "2^20 MSM != (sum k_i s_i) G"

    assert native.available(), "the native C++ oracle did not build"
    sub = torch.randperm(n, generator=torch.Generator().manual_seed(16))[: 1 << 16]
    sub_pts = pts[sub.to(dev)]
    sub_ks = [ks[i] for i in sub.tolist()]
    host_pts = C.projective_to_host_points(C.from_affine(sub_pts))
    got = C.projective_to_host_points(M.msm_auto(sub_pts.contiguous(), F.ints_to_words(sub_ks, dev)))
    assert got == [native.g1_msm(host_pts, sub_ks)], "2^16 MSM != native oracle"

    reps = []
    for _ in range(5):
        reps.append(cuda_ms(lambda: M.msm_auto(pts, sc), 1))
    med = statistics.median(reps)

    # the stages of one MSM, timed apart: K3's four and K4
    stage = {
        "k3_accumulate_ms": cuda_ms(lambda: KS.accumulate(pts, sc, 8), 3),
        "k3_cuda_launches": sorted_cuda_launches(pts, sc, 8),
        "k3_stages_ms": sorted_stages(pts, sc, 8, 5),
    }
    buckets = KS.accumulate(pts, sc, 8)[:, 0].contiguous()
    stage["k4_tail_ms"] = cuda_ms(lambda: K.tail(buckets), 3)
    return {
        "n": n, "setup_s": setup_s, "reps_ms": reps, "median_ms": med,
        "points_per_s": n / (med / 1000.0), "stages": stage,
    }


def _median_ms(fn, reps: int = 3) -> tuple:
    """The median and the list of ``reps`` CUDA-event timings of ``fn``."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


SWEEP_SIGNED_C = (8, 4, 12, 16)  # at every n: the default and three other widths


def phase_sweep(dev, card: str, sizes=(1 << 16, 1 << 18, 1 << 20, 1 << 22), extra_n: int = 1 << 20) -> dict:
    """BASELINE.json config 5, the MSM sweep of 2^16-2^22 points, at every
    window width the single MSM takes: at each n, c = 8 signed (the
    default) and c in {4, 12, 16} signed; at ``extra_n`` also c in {8, 16}
    unsigned and c in {5, 10, 13} signed. Point j is ((j mod 2^20) + 1) G,
    phase 4's points tiled, so every run is checked exactly against
    (sum_j k_j ((j mod 2^20) + 1)) G; at 2^16 also against the native C++
    Pippenger. Each run prints one line: the median of 3 CUDA-event reps
    after the checked call, points/s, the launches per kernel of the
    checked call, whose counts start from 0, and, where c does not divide
    16, the median ms of the digit recoding the run includes (torch ops, the
    JAX package's recoding)."""
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.hostmath.curve import g1_generator, g1_mul
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import cuda_msm as K
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import msm as M

    period = 1 << 20
    n_max = max(sizes)
    t0 = time.perf_counter()
    base = msm_points(min(period, n_max)).to(dev)
    pts_all = base.repeat(math.ceil(n_max / base.shape[0]), 1, 1)[:n_max].contiguous()
    rng = random.Random(22)
    ks = [rng.randrange(R) for _ in range(n_max)]
    sc_all = F.ints_to_words(ks, dev)
    want, acc = {}, 0
    for j, k in enumerate(ks):
        acc += k * (j % period + 1)
        if j + 1 in sizes:
            want[j + 1] = g1_mul(g1_generator(), acc % R)
    small = min(sizes)
    native_want = native.g1_msm(C.projective_to_host_points(C.from_affine(pts_all[:small])), ks[:small])
    setup_s = time.perf_counter() - t0

    plan = [(n, c, True) for n in sizes for c in SWEEP_SIGNED_C]
    plan += [(extra_n, c, False) for c in (8, 16)] + [(extra_n, c, True) for c in (5, 10, 13)]
    runs, path_launches = [], dict.fromkeys(cuda_lib.launches, 0)
    path_cuda_launches = dict.fromkeys(cuda_lib.cuda_launches, 0)
    for n, c, signed in plan:
        pts, sc = pts_all[:n], sc_all[:n]
        if signed:
            run = lambda: M.msm_auto(pts, sc, c=c)  # noqa: E731
        else:
            run = lambda: M.msm_pippenger(pts, sc, c=c, signed=False)  # noqa: E731
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        out = run()
        torch.cuda.synchronize()
        counts = {k: v for k, v in cuda_lib.launches.items() if v}
        cuda_counts = {k: v for k, v in cuda_lib.cuda_launches.items() if v}
        got = C.projective_to_host_points(out)
        assert got == [want[n]], f"n = {n}, c = {c}, signed = {signed}: != (sum k_i s_i) G"
        if n == small:
            assert got == [native_want], f"n = {n}, c = {c}: != native oracle"
        for k, v in counts.items():
            path_launches[k] += v
        for k, v in cuda_counts.items():
            path_cuda_launches[k] += v
        med, reps = _median_ms(run)
        line = {"n": n, "c": c, "signed": signed, "median_ms": med, "reps_ms": reps,
                "points_per_s": n / (med / 1e3), "launches": counts, "cuda_launches": cuda_counts}
        if c not in K.IN_KERNEL_C:  # the digit tensor's recoding in torch, inside median_ms
            recode = M.window_digits_signed if signed else M.window_digits
            line["recode_ms"] = _median_ms(lambda: recode(sc, c).to(torch.int32))[0]
        runs.append(line)
        print("phase 7 msm sweep:", json.dumps(line), f"[{card}]", flush=True)
    for k in ("K3", "K4", "K6", "K8", "K9", "K10"):
        assert path_launches[k] > 0, (k, path_launches)
    assert path_launches["K2"] == 0, path_launches  # no MSM of 64 points or more folds with K2
    return {"setup_s": setup_s, "runs": runs, "path_launches": path_launches,
            "path_cuda_launches": path_cuda_launches}


GROUP_GRID = ((6, 2, False), (6, 2, True), (6, 4, True), (8, 2, False), (8, 2, True), (8, 4, True))


def phase_group(dev, card: str, n: int = 1 << 20, lanes: int = 128, grid=GROUP_GRID, small: int = 1 << 12) -> dict:
    """``benchmarks/tune_group.py``'s default grid on the port: the signed
    single MSM of ``n`` points in ``lanes`` lanes through
    ``msm_stream.msm_single_fused`` with ``wgroup``/``fused`` (K13: the
    sorted accumulation over the whole stream as one lane, then K4, no K2
    fold; chunk 32, G and fused are accepted and have no effect), digits
    included, as tune_group times it; its baseline is ``msm_pippenger`` at
    c = 8 (K3, tune_group's ``prod_sc_pair_c8``). Phase 4's points k G,
    uniform scalars; every run exact against (sum k_i s_i) G. Each run
    prints the median of 3 CUDA-event reps after the checked call,
    points/s, the launches of the checked call, whose counts start from 0,
    and one call of K13 alone with its bound, CUDA launches and (once a c)
    its four stages' times. Then each other entry point of ``msm_stream``
    once, on ``small`` points, against the native oracle."""
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.hostmath.curve import g1_generator, g1_mul
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import cuda_msm_sorted as KS
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import msm as M
    from verkle_kzg_tpu_torch.ops import msm_stream as MS

    t0 = time.perf_counter()
    pts = msm_points(n).to(dev)
    rng = random.Random(9)
    ks = [rng.randrange(R) for _ in range(n)]
    sc = F.ints_to_words(ks, dev)
    want = g1_mul(g1_generator(), sum((i + 1) * k for i, k in enumerate(ks)) % R)
    setup_s = time.perf_counter() - t0

    def checked(kind, fn, **line):
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        line = {"kind": kind, "n": n, **line, "launches": {k: v for k, v in cuda_lib.launches.items() if v},
                "cuda_launches": {k: v for k, v in cuda_lib.cuda_launches.items() if v}}
        assert C.projective_to_host_points(out) == [want], f"{kind}: != (sum k_i s_i) G"
        line["median_ms"], line["reps_ms"] = _median_ms(fn)
        line["points_per_s"] = n / (line["median_ms"] / 1e3)
        return line

    runs = [checked("prod_sc_pair_c8", lambda: M.msm_pippenger(pts, sc, c=8))]
    print("phase 9 group grid:", json.dumps(runs[0]), f"[{card}]", flush=True)
    path_launches = dict.fromkeys(cuda_lib.launches, 0)
    path_cuda_launches = dict.fromkeys(cuda_lib.cuda_launches, 0)
    staged = set()
    for c, g, fused in grid:
        def run(c=c, g=g, fused=fused):
            stream, digits = _k13_stream(pts, sc, lanes, c, True)
            return MS.msm_single_fused(stream, digits, c, chunk=32, signed=True, wgroup=g, fused=fused)

        line = checked(f"group_c{c}_g{g}_f{int(fused)}", run, lanes=lanes)
        for k, v in line["launches"].items():
            path_launches[k] += v
        for k, v in line["cuda_launches"].items():
            path_cuda_launches[k] += v
        # K13 alone, as msm_single_fused calls it: the stream as one lane
        stream, digits = _k13_stream(pts, sc, lanes, c, True)
        flat, one = stream.reshape(n, 2, 8), digits.reshape(digits.shape[0], 1, n)
        line["k13_ms"] = _median_ms(lambda: KS.accumulate_digits(flat, one, c, True, key="K13"), 1)[0]
        # K13's bound, as phase 2 counts it: the stream, digits and buckets
        # once, a mixed add a live digit (phase 4's points have no (0, 0))
        rows = 1 << (c - 1)
        line["k13_bound"] = bound(4 * (stream.numel() + digits.numel() + digits.shape[0] * rows * 24),
                                  int((digits != 0).sum()) * MIXED_FMULS)
        if c not in staged:
            staged.add(c)
            line["k13_entries"] = KS.live_tensor_entries(flat, one)
            line["k13_stages_ms"] = sorted_stages(flat, None, c, 3, True, one)
        del stream, digits, flat, one
        runs.append(line)
        print("phase 9 group grid:", json.dumps(line), f"[{card}]", flush=True)
    assert path_launches["K13"] > 0 and path_launches["K2"] == 0, path_launches

    # every other entry point once, on the first `small` points, 128 lanes
    pa, sm = pts[:small].contiguous(), sc[:small].contiguous()
    host_pts = C.projective_to_host_points(C.from_affine(pa))
    one = native.g1_msm(host_pts, ks[:small])
    lane_want = [native.g1_msm(host_pts[b::lanes], ks[b:small:lanes]) for b in range(lanes)]
    steps = small // lanes
    stream, sc_stream = pa.reshape(steps, lanes, 2, 8), sm.reshape(steps, lanes, 8)
    masks = M.signed_carries(sm, 8).reshape(steps, lanes, -1).contiguous()
    _, digits = _k13_stream(pa, sm, lanes, 6, True)
    _, udigits = _k13_stream(pa, sm, lanes, 8, False)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    checks = {
        "msm_single_fused (K6)": (MS.msm_single_fused(stream, digits, 6, signed=True), [one]),
        "msm_single_fused unsigned (K10)": (MS.msm_single_fused(stream, udigits, 8), [one]),
        "msm_single_fused_sc (K8)": (MS.msm_single_fused_sc(stream, sc_stream, 8), [one]),
        "msm_single_fused_sc_signed (K3)": (MS.msm_single_fused_sc_signed(stream, sc_stream, masks, 8), [one]),
        "bucket_accumulate + batched_bucket_tail (K6, K7)": (
            MS.batched_bucket_tail(MS.bucket_accumulate(stream, digits, 6, signed=True), 6,
                                   nbuckets=MS.signed_table_size(6), shifted=True), lane_want),
        "bucket_accumulate_from_scalars + batched_bucket_tail (K8, K7)": (
            MS.batched_bucket_tail(MS.bucket_accumulate_from_scalars(stream, sc_stream, 8), 8), lane_want),
        "bucket_accumulate_from_scalars_signed + batched_bucket_tail (K3, K7)": (
            MS.batched_bucket_tail(MS.bucket_accumulate_from_scalars_signed(stream, sc_stream, masks, 8), 8,
                                   nbuckets=MS.signed_table_size(8), shifted=True), lane_want),
    }
    torch.cuda.synchronize()
    entry_launches = {k: v for k, v in cuda_lib.launches.items() if v}
    for name, (got, expect) in checks.items():
        assert C.projective_to_host_points(got) == expect, f"{name} != native oracle"
    for k in ("K3", "K4", "K6", "K7", "K8", "K10"):
        assert entry_launches.get(k, 0) > 0, (k, entry_launches)
    return {"setup_s": setup_s, "runs": runs, "path_launches": path_launches,
            "path_cuda_launches": path_cuda_launches, "entry_points_checked": list(checks),
            "entry_point_launches": entry_launches}


def _stage(name, fn, ms, counts, k5_lanes=None):
    """Run one stage of a path: CUDA-event and wall milliseconds, the
    launches per kernel it made, and its calls of
    ``curve.projective_to_host_points`` on card tensors (``ms[name]
    ["card_conversions"]``, a K1AFF launch each); with ``k5_lanes``, also
    the lane count of each K5 call it made, into ``k5_lanes[name]``."""
    import torch

    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import cuda_scalar_mul as K5
    from verkle_kzg_tpu_torch.ops import curve as C

    before = dict(cuda_lib.launches)
    inner, lanes = K5.scalar_mul_affine, []
    convert, conversions = C.projective_to_host_points, []

    def recorded(pts, sc):
        lanes.append(int(pts.shape[0]))
        return inner(pts, sc)

    def counted(p):
        conversions.append(p.device.type != "cpu")
        return convert(p)

    if k5_lanes is not None:
        K5.scalar_mul_affine = recorded
    C.projective_to_host_points = counted
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    try:
        out = fn()
    finally:
        K5.scalar_mul_affine = inner
        C.projective_to_host_points = convert
    end.record()
    torch.cuda.synchronize()
    ms[name] = {"events_ms": start.elapsed_time(end), "wall_ms": (time.perf_counter() - t0) * 1e3,
                "card_conversions": sum(conversions)}
    counts[name] = {k: cuda_lib.launches[k] - before[k] for k in before}
    if k5_lanes is not None:
        k5_lanes[name] = lanes
    return out


def _verkle_keys(n: int, key_len: int = 32) -> list:
    """``benchmarks/bench_all.py:142-143``: distinct (unit 0, unit 1) pairs
    with a fixed tail of ``key_len`` - 3 units (none at the harness's
    default of 3), so sibling stems diverge one level below their parent."""
    tail = tuple((11 * j) % 256 for j in range(key_len - 3))
    return [(i // 256, i % 256, (i * 7) % 256) + tail for i in range(n)]


def _verkle_inputs(leaves: int, key_len: int = 32) -> tuple:
    """Phase 5's keys, their values, and the stem of an extension holding
    only unit 7 (absence mode L)."""
    keys = _verkle_keys(leaves, key_len)
    rng = random.Random(10_000)
    values = {k: rng.randrange(1 << 256) for k in keys}
    return keys, values, (100, 0, 0) + keys[0][3:]


def _verkle_absent(keys, absent_l) -> list:
    """Three keys the trees of ``_verkle_inputs`` do not hold: no root child
    200 (mode E), (0, 0, 0)'s extension reached by another stem (mode O),
    and the unit-7 extension's own key (mode L)."""
    tail = keys[0][3:]
    return [(200, 0, 0) + tail, (0, 0, 1) + tail, absent_l]


def _verkle_build(scheme, params, key_len, keys, values, absent_l, mesh=None):
    """A tree of config 4 (``benchmarks/bench_all.py:126-158``) over
    ``scheme`` and ``params``, width 256, ``key_len``-unit keys, not yet
    committed (its node commits sharded over ``mesh``)."""
    from verkle_kzg_tpu_torch.verkle import VerkleTree

    tree = VerkleTree(scheme, params, key_len=key_len, ext_width=256, mesh=mesh)
    for k in keys:
        tree.insert_single(k, values[k])
    tree._insert(tree.root, absent_l, [(7, 77)], 0)  # the multi-value insert surface
    return tree


def oracle_msm(points, scalars):
    """``native.g1_msm`` with its window fitted to the point count: c = 5 at
    a node's 256 points, 2 at an extension's 4 (its default c = 12 walks 2 x
    4,095 buckets a window, about 90 ms a call at either size)."""
    from verkle_kzg_tpu_torch import native

    return native.g1_msm(points, scalars, c=max(1, (len(points).bit_length() + 1) // 2))


def _check_verkle_oracle(tree, root, g, exts=None) -> None:
    """The root, up to 4 depth-1 internal nodes and 64 sampled extensions
    (or of ``exts``; their c1, c2 and extension commitments) against the
    native C++ Pippenger over the basis ``g`` of host points."""
    assert root == oracle_msm(g, tree._internal_vector(tree.root)), "root != native oracle"
    inner = [node for node in tree.root.children.values() if hasattr(node, "children")]
    for node in inner[:: max(1, len(inner) // 4)][:4]:
        assert node.commit == oracle_msm(g, tree._internal_vector(node)), "depth-1 node != native oracle"
    if exts is None:
        exts = [ext for node in inner for ext in node.children.values() if hasattr(ext, "stem")]
    for ext in random.Random(64).sample(exts, min(64, len(exts))):
        c1, c2 = tree._ext_leaf_vectors(ext)
        assert ext.c1_commit == oracle_msm(g, c1) and ext.c2_commit == oracle_msm(g, c2)
        assert ext.commit == oracle_msm(g[:4], tree._ext_data_vector(ext)), "extension != native oracle"


def _all_commits(tree) -> list:
    out = []

    def walk(node, path):
        if hasattr(node, "stem"):
            out.append((path, node.commit, node.c1_commit, node.c2_commit))
            return
        out.append((path, node.commit))
        for unit in sorted(node.children):
            walk(node.children[unit], path + (unit,))

    walk(tree.root, ())
    return out


def _device_busy_ms(prof) -> tuple:
    """Union of the CUDA kernel intervals of a profile, in ms, and the
    kernel time by name."""
    import torch

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy, cur_start, cur_end = 0.0, None, None
    for a, b in sorted(spans):
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        busy += cur_end - cur_start
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return busy / 1e3, top


def phase_verkle(dev, crs, leaves: int = 10_000, small_leaves: int = 150, keep=None) -> dict:
    """BASELINE.json config 4 at its published size: a verkle tree with
    32-unit keys and width-256 nodes, 10,000 leaves, committed, 16 present
    and 3 absent keys proved with one multiproof and verified statelessly.
    The committed tree is appended to ``keep`` when one is given."""
    import torch

    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import cuda_scalar_mul as K5
    from verkle_kzg_tpu_torch.schemes import IPA, IPAParams

    keys, values, absent_l = _verkle_inputs(leaves)

    def build():
        return _verkle_build(IPA, crs, 32, keys, values, absent_l)

    t0 = time.perf_counter()
    tree = build()
    insert_s = time.perf_counter() - t0

    sample = keys[:: max(1, len(keys) // 16)][:16]  # bench_all.py:155
    prove_keys = sample + _verkle_absent(keys, absent_l)
    claims = {k: values.get(k) for k in prove_keys}

    ms, counts, k5_lanes = {}, {}, {}
    cuda_lib.reset_launches()
    K5.reset_regimes()
    root = _stage("commit", tree.commitment, ms, counts, k5_lanes)
    proof = _stage("prove", lambda: tree.prove_keys(prove_keys), ms, counts, k5_lanes)
    ok = _stage("verify", lambda: tree.verify_keys(prove_keys, claims, proof), ms, counts, k5_lanes)
    path_launches = dict(cuda_lib.launches)
    path_cuda_launches = dict(cuda_lib.cuda_launches)
    regimes = dict(K5.regime_launches)

    assert ok, "the honest verkle proof was rejected"
    bad = dict(claims)
    bad[sample[3]] += 1
    assert not tree.verify_keys(prove_keys, bad, proof), "a wrong claimed value was accepted"
    assert sorted(m[0] for m in proof.modes.values()) == ["E", "L", "O"] + ["P"] * 16, proof.modes
    assert min(counts["commit"][k] for k in ("K5", "K6", "K7")) > 0, counts["commit"]
    # K2FOLD sums the sparse commits and the verify's 51 commitments, so no K2
    assert min(path_launches[k] for k in ("K1IPA", "FSX", "K1AFF", "K2FOLD", "K3", "K4", "K5", "K6", "K7")) > 0, \
        path_launches
    assert path_launches["K2"] == 0, path_launches
    # the multiproof's passes: two K1MP and one K1QUO; K1 only for the D and
    # E commits' standard form, no inversion on the card
    c = counts["prove"]
    assert (c["K1"], c["K1INV"], c["K1QUO"], c["K1MP"]) == (2, 0, 1, 2), c
    assert tuple(path_launches[k] for k in ("K1", "K1INV", "K1QUO", "K1MP")) == (2, 0, 1, 2), path_launches
    assert regimes["many"] > 0 and regimes["few"] > 0, regimes
    # every conversion of card points to host points is one K1AFF launch
    for name in ms:
        assert counts[name]["K1AFF"] == ms[name]["card_conversions"] > 0, (name, counts[name], ms[name])

    # sampled commitments against the native C++ Pippenger
    _check_verkle_oracle(tree, root, crs.g_host)

    # where the commit's time goes: a profiled commit of a second tree
    from torch.profiler import ProfilerActivity, profile

    again = build()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        assert again.commitment() == root
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = _device_busy_ms(prof)
    # and where the host's share goes: a third tree's commit under cProfile
    from verkle_kzg_tpu_torch.tools.smoke_phases import cprofile_top

    third = build()
    root3, host_split = cprofile_top(third.commitment)
    assert root3 == root
    print("phase 5 commit under cProfile, by cumulative s:", json.dumps(host_split), flush=True)

    # a small tree of the same geometry (a sparse root, a dense depth-1
    # node), on the card and on the CPU path
    cpu = IPAParams(n=crs.n, g_host=crs.g_host, q_host=crs.q_host, domain=crs.domain, device="cpu")
    cpu_small_s = _small_tree_card_vs_cpu(IPA, crs, cpu, 32, keys[:small_leaves], values)

    if keep is not None:
        keep.append(tree)
    return {
        "leaves": leaves,
        "insert_s": insert_s,
        "ms": ms,
        "leaves_per_s": leaves / (ms["commit"]["wall_ms"] / 1e3),
        "launches_per_stage": counts,
        "path_launches": path_launches,
        "path_cuda_launches": path_cuda_launches,
        "k5_regime_launches": regimes,
        "k5_lanes": k5_lanes,
        "queries": len(prove_keys),
        "profiled_commit": {"wall_ms": profiled_wall_ms, "device_busy_ms": busy_ms, "kernel_ms_by_name": top},
        "cprofile_commit": host_split,
        "small_leaves": small_leaves,
        "cpu_plain_commit_small_s": cpu_small_s,
        "root": root,
    }


def _small_tree_card_vs_cpu(scheme, params, cpu_params, key_len, keys, values) -> float:
    """The tree of ``keys`` committed on the card (``params``) and on the
    CPU path (``cpu_params``), every node commitment equal; returns the
    CPU commit's seconds."""
    from verkle_kzg_tpu_torch.verkle import VerkleTree

    small = [VerkleTree(scheme, p, key_len=key_len, ext_width=256) for p in (params, cpu_params)]
    for t in small:
        for k in keys:
            t.insert_single(k, values[k])
    small[0].commitment()
    t0 = time.perf_counter()
    small[1].commitment()
    cpu_s = time.perf_counter() - t0
    assert _all_commits(small[0]) == _all_commits(small[1]), f"{len(keys)}-leaf tree: card != CPU"
    return cpu_s


def phase_verkle_kzg(dev, card: str, leaves: int = 10_000, small_leaves: int = 150, key_lens=(3, 32),
                     keep=None) -> dict:
    """Config 4 over KZG as ``benchmarks/bench_all.py:126-158`` builds it:
    ``kzg_setup(256)`` on the card and a tree of ``leaves`` of its keys at
    each of ``key_lens`` (3, the harness's default, an empty tail; 32, the
    Ethereum geometry, phase 5's keys), each committed, its 16 sampled keys
    (``bench_all.py:155``) and the E, O and L absent keys proved with one
    KZG multiproof and verified, a wrong claim rejected; the root, depth-1
    nodes and 64 extensions against the native C++ Pippenger over the
    Lagrange SRS; at key_len 3 a ``small_leaves`` tree on the card against
    the CPU path (30-45 s of the CPU's plain versions; key_len 32's would
    differ from phase 5's, checked so over the IPA, only in the basis).
    The launches start from 0 before each tree's commit and are read after
    its verify. KZG's verify ends in ``KZG.verify_point`` on the host (a
    G2 scalar multiplication, G1 operations and the pairing product): its
    spans (``protocol.kzg.verify_point``, ``protocol.kzg.pairing``, ``utils/metrics.span``)
    give the verify's share of each. The committed key_len-32 tree is
    appended to ``keep`` when one is given."""
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import cuda_scalar_mul as K5
    from verkle_kzg_tpu_torch.schemes import KZG, KZGParams, kzg_setup
    from verkle_kzg_tpu_torch.utils import metrics

    ms, counts = {}, {}
    _sync(dev)
    cuda_lib.reset_launches()
    params = _stage("setup", lambda: kzg_setup(256, device=dev), ms, counts)
    cpu = KZGParams(size=params.size, lagrange_host=params.lagrange_host, g2=params.g2, domain=params.domain,
                    device="cpu")
    out = {"setup_ms": ms["setup"]}
    for key_len in key_lens:
        keys, values, absent_l = _verkle_inputs(leaves, key_len)
        t0 = time.perf_counter()
        tree = _verkle_build(KZG, params, key_len, keys, values, absent_l)
        insert_s = time.perf_counter() - t0
        sample = keys[:: max(1, len(keys) // 16)][:16]
        prove_keys = sample + _verkle_absent(keys, absent_l)
        claims = {k: values.get(k) for k in prove_keys}

        ms, counts = {}, {}
        _sync(dev)
        cuda_lib.reset_launches()
        K5.reset_regimes()
        root = _stage("commit", tree.commitment, ms, counts)
        proof = _stage("prove", lambda: tree.prove_keys(prove_keys), ms, counts)
        before = metrics.counters()
        ok = _stage("verify", lambda: tree.verify_keys(prove_keys, claims, proof), ms, counts)
        spans = {k: (metrics.counters().get(f"span.protocol.{k}.s", 0.0) - before.get(f"span.protocol.{k}.s", 0.0))
                 * 1e3
                 for k in ("kzg.verify_point", "kzg.pairing")}
        path_launches = dict(cuda_lib.launches)
        regimes = dict(K5.regime_launches)

        assert ok, f"key_len {key_len}: the honest KZG verkle proof was rejected"
        bad = dict(claims)
        bad[sample[3]] += 1
        assert not tree.verify_keys(prove_keys, bad, proof), f"key_len {key_len}: a wrong claim was accepted"
        assert sorted(m[0] for m in proof.modes.values()) == ["E", "L", "O"] + ["P"] * 16, proof.modes
        assert min(counts["commit"][k] for k in ("K5", "K6", "K7")) > 0, counts["commit"]
        assert path_launches["K2"] == 0, path_launches
        # the KZG multiproof: its passes, the D and E commits' standard form,
        # and the out-of-domain prove at t (a sub, the quotient's sub and
        # product, the standard form, one K1INV), as phase 8's
        c = counts["prove"]
        assert (c["K1"], c["K1INV"], c["K1QUO"], c["K1MP"]) == (6, 1, 1, 2), (key_len, c)
        assert regimes["many"] > 0 and regimes["few"] > 0, regimes
        for name in ms:
            assert counts[name]["K1AFF"] == ms[name]["card_conversions"] > 0, (name, counts[name], ms[name])
        _check_verkle_oracle(tree, root, params.lagrange_host)
        cpu_small_s = (_small_tree_card_vs_cpu(KZG, params, cpu, key_len, keys[:small_leaves], values)
                       if key_len == 3 else None)
        rec = {
            "key_len": key_len, "leaves": leaves, "insert_s": insert_s, "ms": ms,
            "leaves_per_s": leaves / (ms["commit"]["wall_ms"] / 1e3),
            "verify_point_ms": spans["kzg.verify_point"], "pairing_ms": spans["kzg.pairing"],
            "verify_point_share": spans["kzg.verify_point"] / ms["verify"]["wall_ms"],
            "pairing_share": spans["kzg.pairing"] / ms["verify"]["wall_ms"],
            "launches_per_stage": {name: {k: v for k, v in c.items() if v} for name, c in counts.items()},
            "path_launches": path_launches, "k5_regime_launches": regimes, "queries": len(prove_keys),
            "small_leaves": small_leaves if cpu_small_s is not None else None,
            "cpu_plain_commit_small_s": cpu_small_s, "root": root,
        }
        print(f"phase 11 verkle over KZG, key_len {key_len}:", json.dumps(rec), f"[{card}]", flush=True)
        out[f"key_len_{key_len}"] = rec
        if keep is not None and key_len == 32:
            keep.append(tree)
    return out


#: Phase 12's writes: new values of present keys, new units in present
#: extensions, new stems splitting an extension, new root children. The
#: counts reach each branch of an insert into a committed tree many times
#: over; they are no source's block of state writes.
WRITE_BLOCK = {"updates": 1000, "units": 100, "splits": 100, "roots": 50}


def _write_block(keys, absent_l, block=WRITE_BLOCK, seed: int = 19) -> dict:
    """A seeded block of writes into a tree of ``_verkle_inputs``' 32-unit
    keys: each kind of ``block`` a list of (stem, unit, value) inserts,
    applied in the order updates, units, splits, roots. Updates: new values
    of present keys, spread over the tree. Units: new units in present
    keys' extensions, four extensions taking five each above unit 127 (so
    their c2 vectors turn dense), the rest one each. Splits: new stems,
    each a new unit 2 under a present (unit 0, unit 1), which split that
    depth-2 extension into a new internal node (``VerkleTree.
    _next_diff_depth``). Roots: new stems under root children that did not
    exist. The mode-E, -O and -L keys of ``_verkle_absent`` stay absent."""
    rng = random.Random(seed)
    tail, last = keys[0][3:], keys[0][-1]  # every key's unit is its tail's last

    def value():
        return rng.randrange(1 << 256)

    out = {"updates": [(k, k[-1], value()) for k in rng.sample(keys, block["updates"])], "units": []}
    hosts = rng.sample(keys[1:], block["units"] - 16)
    for k in hosts[:-4]:
        out["units"].append((k, rng.choice([u for u in range(256) if u != last]), value()))
    for k in hosts[-4:]:
        out["units"] += [(k, u, value()) for u in rng.sample(range(128, 256), 5)]
    unit2 = {k[:2]: k[2] for k in keys}
    pairs = rng.sample(sorted(unit2)[1:], block["splits"])  # not (0, 0): the mode-O key's extension
    out["splits"] = [(s, s[-1], value()) for s in
                     (p + (rng.choice([u for u in range(256) if u != unit2[p]]),) + tail for p in pairs)]
    used = {k[0] for k in keys} | {absent_l[0], 200}  # 200: the mode-E key's root slot
    out["roots"] = [(s, s[-1], value()) for s in
                    ((u0, rng.randrange(256), rng.randrange(256)) + tail
                     for u0 in rng.sample([u for u in range(256) if u not in used], block["roots"]))]
    return out


def _written_nodes(tree, stems) -> tuple:
    """The internal nodes and extensions on the paths of ``stems``, each
    once (what a commit after writes to those stems must commit again),
    and the internal nodes' count by depth."""
    internal, exts, depths = {}, {}, {}
    for stem in stems:
        node, depth = tree.root, 0
        while hasattr(node, "children"):
            if id(node) not in internal:
                internal[id(node)] = node
                depths[depth] = depths.get(depth, 0) + 1
            node, depth = node.children[stem[depth]], depth + 1
        assert node.stem == stem, (stem, node.stem)
        exts[id(node)] = node
    return list(internal.values()), list(exts.values()), depths


def phase_writes(dev, card: str, trees, leaves: int = 10_000, block=WRITE_BLOCK) -> dict:
    """Branch coverage of the re-commit: the writes of ``_write_block``
    (each branch of an insert into a committed tree; a coverage mix, not a
    workload) into committed trees of phase 5's keys: phase 5's over the
    IPA and phase 11's key_len-32 one over KZG. Each is committed again: the dirty counters (``verkle.commit.
    dirty_ext`` / ``dirty_internal``) equal the nodes on the written paths,
    so no clean node is committed again; every node equals that of a tree
    built from scratch with the final contents and committed once; the
    root, depth-1 nodes, 8 re-committed internal nodes and 64 re-committed
    extensions equal the native C++ Pippenger; 16 written keys and the
    three absent ones prove and verify, a wrong claim rejected. The
    launches start from 0 before the re-commit and are read after the
    fresh tree's commit."""
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.schemes import IPA
    from verkle_kzg_tpu_torch.utils import metrics
    from verkle_kzg_tpu_torch.verkle import VerkleTree

    keys, values, absent_l = _verkle_inputs(leaves)
    block_writes = _write_block(keys, absent_l, block)
    writes = [w for kind in ("updates", "units", "splits", "roots") for w in block_writes[kind]]
    contents = {k: {k[-1]: values[k]} for k in keys}  # stem -> its leaves, in insertion order
    contents[absent_l] = {7: 77}
    for stem, unit, v in writes:
        contents.setdefault(stem, {})[unit] = v
    stems = list(dict.fromkeys(stem for stem, _, _ in writes))
    # 6 updated keys, 5 split stems' and 5 new root children's keys; the absent three
    updated = list(dict.fromkeys(stem for stem, _, _ in block_writes["updates"]))
    prove_keys = (updated[:: max(1, len(updated) // 6)][:6]
                  + [w[0] for w in block_writes["splits"][:: max(1, block["splits"] // 5)][:5]]
                  + [w[0] for w in block_writes["roots"][:: max(1, block["roots"] // 5)][:5]]
                  + _verkle_absent(keys, absent_l))
    claims = {k: contents.get(k, {}).get(k[-1]) for k in prove_keys}
    out = {}
    for tree in trees:
        name = "ipa" if tree.scheme is IPA else "kzg"
        old_root = tree.root.commit
        assert old_root is not None, f"{name}: the tree was not committed"
        t0 = time.perf_counter()
        for stem, unit, v in writes:
            tree._insert(tree.root, stem, [(unit, v)], 0)
        writes_ms = (time.perf_counter() - t0) * 1e3
        internal, exts, depths = _written_nodes(tree, stems)
        # the root, the depth-1 nodes written under, one new node a split
        assert sorted(depths) == [0, 1, 2] and (depths[0], depths[2]) == (1, block["splits"]), depths

        ms, counts = {}, {}
        before = metrics.counters()
        _sync(dev)
        cuda_lib.reset_launches()
        root = _stage("recommit", tree.commitment, ms, counts)
        after = metrics.counters()
        dirty = {k: int(after.get(f"verkle.commit.{k}", 0) - before.get(f"verkle.commit.{k}", 0))
                 for k in ("dirty_ext", "dirty_internal")}
        proof = _stage("prove", lambda: tree.prove_keys(prove_keys), ms, counts)
        ok = _stage("verify", lambda: tree.verify_keys(prove_keys, claims, proof), ms, counts)
        # the same contents, inserted into a new tree and committed once
        fresh = VerkleTree(tree.scheme, tree.params, key_len=32, ext_width=256)
        for stem, leaves_of in contents.items():
            fresh._insert(fresh.root, stem, list(leaves_of.items()), 0)
        fresh_root = _stage("fresh_commit", fresh.commitment, ms, counts)
        path_launches = dict(cuda_lib.launches)

        assert root != old_root, f"{name}: the root did not change"
        assert dirty == {"dirty_ext": len(exts), "dirty_internal": len(internal)}, \
            (name, dirty, len(exts), len(internal))
        assert fresh_root == root and _all_commits(fresh) == _all_commits(tree), f"{name}: re-commit != fresh tree"
        assert min(counts["recommit"][k] for k in ("K5", "K6", "K7")) > 0, (name, counts["recommit"])
        assert ok, f"{name}: the honest proof after the writes was rejected"
        bad = dict(claims)
        bad[prove_keys[0]] += 1
        assert not tree.verify_keys(prove_keys, bad, proof), f"{name}: a wrong claim was accepted"
        assert sorted(m[0] for m in proof.modes.values()) == ["E", "L", "O"] + ["P"] * 16, proof.modes
        for stage in ms:
            assert counts[stage]["K1AFF"] == ms[stage]["card_conversions"] > 0, (stage, counts[stage], ms[stage])
        g = tree.params.g_host if name == "ipa" else tree.params.lagrange_host
        _check_verkle_oracle(tree, root, g, exts=exts)
        for node in random.Random(8).sample(internal[1:], min(8, len(internal) - 1)):
            assert node.commit == oracle_msm(g, tree._internal_vector(node)), "re-committed node != native"
        rec = {
            "writes": {kind: len(ws) for kind, ws in block_writes.items()}, "stems_written": len(stems),
            "writes_applied_ms": writes_ms, "ms": ms, "dirty": dirty, "written_internal_by_depth": depths,
            "nodes": len(_all_commits(tree)),
            "launches_per_stage": {stage: {k: v for k, v in c.items() if v} for stage, c in counts.items()},
            "path_launches": {k: v for k, v in path_launches.items() if v}, "root": root,
        }
        print(f"phase 12 block of writes, {name}:", json.dumps(rec), f"[{card}]", flush=True)
        out[name] = rec
    return out


def _multiproof_queries(crs, ipa_data, m: int) -> list:
    """Phase 6's ``m`` queries at seeded domain points of phase 3's vector."""
    from verkle_kzg_tpu_torch.schemes import ProverQuery

    vals, data, commit = ipa_data
    rng = random.Random(1024)
    queries = []
    for _ in range(m):
        z = rng.randrange(crs.domain.size)
        queries.append(ProverQuery(data=data, commit=commit, z=z, y=vals[z]))
    return queries


#: Phase 6's query counts: config 3's first size and the three of the
#: reference harness (``benchmarks/bench_all.py:111-113``, from
#: ``benches/ipa.rs:19,111-159``).
MULTIPROOF_SIZES = (1024, 4096, 16384, 32768)


def phase_multiproof(dev, crs, ipa_data, sizes=MULTIPROOF_SIZES) -> dict:
    """BASELINE.json config 3 (``benchmarks/bench_all.py:103-123``) at each
    of ``sizes``: that many queries at random domain points of the phase-3
    vector, proved and verified. At each size the launches start from 0
    and are read after its verify; the grouped pass's plan (levels of power
    tables, segments, chunks) and the transcript's host time for the
    queries are recorded beside the times. The first size's record is the
    phase's own (phase 10 is held to its D and digest); every size's is
    under ``by_m``."""
    from verkle_kzg_tpu_torch.fiatshamir.transcript import Transcript
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import cuda_multiproof as KM
    from verkle_kzg_tpu_torch.ops import cuda_scalar_mul as K5
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.schemes import IPA, prove_multiproof, verify_multiproof
    from verkle_kzg_tpu_torch.schemes import multiproof as MP

    by_m = {}
    for m in sizes:
        queries = _multiproof_queries(crs, ipa_data, m)
        vq = [q.to_verifier_query() for q in queries]
        prove_multiproof(IPA, crs, queries)  # warm-up

        ms, counts, k5_lanes = {}, {}, {}
        _sync(dev)
        cuda_lib.reset_launches()
        K5.reset_regimes()
        proof = _stage("prove", lambda: prove_multiproof(IPA, crs, queries), ms, counts, k5_lanes)
        ok = _stage("verify", lambda: verify_multiproof(IPA, crs, vq, proof), ms, counts, k5_lanes)
        path_launches = dict(cuda_lib.launches)
        regimes = dict(K5.regime_launches)
        assert ok, f"the honest multiproof of {m} queries was rejected"
        bad = [q.to_verifier_query() for q in queries]
        bad[m // 2].y = (bad[m // 2].y + 1) % R
        assert not verify_multiproof(IPA, crs, bad, proof), f"a wrong y was accepted at {m} queries"
        assert min(path_launches[k] for k in ("K1IPA", "FSX", "K3", "K4", "K5")) > 0, (m, path_launches)
        assert path_launches["K2"] == 0, (m, path_launches)  # E's one lane is no fold
        assert counts["verify"]["K5"] == regimes["few"] == 1, (m, counts["verify"], regimes)  # E's one lane
        # the passes: two K1MP and one K1QUO; K1 only for the D and E commits
        c = counts["prove"]
        assert (c["K1"], c["K1INV"], c["K1QUO"], c["K1MP"]) == (2, 0, 1, 2), (m, c)
        assert tuple(path_launches[k] for k in ("K1", "K1INV", "K1QUO", "K1MP")) == (2, 0, 1, 2), (m, path_launches)
        digest = multiproof_digest(proof)
        with plain_passes():  # the same multiproof through the plain versions of the passes
            twin = prove_multiproof(IPA, crs, queries)
        assert twin.d == proof.d and multiproof_digest(twin) == digest, f"{m} queries: != the plain-pass twin"

        # the grouped pass's plan, and the transcript's O(M) host work alone
        _, plan = KM.plan_segments([q.z for q in queries], [0] * m)
        t0 = time.perf_counter()
        MP._absorb_queries(Transcript("multiproof"), queries)
        absorb_ms = (time.perf_counter() - t0) * 1e3
        by_m[m] = {
            "m": m, "ms": ms, "launches_per_stage": counts, "path_launches": path_launches,
            "k5_regime_launches": regimes, "k5_lanes": k5_lanes, "d": proof.d, "digest": digest,
            "grouped_plan": {"levels": KM.power_levels(plan), "segments": int(plan.seg_len.size),
                             "chunks": int(plan.chunk_seg.size), "longest_segment": int(plan.seg_len.max()),
                             "multi_chunk_segments": int((plan.seg_count > 1).sum())},
            "absorb_queries_wall_ms": absorb_ms,
        }
        summary = {"prove_events_ms": ms["prove"]["events_ms"], "prove_wall_ms": ms["prove"]["wall_ms"],
                   "verify_events_ms": ms["verify"]["events_ms"], "verify_wall_ms": ms["verify"]["wall_ms"],
                   "absorb_queries_wall_ms": absorb_ms, **by_m[m]["grouped_plan"]}
        print(f"phase 6 multiproof: {m} queries", json.dumps(summary), flush=True)
    first = by_m[sizes[0]]
    return {**first, "by_m": {str(m): {k: v for k, v in r.items() if k not in ("d", "k5_lanes")}
                              for m, r in by_m.items()}}


def phase_kzg(dev, card: str, n: int = 256, fk_len: int = 200, small: int = 16, m: int = 1024) -> dict:
    """BASELINE.json config 1, KZG at domain 256 (``benchmarks/bench_all.py``'s
    KZG rows): setup, commit against the native oracle, proofs in and out of
    the domain with their pairings, a tampered commitment, the point ==
    size quirk; NTT round trips; FK all-points proofs over ``fk_len``
    values against the ``n`` single proofs; FK at domain ``small`` on the
    card against the CPU path; and the multiproof of ``m`` queries over KZG
    (config 3, the KZG half). The launch counts start from 0 where that
    path starts and are read where it ends; one ``scalar_mul``, the NTT
    round trips and one G1 NTT timed stage by stage run after it, each
    with its launches counted on its own."""
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.errors import KZGError
    from verkle_kzg_tpu_torch.hostmath.curve import g1_add, g1_generator, g1_mul
    from verkle_kzg_tpu_torch.ops import cuda_g1_chain as G
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import ntt as N
    from verkle_kzg_tpu_torch.params import R, fr_root_of_unity
    from verkle_kzg_tpu_torch.poly import FrVector
    from verkle_kzg_tpu_torch.schemes import (
        DEFAULT_KZG_SECRET, KZG, KZGParams, ProverQuery, kzg_setup, prove_multiproof, verify_multiproof,
    )

    ms, counts = {}, {}
    rng = random.Random(8)
    vals = [rng.randrange(R) for _ in range(n)]
    index, outside = 17, 3 * n

    # the KZG path, through its entry points only: the launch counts start
    # from 0 here and are read where it ends, before the parts below it
    # that call the ops (scalar_mul, the NTTs) or the wrappers themselves
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    params = _stage("setup", lambda: kzg_setup(n, device=dev), ms, counts)
    data = FrVector.from_ints(vals, params.domain, device=dev)
    warm = KZG.commit(params, data)
    KZG.verify(params, warm, index, KZG.prove(params, warm, index, data))
    commit = _stage("commit", lambda: KZG.commit(params, data), ms, counts)
    proof = _stage("prove", lambda: KZG.prove(params, commit, index, data), ms, counts)
    ok = _stage("verify", lambda: KZG.verify(params, commit, index, proof), ms, counts)
    proof_out = _stage("prove_outside", lambda: KZG.prove(params, commit, outside, data), ms, counts)
    ok_out = _stage("verify_outside", lambda: KZG.verify(params, commit, outside, proof_out), ms, counts)
    assert commit == native.g1_msm(params.lagrange_host, vals), "commit != native oracle"
    assert ok and ok_out, "an honest KZG proof was rejected"
    assert proof.y == vals[index] and proof_out.y == data.evaluate(outside)
    assert not KZG.verify(params, g1_add(commit, g1_generator()), index, proof), "a tampered commitment was accepted"
    try:
        KZG.prove(params, commit, n, data)
        raise AssertionError("point == size did not raise KZGError")
    except KZGError:
        pass

    # FK at n over fk_len values (the zero-padded tail) against n single proofs
    fk_data = FrVector.from_ints(vals[:fk_len], params.domain, device=dev)
    fk_commit = KZG.commit(params, fk_data)
    proofs = _stage("fk", lambda: KZG.prove_all_points(params, fk_data), ms, counts)
    singles = _stage("prove_all_singles", lambda: [KZG.prove(params, fk_commit, i, fk_data) for i in range(n)],
                     ms, counts)
    assert [(p.proof, p.y) for p in proofs] == [(p.proof, p.y) for p in singles], "FK != single proofs"
    fk_digest = proofs_digest(proofs)
    assert KZG.verify(params, fk_commit, 0, proofs[0]) and KZG.verify(params, fk_commit, fk_len + 1, proofs[fk_len + 1])

    # FK at domain `small` on the card (held against the CPU path below)
    p_small = kzg_setup(small, device=dev)
    v_small = vals[: small - 3]
    fk_card = _stage(f"fk_{small}", lambda: KZG.prove_all_points(
        p_small, FrVector.from_ints(v_small, p_small.domain, device=dev)), ms, counts)

    # the multiproof of m queries over KZG at domain n
    queries = []
    for _ in range(m):
        z = rng.randrange(n)
        queries.append(ProverQuery(data=data, commit=commit, z=z, y=vals[z]))
    vq = [q.to_verifier_query() for q in queries]
    prove_multiproof(KZG, params, queries)  # warm-up
    mproof = _stage("multiproof_prove", lambda: prove_multiproof(KZG, params, queries), ms, counts)
    mok = _stage("multiproof_verify", lambda: verify_multiproof(KZG, params, vq, mproof), ms, counts)
    assert mok, "the honest KZG multiproof was rejected"
    bad = [q.to_verifier_query() for q in queries]
    bad[m // 2].y = (bad[m // 2].y + 1) % R
    assert not verify_multiproof(KZG, params, bad, mproof), "a wrong y was accepted"

    torch.cuda.synchronize()
    path_launches = dict(cuda_lib.launches)
    assert min(path_launches[k] for k in ("K3", "K4", "K5", "G1SMUL", "G1BFLY", "K1AFF", "K1NTT")) > 0, path_launches
    # (K1, K1INV, K1QUO, K1MP): an in-domain prove is one K1QUO and the MSM's
    # standard form; the out-of-domain one a sub, the quotient's sub and
    # product, the standard form and one K1INV; a multiproof its passes, the
    # D and E commits and the out-of-domain prove at t
    want = {"commit": (1, 0, 0, 0), "prove": (1, 0, 1, 0), "prove_outside": (4, 1, 0, 0),
            "prove_all_singles": (n, 0, n, 0), "multiproof_prove": (6, 1, 1, 2), "multiproof_verify": (0, 0, 0, 0)}
    for name, expect in want.items():
        assert tuple(counts[name][k] for k in ("K1", "K1INV", "K1QUO", "K1MP")) == expect, (name, counts[name])

    # FK: its Fr INTT at N and NTT at 2N one K1NTT each, K1 only for y's standard form
    for name in ("fk", f"fk_{small}"):
        assert (counts[name]["K1NTT"], counts[name]["K1"]) == (2, 1), (name, counts[name])
    # the warm-up commit and prove, the stages above, FK's commit, FK at n and at small
    path_k1 = 2 + 1 + 1 + 4 + 1 + 1 + n + 1 + 2 * 6
    assert tuple(path_launches[k] for k in ("K1", "K1INV", "K1QUO", "K1MP")) == (path_k1, 3, n + 4, 4), path_launches
    # every conversion of card points to host points is one K1AFF launch
    for name in ms:
        assert counts[name]["K1AFF"] == ms[name]["card_conversions"], (name, counts[name], ms[name])

    # the proofs through the plain versions of K1QUO and K1MP
    with plain_passes():
        twin_proof = KZG.prove(params, commit, index, data)
        twin_singles = [KZG.prove(params, fk_commit, i, fk_data) for i in range(n)]
        twin_mp = prove_multiproof(KZG, params, queries)
    assert twin_proof == proof, "the KZG prove != its plain-quotient twin"
    assert proofs_digest(twin_singles) == proofs_digest(singles) == fk_digest, "single proves != plain twins"
    mp_digest = multiproof_digest(mproof)
    assert twin_mp.d == mproof.d and multiproof_digest(twin_mp) == mp_digest, "KZG multiproof != its plain twin"

    # off the path: FK at `small` on the CPU, the card's G1 NTT at `small`
    # against the CPU's
    cpu = KZGParams(size=small, lagrange_host=p_small.lagrange_host, g2=p_small.g2, domain=p_small.domain,
                    device="cpu")
    t0 = time.perf_counter()
    fk_cpu = KZG.prove_all_points(cpu, FrVector.from_ints(v_small, p_small.domain, device="cpu"))
    cpu_fk_s = time.perf_counter() - t0
    assert [(p.proof, p.y) for p in fk_card] == [(p.proof, p.y) for p in fk_cpu], "FK: card != CPU"
    lag_small = C.from_affine(p_small.lagrange_affine)
    assert torch.equal(N.ntt_g1(lag_small).cpu(), N.ntt_g1(lag_small.cpu())), "G1 NTT: card != CPU"

    # one G1 scalar multiplication at n lanes (G1SMUL), against the host
    lag = C.from_affine(params.lagrange_affine)
    ks = [rng.randrange(R) for _ in range(n)]
    sc = F.ints_to_words(ks, dev)
    prod = _stage(f"scalar_mul_{n}", lambda: C.scalar_mul(lag, sc), ms, counts)
    assert C.projective_to_host_points(prod[:4]) == [g1_mul(a, k) for a, k in zip(params.lagrange_host[:4], ks)]

    # NTT round trips; the G1 NTT of the Lagrange SRS is the monomial SRS
    for size in (n, 2 * n):
        coeffs = [rng.randrange(R) for _ in range(size)]
        a = F.ints_to_mont(coeffs, "fr", dev)
        ev = _stage(f"ntt_fr_{size}", lambda: N.ntt_fr(a), ms, counts)
        back = _stage(f"intt_fr_{size}", lambda: N.intt_fr(ev), ms, counts)
        assert torch.equal(back, a), f"Fr NTT round trip at {size}"
        for kind in ("ntt_fr", "intt_fr"):  # one K1NTT a transform, no K1
            c = counts[f"{kind}_{size}"]
            assert (c["K1NTT"], c["K1"]) == (1, 0), (kind, size, c)
        w = fr_root_of_unity(size)
        assert F.mont_to_ints(ev[1:2], "fr") == [sum(c * pow(w, j, R) for j, c in enumerate(coeffs)) % R]
    mono = _stage(f"ntt_g1_{n}", lambda: N.ntt_g1(lag), ms, counts)
    back = _stage(f"intt_g1_{n}", lambda: N.intt_g1(mono), ms, counts)
    assert C.projective_to_host_points(back) == params.lagrange_host, "G1 NTT round trip"
    assert C.projective_to_host_points(mono[:3]) == [
        g1_mul(g1_generator(), pow(DEFAULT_KZG_SECRET, i, R)) for i in range(3)
    ], "G1 NTT of the Lagrange SRS != [s^i G]"

    # where FK's time goes (it runs four G1 NTTs, and its pointwise product
    # is one more scalar_mul of the same kind): one G1 NTT at n, ntt_g1's
    # own loop with a CUDA-event pair around each stage's launch and no
    # synchronize between stages; the device's busy share is the sum of
    # the stages' event times over the host's wall time of that same run
    bitrev, twiddles = N._Plan(n, False).on(dev, False)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in twiddles]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs = lag[bitrev]
    for s, (tw, (start, end)) in enumerate(zip(twiddles, events)):
        start.record()
        xs = G.butterfly(xs, tw, s)
        end.record()
    torch.cuda.synchronize()
    ntt_wall_ms = (time.perf_counter() - t0) * 1e3
    stage_ms = [start.elapsed_time(end) for start, end in events]
    assert torch.equal(xs, mono)

    logn = n.bit_length() - 1
    chain = ("K11", "K2", "G1SMUL", "G1BFLY")
    per = {"scalar_mul": counts[f"scalar_mul_{n}"], "ntt_g1": counts[f"ntt_g1_{n}"],
           "intt_g1": counts[f"intt_g1_{n}"], "fk": counts["fk"]}
    want = {"scalar_mul": (0, 0, 1, 0), "ntt_g1": (0, 0, 0, logn), "intt_g1": (0, 0, 1, logn),
            "fk": (0, 0, 2, 4 * logn + 2)}
    for name, expect in want.items():
        assert tuple(per[name][k] for k in chain) == expect, (name, per[name])
    return {
        "n": n, "fk_len": fk_len, "multiproof_m": m, "ms": ms, "launches_per_stage": counts,
        "path_launches": path_launches,
        "launches_per": {name: {k: v for k, v in c.items() if v} for name, c in per.items()},
        "ntt_g1_events": {"stage_ms": stage_ms, "wall_ms": ntt_wall_ms, "busy_share": sum(stage_ms) / ntt_wall_ms},
        "cpu_plain_fk_small_s": cpu_fk_s, "small": small, "fk_sha256": fk_digest, "multiproof_sha256": mp_digest,
    }


def phase_mesh(dev, card: str, crs, ipa_data, ref: dict, n: int = 1 << 20, lanes: int = 40, width: int = 256,
               ntt_sizes=(256, 512), fk_n: int = 256, fk_len: int = 200, leaves: int = 10_000, m: int = 1024) -> dict:
    """The parallel package at world size 1 over NCCL on the card (gloo
    where ``dev`` is the CPU, for a rehearsal), through ``make_mesh()``:
    ``msm_sharded`` on phase 4's 2^20 points, ``msm_batched_sharded`` and
    ``msm_fixed_base_sharded`` at the dense commit's shape, the Fr and G1
    four-step and its inverse at 256 and 512, FK at 256, phase 5's tree and
    phase 6's multiproof with ``mesh=``. Each path against its unsharded
    twin in this run and against the earlier phase's result in ``ref``
    (phase 5's root, phase 6's D, phase 8's FK digest), and its time beside
    its twin's."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, timeout=datetime.timedelta(seconds=600))
        try:
            return _mesh_paths(dev, card, crs, ipa_data, ref, n, lanes, width, ntt_sizes, fk_n, fk_len, leaves, m)
        finally:
            dist.destroy_process_group()


def _mesh_paths(dev, card, crs, ipa_data, ref, n, lanes, width, ntt_sizes, fk_n, fk_len, leaves, m) -> dict:
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.hostmath.curve import g1_generator, g1_mul
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import msm as M
    from verkle_kzg_tpu_torch.ops import ntt as N
    from verkle_kzg_tpu_torch.parallel import make_mesh
    from verkle_kzg_tpu_torch.parallel import mesh as PM
    from verkle_kzg_tpu_torch.parallel import ntt as PN
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.poly import FrVector
    from verkle_kzg_tpu_torch.schemes import IPA, kzg_setup, prove_multiproof, verify_multiproof
    from verkle_kzg_tpu_torch.schemes.fk import prove_all_points

    mesh = make_mesh() if dev.type == "cuda" else make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device(dev)), mesh
    t0 = time.perf_counter()
    PM.all_gather(mesh, torch.zeros(8, dtype=torch.int32, device=dev))  # the communicator's set-up
    init_ms = (time.perf_counter() - t0) * 1e3

    # the inputs, as phases 4, 5, 6 and 8 make them
    pts = msm_points(n).to(dev)
    rng = random.Random(20)
    ks = [rng.randrange(R) for _ in range(n)]
    sc = F.ints_to_words(ks, dev)
    want = g1_mul(g1_generator(), sum((i + 1) * k for i, k in enumerate(ks)) % R)
    rng = random.Random(10)
    basis = crs.g_affine[:width]
    dense_ks = [[rng.randrange(R) for _ in range(width)] for _ in range(lanes)]
    dense = F.ints_to_words([k for lane in dense_ks for k in lane], dev).reshape(lanes, width, F.WORDS)
    lane_pts = pts[: lanes * width].reshape(lanes, width, 2, F.WORDS)
    fr_in = {s: F.ints_to_mont([rng.randrange(R) for _ in range(s)], "fr", dev) for s in ntt_sizes}
    g1_in = {s: C.from_affine(pts[:s]) for s in ntt_sizes}
    kzg = kzg_setup(fk_n, device=dev)
    rng8 = random.Random(8)  # phase 8's values
    fk_vals = [rng8.randrange(R) for _ in range(fk_n)][:fk_len]
    fk_data = FrVector.from_ints(fk_vals, kzg.domain, device=dev)
    keys, values, absent_l = _verkle_inputs(leaves)
    queries = _multiproof_queries(crs, ipa_data, m)
    vq = [q.to_verifier_query() for q in queries]

    # name -> (the mesh path, its unsharded twin)
    paths = {
        "msm_sharded": (lambda: PM.msm_sharded(pts, sc, mesh), lambda: M.msm_pippenger(pts, sc, c=8)),
        "msm_batched_sharded": (lambda: PM.msm_batched_sharded(lane_pts, dense, mesh),
                                lambda: M.msm_batched(lane_pts, dense, c=8)),
        "msm_fixed_base_sharded": (lambda: PM.msm_fixed_base_sharded(basis, dense, mesh),
                                   lambda: M.msm_fixed_base(basis, dense)),
    }
    for s in ntt_sizes:
        paths[f"ntt_fr_{s}"] = (lambda s=s: PN.ntt_fr_sharded(fr_in[s], mesh), lambda s=s: N.ntt_fr(fr_in[s]))
        paths[f"intt_fr_{s}"] = (lambda s=s: PN.intt_fr_sharded(fr_in[s], mesh), lambda s=s: N.intt_fr(fr_in[s]))
        paths[f"ntt_g1_{s}"] = (lambda s=s: PN.ntt_g1_sharded(g1_in[s], mesh), lambda s=s: N.ntt_g1(g1_in[s]))
        paths[f"intt_g1_{s}"] = (lambda s=s: PN.intt_g1_sharded(g1_in[s], mesh), lambda s=s: N.intt_g1(g1_in[s]))
    paths["fk"] = (lambda: prove_all_points(kzg, fk_data, mesh=mesh), lambda: prove_all_points(kzg, fk_data))
    paths["multiproof_prove"] = (lambda: prove_multiproof(IPA, crs, queries, mesh=mesh),
                                 lambda: prove_multiproof(IPA, crs, queries))

    # the mesh paths once each, with fresh launch counts
    tree = _verkle_build(IPA, crs, 32, keys, values, absent_l, mesh=mesh)
    ms, counts, out = {}, {}, {}
    _sync(dev)
    cuda_lib.reset_launches()
    for name, (fn, _) in paths.items():
        out[name] = _stage(name, fn, ms, counts)
    out["verkle_commit"] = _stage("verkle_commit", tree.commitment, ms, counts)
    proof = out["multiproof_prove"]
    out["multiproof_verify"] = _stage("multiproof_verify", lambda: verify_multiproof(IPA, crs, vq, proof, mesh=mesh),
                                      ms, counts)
    _sync(dev)
    path_launches = dict(cuda_lib.launches)

    # each against its twin, and the earlier phases' results
    host = C.projective_to_host_points
    twin = {name: t() for name, (_, t) in paths.items()}
    assert host(out["msm_sharded"][None]) == host(twin["msm_sharded"][None]) == [want], "msm_sharded != oracle"
    sub = torch.randperm(n, generator=torch.Generator().manual_seed(16))[: 1 << 16].to(dev)
    sub_pts = pts[sub].contiguous()
    got = host(PM.msm_sharded(sub_pts, sc[sub].contiguous(), mesh)[None])
    assert got == [native.g1_msm(host(C.from_affine(sub_pts)), [ks[i] for i in sub.tolist()])], "2^16 != native"
    for name in ("msm_batched_sharded", "msm_fixed_base_sharded"):
        assert host(out[name]) == host(twin[name]), name
    lane_host = host(C.from_affine(lane_pts[0]))
    assert host(out["msm_batched_sharded"][:1]) == [native.g1_msm(lane_host, dense_ks[0])]
    assert host(out["msm_fixed_base_sharded"][-1:]) == [native.g1_msm(crs.g_host[:width], dense_ks[-1])]
    for s in ntt_sizes:
        logn = s.bit_length() - 1
        for kind in ("ntt_fr", "intt_fr"):
            assert torch.equal(out[f"{kind}_{s}"], twin[f"{kind}_{s}"]), (kind, s)
            c = counts[f"{kind}_{s}"]  # a K1NTT a sub-NTT pass, a K1 for the twiddles
            assert (c["K1NTT"], c["K1"]) == (2, 1), (kind, s, c)
        assert torch.equal(PN.intt_fr_sharded(out[f"ntt_fr_{s}"], mesh), fr_in[s]), f"Fr round trip at {s}"
        for kind in ("ntt_g1", "intt_g1"):
            assert host(out[f"{kind}_{s}"]) == host(twin[f"{kind}_{s}"]), (kind, s)
        assert host(PN.intt_g1_sharded(out[f"ntt_g1_{s}"], mesh)) == host(g1_in[s]), f"G1 round trip at {s}"
        # the sub-NTTs: one G1BFLY launch a stage over all the columns
        for kind, smul in (("ntt_g1", 1), ("intt_g1", 3)):
            c = counts[f"{kind}_{s}"]
            assert (c["G1BFLY"], c["G1SMUL"]) == (logn, smul), (kind, s, c)
    logn = fk_n.bit_length() - 1
    assert (counts["fk"]["G1BFLY"], counts["fk"]["G1SMUL"]) == (4 * logn + 2, 7), counts["fk"]
    assert (counts["fk"]["K1NTT"], counts["fk"]["K1"]) == (4, 3), counts["fk"]  # 2 four-steps, y's standard form
    for name in ms:
        assert counts[name]["K1AFF"] == ms[name]["card_conversions"], (name, counts[name], ms[name])
    assert [(p.proof, p.y) for p in out["fk"]] == [(p.proof, p.y) for p in twin["fk"]], "FK: mesh != twin"
    assert proofs_digest(out["fk"]) == ref["fk_sha256"], "FK with the mesh != phase 8's proofs"
    assert out["verkle_commit"] == ref["root"], "the tree with the mesh != phase 5's root"
    assert out["multiproof_prove"].d == twin["multiproof_prove"].d == ref["d"], "multiproof D != phase 6's"
    assert multiproof_digest(out["multiproof_prove"]) == ref["mp_sha256"], "multiproof != phase 6's"
    assert out["multiproof_verify"], "the honest multiproof was rejected on the mesh"
    bad = [q.to_verifier_query() for q in queries]
    bad[m // 2].y = (bad[m // 2].y + 1) % R
    assert not verify_multiproof(IPA, crs, bad, proof, mesh=mesh), "a wrong y was accepted on the mesh"
    assert counts["msm_sharded"]["K3"] == counts["msm_sharded"]["K4"] == 1, counts["msm_sharded"]
    for name in ("msm_batched_sharded", "msm_fixed_base_sharded", "verkle_commit"):
        assert counts[name]["K6"] > 0 and counts[name]["K7"] > 0, (name, counts[name])
    c = counts["multiproof_prove"]
    assert min(c[k] for k in ("K1IPA", "FSX", "K3", "K4")) > 0, c
    assert (c["K1"], c["K1INV"], c["K1QUO"], c["K1MP"]) == (2, 0, 1, 2), c

    # times, the mesh path beside its twin: CUDA events over a few calls in
    # turns (mesh, twin, twin, mesh); the tree by the wall clock
    times = {}
    for name, (fn, tw) in paths.items():
        reps = 1 if name in ("fk", "multiproof_prove") else 5
        a, b, c2, d2 = cuda_ms(fn, reps), cuda_ms(tw, reps), cuda_ms(tw, reps), cuda_ms(fn, reps)
        times[name] = {"mesh_ms": [a, d2], "twin_ms": [b, c2]}
    trees = []
    for shard in (False, True, False):
        t = _verkle_build(IPA, crs, 32, keys, values, absent_l, mesh=mesh if shard else None)
        _sync(dev)
        t0 = time.perf_counter()
        assert t.commitment() == ref["root"]
        _sync(dev)
        trees.append((time.perf_counter() - t0) * 1e3)
    times["verkle_commit"] = {"mesh_wall_ms": [ms["verkle_commit"]["wall_ms"], trees[1]],
                              "twin_wall_ms": [trees[0], trees[2]]}
    times["multiproof_verify"] = {"mesh_ms": [ms["multiproof_verify"]["events_ms"]]}
    for name, rec in times.items():
        rec["launches"] = {k: v for k, v in counts[name].items() if v}
        print("phase 10 mesh:", name, json.dumps(rec), f"[{card}]", flush=True)
    return {"world_size": 1, "comm_init_ms": init_ms, "times": times, "path_launches": path_launches}


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def proofs_digest(proofs) -> str:
    """SHA-256 of a KZG proof list's (proof, y) pairs, as JSON."""
    return hashlib.sha256(json.dumps([(p.proof, p.y) for p in proofs]).encode()).hexdigest()


def k1_counts(phase: dict) -> dict:
    """K1's, K1INV's, K1IPA's, K1QUO's, K1MP's, K1AFF's, K1NTT's and FSX's
    launches in each stage of a phase's record."""
    keys = ("K1", "K1INV", "K1IPA", "K1QUO", "K1MP", "K1AFF", "K1NTT", "FSX")
    return {stage: {k: c[k] for k in keys} for stage, c in phase["launches_per_stage"].items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from verkle_kzg_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from verkle_kzg_tpu_torch.tools import point_regimes as PR

    t0 = time.perf_counter()
    building = PR.probe_build()  # beside the library's sources, one nvcc each
    try:
        cuda_lib.lib()
    except BaseException:
        building.kill()
        building.wait()
        raise
    probe = PR.Probe(building)
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in (cuda_lib.BUILD / "ptxas.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            print("  ptxas:", line.strip(), flush=True)
    print("  probe ptxas:", json.dumps(probe.ptxas), flush=True)

    from verkle_kzg_tpu_torch.schemes import ipa_setup

    t0 = time.perf_counter()
    crs = ipa_setup(256, device=dev)
    print(f"crs: 257 hash-to-curve points in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    cuda_lib.reset_launches()
    kern = phase_kernels(dev, crs, probe)
    phase2_launches = dict(cuda_lib.launches)
    print(f"phase 2 kernels vs plain (exact, tolerance 0; {time.perf_counter() - t0:.1f} s):", json.dumps(kern),
          flush=True)

    t0 = time.perf_counter()
    ipa, ipa_data = phase_ipa(dev, crs)
    print(f"phase 3 ipa@256 ({time.perf_counter() - t0:.1f} s):", json.dumps(ipa), f"[{card}]", flush=True)

    t0 = time.perf_counter()
    msm = phase_msm(dev)
    print(f"phase 4 msm 2^20 ({time.perf_counter() - t0:.1f} s):", json.dumps(msm), f"[{card}]", flush=True)

    t0 = time.perf_counter()
    committed = []  # phase 5's tree, then phase 11's key_len-32 tree: phase 12 writes into them
    verkle = phase_verkle(dev, crs, keep=committed)
    print(f"phase 5 verkle, 10k leaves, Ethereum geometry ({time.perf_counter() - t0:.1f} s):", json.dumps(verkle),
          f"[{card}]", flush=True)
    print("phase 5 K1, K1INV, K1IPA, K1QUO, K1MP, K1AFF, K1NTT and FSX launches per stage:",
          json.dumps(k1_counts(verkle)),
          flush=True)
    print("phase 5 K5 lanes of each call per stage:", json.dumps(verkle["k5_lanes"]), flush=True)

    t0 = time.perf_counter()
    mp = phase_multiproof(dev, crs, ipa_data)
    print(f"phase 6 multiproof, {', '.join(mp['by_m'])} queries at 256 ({time.perf_counter() - t0:.1f} s):",
          json.dumps(mp), f"[{card}]", flush=True)
    print("phase 6 K1, K1INV, K1IPA, K1QUO, K1MP, K1AFF, K1NTT and FSX launches per stage:",
          json.dumps(k1_counts(mp)), flush=True)
    print("phase 6 K5 lanes of each call per stage:", json.dumps(mp["k5_lanes"]), flush=True)

    t0 = time.perf_counter()
    sweep = phase_sweep(dev, card)
    print(f"phase 7 msm sweep: {time.perf_counter() - t0:.1f} s, launches {json.dumps(sweep['path_launches'])}",
          f"[{card}]", flush=True)

    t0 = time.perf_counter()
    kzg = phase_kzg(dev, card)
    print(f"phase 8 kzg@256, fk, kzg multiproof ({time.perf_counter() - t0:.1f} s):", json.dumps(kzg),
          f"[{card}]", flush=True)
    print("phase 8 K1, K1INV, K1IPA, K1QUO, K1MP, K1AFF, K1NTT and FSX launches per stage:",
          json.dumps(k1_counts(kzg)), "path:",
          json.dumps({k: kzg["path_launches"][k] for k in ("K1", "K1INV", "K1QUO", "K1MP", "K1AFF", "K1NTT")}),
          flush=True)

    t0 = time.perf_counter()
    group = phase_group(dev, card)
    print(f"phase 9 tune_group grid ({time.perf_counter() - t0:.1f} s): launches",
          json.dumps(group["path_launches"]), "entry points' launches", json.dumps(group["entry_point_launches"]),
          f"[{card}]", flush=True)

    t0 = time.perf_counter()
    ref = {"root": verkle["root"], "d": mp["d"], "mp_sha256": mp["digest"], "fk_sha256": kzg["fk_sha256"]}
    mesh = phase_mesh(dev, card, crs, ipa_data, ref)
    print(f"phase 10 mesh, world size 1 over NCCL ({time.perf_counter() - t0:.1f} s): launches",
          json.dumps(mesh["path_launches"]), f"communicator set-up {mesh['comm_init_ms']:.1f} ms", f"[{card}]",
          flush=True)

    t0 = time.perf_counter()
    kzg_tree = phase_verkle_kzg(dev, card, keep=committed)
    print(f"phase 11 verkle over KZG, 10k leaves, key_len 3 and 32 ({time.perf_counter() - t0:.1f} s): launches",
          json.dumps({k: r["path_launches"] for k, r in kzg_tree.items() if k.startswith("key_len")}), f"[{card}]",
          flush=True)

    t0 = time.perf_counter()
    writes = phase_writes(dev, card, committed)
    print(f"phase 12 the re-commit's branches, IPA and KZG ({time.perf_counter() - t0:.1f} s): dirty",
          json.dumps({k: r["dirty"] for k, r in writes.items()}), f"[{card}]", flush=True)

    sources = {"K1": "field.cu", "K1INV": "field_inv.cu", "K1IPA": "ipa_round.cu", "K1QUO": "quotient.cu",
               "K1MP": "multiproof.cu", "K1AFF": "affine.cu", "K1NTT": "ntt_fr.cu", "K2": "curve.cu",
               "K2FOLD": "curve.cu", "K3": "msm_sorted.cu", "K4": "msm_tail.cuh",
               "K5": "scalar_mul.cu", "K6": "msm_sorted.cu", "K7": "msm_tail.cuh",
               "K8": "msm_sorted.cu", "K9": "msm_sorted.cu", "K10": "msm_sorted.cu",
               "K11": "curve.cu", "K12": "curve.cu", "K13": "msm_sorted.cu",
               "G1SMUL": "g1_chain.cu", "G1BFLY": "g1_chain.cu", "FSX": "fiat_shamir.cu",
               "FBMSM": "msm_table.cu"}
    replaces = {
        "K1": "verkle_kzg_tpu/ops/pallas_field.py:298",
        # the K1 chain of verkle_kzg_tpu/ops/field.py:327's scan and :342's batch inversion
        "K1INV": "verkle_kzg_tpu/ops/pallas_field.py:298",
        # the K1 chain of verkle_kzg_tpu/schemes/ipa.py:214's round_body
        "K1IPA": "verkle_kzg_tpu/ops/pallas_field.py:298",
        # the K1 chains of verkle_kzg_tpu/poly/lagrange.py:26's _quotient_in_domain
        # and of verkle_kzg_tpu/schemes/multiproof.py:78-129's three programs
        "K1QUO": "verkle_kzg_tpu/ops/pallas_field.py:298",
        "K1MP": "verkle_kzg_tpu/ops/pallas_field.py:298",
        # the K1 work of verkle_kzg_tpu/ops/curve.py:273's to_affine, which :320's
        # projective_to_host_points runs before its read, and of ops/ntt.py:88's _fr_stage
        "K1AFF": "verkle_kzg_tpu/ops/pallas_field.py:298",
        "K1NTT": "verkle_kzg_tpu/ops/pallas_field.py:298",
        "K2": "verkle_kzg_tpu/ops/pallas_curve.py:328",
        # the K2 chain of verkle_kzg_tpu/ops/msm.py:67's fold_reduce_lanes
        "K2FOLD": "verkle_kzg_tpu/ops/pallas_curve.py:328",
        "K3": "verkle_kzg_tpu/ops/pallas_msm.py:700",
        "K4": "verkle_kzg_tpu/ops/pallas_msm.py:1041",
        "K5": "verkle_kzg_tpu/ops/pallas_curve.py:432",
        "K6": "verkle_kzg_tpu/ops/pallas_msm.py:853",
        "K7": "verkle_kzg_tpu/ops/pallas_msm.py:1152",
        "K8": "verkle_kzg_tpu/ops/pallas_msm.py:330",
        "K9": "verkle_kzg_tpu/ops/pallas_msm.py:719",
        "K10": "verkle_kzg_tpu/ops/pallas_msm.py:883",
        "K11": "verkle_kzg_tpu/ops/pallas_curve.py:350",
        "K12": "verkle_kzg_tpu/ops/pallas_curve.py:358",
        "K13": "verkle_kzg_tpu/ops/pallas_msm.py:807",
        # the chain of verkle_kzg_tpu/ops/curve.py:239's scan: double (:350) and add (:328) a bit
        "G1SMUL": "verkle_kzg_tpu/ops/pallas_curve.py:328",
        "G1BFLY": "verkle_kzg_tpu/ops/pallas_curve.py:328",
        # no pallas_call: the jnp digest chain in the fused loop's round body
        # (to_affine, g1_compressed_bytes, hash_to_fr, to_mont)
        "FSX": "verkle_kzg_tpu/schemes/ipa.py:249",
        # no counterpart: the JAX package has no fixed-base table; on the
        # IPA's path it takes the place of K3 + K4
        "FBMSM": "none: replaces K3 + K4 over the IPA CRS",
    }
    # launches: K1, K1IPA, K1QUO, K1MP, K1AFF, FSX, K2FOLD, K3-K7 and FBMSM from the
    # verkle path of phase 5 (commit, prove, verify), which runs all of them; K8-K10 from the
    # sweep of phase 7; K1INV, K1NTT, G1SMUL and G1BFLY from the KZG path of phase 8; K2,
    # K11 and K12 from phase 2, since no path calls the standalone add (its
    # folds are K2FOLD's), double (the scalar multiplication it served is
    # G1SMUL's) or mixed add; K13 from the tune_group grid of phase 9.
    # Timings: each kernel's first record in phase 2; max_abs_err over all
    # of its records (K3 at c = 1, 4, 8; K4 at c = 1, 4, 8, 12, 16; ...).
    path_of = {
        **dict.fromkeys(("K1", "K1IPA", "K1QUO", "K1MP", "K1AFF", "FSX", "K2FOLD", "K3", "K4", "K5", "K6", "K7",
                         "FBMSM"), ("phase 5", verkle["path_launches"])),
        "K1NTT": ("phase 8: FK's two Fr transforms, at 256 and at 16", kzg["path_launches"]),
        "K1INV": ("phase 8: no inversion runs on the card in phase 5 since K1QUO", kzg["path_launches"]),
        "K2": ("phase 2: no op of a path calls curve.add since K2FOLD (the IPA table's build does, once)",
               phase2_launches),
        **dict.fromkeys(("K8", "K9", "K10"), ("phase 7", sweep["path_launches"])),
        "K11": ("phase 2: no op of a path calls curve.double since G1SMUL (the IPA table's build does, once)",
                phase2_launches),
        "K12": ("phase 2 only: no path of either package calls it", phase2_launches),
        **dict.fromkeys(("G1SMUL", "G1BFLY"), ("phase 8", kzg["path_launches"])),
        "K13": ("phase 9", group["path_launches"]),
    }
    cuda_path = {**{k: verkle["path_cuda_launches"][k] for k in ("K3", "K6")},
                 **{k: sweep["path_cuda_launches"][k] for k in ("K8", "K9", "K10")},
                 "K13": group["path_cuda_launches"]["K13"]}
    chains = {"G1SMUL": "verkle_kzg_tpu/ops/curve.py:239", "G1BFLY": "verkle_kzg_tpu/ops/curve.py:239",
              "K1INV": "verkle_kzg_tpu/ops/field.py:327 and verkle_kzg_tpu/ops/field.py:342",
              "K1IPA": "verkle_kzg_tpu/schemes/ipa.py:214", "K2FOLD": "verkle_kzg_tpu/ops/msm.py:67",
              "K1QUO": "verkle_kzg_tpu/poly/lagrange.py:26-40", "K1MP": "verkle_kzg_tpu/schemes/multiproof.py:78-129",
              # K1AFF's chain_ms: the port's host-int conversion it replaced
              "K1AFF": "verkle_kzg_tpu/ops/curve.py:273-284 and :320-329",
              "K1NTT": "verkle_kzg_tpu/ops/ntt.py:88-96",
              "FSX": "verkle_kzg_tpu/schemes/ipa.py:236-252"}
    kernels = []
    for k in sources:
        first = kern[k] if k in kern else kern[min(r for r in kern if r.startswith(k + "@"))]
        mine = [r for r in kern if r == k or r.startswith(k + "@")]
        kernels.append({
            "name": k,
            "route": "cuda",
            "source": f"verkle_kzg_tpu_torch/csrc/{sources[k]}",
            "replaces": replaces[k],
            "launches": path_of[k][1][k],
            "launches_from": path_of[k][0],
            "launches_phase10": mesh["path_launches"][k],
            "max_abs_err": max(kern[r]["max_abs_err"] for r in mine),
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": None,
            **({"chain_ms": first["chain_ms"], "replaces_chain": chains[k]} if k in chains else {}),
            # the sorted accumulations (K3/K9/K8/K10/K6/K13): the main path's
            # CUDA launches and one call's, as the C entry point counted
            # them, and the first record's stage times
            **({"cuda_launches": cuda_path[k], "cuda_launches_per_call": first["cuda_launches"],
                "stages_ms": first["stages_ms"]} if k in cuda_path else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
