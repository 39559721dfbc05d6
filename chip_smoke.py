#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (verkle_kzg_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (the kernels are built from
verkle_kzg_tpu_torch/csrc/ into the git-ignored verkle_kzg_tpu_torch/_build/),
and no JAX. Phases, each of which raises on failure:

  1. the card's name and power limit, and the kernels' build (one nvcc per
     source, in parallel);
  2. each kernel (K1-K13) against its plain PyTorch version on the card, at
     the shapes the main paths give it, exact, with its time and the least
     time the card could take for the same work;
  3. IPA at domain 256 (commit, prove, verify, commitment proof) with its
     checks, launch counts and timings, and a proof at domain 32 on the
     card against the CPU plain path;
  4. one MSM of 2^20 points through msm_auto, against an exact oracle, and
     its rate;
  5. the verkle tree at Ethereum geometry (BASELINE.json config 4: 32-unit
     keys, width-256 nodes, 10,000 leaves): insert, commit, prove 16
     present and 3 absent keys with one multiproof, verify statelessly;
     sampled commitments against the native C++ oracle, a 150-leaf tree on
     the card against the CPU plain path, and a profile of the commit;
  6. the multiproof of 1,024 queries at domain 256 (BASELINE.json config 3);
  7. the single-MSM sweep of BASELINE.json config 5, 2^16-2^22 points, at
     c = 8, 4, 12 and 16 signed, and at 2^20 also unsigned c = 8 and 16 and
     signed c = 5, 10 and 13, each run exact against an oracle;
  8. KZG at domain 256 (BASELINE.json config 1): setup, commit against the
     native oracle, proofs in and out of the domain with their pairings;
     Fr and G1 NTT round trips; FK all-points proofs against the 256 single
     proofs; FK at domain 16 on the card against the CPU path; and the
     1,024-query multiproof over KZG (config 3, the KZG half);
  9. benchmarks/tune_group.py's default grid on the port: the signed
     single MSM of 2^20 points in 128 lanes through the lane-stream entry
     point msm_stream.msm_single_fused with wgroup/fused (K13), against the
     c = 8 msm_pippenger (K3), each run exact; then every other entry point
     of msm_stream once at 2^12 points against the native oracle.

Each of phases 2, 3, 5, 6 and 8, and each run of phases 7 and 9, sets the
launch counts to 0 just before its path and reads them just after. The last two
lines of standard output are the card's name and power limit and a JSON
object {"ok": true, "device": {...}}; the line before them holds the
per-kernel JSON record.
"""

from __future__ import annotations

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


def phase_kernels(dev, crs) -> dict:
    """K1-K13 against their plain versions on the card, exact."""
    import torch

    from verkle_kzg_tpu_torch.hostmath import curve as hc
    from verkle_kzg_tpu_torch.params import FQ, FR, R
    from verkle_kzg_tpu_torch.ops import cuda_curve, cuda_field
    from verkle_kzg_tpu_torch.ops import cuda_msm as K
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
            errs.append(max_abs_err(cuda_field.binop(op, a, b, spec), cuda_field.plain(op, a, b, spec)))
            assert errs[-1] == 0, (spec, op)
    rec["K1"] = {
        "max_abs_err": max(errs),
        "ms": cuda_ms(lambda: cuda_field.binop("mul", a, b, "fq"), 50),
        "plain_ms": cuda_ms(lambda: cuda_field.plain("mul", a, b, "fq"), 3),
        "shape": "2^16 Fq mont_mul",
        **bound(a.numel() * 4 * 3, a.shape[0]),
    }

    # K2: the IPA MSM's first segment fold, 32 x 8 x 128 point pairs, with
    # infinity, P + P and P + (-P) among them.
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(128)) for _ in range(64)]
    n2 = 32 * 8 * 128
    ps = [base[i % 64] for i in range(n2)]
    qs = [base[(7 * i + 3) % 64] for i in range(n2)]
    ps[0], qs[1], ps[2], qs[2], qs[3] = None, None, base[5], base[5], hc.g1_neg(ps[3])
    p = C.from_affine(C.host_points_to_affine(ps, dev))
    q = C.from_affine(C.host_points_to_affine(qs, dev))
    got = cuda_curve.add(p, q)
    rec["K2"] = {"max_abs_err": max_abs_err(got, cuda_curve.plain(p, q)), "shape": "32768 point adds"}
    assert rec["K2"]["max_abs_err"] == 0
    assert C.projective_to_host_points(got[:4]) == [hc.g1_add(a_, b_) for a_, b_ in zip(ps[:4], qs[:4])]
    rec["K2"]["ms"] = cuda_ms(lambda: cuda_curve.add(p, q), 20)
    rec["K2"]["plain_ms"] = cuda_ms(lambda: cuda_curve.plain(p, q), 2)
    rec["K2"].update(bound(3 * p.numel() * 4, n2 * ADD_FMULS))

    # K11 and K12 at K2's shape, on the K2 sums p + q (Z is not 1; the
    # identity at slot 3): doubling them, and adding the affine qs to them
    # (the (0, 0) sentinel at slot 1, identity + (-P) at slot 3).
    pz = got
    sums = C.projective_to_host_points(pz[:6])
    got = cuda_curve.double(pz)
    rec["K11"] = {"max_abs_err": max_abs_err(got, cuda_curve.plain_double(pz)), "shape": "32768 point doublings"}
    assert rec["K11"]["max_abs_err"] == 0
    assert C.projective_to_host_points(got[:6]) == [hc.g1_add(a_, a_) for a_ in sums]
    rec["K11"]["ms"] = cuda_ms(lambda: cuda_curve.double(pz), 20)
    rec["K11"]["plain_ms"] = cuda_ms(lambda: cuda_curve.plain_double(pz), 2)
    rec["K11"].update(bound(2 * pz.numel() * 4, n2 * DOUBLE_FMULS))
    qa = C.host_points_to_affine(qs, dev)
    got = cuda_curve.mixed_add(pz, qa)
    rec["K12"] = {"max_abs_err": max_abs_err(got, cuda_curve.plain_mixed_add(pz, qa)), "shape": "32768 mixed adds"}
    assert rec["K12"]["max_abs_err"] == 0
    assert C.projective_to_host_points(got[:6]) == [hc.g1_add(a_, b_) for a_, b_ in zip(sums, qs[:6])]
    rec["K12"]["ms"] = cuda_ms(lambda: cuda_curve.mixed_add(pz, qa), 20)
    rec["K12"]["plain_ms"] = cuda_ms(lambda: cuda_curve.plain_mixed_add(pz, qa), 2)
    live = int((~C.affine_is_infinity(qa)).sum())  # sentinel lanes do no products
    rec["K12"].update(bound((pz.numel() * 2 + qa.numel()) * 4, live * MIXED_FMULS))
    # K11 and K2 at the width of a G1 NTT stage of FK at domain 256 (256
    # butterflies: a double and an add per bit of the twiddle's product)
    w = pz[:256].contiguous()
    for name, run, plain_fn, nbytes, fmuls in (
        ("K11@256", lambda: cuda_curve.double(w), lambda: cuda_curve.plain_double(w), 2 * w.numel() * 4,
         256 * DOUBLE_FMULS),
        ("K2@256", lambda: cuda_curve.add(w, w.flip(0)), lambda: cuda_curve.plain(w, w.flip(0)), 3 * w.numel() * 4,
         256 * ADD_FMULS),
    ):
        out = run()
        plain_out, plain_ms = timed_once(plain_fn)
        rec[name] = {"max_abs_err": max_abs_err(out, plain_out), "ms": cuda_ms(run, 50), "plain_ms": plain_ms,
                     "shape": "256 points, one G1 NTT stage at domain 256", **bound(nbytes, fmuls)}
        assert rec[name]["max_abs_err"] == 0, name

    # K3 + K4: the 257-point IPA basis shape and 2^12 points, with zero
    # scalars, r - 1 and (0, 0) padding.
    k3_err = k4_err = 0
    for n in (257, 1 << 12):
        pts = [base[i % 64] for i in range(n)]
        pts[1] = None
        ks = [rng.randrange(R) for _ in range(n)]
        ks[0], ks[2], ks[3] = 0, R - 1, 0
        nseg, seg_len = M.segments(n)
        pad = nseg * seg_len - n
        pa = torch.nn.functional.pad(C.host_points_to_affine(pts, dev), (0, 0, 0, 0, 0, pad)).contiguous()
        sc = torch.nn.functional.pad(F.ints_to_words(ks, dev), (0, 0, 0, pad)).contiguous()
        masks = M.signed_carries(sc, 8).contiguous()
        table = K.accumulate(pa, sc, masks, nseg, seg_len)
        k3_err = max(k3_err, max_abs_err(table, K.plain_accumulate(pa, sc, masks, nseg, seg_len)))
        buckets = M.fold_reduce_lanes(table, dim=1)[:, 0].contiguous()
        out = K.tail(buckets)
        plain_out = K.plain_tail(buckets)
        k4_err = max(k4_err, max_abs_err(out, plain_out))
        assert k3_err == 0 and k4_err == 0, n
        assert C.projective_to_host_points(out) == C.projective_to_host_points(plain_out)
        if n == 257:
            want = hc.g1_msm_naive(pts, ks)
            assert C.projective_to_host_points(M.msm_auto(pa[:n], sc[:n])) == [want]
            live = (K.scalar_digits(sc, masks, 8, True) != 0) & ~C.affine_is_infinity(pa)[:, None]
            rec["K3"] = {
                "ms": cuda_ms(lambda: K.accumulate(pa, sc, masks, nseg, seg_len), 20),
                "plain_ms": cuda_ms(lambda: K.plain_accumulate(pa, sc, masks, nseg, seg_len), 2),
                "shape": f"257 points, {nseg} segments",
                **bound(4 * (pa.numel() + sc.numel() + masks.numel() + table.numel()),
                        int(live.sum()) * MIXED_FMULS),
            }
            rec["K4"] = {
                "ms": cuda_ms(lambda: K.tail(buckets), 20),
                "plain_ms": cuda_ms(lambda: K.plain_tail(buckets), 2),
                "shape": "32 x 128 buckets",
                **bound(4 * (buckets.numel() + 24), tail_fmuls(32, 128, 8)),
            }
            rec["msm257"] = {
                "ms": cuda_ms(lambda: M.msm_auto(pa[:n], sc[:n]), 20),
                "plain_k3_k4_ms": rec["K3"]["plain_ms"] + rec["K4"]["plain_ms"],
            }
    rec["K3"]["max_abs_err"] = k3_err
    rec["K4"]["max_abs_err"] = k4_err
    rec.update(_kernels_k5_k7(dev, crs, rng))
    rec.update(_kernels_windows(dev, base, rng))
    rec.update(_kernels_k13(dev, base, rng))
    return rec


def tail_fmuls(w: int, rows: int, c: int) -> int:
    """Montgomery products of K4 on (W, rows) buckets: two adds a row for
    the chunk sums; per combine group of m >= 2 pairs 2 (m - 2) + 1 + m adds
    and 5 doublings a level; Horner (W - 1) (c doublings + 1 add)."""
    from verkle_kzg_tpu_torch.ops import cuda_msm as K

    adds, dbls = w * 2 * rows, 0
    for level, n in enumerate(K.tail_levels(rows)[:-1], start=1):
        for g in range(math.ceil(n / K.CHUNK)):
            m = min(K.CHUNK, n - K.CHUNK * g)
            if m > 1:
                adds += w * (2 * (m - 2) + 1 + m)
                dbls += w * K.LOG2_CHUNK * level
    adds += w - 1
    dbls += (w - 1) * c
    return adds * ADD_FMULS + dbls * DOUBLE_FMULS


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
    points), exact against their plain versions: K3 at c = 1 and 4, K8
    (unsigned, c = 8), K6 unsigned at c = 5 and K10 unsigned at c = 9 on
    ``n`` points, phase 7's smallest size and segmentation; K9 (c = 16), K8
    at c = 16 and K10 at c = 12 signed on ``n_wide`` points, where the 1 GiB
    table cap already gives phase 7's segment counts (21, 10 and 248) and
    only the segment length is shorter. Then K4 on every mode's folded
    tables, signed and unsigned, each tail also against the native oracle.
    A plain version is timed on the one call that is compared."""
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.ops import cuda_msm as K
    from verkle_kzg_tpu_torch.ops import cuda_msm_batched as KB
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
    modes = [  # name, c, signed, route (scalar words or digit tensor), points
        ("K3@c1", 1, True, "words", n), ("K3@c4", 4, True, "words", n), ("K9", 16, True, "words", n_wide),
        ("K8", 8, False, "words", n), ("K8@c16", 16, False, "words", n_wide),
        ("K6@c5-unsigned", 5, False, "digits", n),
        ("K10", 12, True, "digits", n_wide), ("K10@c9-unsigned", 9, False, "digits", n),
    ]
    for name, c, signed, route, m in modes:
        nseg, seg_len = M.segments(m, K.windows(c) * K.rows(c, signed))
        pad = nseg * seg_len - m
        pa = torch.nn.functional.pad(pa_all[:m], (0, 0, 0, 0, 0, pad)).contiguous()
        sc = torch.nn.functional.pad(sc_all[:m], (0, 0, 0, pad)).contiguous()
        dead = C.affine_is_infinity(pa)
        if route == "words":
            masks = M.signed_carries(sc, c).contiguous() if signed else None
            args = (pa, sc, masks, nseg, seg_len, c, signed)
            run, plain = (lambda a=args: K.accumulate(*a)), (lambda a=args: K.plain_accumulate(*a))
            live = int(((K.scalar_digits(sc, masks, c, signed) != 0) & ~dead[:, None]).sum())
            inputs = pa.numel() + sc.numel() + (masks.numel() if signed else 0)
        else:
            digits = (M.window_digits_signed if signed else M.window_digits)(sc, c)
            digits = digits.to(torch.int32)[:, None].contiguous()
            args = (pa, digits, nseg, seg_len, c, signed)
            run, plain = (lambda a=args: KB.accumulate(*a)), (lambda a=args: KB.plain_accumulate(*a))
            live = int(((digits[:, 0] != 0) & ~dead[None, :]).sum())
            inputs = pa.numel() + digits.numel()
        table = run().reshape(K.windows(c), nseg, K.rows(c, signed), 3, 8)
        plain_table, plain_ms = timed_once(plain)
        err = max_abs_err(table, plain_table.reshape(table.shape))
        assert err == 0, name
        del plain_table
        sign = "signed" if signed else "unsigned"
        rec[name] = {
            "max_abs_err": err,
            "ms": cuda_ms(run, 5),
            "plain_ms": plain_ms,
            "library_ms": None,
            "shape": f"{m} points, c = {c}, {sign}, {nseg} segments of {seg_len}",
            **bound(4 * (inputs + table.numel()), live * MIXED_FMULS),
        }
        buckets[(c, signed)] = (M.fold_reduce_lanes(table, dim=1)[:, 0].contiguous(), m)
        del table

    for (c, signed), (bk, m) in buckets.items():
        out = K.tail(bk, c)
        plain_out, plain_ms = timed_once(lambda: K.plain_tail(bk, c))
        err = max_abs_err(out, plain_out)
        assert err == 0 and C.projective_to_host_points(out) == [want[m]], (c, signed)
        sign = "" if signed else "-unsigned"
        rec[f"K4@c{c}{sign}"] = {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: K.tail(bk, c), 5),
            "plain_ms": plain_ms,
            "library_ms": None,
            "shape": f"{bk.shape[0]} x {bk.shape[1]} buckets, c = {c}{'' if signed else ', unsigned'}",
            **bound(4 * (bk.numel() + 24), tail_fmuls(bk.shape[0], bk.shape[1], c)),
        }
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


def _kernels_k5_k7(dev, crs, rng, lanes: int = 40000, batch: int = 40) -> dict:
    """K5 on 2^12 edge-case lanes and at the shape of the verkle commit's
    c1/c2 launch (40,000 lanes over the basis, half of them zero-scalar pad
    lanes, 128-bit leaf halves in the others); K6 and K7 at the dense
    verkle level (width 256, c = 5, 40 lanes) and at width 64 (c = 4)."""
    import torch

    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.ops import cuda_msm_batched as KB
    from verkle_kzg_tpu_torch.ops import cuda_scalar_mul as K5
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import msm as M

    rec = {}
    basis = crs.g_affine  # (256, 2, 8)

    # K5: edge lanes (zero scalars, r - 1, (0, 0) points), then the commit shape
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
        errs.append(max_abs_err(out, K5.plain(pa, sc)))
        assert errs[-1] == 0, n
    hp = C.projective_to_host_points(out[:8])
    gx = [crs.g_host[i] for i in idx[:8].tolist()]
    from verkle_kzg_tpu_torch.hostmath import curve as hc

    assert hp == [hc.g1_mul(g, k) for g, k in zip(gx, ks[:8])], "K5 != host scalar mul"
    rec["K5"] = {
        "max_abs_err": max(errs),
        "ms": cuda_ms(lambda: K5.scalar_mul_affine(pa, sc), 5),
        "plain_ms": cuda_ms(lambda: K5.plain(pa, sc), 1),
        "shape": f"{lanes} lanes, 128-bit scalars on half",
        **bound(4 * (pa.numel() + sc.numel() + out.numel()), _k5_work(pa, ks)),
    }

    # K6 and K7: 40 lanes over the basis, lane 0 all zero, ties in lane 1
    k6_err = k7_err = 0
    b = batch
    for width in (64, 256):
        c = M._auto_c_batched(width)
        ks = [[rng.randrange(R) for _ in range(width)] for _ in range(b)]
        ks[0] = [0] * width
        ks[1][0] = (1 << (c - 1)) | (1 << (c - 1)) << c
        scalars = F.ints_to_words([x for k in ks for x in k], dev).reshape(b, width, 8)
        digits = M.window_digits_signed(scalars, c).to(torch.int32).contiguous()
        nseg, seg_len = M.segments(width)
        pts = basis[:width].contiguous()
        table = KB.accumulate(pts, digits, nseg, seg_len, c)
        k6_err = max(k6_err, max_abs_err(table, KB.plain_accumulate(pts, digits, nseg, seg_len, c)))
        buckets = M.fold_reduce_lanes(table, dim=2)[:, :, 0].contiguous()
        out = KB.tail(buckets, c)
        k7_err = max(k7_err, max_abs_err(out, KB.plain_tail(buckets, c)))
        assert k6_err == 0 and k7_err == 0, width
        from verkle_kzg_tpu_torch import native

        got = C.projective_to_host_points(out[:3])
        assert got == [native.g1_msm(crs.g_host[:width], k) for k in ks[:3]], "K6 + K7 != native oracle"
    w, rows = KB.windows(c), KB.rows(c)
    live = int((digits != 0).sum())
    rec["K6"] = {
        "max_abs_err": k6_err,
        "ms": cuda_ms(lambda: KB.accumulate(pts, digits, nseg, seg_len, c), 20),
        "plain_ms": cuda_ms(lambda: KB.plain_accumulate(pts, digits, nseg, seg_len, c), 1),
        "shape": f"width 256, c = 5, {b} lanes, {nseg} segments",
        **bound(4 * (digits.numel() + pts.numel() + table.numel()), live * MIXED_FMULS),
    }
    adds, dbls = w * 2 * rows + (w - 1), (w - 1) * c
    rec["K7"] = {
        "max_abs_err": k7_err,
        "ms": cuda_ms(lambda: KB.tail(buckets, c), 20),
        "plain_ms": cuda_ms(lambda: KB.plain_tail(buckets, c), 1),
        "shape": f"width 256, c = 5, {b} lanes",
        **bound(4 * (buckets.numel() + out.numel()), b * (adds * ADD_FMULS + dbls * DOUBLE_FMULS)),
    }
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
    """K13 against its plain version on ``n`` points in ``lanes`` lanes
    (zero scalars, r - 1, a (0, 0) point) at each (c, G, fused, sign) of
    K13_CASES; the first case's single MSM also against the native oracle."""
    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.ops import cuda_msm_group as KG
    from verkle_kzg_tpu_torch.ops import curve as C
    from verkle_kzg_tpu_torch.ops import field as F
    from verkle_kzg_tpu_torch.ops import msm_stream as MS

    pts = [base[i % 64] for i in range(n)]
    pts[1] = None
    ks = [rng.randrange(R) for _ in range(n)]
    ks[0], ks[2], ks[3] = 0, R - 1, 0
    pa, sc = C.host_points_to_affine(pts, dev), F.ints_to_words(ks, dev)
    dead = C.affine_is_infinity(pa)
    rec = {}
    for name, c, g, fused, signed in K13_CASES:
        stream, digits = _k13_stream(pa, sc, lanes, c, signed)
        run = lambda: KG.accumulate(stream, digits, c, signed, g, fused)  # noqa: E731
        table = run()
        plain_table, plain_ms = timed_once(lambda: KG.plain_accumulate(stream, digits, c, signed))
        err = max_abs_err(table, plain_table)
        assert err == 0, name
        if name == "K13":
            got = MS.msm_single_fused(stream, digits, c, signed=signed, wgroup=g, fused=fused)
            assert C.projective_to_host_points(got) == [native.g1_msm(pts, ks)], "K13 MSM != native oracle"
        live = int(((digits != 0) & ~dead.reshape(digits.shape[1:])[None]).sum())
        rec[name] = {
            "max_abs_err": err,
            "ms": cuda_ms(run, 5),
            "plain_ms": plain_ms,
            "library_ms": None,
            "shape": f"{n} points, {lanes} lanes, c = {c}, G = {g}, {'fused' if fused else 'unfused'}, "
                     f"{'signed' if signed else 'unsigned'}",
            **bound(4 * (stream.numel() + digits.numel() + table.numel()), live * MIXED_FMULS),
        }
    return rec


def phase_ipa(dev, crs, small: int = 32):
    """IPA at domain 256 on the card: checks, launch counts, timings; and a
    proof at domain ``small`` on the card against the CPU plain path. Also
    returns the data vector and its commitment for phase 6."""
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.fiatshamir.transcript import Transcript
    from verkle_kzg_tpu_torch.hostmath.curve import g1_add, g1_generator
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.poly import Domain, FrVector
    from verkle_kzg_tpu_torch.schemes import IPA, IPAParams

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
    proof = run("prove", lambda: IPA.prove_point(crs, commit, index, data, t_gpu))
    ok = run("verify", lambda: IPA.verify(crs, commit, index, proof))
    proof_out = IPA.prove(crs, commit, outside, data)
    ok_out = IPA.verify(crs, commit, outside, proof_out)
    bad_commit = IPA.verify(crs, g1_add(commit, g1_generator()), index, proof)
    cross = IPA.verify(crs, commit, index, proof_out)
    cproof = IPA.prove_commitment(crs, commit, data)
    cok = IPA.verify_commitment_proof(crs, commit, cproof)
    torch.cuda.synchronize()
    main_path_launches = dict(cuda_lib.launches)

    assert ok and ok_out and cok, "an honest proof was rejected"
    assert not bad_commit and not cross, "a tampered or cross proof was accepted"
    assert proof.y == vals[index] and len(proof.l) == 8
    assert commit == native.g1_msm(crs.g_host, vals), "commit != native oracle"
    assert counts["commit"]["K3"] == 1 and counts["commit"]["K4"] == 1
    assert counts["prove"]["K3"] == 16 and counts["prove"]["K4"] == 16
    assert counts["verify"]["K3"] == 1 and counts["verify"]["K4"] == 1
    assert min(main_path_launches[k] for k in ("K1", "K2", "K3", "K4")) > 0, main_path_launches

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
        "ms": ms,
        "launches_per_call": counts,
        "main_path_launches": main_path_launches,
        "cpu_plain_prove_s": secs[1], "cpu_plain_prove_domain": small,
    }, (vals, data, commit)


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

    # the three stages of one MSM, timed apart
    nseg, seg_len = M.segments(n)
    masks = M.signed_carries(sc, 8).contiguous()
    stage = {
        "signed_carries_ms": cuda_ms(lambda: M.signed_carries(sc, 8), 3),
        "k3_accumulate_ms": cuda_ms(lambda: K.accumulate(pts, sc, masks, nseg, seg_len), 3),
    }
    table = K.accumulate(pts, sc, masks, nseg, seg_len)
    stage["k2_fold_ms"] = cuda_ms(lambda: M.fold_reduce_lanes(table, dim=1), 3)
    buckets = M.fold_reduce_lanes(table, dim=1)[:, 0].contiguous()
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
    after the checked call, points/s, and the launches per kernel of the
    checked call, whose counts start from 0."""
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.hostmath.curve import g1_generator, g1_mul
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.ops import cuda_lib
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
        got = C.projective_to_host_points(out)
        assert got == [want[n]], f"n = {n}, c = {c}, signed = {signed}: != (sum k_i s_i) G"
        if n == small:
            assert got == [native_want], f"n = {n}, c = {c}: != native oracle"
        for k, v in counts.items():
            path_launches[k] += v
        med, reps = _median_ms(run)
        line = {"n": n, "c": c, "signed": signed, "median_ms": med, "reps_ms": reps,
                "points_per_s": n / (med / 1e3), "launches": counts}
        runs.append(line)
        print("phase 7 msm sweep:", json.dumps(line), f"[{card}]", flush=True)
    for k in ("K2", "K3", "K4", "K6", "K8", "K9", "K10"):
        assert path_launches[k] > 0, (k, path_launches)
    return {"setup_s": setup_s, "runs": runs, "path_launches": path_launches}


GROUP_GRID = ((6, 2, False), (6, 2, True), (6, 4, True), (8, 2, False), (8, 2, True), (8, 4, True))


def phase_group(dev, card: str, n: int = 1 << 20, lanes: int = 128, grid=GROUP_GRID, small: int = 1 << 12) -> dict:
    """``benchmarks/tune_group.py``'s default grid on the port: the signed
    single MSM of ``n`` points in ``lanes`` lanes through
    ``msm_stream.msm_single_fused`` with ``wgroup``/``fused`` (K13, K2
    fold, K4; chunk 32 is accepted and has no effect), digits included, as
    tune_group times it; its baseline is ``msm_pippenger`` at c = 8 (K3,
    tune_group's ``prod_sc_pair_c8``). Phase 4's points k G, uniform
    scalars; every run exact against (sum k_i s_i) G. Each run prints the
    median of 3 CUDA-event reps after the checked call, points/s, the
    launches of the checked call, whose counts start from 0, and one call
    of K13 alone. Then each other entry point of ``msm_stream`` once, on
    ``small`` points, against the native oracle."""
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.hostmath.curve import g1_generator, g1_mul
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.ops import cuda_msm_group as KG
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
        line = {"kind": kind, "n": n, **line, "launches": {k: v for k, v in cuda_lib.launches.items() if v}}
        assert C.projective_to_host_points(out) == [want], f"{kind}: != (sum k_i s_i) G"
        line["median_ms"], line["reps_ms"] = _median_ms(fn)
        line["points_per_s"] = n / (line["median_ms"] / 1e3)
        return line

    runs = [checked("prod_sc_pair_c8", lambda: M.msm_pippenger(pts, sc, c=8))]
    print("phase 9 group grid:", json.dumps(runs[0]), f"[{card}]", flush=True)
    path_launches = dict.fromkeys(cuda_lib.launches, 0)
    for c, g, fused in grid:
        def run(c=c, g=g, fused=fused):
            stream, digits = _k13_stream(pts, sc, lanes, c, True)
            return MS.msm_single_fused(stream, digits, c, chunk=32, signed=True, wgroup=g, fused=fused)

        line = checked(f"group_c{c}_g{g}_f{int(fused)}", run, lanes=lanes)
        for k, v in line["launches"].items():
            path_launches[k] += v
        stream, digits = _k13_stream(pts, sc, lanes, c, True)
        line["k13_ms"] = _median_ms(lambda: KG.accumulate(stream, digits, c, True, g, fused), 1)[0]
        runs.append(line)
        print("phase 9 group grid:", json.dumps(line), f"[{card}]", flush=True)
    assert path_launches["K13"] > 0, path_launches

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
    for name, (got, expect) in checks.items():
        assert C.projective_to_host_points(got) == expect, f"{name} != native oracle"
    return {"setup_s": setup_s, "runs": runs, "path_launches": path_launches, "entry_points_checked": list(checks)}


def _stage(name, fn, ms, counts):
    """Run one stage of a path: CUDA-event and wall milliseconds, and the
    launches per kernel it made."""
    import torch

    from verkle_kzg_tpu_torch.ops import cuda_lib

    before = dict(cuda_lib.launches)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    ms[name] = {"events_ms": start.elapsed_time(end), "wall_ms": (time.perf_counter() - t0) * 1e3}
    counts[name] = {k: cuda_lib.launches[k] - before[k] for k in before}
    return out


def _verkle_keys(n: int) -> list:
    """``benchmarks/bench_all.py:142-143``: distinct (unit 0, unit 1) pairs
    with a fixed tail, so sibling stems diverge one level below their parent."""
    tail = tuple((11 * j) % 256 for j in range(32 - 3))
    return [(i // 256, i % 256, (i * 7) % 256) + tail for i in range(n)]


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


def phase_verkle(dev, crs, leaves: int = 10_000, small_leaves: int = 150) -> dict:
    """BASELINE.json config 4 at its published size: a verkle tree with
    32-unit keys and width-256 nodes, 10,000 leaves, committed, 16 present
    and 3 absent keys proved with one multiproof and verified statelessly."""
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.schemes import IPA, IPAParams
    from verkle_kzg_tpu_torch.verkle import VerkleTree

    keys = _verkle_keys(leaves)
    rng = random.Random(10_000)
    values = {k: rng.randrange(1 << 256) for k in keys}
    tail = keys[0][3:]
    absent_e = (200, 0, 0) + tail  # no root child 200: mode E
    absent_o = (0, 0, 1) + tail  # reaches (0, 0, 0)'s extension: mode O
    absent_l = (100, 0, 0) + tail  # an extension of this stem holding only unit 7: mode L

    def build():
        tree = VerkleTree(IPA, crs, key_len=32, ext_width=256)
        for k in keys:
            tree.insert_single(k, values[k])
        tree._insert(tree.root, absent_l, [(7, 77)], 0)  # the multi-value insert surface
        return tree

    t0 = time.perf_counter()
    tree = build()
    insert_s = time.perf_counter() - t0

    sample = keys[:: max(1, len(keys) // 16)][:16]  # bench_all.py:155
    prove_keys = sample + [absent_e, absent_o, absent_l]
    claims = {k: values.get(k) for k in prove_keys}

    ms, counts = {}, {}
    cuda_lib.reset_launches()
    root = _stage("commit", tree.commitment, ms, counts)
    proof = _stage("prove", lambda: tree.prove_keys(prove_keys), ms, counts)
    ok = _stage("verify", lambda: tree.verify_keys(prove_keys, claims, proof), ms, counts)
    path_launches = dict(cuda_lib.launches)

    assert ok, "the honest verkle proof was rejected"
    bad = dict(claims)
    bad[sample[3]] += 1
    assert not tree.verify_keys(prove_keys, bad, proof), "a wrong claimed value was accepted"
    assert sorted(m[0] for m in proof.modes.values()) == ["E", "L", "O"] + ["P"] * 16, proof.modes
    assert min(counts["commit"][k] for k in ("K5", "K6", "K7")) > 0, counts["commit"]
    assert min(path_launches[f"K{i}"] for i in range(1, 8)) > 0, path_launches

    # sampled commitments against the native C++ Pippenger
    g = crs.g_host
    assert root == native.g1_msm(g, tree._internal_vector(tree.root)), "root != native oracle"
    inner = [node for node in tree.root.children.values() if hasattr(node, "children")]
    for node in inner[:: max(1, len(inner) // 4)][:4]:
        assert node.commit == native.g1_msm(g, tree._internal_vector(node)), "depth-1 node != native oracle"
    exts = [ext for node in inner for ext in node.children.values()]
    for ext in random.Random(64).sample(exts, min(64, len(exts))):
        c1, c2 = tree._ext_leaf_vectors(ext)
        assert ext.c1_commit == native.g1_msm(g, c1) and ext.c2_commit == native.g1_msm(g, c2)
        assert ext.commit == native.g1_msm(g[:4], tree._ext_data_vector(ext)), "extension != native oracle"

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

    # a small tree of the same geometry (a sparse root, a dense depth-1
    # node), on the card and on the CPU path
    small_keys = keys[:small_leaves]
    cpu = IPAParams(n=crs.n, g_host=crs.g_host, q_host=crs.q_host, domain=crs.domain, device="cpu")
    small = [VerkleTree(IPA, p, key_len=32, ext_width=256) for p in (crs, cpu)]
    for t in small:
        for k in small_keys:
            t.insert_single(k, values[k])
    small[0].commitment()
    t0 = time.perf_counter()
    small[1].commitment()
    cpu_small_s = time.perf_counter() - t0
    assert _all_commits(small[0]) == _all_commits(small[1]), f"{small_leaves}-leaf tree: card != CPU"

    return {
        "leaves": leaves,
        "insert_s": insert_s,
        "ms": ms,
        "leaves_per_s": leaves / (ms["commit"]["wall_ms"] / 1e3),
        "launches_per_stage": counts,
        "path_launches": path_launches,
        "queries": len(prove_keys),
        "profiled_commit": {"wall_ms": profiled_wall_ms, "device_busy_ms": busy_ms, "kernel_ms_by_name": top},
        "small_leaves": small_leaves,
        "cpu_plain_commit_small_s": cpu_small_s,
    }


def phase_multiproof(dev, crs, ipa_data, m: int = 1024) -> dict:
    """BASELINE.json config 3 (``benchmarks/bench_all.py:103-123``, its first
    size): 1,024 queries at random domain points of the phase-3 vector."""
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.schemes import IPA, ProverQuery, prove_multiproof, verify_multiproof

    vals, data, commit = ipa_data
    rng = random.Random(1024)
    queries = []
    for _ in range(m):
        z = rng.randrange(crs.domain.size)
        queries.append(ProverQuery(data=data, commit=commit, z=z, y=vals[z]))
    vq = [q.to_verifier_query() for q in queries]
    prove_multiproof(IPA, crs, queries)  # warm-up

    ms, counts = {}, {}
    cuda_lib.reset_launches()
    proof = _stage("prove", lambda: prove_multiproof(IPA, crs, queries), ms, counts)
    ok = _stage("verify", lambda: verify_multiproof(IPA, crs, vq, proof), ms, counts)
    path_launches = dict(cuda_lib.launches)
    assert ok, "the honest multiproof was rejected"
    bad = [q.to_verifier_query() for q in queries]
    bad[m // 2].y = (bad[m // 2].y + 1) % R
    assert not verify_multiproof(IPA, crs, bad, proof), "a wrong y was accepted"
    assert min(path_launches[k] for k in ("K1", "K2", "K3", "K4", "K5")) > 0, path_launches
    return {"m": len(queries), "ms": ms, "launches_per_stage": counts, "path_launches": path_launches}


def phase_kzg(dev, card: str, n: int = 256, fk_len: int = 200, small: int = 16, m: int = 1024) -> dict:
    """BASELINE.json config 1, KZG at domain 256 (``benchmarks/bench_all.py``'s
    KZG rows): setup, commit against the native oracle, proofs in and out of
    the domain with their pairings, a tampered commitment, the point ==
    size quirk; NTT round trips; FK all-points proofs over ``fk_len``
    values against the ``n`` single proofs; FK at domain ``small`` on the
    card against the CPU path; and the multiproof of ``m`` queries over KZG
    (config 3, the KZG half). The launch counts start from 0 at the
    phase's start and are read at its end."""
    import torch

    from verkle_kzg_tpu_torch import native
    from verkle_kzg_tpu_torch.errors import KZGError
    from verkle_kzg_tpu_torch.hostmath.curve import g1_add, g1_generator, g1_mul
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

    # NTT round trips; the G1 NTT of the Lagrange SRS is the monomial SRS
    for size in (n, 2 * n):
        coeffs = [rng.randrange(R) for _ in range(size)]
        a = F.ints_to_mont(coeffs, "fr", dev)
        ev = _stage(f"ntt_fr_{size}", lambda: N.ntt_fr(a), ms, counts)
        assert torch.equal(N.intt_fr(ev), a), f"Fr NTT round trip at {size}"
        w = fr_root_of_unity(size)
        assert F.mont_to_ints(ev[1:2], "fr") == [sum(c * pow(w, j, R) for j, c in enumerate(coeffs)) % R]
    lag = C.from_affine(params.lagrange_affine)
    mono = _stage(f"ntt_g1_{n}", lambda: N.ntt_g1(lag), ms, counts)
    back = _stage(f"intt_g1_{n}", lambda: N.intt_g1(mono), ms, counts)
    assert C.projective_to_host_points(back) == params.lagrange_host, "G1 NTT round trip"
    assert C.projective_to_host_points(mono[:3]) == [
        g1_mul(g1_generator(), pow(DEFAULT_KZG_SECRET, i, R)) for i in range(3)
    ], "G1 NTT of the Lagrange SRS != [s^i G]"

    # FK at n over fk_len values (the zero-padded tail) against n single proofs
    fk_data = FrVector.from_ints(vals[:fk_len], params.domain, device=dev)
    fk_commit = KZG.commit(params, fk_data)
    before = dict(cuda_lib.launches)
    proofs = _stage("fk", lambda: KZG.prove_all_points(params, fk_data), ms, counts)
    fk_launches = {k: cuda_lib.launches[k] - before[k] for k in before}
    singles = _stage("prove_all_singles", lambda: [KZG.prove(params, fk_commit, i, fk_data) for i in range(n)],
                     ms, counts)
    assert [(p.proof, p.y) for p in proofs] == [(p.proof, p.y) for p in singles], "FK != single proofs"
    assert KZG.verify(params, fk_commit, 0, proofs[0]) and KZG.verify(params, fk_commit, fk_len + 1, proofs[fk_len + 1])

    # where FK's time goes: the device's busy share of one G1 NTT at n (FK
    # runs four, and its pointwise product is one more scalar_mul of the
    # same kind), from a profile of the card's kernels only
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = N.ntt_g1(lag)
        torch.cuda.synchronize()
        ntt_profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    assert torch.equal(again, mono)
    ntt_busy_ms, ntt_top = _device_busy_ms(prof)

    # FK at domain `small` on the card and on the CPU path, bit for bit
    p_small = kzg_setup(small, device=dev)
    cpu = KZGParams(size=small, lagrange_host=p_small.lagrange_host, g2=p_small.g2, domain=p_small.domain,
                    device="cpu")
    v_small = vals[: small - 3]
    lag_small = C.from_affine(p_small.lagrange_affine)
    assert torch.equal(N.ntt_g1(lag_small).cpu(), N.ntt_g1(lag_small.cpu())), "G1 NTT: card != CPU"
    fk_card = KZG.prove_all_points(p_small, FrVector.from_ints(v_small, p_small.domain, device=dev))
    t0 = time.perf_counter()
    fk_cpu = KZG.prove_all_points(cpu, FrVector.from_ints(v_small, p_small.domain, device="cpu"))
    cpu_fk_s = time.perf_counter() - t0
    assert [(p.proof, p.y) for p in fk_card] == [(p.proof, p.y) for p in fk_cpu], "FK: card != CPU"

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
    assert min(path_launches[k] for k in ("K1", "K2", "K3", "K4", "K5", "K11")) > 0, path_launches
    assert fk_launches["K11"] > 0 and fk_launches["K2"] > 0, fk_launches
    return {
        "n": n, "fk_len": fk_len, "multiproof_m": m, "ms": ms, "launches_per_stage": counts,
        "fk_launches": {k: v for k, v in fk_launches.items() if v}, "path_launches": path_launches,
        "ntt_g1_profiled": {"wall_ms": ntt_profiled_wall_ms, "device_busy_ms": ntt_busy_ms, "kernel_ms_by_name": ntt_top},
        "cpu_plain_fk_small_s": cpu_fk_s, "small": small,
    }


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

    t0 = time.perf_counter()
    cuda_lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in (cuda_lib.BUILD / "ptxas.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    from verkle_kzg_tpu_torch.schemes import ipa_setup

    t0 = time.perf_counter()
    crs = ipa_setup(256, device=dev)
    print(f"crs: 257 hash-to-curve points in {time.perf_counter() - t0:.1f} s", flush=True)

    cuda_lib.reset_launches()
    kern = phase_kernels(dev, crs)
    phase2_launches = dict(cuda_lib.launches)
    print("phase 2 kernels vs plain (exact, tolerance 0):", json.dumps(kern), flush=True)

    ipa, ipa_data = phase_ipa(dev, crs)
    print("phase 3 ipa@256:", json.dumps(ipa), f"[{card}]", flush=True)

    msm = phase_msm(dev)
    print("phase 4 msm 2^20:", json.dumps(msm), f"[{card}]", flush=True)

    verkle = phase_verkle(dev, crs)
    print("phase 5 verkle, 10k leaves, Ethereum geometry:", json.dumps(verkle), f"[{card}]", flush=True)

    mp = phase_multiproof(dev, crs, ipa_data)
    print("phase 6 multiproof, 1024 queries at 256:", json.dumps(mp), f"[{card}]", flush=True)

    t0 = time.perf_counter()
    sweep = phase_sweep(dev, card)
    print(f"phase 7 msm sweep: {time.perf_counter() - t0:.1f} s, launches {json.dumps(sweep['path_launches'])}",
          f"[{card}]", flush=True)

    t0 = time.perf_counter()
    kzg = phase_kzg(dev, card)
    print(f"phase 8 kzg@256, fk, kzg multiproof ({time.perf_counter() - t0:.1f} s):", json.dumps(kzg),
          f"[{card}]", flush=True)

    t0 = time.perf_counter()
    group = phase_group(dev, card)
    print(f"phase 9 tune_group grid ({time.perf_counter() - t0:.1f} s): launches",
          json.dumps(group["path_launches"]), f"[{card}]", flush=True)

    sources = {"K1": "field.cu", "K2": "curve.cu", "K3": "msm_accumulate.cuh", "K4": "msm.cu",
               "K5": "scalar_mul.cu", "K6": "msm_batched.cu", "K7": "msm_batched.cu",
               "K8": "msm_accumulate.cuh", "K9": "msm_accumulate.cuh", "K10": "msm_batched.cu",
               "K11": "curve.cu", "K12": "curve.cu", "K13": "msm_group.cu"}
    replaces = {
        "K1": "verkle_kzg_tpu/ops/pallas_field.py:298",
        "K2": "verkle_kzg_tpu/ops/pallas_curve.py:328",
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
    }
    # launches: K1-K7 from the verkle path of phase 5 (commit, prove,
    # verify), which runs all seven; K8-K10 from the sweep of phase 7; K11
    # from the KZG path of phase 8; K12 from phase 2, since no path of
    # either package calls the standalone mixed add; K13 from the
    # tune_group grid of phase 9.
    # Timings: each kernel's first record in phase 2; max_abs_err over all
    # of its records (K3 at c = 1, 4, 8; K4 at c = 1, 4, 8, 12, 16; ...).
    path_of = {
        **dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6", "K7"), ("phase 5", verkle["path_launches"])),
        **dict.fromkeys(("K8", "K9", "K10"), ("phase 7", sweep["path_launches"])),
        "K11": ("phase 8", kzg["path_launches"]),
        "K12": ("phase 2 only: no path of either package calls it", phase2_launches),
        "K13": ("phase 9", group["path_launches"]),
    }
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
            "max_abs_err": max(kern[r]["max_abs_err"] for r in mine),
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
