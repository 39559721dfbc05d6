"""Kernel K4, the single-MSM tail at any window width, and what the
single-MSM accumulations share: the window count and rows of a width and
the digits of the scalar words.

The accumulations are elsewhere: K3, K9 and K8 (signed and unsigned
digits from the scalar words, c dividing 16) and K6, K10 and K13 (a digit
tensor) are one bucket-sorted design (``cuda_msm_sorted.py``). A window of
width c has 2^(c-1) bucket rows for balanced signed digits and 2^c - 1 for
unsigned ones, row i the bucket of digit +-(i + 1), so the tail reads one
layout for both. (The TPU's unsigned kernel kept 2^c rows with a trash row
0.)

K4 replaces ``pallas_msm._single_tail``'s second launch (line 1041), with
bodies ``_suffix_horner_kernel`` and ``_window_sum``: per window the
weighted sum T_w = sum_i (i + 1) B_wi, then Horner from the top window down
(c doublings, then an add), output reduced. K7 (``cuda_msm_batched.py``)
computes the same per lane, and both run ONE tail, ``csrc/msm_tail.cuh``,
over buckets (W, B, rows, 3, 8), K4 with B = 1; the two keep their launch
counts, one per tail, since they stand for two TPU kernels.

Horner's c (W - 1) doublings and W - 1 adds are one dependent chain that
no order of the sums shortens, so the tail is bound by the time of one
dependent point operation times that chain, plus the depth of the window
sums; the products themselves are a small share of the card's rate. The
design cuts both:

  * the window sums in log depth: a window's rows are cut into runs of
    :func:`run_len` rows (4 at 128 rows), a lane sums one run from its top
    row (S = the rows seen, T = the sum of the running S), and a warp
    combines GROUP = 32 runs in a five-level tree that keeps
    X = sum_k k S_k beside S and T, so that T + L X is the group's weighted
    sum; windows of more than 32 runs take more levels of the same combine
    over the groups (:func:`tail_levels`); windows of fewer runs share a
    warp, so that K7's 40 lanes of 52 windows of 4 runs fill 260 warps;
  * Horner on a warp, each RCB16 step's independent products (4 + 4 a
    doubling, 6 + 6 an add) on separate lanes.

A tail of at most 1,024 rows a window (c <= 11 signed, c <= 10 unsigned)
is one CUDA launch, in which the warp that completes a lane's windows runs
its Horner; wider ones take a launch per combine level and one for Horner
(:func:`tail_launches`).

Every plain version follows its kernel's order of additions and domain
(lazy, reduced at the end), so kernel and plain version agree bit for bit.
The plain tail adds in another order than the JAX double suffix scan, so
against the JAX package only the group element is compared.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib
from . import curve as C
from . import field as F

GROUP = 32  # the tail: items (runs of rows, or a level's pairs) a warp combines
IN_KERNEL_C = (1, 2, 4, 8, 16)  # widths whose digits lie in one scalar word


def windows(c: int) -> int:
    return math.ceil(256 / c)


def rows(c: int, signed: bool) -> int:
    """Bucket rows per window: |d| in [1, 2^(c-1)] signed, d in [1, 2^c - 1]
    unsigned, row |d| - 1 (``pallas_msm.signed_table_size`` for signed)."""
    return 1 << (c - 1) if signed else (1 << c) - 1


def mask_words(c: int) -> int:
    """Carry words per scalar (``ops/msm.py::carry_mask_words`` of W)."""
    return windows(c) // 32 + 1


def scalar_digits(sc, masks, c: int, signed: bool) -> torch.Tensor:
    """The digits a kernel derives from the scalar words: (n, 8) standard
    scalars (and, signed, (n, nwords) carry words) -> (n, W) int64; signed
    d_w = raw digit w + carry-in bit w - (carry-out bit w + 1) << c,
    unsigned the raw digit."""
    dev = sc.device
    w = windows(c)
    v = sc.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 32, c, device=dev)
    raw = ((v[..., None] >> shifts) & ((1 << c) - 1)).reshape(-1, w)
    if not signed:
        return raw
    mv = masks.to(torch.int64) & 0xFFFFFFFF
    bits = ((mv[..., None] >> torch.arange(32, device=dev)) & 1).reshape(raw.shape[0], -1)
    return raw + bits[:, :w] - (bits[:, 1 : w + 1] << c)


def run_len(nrows: int) -> int:
    """Rows of one run of the tail's window sums: 32 runs a window up to
    1,024 rows, at least 4 rows and at most 32 a run."""
    return min(32, max(4, (1 << (nrows - 1).bit_length()) // GROUP))


def tail_levels(nrows: int) -> list:
    """(items per window, log2 rows per item) entering each combine level of
    the tail: the runs, then the groups of 32 of the level before, until
    one group spans a window."""
    log2 = run_len(nrows).bit_length() - 1
    levels = [(-(-nrows >> log2), log2)]
    while levels[-1][0] > GROUP:
        levels.append((math.ceil(levels[-1][0] / GROUP), levels[-1][1] + 5))
    return levels


def tail_launches(nrows: int) -> int:
    """CUDA launches of one tail: one, with Horner in it, when a group spans
    a window; else a launch per combine level and one for Horner."""
    n = len(tail_levels(nrows))
    return 1 if n == 1 else n + 1


_BATCH = 512  # points a plain group-law call takes: CPU limb arithmetic is fastest near this


def _batched(fn, *xs: torch.Tensor) -> torch.Tensor:
    """fn over (..., 3, 16) limbs in pieces of at most _BATCH points."""
    flat = [x.reshape(-1, 3, F.LIMBS) for x in xs]
    n = flat[0].shape[0]
    if n <= _BATCH:
        return fn(*xs)
    out = torch.cat([fn(*(f[i : i + _BATCH] for f in flat)) for i in range(0, n, _BATCH)])
    return out.reshape(xs[0].shape)


def _add16(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return _batched(lambda a, b: C.add16(a, b, lazy=True), p, q)


def _double16(p: torch.Tensor) -> torch.Tensor:
    return _batched(lambda a: C.double16(a, lazy=True), p)


def _live(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rows where p or q (limbs) is not the identity's words: RCB16 maps a
    pair of them, and a doubling of one, to the identity's words again, so
    the plain tail skips those rows (wide tables are mostly identity)."""
    inf = C.infinity16((), p.device)
    return ~((p == inf).flatten(-2).all(-1) & (q == inf).flatten(-2).all(-1))


def _add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Lazy p + q on (..., 3, 16) limbs, computed only on live rows."""
    live = _live(p, q)
    if bool(live.all()):
        return _add16(p, q)
    out = p.clone()
    idx = live.nonzero(as_tuple=True)
    if idx[0].numel():
        out[idx] = _add16(p[idx], q[idx])
    return out


def _double(p: torch.Tensor, k: int) -> torch.Tensor:
    """k lazy doublings on (..., 3, 16) limbs, identity rows skipped."""
    if k == 0:
        return p
    idx = _live(p, p).nonzero(as_tuple=True)
    out = p.clone()
    q = p[idx]
    for _ in range(k):
        q = _double16(q)
    out[idx] = q
    return out


def _runs(x: torch.Tensor, log2_run: int) -> tuple:
    """The tail's first step on (W, B, rows, 3, 16) limbs: per run of
    2^log2_run rows (the last may be shorter), from its top row down,
    S = the rows seen and T = the sum of the running S, both starting at
    the top row. -> S, T (W, B, runs, 3, 16)."""
    w, b, nrows = x.shape[:3]
    size = 1 << log2_run
    n = -(-nrows >> log2_run)
    if n * size > nrows:
        x = torch.cat([x, C.infinity16((w, b, n * size - nrows), x.device)], dim=2)
    x = x.reshape(w, b, n, size, 3, F.LIMBS)
    top_last = nrows - 1 - (n - 1) * size  # the last run's top row
    s = x[:, :, :, size - 1].clone()
    s[:, :, n - 1] = x[:, :, n - 1, top_last]
    t = s.clone()
    for j in range(size - 2, -1, -1):
        k = n if j < top_last else n - 1  # runs with row j below their top
        if k:
            s[:, :, :k] = _add(s[:, :, :k], x[:, :, :k, j])
            t[:, :, :k] = _add(t[:, :, :k], s[:, :, :k])
    return s, t


def _combine(s: torch.Tensor, t: torch.Tensor, log2_len: int) -> tuple:
    """One combine level on (W, B, n, 3, 16) items (S, T), each over
    2^log2_len rows: a warp's tree over each group of up to 32 items. Node
    (S, T, X) over items [a, a + h) with X = sum_k (k - a) S_k; merging a
    full left node of h items with its right node gives
    E = X_r + h S_r (h S_r alone for a one-item right node), S = S_l + S_r,
    T = T_l + T_r and X = X_l + E (E at h = 1); the root gives
    T + 2^log2_len X. -> S, T (W, B, ceil(n / 32), 3, 16)."""
    w, b, n = s.shape[:3]
    g = math.ceil(n / GROUP)
    dev = s.device
    pad = g * GROUP - n
    if pad:
        s = torch.cat([s, C.infinity16((w, b, pad), dev)], dim=2)
        t = torch.cat([t, C.infinity16((w, b, pad), dev)], dim=2)
    s = s.reshape(w, b, g, GROUP, 3, F.LIMBS)
    t = t.reshape(w, b, g, GROUP, 3, F.LIMBS)
    x = torch.zeros_like(s)
    m = (n - torch.arange(g, device=dev) * GROUP).clamp(max=GROUP)  # items per group
    h = 1
    while h < GROUP:
        left = torch.arange(0, GROUP, 2 * h, device=dev)
        gi, li = (left[None, :] + h < m[:, None]).nonzero(as_tuple=True)
        if not gi.numel():
            break
        lo, hi = left[li], left[li] + h
        e = _double(s[:, :, gi, hi], h.bit_length() - 1)
        has_x = (m[gi] - hi).clamp(max=h) >= 2
        if bool(has_x.any()):
            e[:, :, has_x] = _add(x[:, :, gi[has_x], hi[has_x]], e[:, :, has_x])
        if h == 1:
            s_new, t_new = _add(torch.stack([s[:, :, gi, lo], t[:, :, gi, lo]]),
                                torch.stack([s[:, :, gi, hi], t[:, :, gi, hi]])).unbind(0)
            x_new = e
        else:
            s_new, t_new, x_new = _add(torch.stack([s[:, :, gi, lo], t[:, :, gi, lo], x[:, :, gi, lo]]),
                                       torch.stack([s[:, :, gi, hi], t[:, :, gi, hi], e])).unbind(0)
        s[:, :, gi, lo], t[:, :, gi, lo], x[:, :, gi, lo] = s_new, t_new, x_new
        h *= 2
    s, t, x = s[:, :, :, 0], t[:, :, :, 0], x[:, :, :, 0]
    multi = m >= 2
    if bool(multi.any()):
        t[:, :, multi] = _add(t[:, :, multi], _double(x[:, :, multi], log2_len))
    return s, t


def plain_tail(buckets: torch.Tensor, c: int = 8) -> torch.Tensor:
    """The plain version of the tail of K4 and K7: (W, rows, 3, 8) -> (3, 8),
    or (W, B, rows, 3, 8) -> (B, 3, 8); reduced buckets (row i = the bucket
    of digit i + 1) to the reduced projective sum_w 2^(c w) sum_i (i + 1) B_wi
    of each lane. The window sums in the kernel's order (runs, then each
    combine level's tree), vectorised over windows, lanes, groups and runs;
    then Horner from the top window, c lazy doublings and a lazy add."""
    single = buckets.dim() == 4
    x = F.to_limbs(buckets[:, None] if single else buckets)
    levels = tail_levels(x.shape[2])
    s, t = _runs(x, levels[0][1])
    for _, log2_len in levels:
        s, t = _combine(s, t, log2_len)
    sums = t[:, :, 0]  # (W, B, 3, 16)
    acc = sums[-1]
    for win in range(sums.shape[0] - 2, -1, -1):
        for _ in range(c):
            acc = C.double16(acc, lazy=True)
        acc = C.add16(acc, sums[win], lazy=True)
    out = F.from_limbs(C.reduce16(acc))
    return out[0] if single else out


def launch_tail(buckets: torch.Tensor, c: int, key: str, parts: int = 3, sums=None) -> tuple:
    """Launch the tail of K4 (key "K4", B = 1) or K7 on (W, B, rows, 3, 8)
    CUDA buckets: the window sums (parts 1, into ``sums``), Horner (parts 2,
    from ``sums``) or both (3). -> (out (B, 3, 8), sums (B, W, 3, 8)).
    Counts one launch of ``key`` a call."""
    w, b, nrows = buckets.shape[:3]
    dev = buckets.device
    levels = tail_levels(nrows)

    def scratch(i):
        if i + 1 >= len(levels):
            return None
        return torch.empty((w, b, levels[i + 1][0], 2, 3, 8), dtype=torch.int32, device=dev)

    pairs_a, pairs_b = scratch(0), scratch(1)
    if sums is None:
        sums = torch.empty((b, w, 3, 8), dtype=torch.int32, device=dev)
    # In a one-launch tail the warps count each lane's finished windows here,
    # and the warp that finishes the last runs that lane's Horner: zeros of
    # its own for each call, so tails on other streams never share them.
    counters = torch.zeros(b, dtype=torch.int32, device=dev)
    out = torch.empty((b, 3, 8), dtype=torch.int32, device=dev)
    ptrs = [buckets.data_ptr(), 0 if pairs_a is None else pairs_a.data_ptr(),
            0 if pairs_b is None else pairs_b.data_ptr(), sums.data_ptr(), counters.data_ptr(),
            out.data_ptr()]
    log2_run = levels[0][1]
    if key == "K4":
        err = cuda_lib.lib().vkzg_msm_tail(*ptrs, w, nrows, log2_run, c, parts, cuda_lib.stream(buckets))
    else:
        err = cuda_lib.lib().vkzg_msm_batched_tail(*ptrs, w, b, nrows, log2_run, c, parts,
                                                   cuda_lib.stream(buckets))
    cuda_lib.check(err, f"{key} tail")
    cuda_lib.launches[key] += 1
    return out, sums


def tail(buckets: torch.Tensor, c: int = 8) -> torch.Tensor:
    if buckets.device.type == "cpu":
        return plain_tail(buckets, c)
    nrows = buckets.shape[1]
    if not 1 <= c <= 16 or buckets.shape != (windows(c), nrows, 3, 8) or nrows < 1:
        raise ValueError("msm tail: buckets must be (ceil(256 / c), rows, 3, 8)")
    cuda_lib.require_cuda("msm.tail", buckets)
    return launch_tail(buckets[:, None], c, "K4")[0][0]
