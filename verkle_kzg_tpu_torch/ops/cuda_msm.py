"""Kernels K3, K8, K9 and K4: the single-MSM bucket accumulation with
in-kernel digits, and the single-MSM tail at any window width.

The accumulation is ONE ``__global__`` in ``csrc/msm_accumulate.cuh``,
templated on the window width c in {1, 2, 4, 8, 16} (c divides 16, so a
digit lies inside one 32-bit scalar word) and on the digit sign, with its
signed and unsigned instances built from ``csrc/msm_signed.cu`` and
``csrc/msm_unsigned.cu`` in parallel. Its segment walk is the one K6 and
K10 run too (``accumulate_segment``); only the digit fetch differs. Its
launches are counted under the name of the TPU kernel each instance
replaces, all in ``verkle_kzg_tpu/ops/pallas_msm.py``:

  * K3, signed, c in {1, 2, 4, 8}: the launch at line 700,
    ``_accum_kernel_sc_signed_pair`` (helpers ``_gather_scatter_step_pair``,
    ``_negate_y_sel``); c = 8 is the default single MSM;
  * K9, signed, c = 16: the launch at line 719, ``_accum_kernel_sc_signed``;
  * K8, unsigned: the launch at line 330, ``_accum_kernel_sc``.

Window w's digit is bits [w c, w c + c) of the scalar words. Signed, it is
then balanced with the packed carry bits of ``ops/msm.py::signed_carries``
(carry-in bit w, carry-out bit w + 1, read from ``nwords`` words), and y is
negated where d < 0. Either sign adds the point into row |d| - 1 of a table
of ``rows(c, signed)`` rows: 2^(c-1) signed, 2^c - 1 unsigned (digit 0 adds
nothing), so the tail reads one layout, row i = the bucket of i + 1. (The
TPU's unsigned kernel kept 2^c rows with a trash row 0.)

The TPU has no scatter, so each of its lanes kept a private bucket column
and every step gathered and scattered the whole table with masks, two
windows interleaved for latency where the tables fit in VMEM. Hopper
scatters freely, so here the point stream is cut into S segments and one
thread owns one (window, segment) pair with its own table in global memory,
(W, S, rows, 3, 8) in all; pairing windows buys nothing there. A step is one
row read, one lazy mixed add (11 Montgomery products) and one row write. The
kernel is bound by those products (integer throughput) and by the latency
of its scattered 96-byte row accesses. S is chosen (``ops/msm.py::segments``)
so that the W * S threads fill the card's 132 SMs (S = 1024 at 2^20 points
and c = 8), under a cap on the tables' bytes: at c = 16 a table is 2^15 or
2^16 rows, so S stays near 10-20 and each thread walks a long segment,
which bounds the wide windows by the latency of one thread's chain. K2 then
folds the S partial tables (``ops/msm.py``).

K4 replaces ``pallas_msm._single_tail``'s second launch (line 1041), with
bodies ``_suffix_horner_kernel`` and ``_window_sum``: per window the
weighted sum sum_i (i + 1) B_i, then Horner from the top window down (c
doublings, then an add), output reduced. Its rows are cut into chunks of
32. A thread per (window, chunk) runs the suffix sum from the chunk's top
row, keeping S = sum of the rows seen and T = sum of the running S, so
T = sum_j (j + 1) B_j over the chunk. The chunk pairs (S_k, T_k) are then
combined 32 at a time by

    sum_i (i + 1) B_i = sum_k T_k + 32 sum_k k S_k,

with sum_k k S_k by the same suffix rule over the chunk sums, level after
level (one launch each, a thread per (window, group), the weight 32 growing
32-fold a level), until one pair per window remains; one thread then runs
Horner. The depth is 64 + about 100 a level dependent point operations for
the window sums (two levels at c = 16) and W c doublings plus W adds for
Horner, about 270-290 at any c: the kernel is bound by that serial chain's
latency, which no width hides. At c = 8 there are 4 chunks and one level,
so the order of additions is that of a single 4-chunk window sum.

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

CHUNK = 32  # K4: rows a thread sums, and pairs a combine step takes
LOG2_CHUNK = 5
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


def launch_key(c: int, signed: bool) -> str:
    """The TPU counterpart an accumulation launch is counted under."""
    if not signed:
        return "K8"
    return "K9" if c == 16 else "K3"


def _check_c(c: int) -> None:
    if c not in IN_KERNEL_C:
        raise ValueError(f"in-kernel digits need c dividing 16, got {c}")


def scalar_digits(sc, masks, c: int, signed: bool) -> torch.Tensor:
    """The digits the kernel derives: (n, 8) standard scalars (and, signed,
    (n, nwords) carry words) -> (n, W) int64; signed d_w = raw digit w +
    carry-in bit w - (carry-out bit w + 1) << c, unsigned the raw digit."""
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


def plain_tables(pts, digits, base, nrows: int) -> torch.Tensor:
    """The accumulation every bucket kernel (K3, K6, K8, K9, K10) runs, as
    its plain version: table thread t walks the points base[t] + i, i < L,
    of the (P, 2, 8) affine stream, adding point base[t] + i into row
    |digits[t, i]| - 1 with the lazy mixed add, y negated for a negative
    digit; digit 0 and the (0, 0) sentinel add nothing. (T, L) int64
    digits -> (T, nrows, 3, 8) reduced tables.

    The tables stay in the kernel's int32 word layout and a step widens
    only the rows it touches, and only the touched rows are reduced at the
    end (an untouched row holds the identity, already reduced): a table is
    up to 2^16 rows, and the plain versions run on the CPU."""
    dev = pts.device
    t, seg_len = digits.shape
    table = C.infinity((t, nrows), dev)
    touched = torch.zeros((t, nrows), dtype=torch.bool, device=dev)
    live_pt = ~C.affine_is_infinity(pts)
    for i in range(seg_len):
        pidx = base + i
        d = digits[:, i]
        idx = ((d != 0) & live_pt[pidx]).nonzero().flatten()
        if not idx.numel():
            continue
        di, p = d[idx], F.to_limbs(pts[pidx[idx]])
        neg_y = F.sub16(torch.zeros_like(p[:, 1]), p[:, 1], "fq")
        q = torch.stack([p[:, 0], torch.where((di < 0)[:, None], neg_y, p[:, 1])], dim=-2)
        row = di.abs() - 1
        new = C.mixed_add16(F.to_limbs(table[idx, row]), q, lazy=True)
        table[idx, row] = F.from_limbs(new)
        touched[idx, row] = True
    ti, ri = touched.nonzero(as_tuple=True)
    table[ti, ri] = F.from_limbs(C.reduce16(F.to_limbs(table[ti, ri])))
    return table


def plain_accumulate(pts, sc, masks, nseg: int, seg_len: int, c: int = 8, signed: bool = True) -> torch.Tensor:
    """The plain version of K3 / K8 / K9: (S*L, 2, 8) affine x (S*L, 8)
    standard scalars x (S*L, nwords) carry words (None unsigned) ->
    (W, S, rows, 3, 8) reduced bucket tables, one per (window, segment)."""
    _check_c(c)
    w = windows(c)
    d = scalar_digits(sc, masks, c, signed).reshape(nseg, seg_len, w).permute(2, 0, 1)  # (W, S, L)
    base = (torch.arange(nseg, device=pts.device) * seg_len).repeat(w)
    table = plain_tables(pts, d.reshape(w * nseg, seg_len), base, rows(c, signed))
    return table.reshape(w, nseg, rows(c, signed), 3, 8)


def accumulate(pts, sc, masks, nseg: int, seg_len: int, c: int = 8, signed: bool = True) -> torch.Tensor:
    if pts.device.type == "cpu":
        return plain_accumulate(pts, sc, masks, nseg, seg_len, c, signed)
    _check_c(c)
    n = nseg * seg_len
    if pts.shape != (n, 2, 8) or sc.shape != (n, 8):
        raise ValueError("msm accumulate: shapes do not match the segmentation")
    if signed and (masks is None or masks.shape != (n, mask_words(c))):
        raise ValueError("msm accumulate: signed digits need (n, nwords) carry words")
    tensors = (pts, sc, masks) if signed else (pts, sc)
    cuda_lib.require_cuda("msm.accumulate", *tensors)
    table = torch.empty((windows(c), nseg, rows(c, signed), 3, 8), dtype=torch.int32, device=pts.device)
    err = cuda_lib.lib().vkzg_msm_accumulate(
        pts.data_ptr(), sc.data_ptr(), masks.data_ptr() if signed else 0, table.data_ptr(),
        nseg, seg_len, c, int(signed), cuda_lib.stream(pts),
    )
    cuda_lib.check(err, "vkzg_msm_accumulate")
    cuda_lib.launches[launch_key(c, signed)] += 1
    return table


def tail_levels(nrows: int) -> list:
    """Pairs per window entering each K4 launch: the chunk count, then each
    combine level's group count, down to 1."""
    sizes = [math.ceil(nrows / CHUNK)]
    while sizes[-1] > 1:
        sizes.append(math.ceil(sizes[-1] / CHUNK))
    return sizes


def _chunk_pairs(buckets: torch.Tensor) -> torch.Tensor:
    """K4's first launch: (W, rows, 3, 8) -> (W, K, 2, 3, 8) lazy (S, T) per
    chunk of 32 rows, the suffix sum from the chunk's top row."""
    w, nrows = buckets.shape[:2]
    k = math.ceil(nrows / CHUNK)
    pad = k * CHUNK - nrows
    b = torch.cat([buckets, C.infinity((w, pad), buckets.device)], dim=1) if pad else buckets
    b = b.reshape(w, k, CHUNK, 3, 8)
    valid = (torch.arange(k * CHUNK, device=b.device) < nrows).reshape(k, CHUNK)
    s = C.infinity((w, k), b.device)
    t = s
    for j in range(CHUNK - 1, -1, -1):
        v = valid[None, :, j, None, None]
        s = torch.where(v, C.add_sparse(s, b[:, :, j], lazy=True), s)
        t = torch.where(v, C.add_sparse(t, s, lazy=True), t)
    return torch.stack([s, t], dim=2)


def _combine(pairs: torch.Tensor, level: int) -> torch.Tensor:
    """A K4 combine launch: (W, n, 2, 3, 8) pairs over groups of 2^(5 level)
    rows -> (W, ceil(n / 32), 2, 3, 8). A group of m >= 2 pairs gives
    S = sum_k S_k and T = sum_k T_k + 2^(5 level) sum_k k S_k, the second sum
    by the suffix rule from the top pair; a group of one pair is copied."""
    w, n = pairs.shape[:2]
    g = math.ceil(n / CHUNK)
    pad = g * CHUNK - n
    dev = pairs.device
    if pad:
        pairs = torch.cat([pairs, C.infinity((w, pad, 2), dev)], dim=1)
    x = pairs.reshape(w, g, CHUNK, 2, 3, 8)
    m = (n - torch.arange(g, device=dev) * CHUNK).clamp(max=CHUNK)  # pairs per group
    top = (m - 1)[None, :, None, None].expand(w, g, 3, 8)
    u = x[:, :, :, 0].gather(2, top[:, :, None]).squeeze(2)
    v = u
    for k in range(CHUNK - 2, 0, -1):
        on = (k < m - 1)[None, :, None, None]
        u = torch.where(on, C.add_sparse(u, x[:, :, k, 0], lazy=True), u)
        v = torch.where(on, C.add_sparse(v, u, lazy=True), v)
    u = C.add_sparse(u, x[:, :, 0, 0], lazy=True)
    vl = F.to_limbs(v)
    for _ in range(LOG2_CHUNK * level):
        vl = C.double16(vl, lazy=True)
    v = F.from_limbs(vl)
    for k in range(CHUNK):
        on = (k < m)[None, :, None, None]
        v = torch.where(on, C.add_sparse(v, x[:, :, k, 1], lazy=True), v)
    single = (m == 1)[None, :, None, None, None]
    return torch.where(single, x[:, :, 0], torch.stack([u, v], dim=2))


def plain_tail(buckets: torch.Tensor, c: int = 8) -> torch.Tensor:
    """K4's plain version: (W, rows, 3, 8) reduced buckets (row i = the
    bucket of digit i + 1) -> (3, 8) reduced projective
    sum_w 2^(c w) sum_i (i + 1) B_wi."""
    pairs = _chunk_pairs(buckets)
    level = 1
    while pairs.shape[1] > 1:
        pairs = _combine(pairs, level)
        level += 1
    sums = F.to_limbs(pairs[:, 0, 1])
    acc = sums[-1]
    for win in range(sums.shape[0] - 2, -1, -1):
        for _ in range(c):
            acc = C.double16(acc, lazy=True)
        acc = C.add16(acc, sums[win], lazy=True)
    return F.from_limbs(C.reduce16(acc))


def tail(buckets: torch.Tensor, c: int = 8) -> torch.Tensor:
    if buckets.device.type == "cpu":
        return plain_tail(buckets, c)
    w, nrows = buckets.shape[:2]
    if not 1 <= c <= 16 or buckets.shape != (windows(c), nrows, 3, 8) or nrows < 1:
        raise ValueError("msm tail: buckets must be (ceil(256 / c), rows, 3, 8)")
    cuda_lib.require_cuda("msm.tail", buckets)
    sizes = tail_levels(nrows)
    first = torch.empty((w, sizes[0], 2, 3, 8), dtype=torch.int32, device=buckets.device)
    second = torch.empty((w, sizes[1] if len(sizes) > 1 else 1, 2, 3, 8), dtype=torch.int32, device=buckets.device)
    out = torch.empty((3, 8), dtype=torch.int32, device=buckets.device)
    err = cuda_lib.lib().vkzg_msm_tail(
        buckets.data_ptr(), first.data_ptr(), second.data_ptr(), out.data_ptr(),
        w, nrows, c, cuda_lib.stream(buckets),
    )
    cuda_lib.check(err, "vkzg_msm_tail")
    # one count per tail, which is len(sizes) + 1 CUDA launches: the chunk
    # sums, one per combine level, and Horner
    cuda_lib.launches["K4"] += 1
    return out
