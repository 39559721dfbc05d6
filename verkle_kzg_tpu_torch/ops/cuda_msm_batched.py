"""Kernels K6, K10 and K7: the digit-tensor Pippenger accumulation and the
lane-batched tail.

A batch of B independent MSMs, each lane its own MSM over N points: the
dense verkle node commits (``verkle/tree.py::_dense_commit`` ->
``ops/msm.py::msm_fixed_base``, the 256-point basis shared by every lane)
and ``msm_batched`` (points per lane), with the balanced signed digits of
``ops/msm.py::window_digits_signed``, c in [2, 7]. The single MSM at a
width whose digits are not taken in the kernel (c in {3, 5, 6, 7, 9 ...
15}, ``ops/msm.py::msm_pippenger``) runs the same accumulation with one
lane, signed or unsigned (``window_digits``). A window has ``rows(c,
signed)`` bucket rows, row |d| - 1 holding the bucket of digit +-|d|: the
kernel never reads the sign of the mode, only of each digit. Its launches
count as K6 up to 128 rows and as K10 above (c >= 9), after the two TPU
kernels the JAX package chose between by table size.

K6 replaces ``verkle_kzg_tpu/ops/pallas_msm.py``: the launch at line 853 in
``_bucket_accumulate_impl`` with body ``_accum_kernel_pair`` (helpers
``_gather_scatter_step_pair``, ``_negate_y_sel``). The TPU cannot scatter,
so each of its lanes kept a private bucket column and every step gathered
and scattered the whole table with masks, two windows interleaved for
latency. Hopper scatters freely, so here one thread owns one (window,
lane, point segment) with its own 2^(c-1)-row table in global memory
(16 rows x 96 bytes at c = 5): a step reads the row |d| - 1, does one lazy
mixed add (11 Montgomery products) with y negated for d < 0 and writes the
row back; the rows are reduced at the end (the segment walk
``accumulate_segment`` of ``csrc/msm_accumulate.cuh``, shared with K3, K8
and K9, which take their digits from the scalar words). A verkle level of 40 dense
nodes at width 256 is only W x B = 52 x 40 = 2,080 (window, lane) pairs,
under one warp per SM, so the point stream is cut into segments as K3
does (``ops/msm.py::segments``, 16 at N = 256) and K2 folds the partial
tables. The kernel is bound by the latency of its scattered 96-byte row
accesses and of the serial mixed adds of a segment more than by multiply
throughput.

K10 is the same kernel over wider tables, and replaces the launch at line
883, ``_accum_kernel`` (the unpaired window). The TPU kept a table in VMEM,
so it could not pair windows past 8 MiB of tables; a table here lives in
global memory at any size (2^14 signed or 2^15 - 1 unsigned rows at
c = 15), so the only cost of a wide window is its bytes, which
``ops/msm.py::segments`` caps by taking fewer segments. Its plain version
is ``cuda_msm.plain_tables``, shared with K3, K8 and K9.

K7 replaces the launch at line 1152, ``_batched_tail_kernel``: per lane,
each window's weighted bucket sum sum_i (i + 1) B_i, then Horner from the
top window (c doublings, then an add), output reduced. One block per lane,
one thread per window for the weighted sums (2 x 2^(c-1) lazy adds each,
in parallel), then thread 0 runs Horner's W (c + 1) dependent point
operations (about 312 at width 256), which bound the kernel by latency,
whatever B is. It takes any row count and c in [2, 16] (at most 128
windows, one block): the batched MSMs give it 2^(c-1) signed rows, c in
[2, 7]; ``msm_stream.batched_bucket_tail`` also 2^c - 1 unsigned ones.

Both plain versions follow their kernel's order of additions and domain
(lazy, reduced at the end), so kernel and plain version agree bit for bit.
The tail adds in another order than the JAX double suffix scan, so against
the JAX package only the group element is compared.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib
from . import cuda_msm as K
from . import curve as C
from . import field as F


def windows(c: int) -> int:
    return math.ceil(256 / c)


def rows(c: int, signed: bool = True) -> int:
    """Bucket rows per window (``pallas_msm.signed_table_size`` signed;
    2^c - 1 unsigned, digit d in row d - 1, as ``cuda_msm.rows``)."""
    return K.rows(c, signed)


def launch_key(c: int, signed: bool) -> str:
    """K6 while a table has at most 128 rows (the TPU's window-paired
    ``_accum_kernel_pair``), K10 beyond (its unpaired ``_accum_kernel``,
    taken when a paired table would pass the VMEM cap, ``pallas_msm.py:838``)."""
    return "K6" if rows(c, signed) <= 128 else "K10"


def _check_c(c: int) -> None:
    if not 2 <= c <= 16:
        raise ValueError(f"the batched MSM tail takes c in [2, 16], got {c}")


def plain_accumulate(pts, digits, nseg: int, seg_len: int, c: int, signed: bool = True) -> torch.Tensor:
    """The plain version of K6 / K10: (S*L, 2, 8) shared or (B, S*L, 2, 8)
    per-lane affine points x (W, B, S*L) int32 digits (balanced signed, or
    unsigned in [0, 2^c)) -> (W, B, S, rows, 3, 8) reduced bucket tables."""
    w, b, n = digits.shape
    dev = digits.device
    d = digits.to(torch.int64).reshape(w * b * nseg, seg_len)
    lane = torch.arange(b, device=dev)[:, None] * (0 if pts.dim() == 3 else n)
    base = (lane + torch.arange(nseg, device=dev)[None, :] * seg_len).flatten().repeat(w)
    table = K.plain_tables(pts.reshape(-1, 2, 8), d, base, rows(c, signed))
    return table.reshape(w, b, nseg, rows(c, signed), 3, 8)


def accumulate(pts, digits, nseg: int, seg_len: int, c: int, signed: bool = True) -> torch.Tensor:
    if pts.device.type == "cpu" and digits.device.type == "cpu":
        return plain_accumulate(pts, digits, nseg, seg_len, c, signed)
    if not 1 <= c <= 16:
        raise ValueError(f"the bucket accumulation takes c in [1, 16], got {c}")
    w, b, n = digits.shape
    shared = pts.dim() == 3
    if n != nseg * seg_len or w != windows(c) or pts.shape != ((n, 2, 8) if shared else (b, n, 2, 8)):
        raise ValueError("msm_batched accumulate: shapes do not match the segmentation")
    cuda_lib.require_cuda("msm_batched.accumulate", pts, digits)
    table = torch.empty((w, b, nseg, rows(c, signed), 3, 8), dtype=torch.int32, device=pts.device)
    if table.numel():
        err = cuda_lib.lib().vkzg_msm_batched_accumulate(
            pts.data_ptr(), 0 if shared else n * 16, digits.data_ptr(), table.data_ptr(),
            w, b, nseg, seg_len, rows(c, signed), cuda_lib.stream(pts),
        )
        cuda_lib.check(err, "vkzg_msm_batched_accumulate")
        cuda_lib.launches[launch_key(c, signed)] += 1
    return table


def plain_tail(buckets: torch.Tensor, c: int) -> torch.Tensor:
    """K7's plain version: (W, B, rows, 3, 8) reduced buckets (row i = the
    bucket of digit i + 1; 2^(c-1) rows for signed digits, 2^c - 1 for
    unsigned ones) -> (B, 3, 8) reduced projective, per lane
    sum_w 2^(cw) sum_i (i + 1) B_wi."""
    _check_c(c)
    w, b, nrows = buckets.shape[:3]
    bk = F.to_limbs(buckets)
    s = C.infinity16((w, b), buckets.device)
    t = s
    for j in range(nrows - 1, -1, -1):
        s = C.add16(s, bk[:, :, j], lazy=True)
        t = C.add16(t, s, lazy=True)
    acc = t[w - 1]
    for win in range(w - 2, -1, -1):
        for _ in range(c):
            acc = C.double16(acc, lazy=True)
        acc = C.add16(acc, t[win], lazy=True)
    return F.from_limbs(C.reduce16(acc))


def tail(buckets: torch.Tensor, c: int) -> torch.Tensor:
    if buckets.device.type == "cpu":
        return plain_tail(buckets, c)
    _check_c(c)
    w, b, nrows = buckets.shape[:3]
    if buckets.shape != (windows(c), b, nrows, 3, 8) or nrows < 1:
        raise ValueError("msm_batched tail: buckets must be (ceil(256 / c), B, rows, 3, 8)")
    cuda_lib.require_cuda("msm_batched.tail", buckets)
    out = torch.empty((b, 3, 8), dtype=torch.int32, device=buckets.device)
    if b:
        err = cuda_lib.lib().vkzg_msm_batched_tail(
            buckets.data_ptr(), out.data_ptr(), w, b, nrows, c, cuda_lib.stream(buckets)
        )
        cuda_lib.check(err, "vkzg_msm_batched_tail")
        cuda_lib.launches["K7"] += 1
    return out
