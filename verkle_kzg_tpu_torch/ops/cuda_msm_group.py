"""Kernel K13: the window-grouped bucket accumulation over a lane stream.

K13 replaces ``verkle_kzg_tpu/ops/pallas_msm.py``: the launch at line 807
in ``_bucket_accumulate_impl`` with body ``_accum_kernel_group`` (431-563),
taken by the ``wgroup=``/``fused=`` arguments of ``bucket_accumulate`` and
``msm_single_fused`` (``ops/msm_stream.py`` here). A lane stream is B
independent point streams of S steps, step i of lane b at point i B + b
of ``(S, B, 2, 8)`` affine words; digits ``(W, S, B)`` int32. Each (window,
lane) is one bucket chain: its points in step order, each added with the
lazy mixed add into row |d| - 1 (balanced signed digits, 2^(c-1) rows) or
d - 1 (unsigned, 2^c - 1 rows), y negated for d < 0, digit 0 and the
(0, 0) sentinel adding nothing; the rows are reduced at the end. The
tables come out as ``(W, B, rows, 3, 8)``, the layout of K6/K10 with one
segment a lane.

The TPU kernel gave a grid cell G windows of a lane block and interleaved
their chains in one loop body, since one chain's serial Montgomery
products left its vector unit idle; it kept the G tables in VMEM and, as
it cannot scatter, gathered and scattered the whole table with masks every
step (``fused`` merged step i's scatter with step i + 1's gather into one
pass). Hopper scatters freely, so here one thread owns one (window group,
lane) with G private tables in global memory: a step loads the lane's
point once (64 bytes, coalesced across neighbouring lanes, as are the G
digits) and runs the G lazy mixed adds as independent dependency chains,
instruction-level parallelism against the latency of one chain. ``fused``
on this card issues the loads of step i + 1's G rows before step i's
arithmetic and forwards a row from registers where d_j(i + 1) hits the row
step i wrote. Neither G nor ``fused`` changes any bucket's order of
additions, so every (G, fused) gives the same words, and the same words
as K6's table walk over one segment a lane (up to 128 rows a window; K10
sorts wider ones, and agrees on group elements); one plain version serves
them all.

G is compiled for 1 to 4 (times ``fused``): a larger G runs as groups of
at most 4 (:func:`group_width`), with the same values. A W that G does
not divide leaves the last group's extra chains inert, as the TPU's
all-zero padding windows were.

Bound: operations. At c = 8, 2^20 points, W n = 33.5 M lazy mixed adds of
11 Montgomery products (264 32-bit multiplies each) take 5.8 ms at the
SMs' integer rate (``chip_smoke.py``'s ``bound``); the stream is 64 MiB of
points and 128 MiB of digits, 0.06 ms. The kernel runs ceil(W / G) B
threads (1,024-2,816 at 128 lanes), each a chain of S dependent steps
(8,192 at 2^20 points), so it is bound by the latency of that chain, which
G's independent chains and the fused row loads shorten; cutting each
lane's stream into segments folded by K2, as K6 does, would fill more of
the 132 SMs and is not done here.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib
from . import cuda_msm_batched as KB

GROUP_MAX = 4  # compiled window groups: G in [1, 4]


def group_width(wgroup: int) -> int:
    """The compiled group a ``wgroup`` runs as: G itself up to 4, else the
    widest even split into groups of at most 4 (6 -> 3, 8 -> 4, 9 -> 3)."""
    if wgroup < 1:
        raise ValueError(f"wgroup must be at least 1, got {wgroup}")
    return math.ceil(wgroup / math.ceil(wgroup / GROUP_MAX))


def plain_accumulate(pts_stream, digits, c: int, signed: bool = True) -> torch.Tensor:
    """K13's plain version, for every (G, fused): (S, B, 2, 8) x (W, S, B)
    -> (W, B, rows, 3, 8) reduced, the chain of each (window, lane) in
    step order (``cuda_msm.plain_tables`` through K6's plain version, at
    any width, one segment a lane)."""
    s = pts_stream.shape[0]
    lanes = pts_stream.transpose(0, 1).contiguous()
    return KB.plain_accumulate(lanes, digits.permute(0, 2, 1), 1, s, c, signed)[:, :, 0]


def accumulate(pts_stream, digits, c: int, signed: bool = True, wgroup: int = 2,
               fused: bool = False) -> torch.Tensor:
    """(S, B, 2, 8) affine lane stream x (W, S, B) int32 digits -> (W, B,
    rows, 3, 8) reduced bucket tables, G = ``wgroup`` windows a thread."""
    g = group_width(wgroup)
    if pts_stream.device.type == "cpu" and digits.device.type == "cpu":
        return plain_accumulate(pts_stream, digits, c, signed)
    if not 1 <= c <= 16:
        raise ValueError(f"the bucket accumulation takes c in [1, 16], got {c}")
    w, s, b = digits.shape
    if w != KB.windows(c) or pts_stream.shape != (s, b, 2, 8):
        raise ValueError("msm_group accumulate: pts (S, B, 2, 8) and digits (ceil(256 / c), S, B)")
    cuda_lib.require_cuda("msm_group.accumulate", pts_stream, digits)
    rows = KB.rows(c, signed)
    table = torch.empty((w, b, rows, 3, 8), dtype=torch.int32, device=pts_stream.device)
    if table.numel():
        err = cuda_lib.lib().vkzg_msm_group_accumulate(
            pts_stream.data_ptr(), digits.data_ptr(), table.data_ptr(), w, s, b, rows, g,
            int(fused), cuda_lib.stream(pts_stream),
        )
        cuda_lib.check(err, "vkzg_msm_group_accumulate")
        cuda_lib.launches["K13"] += 1
    return table
