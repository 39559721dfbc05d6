"""Kernel K7: the lane-batched MSM tail.

A batch of B independent MSMs, each lane its own MSM over N points: the
dense verkle node commits (``verkle/tree.py::_dense_commit`` ->
``ops/msm.py::msm_fixed_base``, the 256-point basis shared by every lane)
and ``msm_batched`` (points per lane), with the balanced signed digits of
``ops/msm.py::window_digits_signed``. Their bucket accumulation is the
bucket-sorted kernel of ``cuda_msm_sorted.accumulate_digits`` with the B
lanes as its lanes (K6 up to 128 rows a window, K10 above): no point
segments and no K2 fold.

K7 replaces ``verkle_kzg_tpu/ops/pallas_msm.py``: the launch at line 1152,
``_batched_tail_kernel``: per lane, each window's weighted bucket sum
sum_i (i + 1) B_i, then Horner from the top window (c doublings, then an
add), output reduced. It is K4's tail (``csrc/msm_tail.cuh``, see
``cuda_msm.py``) over B lanes: the window sums of each (window, lane) in
log depth on a warp, then a warp per lane for Horner with each step's
products spread over its lanes, one CUDA launch up to 1,024 rows a window;
the plain version is ``cuda_msm.plain_tail``. It takes any row count and
c in [1, 16], as K4 does: the batched MSMs give it 2^(c-1) signed rows;
``msm_stream.batched_bucket_tail`` also 2^c - 1 unsigned ones.

The plain version follows the kernel's order of additions and domain
(lazy, reduced at the end), so kernel and plain version agree bit for bit.
The tail adds in another order than the JAX double suffix scan, so against
the JAX package only the group element is compared.
"""

from __future__ import annotations

import math

import torch

from ..utils.metrics import span
from . import cuda_lib
from . import cuda_msm as K


def windows(c: int) -> int:
    return math.ceil(256 / c)


def rows(c: int, signed: bool = True) -> int:
    """Bucket rows per window (``pallas_msm.signed_table_size`` signed;
    2^c - 1 unsigned, digit d in row d - 1, as ``cuda_msm.rows``)."""
    return K.rows(c, signed)


def _check_c(c: int) -> None:
    if not 1 <= c <= 16:
        raise ValueError(f"the batched MSM tail takes c in [1, 16], got {c}")


plain_tail = K.plain_tail  # K7's plain version: (W, B, rows, 3, 8) -> (B, 3, 8)


@span("kernels", "K7")
def tail(buckets: torch.Tensor, c: int) -> torch.Tensor:
    _check_c(c)
    if buckets.device.type == "cpu":
        return plain_tail(buckets, c)
    w, b, nrows = buckets.shape[:3]
    if buckets.shape != (windows(c), b, nrows, 3, 8) or nrows < 1:
        raise ValueError("msm_batched tail: buckets must be (ceil(256 / c), B, rows, 3, 8)")
    cuda_lib.require_cuda("msm_batched.tail", buckets)
    if not b:
        return torch.empty((0, 3, 8), dtype=torch.int32, device=buckets.device)
    return K.launch_tail(buckets, c, "K7")[0]
