"""Kernel K2: element-wise complete projective point addition.

Replaces ``verkle_kzg_tpu/ops/pallas_curve.py``: the launch ``_point_call``
behind ``add``, with body ``k_point_add`` (RCB16 algorithm 7, reduced
domain). On the single-MSM path it folds the per-segment partial bucket
tables of K3 (``ops/msm.py::fold_reduce_lanes``), as ``pallas_curve.add``
folds the lanes in ``pallas_msm._single_tail``. The lazy group law that K3
and K4 inline lives beside it in ``csrc/bn254_curve.cuh``.

On the card: one point pair per thread, 12 Montgomery products and 21
modular add/subs on 48 words of input. At the fold's widths (32 windows x
128 buckets x a few segments) it is bound by integer throughput and by
register pressure, since RCB16 keeps about a dozen 8-word temporaries
alive: the kernel pins 128 threads per block with ``__launch_bounds__`` and
the build prints its registers and spills. It runs the same sequence of
field operations as ``k_point_add``, so kernel, plain version and the JAX
package agree bit for bit.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from . import curve as C
from . import field as F


def plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """K2's plain version on (..., 3, 8) int32 words, any device. Pairs of
    identities are not computed (:func:`curve.add_sparse`): the segment
    folds of wide bucket tables are mostly such pairs."""
    return C.add_sparse(p, q)


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if p.device.type == "cpu" and q.device.type == "cpu":
        return plain(p, q)
    p, q = torch.broadcast_tensors(p, q)
    p, q = p.contiguous(), q.contiguous()
    cuda_lib.require_cuda("curve.add", p, q)
    out = torch.empty_like(p)
    n = p.numel() // (3 * F.WORDS)
    if n:
        err = cuda_lib.lib().vkzg_point_add(
            p.data_ptr(), q.data_ptr(), out.data_ptr(), n, cuda_lib.stream(p)
        )
        cuda_lib.check(err, "vkzg_point_add")
        cuda_lib.launches["K2"] += 1
    return out
