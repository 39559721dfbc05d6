"""Kernels K2, K11 and K12: element-wise complete projective group law.

Replaces ``verkle_kzg_tpu/ops/pallas_curve.py``: the launch ``_point_call``
(line 328) behind ``add`` (K2, body ``k_point_add``), ``double`` (K11,
line 350, body ``k_point_double``) and ``mixed_add`` (K12, line 358, body
``k_point_mixed_add``), all in the reduced domain. On the single-MSM path K2
folds the per-segment partial bucket tables of K3
(``ops/msm.py::fold_reduce_lanes``), as ``pallas_curve.add`` folds the lanes
in ``pallas_msm._single_tail``. K11 runs ``curve.double``. Their device
functions are also every bit of ``curve.scalar_mul`` and of the G1 NTT's
butterflies, which run as one launch a call (G1SMUL, G1BFLY in
``cuda_g1_chain.py``), no longer as a K11 and a K2 launch a bit. K12 has no
caller on any path of either package; it makes ``curve.mixed_add`` run on
the card.
The lazy group law that K3-K10 inline lives beside them in
``csrc/bn254_curve.cuh``.

On the card: one point (pair) per thread. K2 does 12 Montgomery products and
21 modular add/subs on 48 words of input, K11 8 products and 11 add/subs on
24 words, K12 11 products on 40 words. At the widths of the MSM folds and of
the NTT stages they are bound by integer throughput and by register
pressure, since RCB16 keeps about a dozen 8-word temporaries alive: the
kernels pin 128 threads per block with ``__launch_bounds__`` and the build
prints their registers and spills. Each runs the same sequence of field
operations as its Pallas body, so kernel, plain version and the JAX package
agree bit for bit. K12's (0, 0) sentinel lanes keep p, as the Pallas
kernel's final select does.
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


def plain_double(p: torch.Tensor) -> torch.Tensor:
    """K11's plain version on (..., 3, 8) int32 words, any device."""
    return F.from_limbs(C.double16(F.to_limbs(p)))


def plain_mixed_add(p: torch.Tensor, q_aff: torch.Tensor) -> torch.Tensor:
    """K12's plain version: (..., 3, 8) projective + (..., 2, 8) affine."""
    return F.from_limbs(C.mixed_add16(F.to_limbs(p), F.to_limbs(q_aff)))


def _launch(fn: str, key: str, out: torch.Tensor, *ins: torch.Tensor) -> torch.Tensor:
    """Run kernel entry ``fn`` over the points of ``out`` and count it."""
    cuda_lib.require_cuda("curve." + fn, out, *ins)
    n = out.numel() // (3 * F.WORDS)
    if n:
        err = getattr(cuda_lib.lib(), fn)(
            *(t.data_ptr() for t in ins), out.data_ptr(), n, cuda_lib.stream(out)
        )
        cuda_lib.check(err, fn)
        cuda_lib.launches[key] += 1
    return out


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if p.device.type == "cpu" and q.device.type == "cpu":
        return plain(p, q)
    p, q = torch.broadcast_tensors(p, q)
    p, q = p.contiguous(), q.contiguous()
    return _launch("vkzg_point_add", "K2", torch.empty_like(p), p, q)


def double(p: torch.Tensor) -> torch.Tensor:
    if p.device.type == "cpu":
        return plain_double(p)
    p = p.contiguous()
    return _launch("vkzg_point_double", "K11", torch.empty_like(p), p)


def mixed_add(p: torch.Tensor, q_aff: torch.Tensor) -> torch.Tensor:
    if p.device.type == "cpu" and q_aff.device.type == "cpu":
        return plain_mixed_add(p, q_aff)
    lead = torch.broadcast_shapes(p.shape[:-2], q_aff.shape[:-2])
    p = p.expand(lead + p.shape[-2:]).contiguous()
    q_aff = q_aff.expand(lead + q_aff.shape[-2:]).contiguous()
    return _launch("vkzg_point_mixed_add", "K12", torch.empty_like(p), p, q_aff)
