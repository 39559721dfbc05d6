"""Kernel K5: scalar multiplication of a batch of affine points.

Replaces ``verkle_kzg_tpu/ops/pallas_curve.py``: ``scalar_mul_affine``
(the ``pallas_call`` at line 432) with body ``_scalar_mul_kernel``, a
256-step MSB-first double-and-add per lane. Its users are the sparse
verkle node commits (``verkle/tree.py::_sparse_commit``), the small-N route
of ``msm_auto`` (N < 64) and ``_batched_naive_affine`` in ``ops/msm.py``.

On the card: one lane per thread, the affine point in registers, the
scalar's words read one at a time; each of the 256 rounds is a lazy
doubling (8 Montgomery products) and, where the bit is set, a lazy mixed
add (11). A lane is a serial chain of about 3,400 products, so the kernel
is bound by 32-bit multiply throughput once enough lanes are in flight and
by the chain's latency below that; the sparse commits of a verkle tree give
it tens of thousands of lanes in one launch. A (0, 0) sentinel lane takes
no bit and emits the identity: the mixed add is not complete for the
sentinel, and the bit mask is the only place the kernel looks at it.

The plain version below follows the kernel's formula sequence and domain
(lazy [0, 2m), reduced once at the end), so kernel and plain version agree
bit for bit; and since the mixed add is the exact Z2 = 1 case of the
complete add, both equal the coordinates of the JAX package's XLA
``ops/curve.py::scalar_mul`` too, not only its group element.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from . import curve as C
from . import field as F


def plain(pts: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """K5's plain version: (n, 2, 8) affine x (n, 8) standard scalars ->
    (n, 3, 8) reduced projective, any device."""
    p = F.to_limbs(pts)
    bits = C.scalar_bits_msb(sc)  # (256, n)
    bits = torch.where(C.affine_is_infinity(pts)[None], 0, bits)
    acc = C.infinity16(pts.shape[:-2], pts.device)
    for bit in bits:
        acc = C.double16(acc, lazy=True)
        if bool(bit.any()):  # a round no lane takes leaves acc as it is
            acc = torch.where(bit[..., None, None] != 0, C.mixed_add16(acc, p, lazy=True), acc)
    return F.from_limbs(C.reduce16(acc))


def scalar_mul_affine(pts: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    if pts.device.type == "cpu" and sc.device.type == "cpu":
        return plain(pts, sc)
    n = pts.shape[0]
    if pts.shape != (n, 2, F.WORDS) or sc.shape != (n, F.WORDS):
        raise ValueError("scalar_mul_affine: points must be (n, 2, 8) and scalars (n, 8)")
    pts, sc = pts.contiguous(), sc.contiguous()
    cuda_lib.require_cuda("curve.scalar_mul_affine", pts, sc)
    out = torch.empty((n, 3, F.WORDS), dtype=torch.int32, device=pts.device)
    if n:
        err = cuda_lib.lib().vkzg_scalar_mul(
            pts.data_ptr(), sc.data_ptr(), out.data_ptr(), n, cuda_lib.stream(pts)
        )
        cuda_lib.check(err, "vkzg_scalar_mul")
        cuda_lib.launches["K5"] += 1
    return out
