"""Kernel K5: scalar multiplication of a batch of affine points.

Replaces ``verkle_kzg_tpu/ops/pallas_curve.py``: ``scalar_mul_affine``
(the ``pallas_call`` at line 432) with body ``_scalar_mul_kernel``, a
256-step MSB-first double-and-add per lane. Its users are the sparse
verkle node commits (``verkle/tree.py::_sparse_commit``: tens of thousands
of lanes, half of them zero-scalar pads at the c1/c2 shape, 128-bit leaf
halves in the others), the small-N route of ``msm_auto`` (N < 64: the
verkle verify's E aggregation, 51 lanes in ``chip_smoke.py`` phase 5, and
one lane in the IPA multiproof's verify) and ``_batched_naive_affine`` in
``ops/msm.py``, and KZG setup's generator multiples.

What bounds it on this card is latency, not the multiply rate. The
function's work at the commit shape, 40,000 lanes, is ~34M Montgomery
products, 0.54 ms at the card's integer rate; but a lane is a chain of
dependent point operations, a product is ~500 dependent instructions
(0.68 us on one thread, ``tools/fmul_probe.py``), and the commit's lanes
fill 1-2 warps a scheduler. The first port ran a lane a thread over all
256 rounds: 4x the function's products (dead lanes and leading zero bits
included, and the mixed add paid by a whole warp whenever one lane took
it), and one lane, the verifiers' call, a ~381-operation chain on one
thread (7-10 ms). The design (``csrc/scalar_mul.cu``, the point operations
of ``csrc/warp_point.cuh`` shared with the MSM tail's Horner):

- each point operation's independent products on separate threads: 4 + 4
  for a doubling and 5 + 6 for a mixed add, so a round's dependent chain is
  4 products and the lazy sums, not 19;
- rounds from the warp's highest set bit down (the identity's lazy doubling
  gives its own words, so the skipped rounds change nothing), and a lane
  whose scalar is 0 or whose point is the (0, 0) sentinel runs no round;
- two regimes. Up to :data:`SWITCH` lanes, one warp a lane: the mixed add
  only where the lane's bit is set. Above it, 4 threads a lane, 8 lanes a
  warp, the lanes ordered by the bit length of their scalars
  (:func:`lane_order`, a device sort, ~0.2 ms; dead lanes last), so that a
  warp starts at its lanes' common top bit and the card holds several warps
  a scheduler; the outputs go back to lane order in the kernel. The mixed
  add then runs every round, a lane whose bit is 0 keeping its
  accumulator. The block shapes are fixed in ``csrc/scalar_mul.cu``;
  :data:`SWITCH` and the shapes are set from ``python -m
  verkle_kzg_tpu_torch.tools.k5_regimes`` on the card (numbers below and in
  PERF.md).

Neither regime is a fallback for the other: both are launches of the same
kernel template, and a CUDA tensor runs one of them or raises.

The plain version below follows the kernel's formula sequence and domain
(lazy [0, 2m), reduced once at the end), so kernel and plain version agree
bit for bit, in any lane order; and since the mixed add is the exact Z2 = 1
case of the complete add, both equal the coordinates of the JAX package's
XLA ``ops/curve.py::scalar_mul`` too, not only its group element.
"""

from __future__ import annotations

import torch

from ..utils.metrics import span
from . import cuda_lib
from . import curve as C
from . import field as F

# Set from tools/k5_regimes.py on an NVIDIA H100 80GB HBM3 at 700 W: through
# this wrapper, with 254-bit scalars, one warp a lane takes 0.73 ms at 1
# lane, 1.00 at 256, 1.17 at 512, 1.33 at 1,024, 1.70 at 1,152, 2.29 at
# 2,048; 4 threads a lane 1.46, 1.55, 1.54, 1.66, 1.56, 1.62 (the lane sort
# included). Up to 132 SMs x 8 warps one warp a lane hides the products'
# latency; above, its time grows with the lanes. The path's calls
# (chip_smoke.py phases 5 and 6) are 1 and 51 lanes (the verifies' E) and
# 40,004 (the verkle commit's two), none near the switch.
#: Lanes at or below which a call runs one warp a lane.
SWITCH = 1024

#: Launches of each regime since the last :func:`reset_regimes`
#: (``cuda_lib.launches["K5"]`` counts both).
regime_launches = {"few": 0, "many": 0}


def reset_regimes() -> None:
    for k in regime_launches:
        regime_launches[k] = 0


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


def bit_lengths(pts: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """(n,) bit length of each lane's scalar, 0 for a zero scalar or a
    (0, 0) point: the rounds the lane needs. Each 32-bit word's length is
    the exponent of its float64 value, which holds it exactly."""
    words = (sc.to(torch.int64) & 0xFFFFFFFF).to(torch.float64)
    e = torch.frexp(words).exponent.to(torch.int64)  # 0 for a zero word
    pos = 32 * torch.arange(F.WORDS, device=sc.device)
    length = torch.where(e > 0, e + pos, 0).amax(-1)
    return torch.where(C.affine_is_infinity(pts), 0, length)


def lane_order(pts: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """(n,) lane indices, longest scalar first and dead lanes last (stable):
    the many-lane regime's group g takes lane ``order[g]``."""
    return torch.argsort(bit_lengths(pts, sc), descending=True, stable=True)


@span("kernels", "K5")
def scalar_mul_affine(pts: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """(n, 2, 8) affine x (n, 8) standard scalars -> (n, 3, 8) reduced
    projective; on the card one warp a lane up to :data:`SWITCH` lanes,
    the many-lane regime above."""
    if pts.device.type == "cpu" and sc.device.type == "cpu":
        return plain(pts, sc)
    n = pts.shape[0]
    if pts.shape != (n, 2, F.WORDS) or sc.shape != (n, F.WORDS):
        raise ValueError("scalar_mul_affine: points must be (n, 2, 8) and scalars (n, 8)")
    pts, sc = pts.contiguous(), sc.contiguous()
    cuda_lib.require_cuda("curve.scalar_mul_affine", pts, sc)
    out = torch.empty((n, 3, F.WORDS), dtype=torch.int32, device=pts.device)
    if n == 0:
        return out
    regime = "few" if n <= SWITCH else "many"
    order = lane_order(pts, sc).to(torch.int32) if regime == "many" else None
    err = cuda_lib.lib().vkzg_scalar_mul(
        pts.data_ptr(), sc.data_ptr(), None if order is None else order.data_ptr(), out.data_ptr(),
        n, cuda_lib.stream(pts),
    )
    cuda_lib.check(err, "vkzg_scalar_mul")
    cuda_lib.launches["K5"] += 1
    regime_launches[regime] += 1
    return out
