"""Multi-scalar multiplication (MSM): signed-digit Pippenger, single and
lane-batched, and double-and-add for small N.

The counterpart of ``verkle_kzg_tpu/ops/msm.py``. A single MSM of N >= 64
(affine point, standard scalar) pairs -> one projective point ``(3, 8)``
with reduced coordinates, at any window width c in [1, 16] and either
digit sign (default c = 8, signed), in two steps:

  1. the bucket accumulation, bucket |d| in row |d| - 1 of a window's
     table, (W, rows) buckets, by the bucket-sorted kernels of
     ``cuda_msm_sorted``. With c dividing 16 they take the points and
     scalars as they are (``accumulate``: K3, K9 at c = 16, K8 unsigned):
     the kernels derive the digits (and, signed, the carries). At any other
     c the scalars are recoded first (:func:`window_digits_signed` or
     :func:`window_digits`) and the same kernels take that digit tensor
     (``accumulate_digits``: K6 up to 128 rows a window, K10 above). None
     pads, cuts point segments or folds;
  2. K4 (``cuda_msm.tail``): the weighted bucket sums and Horner.

Below 64 points ``msm_auto`` multiplies each point by its scalar with K5
(``curve.scalar_mul_affine``) and sums the products with K2FOLD, the JAX
package's K2 halving tree in one launch: the bucket machinery costs
W x 2^(c-1) rows whatever N is.

A batch of B independent MSMs (``msm_fixed_base``: one basis for every
lane, the dense verkle node commits; ``msm_batched``: points per lane)
takes LSB-carry signed digits (:func:`window_digits_signed`) with c from
:func:`_auto_c_batched` or as given, in [1, 16], the same digit-tensor
accumulation with the batch's lanes as its lanes (a shared basis read by
every lane through a lane stride of 0), and K7 (``cuda_msm_batched.tail``);
below 64 points per lane, K5 and a K2FOLD fold. Only the group element is
contract; the JAX package's own paths return other projective
representatives.
"""

from __future__ import annotations

import math

import torch

from ..utils import metrics
from . import cuda_curve as KC
from . import cuda_msm as K
from . import cuda_msm_batched as KB
from . import cuda_msm_sorted as KS
from . import curve as C
from . import field as F

TOTAL_BITS = 256


def window_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(..., N, 8) standard scalars -> (W, ..., N) int64 digits in [0, 2^c),
    LSB window first, W = ceil(256 / c). Digit w is bits [w c, w c + c),
    taken from the one or two 32-bit words it spans (a zero word past the
    top pads the last window)."""
    v = torch.nn.functional.pad(scalars.to(torch.int64) & 0xFFFFFFFF, (0, 1))
    start = torch.arange(math.ceil(TOTAL_BITS / c), device=v.device) * c
    word, shift = start // 32, start % 32
    dig = ((v[..., word] >> shift) | (v[..., word + 1] << (32 - shift))) & ((1 << c) - 1)
    return dig.movedim(-1, 0)


def carry_mask_words(w: int) -> int:
    """Words per scalar of the packed carry bitmask: bits 0..W must be
    addressable (window w reads bit w + 1 as its carry out)."""
    return w // 32 + 1


def signed_carries(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(..., N, 8) standard scalars -> (..., N, nwords) int32 packed carry
    bits: bit w = carry INTO window w = [scalar mod 2^(cw) > 2^(cw-1)], a
    tie (the top digit exactly 2^(c-1)) carrying iff the bits below it are
    not all zero (``ops/msm.py::signed_carries``)."""
    raw = window_digits(scalars, c)  # (W, ..., N)
    w = raw.shape[0]
    nwords = carry_mask_words(w)
    h = 1 << (c - 1)
    nz = (raw != 0).to(torch.int64).cummax(0).values  # any digit <= i nonzero
    below = torch.cat([torch.zeros_like(nz[:1]), nz[:-2]])  # for windows 0..W-2
    prev = raw[:-1]
    carry = ((prev > h) | ((prev == h) & (below > 0))).to(torch.int64)
    bits = torch.cat([torch.zeros_like(carry[:1]), carry])
    pad = torch.zeros((nwords * 32 - w,) + bits.shape[1:], dtype=torch.int64, device=bits.device)
    bits = torch.cat([bits, pad]).reshape((nwords, 32) + bits.shape[1:])
    shifts = torch.arange(32, device=bits.device).reshape((1, 32) + (1,) * (bits.dim() - 2))
    words = (bits << shifts).sum(1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return words.movedim(0, -1)


def window_digits_signed(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """Balanced signed digits (W, ..., N) in [-2^(c-1), 2^(c-1)] by the
    LSB-first carry chain (``ops/msm.py::window_digits_signed``): at an
    exact tie it may differ from :func:`signed_carries`, and both sum to
    the scalar."""
    raw = window_digits(scalars, c)
    h = 1 << (c - 1)
    out = []
    carry = torch.zeros_like(raw[0])
    for i in range(raw.shape[0]):
        d = raw[i] + carry
        carry = (d > h).to(torch.int64)
        out.append(d - (carry << c))
    return torch.stack(out)


def _auto_c(n: int, c: int | None) -> int:
    """Window width for single MSMs (``ops/msm.py::_auto_c``): c = 8 unless
    given, the JAX package's choice on the chip; a given c must lie in
    [1, 16]."""
    if c is None:
        return 8
    if not 1 <= c <= 16:
        raise ValueError(f"MSM window width c must be in [1, 16], got {c}")
    return c


def fold_reduce_lanes(p: torch.Tensor, dim: int = -3) -> torch.Tensor:
    """Tree-reduce points (..., 3, 8) over ``dim`` (size -> 1) by halving,
    the odd point carried to the end of each level: one K2FOLD launch over
    every row (``cuda_curve.fold``)."""
    dim = dim % p.dim()
    n = p.shape[dim]
    if n == 1:
        return p
    rows = p.movedim(dim, -3)
    lead = rows.shape[:-3]
    out = KC.fold(rows.reshape((math.prod(lead), n, 3, F.WORDS)))
    return out.reshape(lead + (1, 3, F.WORDS)).movedim(-3, dim)


def msm_pippenger(points_affine: torch.Tensor, scalars: torch.Tensor, c: int | None = None,
                  lanes: int = 128, signed: bool = True):
    """(N, 2, 8) affine Montgomery points x (N, 8) standard scalars ->
    (3, 8) projective, reduced (``ops/msm.py::msm_pippenger``).

    ``c``: window bits in [1, 16], default 8. ``signed``: balanced signed
    digits (2^(c-1) bucket rows a window) or unsigned ones (2^c - 1 rows).
    ``lanes`` is accepted for parity with the JAX package and has no
    effect: the sorted entries' chunks take the place of the TPU's lanes,
    and only the group element is contract."""
    c = _auto_c(points_affine.shape[0], c)
    points_affine = points_affine.contiguous()
    scalars = scalars.contiguous()
    if c in K.IN_KERNEL_C:
        buckets = KS.accumulate(points_affine, scalars, c, signed=signed)
    else:
        digits = (window_digits_signed if signed else window_digits)(scalars, c).to(torch.int32).contiguous()
        buckets = KS.accumulate_digits(points_affine, digits[:, None], c, signed)
    return K.tail(buckets[:, 0].contiguous(), c)


def msm_auto(points_affine: torch.Tensor, scalars: torch.Tensor, c: int | None = None, lanes: int = 128):
    """Single MSM entry point (``ops/msm.py::msm_auto``): double-and-add
    (K5) and a K2FOLD fold below 64 points, whatever c is; Pippenger from 64 on
    (:func:`msm_pippenger`, signed digits). ``lanes`` has no effect."""
    metrics.record("msm.single.calls")
    metrics.record("msm.single.points", points_affine.shape[0])
    return _msm_auto_impl(points_affine, scalars, c, lanes)


def _msm_auto_impl(points_affine: torch.Tensor, scalars: torch.Tensor, c: int | None = None, lanes: int = 128):
    """:func:`msm_auto` without its counters, for the sharded MSMs'
    local parts (``ops/msm.py::_msm_auto_impl``)."""
    if points_affine.shape[0] < 64:
        return fold_reduce_lanes(C.scalar_mul_affine(points_affine, scalars), dim=0)[0]
    return msm_pippenger(points_affine, scalars, c=c, lanes=lanes)


# ---------------------------------------------------------------------------
# Lane-batched MSMs: each lane of a batch is an independent MSM
# ---------------------------------------------------------------------------


def _auto_c_batched(n: int, c: int | None = None) -> int:
    """Window width for the lane-batched path (``ops/msm.py::_auto_c_batched``):
    the bucket tails cost W x 2^(c-1) point adds per MSM, which do not
    amortize over a large N, so c ~ log2(N) / 2 + 1: 4 at N = 64, 5 at 256."""
    return c if c is not None else min(6, max(2, (n.bit_length() - 1) // 2 + 1))


def _batched_naive_affine(points_affine: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """(B, N, 2, 8) affine x (B, N, 8) standard scalars -> (B, 3, 8): the
    B * N scalar multiplications in ONE K5 launch, then one K2FOLD over N
    (``ops/msm.py::_batched_naive_affine``)."""
    b, n = scalars.shape[:2]
    prods = C.scalar_mul_affine(
        points_affine.reshape(b * n, 2, F.WORDS).contiguous(), scalars.reshape(b * n, F.WORDS).contiguous()
    )
    return fold_reduce_lanes(prods.reshape(b, n, 3, F.WORDS), dim=1)[:, 0]


def _msm_lanewise(points_affine: torch.Tensor, scalars: torch.Tensor, c: int) -> torch.Tensor:
    """Core batched Pippenger (``ops/msm.py::_msm_lanewise``): (N, 2, 8)
    shared or (B, N, 2, 8) per-lane points x (B, N, 8) standard scalars ->
    (B, 3, 8). The scalars become (W, B, N) LSB-carry signed digits; the
    sorted accumulation takes the B lanes as its lanes (K6 up to 128 rows a
    window, K10 above; a shared basis is an ``expand`` that the kernel
    reads at lane stride 0, never a copy per lane), and K7 runs the tails.
    Its scratch is bounded by ``cuda_msm_sorted.SCRATCH_BYTES``: the
    windows go in groups above it."""
    digits = window_digits_signed(scalars, c).to(torch.int32)
    w, b, n = digits.shape
    pts = points_affine.expand(b, n, 2, F.WORDS) if points_affine.dim() == 3 else points_affine
    return KB.tail(KS.accumulate_digits(pts, digits, c), c)


def msm_batched(points_affine: torch.Tensor, scalars: torch.Tensor, c: int | None = None) -> torch.Tensor:
    """Batch of B independent MSMs (``ops/msm.py::msm_batched``):
    (B, N, 2, 8) affine x (B, N, 8) standard scalars -> (B, 3, 8) reduced."""
    b, n = scalars.shape[:2]
    metrics.record("msm.batched.calls")
    metrics.record("msm.batched.points", b * n)
    return _msm_batched_impl(points_affine, scalars, c)


def _msm_batched_impl(points_affine: torch.Tensor, scalars: torch.Tensor, c: int | None = None) -> torch.Tensor:
    """:func:`msm_batched` without its counters (``ops/msm.py::_msm_batched_impl``)."""
    n = scalars.shape[1]
    if n < 64:
        return _batched_naive_affine(points_affine, scalars)
    return _msm_lanewise(points_affine, scalars, _auto_c_batched(n, c))


def msm_fixed_base(points_affine: torch.Tensor, scalars: torch.Tensor, c: int | None = None) -> torch.Tensor:
    """Fixed-basis MSM for a stack of scalar vectors (``ops/msm.py::msm_fixed_base``):
    (N, 2, 8) affine x (B, N, 8) standard scalars -> (B, 3, 8) reduced. The
    basis is read by every lane and never copied per lane."""
    b, n = scalars.shape[:2]
    metrics.record("msm.fixed_base.calls")
    metrics.record("msm.fixed_base.points", b * n)
    return _msm_fixed_base_impl(points_affine, scalars, c)


def _msm_fixed_base_impl(points_affine: torch.Tensor, scalars: torch.Tensor, c: int | None = None) -> torch.Tensor:
    """:func:`msm_fixed_base` without its counters (``ops/msm.py::_msm_fixed_base_impl``)."""
    b, n = scalars.shape[:2]
    if n < 64:
        return _batched_naive_affine(points_affine[None].expand(b, n, 2, F.WORDS), scalars)
    return _msm_lanewise(points_affine, scalars, _auto_c_batched(n, c))
