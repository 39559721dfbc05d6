"""The lane-stream MSM entry points: the counterparts of the public functions
of ``verkle_kzg_tpu/ops/pallas_msm.py``, under their JAX names.

A lane stream is B independent point streams of S steps; step i of lane b
is point i B + b. The layouts keep JAX's axes and their order, with the
16 uint32 limb planes replaced by trailing int32 words (``convert.py``
carries JAX's arrays across):

  * ``pts_stream`` (S, B, 2, 8) affine Montgomery words, (0, 0) the
    sentinel that adds nothing;
  * ``digits`` (W, S, B) int32, W = ceil(256 / c);
  * ``sc_stream`` (S, B, 8) standard-form scalars, ``masks`` (S, B, nwords)
    the packed carry words of ``ops/msm.py::signed_carries``;
  * buckets (W, rows, B, 3, 8), reduced. Signed, 2^(c-1) rows, row i the
    bucket of digit i + 1 (:func:`signed_table_size`). Unsigned, 2^c rows,
    row d the bucket of digit d; row 0, the TPU's trash bucket for digit 0,
    which every caller drops, is left at the identity here;
  * ``msm_single_fused*`` return one (3, 8) projective point,
    ``batched_bucket_tail`` (B, 3, 8), reduced.

Routing. ``wgroup`` takes K13 (``cuda_msm_group``), G windows a thread,
with the pipelined row loads when ``fused``. Without it the digit tensor
goes to K6/K10 (``cuda_msm_batched.accumulate``, counted by its
``launch_key``) with the stream transposed to its per-lane layout and one
segment of S points a lane. The ``_from_scalars`` functions take K3/K8/K9
(``cuda_msm.accumulate``), each lane a segment. ``msm_single_fused*`` fold
the lanes' tables with K2 (``ops/msm.py::fold_reduce_lanes``) and run the
tail K4; ``batched_bucket_tail`` is K7. Each bucket row holds the same
group element as JAX's; the projective words differ (the TPU kernels run
their identity adds through the complete formulas, and the port's tails
add in another order), so only group elements are contract.

``chunk`` and ``wpair`` are accepted and have no effect: they sized the
TPU's VMEM blocks and paired its windows. ``msm_single_fused*`` raise for a
lane count that is not a power of two, as JAX asserts. Not ported, by
decision: ``interpret`` (there is no Pallas; the plain versions run on the
CPU) and the ``_donated`` twins (buffer donation is a ``jit`` notion).
"""

from __future__ import annotations

import torch

from . import cuda_msm as K
from . import cuda_msm_batched as KB
from . import cuda_msm_group as KG
from . import curve as C
from .msm import fold_reduce_lanes


def signed_table_size(c: int) -> int:
    """Bucket rows a window for signed digits: 2^(c-1), row i = digit i + 1."""
    return 1 << (c - 1)


def _check_lanes(b: int) -> None:
    if b < 1 or b & (b - 1):
        raise ValueError(f"lane count must be a power of two, got {b}")


def _digit_tables(pts_stream, digits, c: int, signed: bool, wgroup, fused: bool) -> torch.Tensor:
    """(S, B, 2, 8) x (W, S, B) -> (W, B, rows, 3, 8) tables, row |d| - 1."""
    if wgroup is not None:
        return KG.accumulate(pts_stream.contiguous(), digits.to(torch.int32).contiguous(), c, signed,
                             wgroup, fused)
    s = pts_stream.shape[0]
    lanes = pts_stream.transpose(0, 1).contiguous()
    per_lane = digits.to(torch.int32).permute(0, 2, 1).contiguous()
    return KB.accumulate(lanes, per_lane, 1, s, c, signed)[:, :, 0]


def _scalar_tables(pts_stream, sc_stream, masks, c: int, signed: bool) -> torch.Tensor:
    """(S, B, 2, 8) x (S, B, 8) [x (S, B, nwords)] -> (W, B, rows, 3, 8)
    tables from the digits K3/K8/K9 take from the scalar words."""
    s, b = pts_stream.shape[:2]
    pts = pts_stream.transpose(0, 1).reshape(b * s, 2, 8).contiguous()
    sc = sc_stream.transpose(0, 1).reshape(b * s, 8).contiguous()
    m = masks.transpose(0, 1).reshape(b * s, -1).contiguous() if signed else None
    return K.accumulate(pts, sc, m, b, s, c, signed)


def _jax_rows(tables: torch.Tensor, signed: bool) -> torch.Tensor:
    """(W, B, rows, 3, 8) -> JAX's (W, rows, B, 3, 8); unsigned with the
    identity as row 0."""
    out = tables.permute(0, 2, 1, 3, 4)
    if not signed:
        w, _, b = out.shape[:3]
        out = torch.cat([C.infinity((w, 1, b), out.device), out], dim=1)
    return out.contiguous()


def _single(tables: torch.Tensor, c: int) -> torch.Tensor:
    """Fold the lanes' tables with K2, then the tail K4 -> (3, 8)."""
    return K.tail(fold_reduce_lanes(tables, dim=1)[:, 0].contiguous(), c)


def bucket_accumulate(pts_stream, digits, c: int, chunk: int = 64, signed: bool = False,
                      wpair: bool = True, wgroup: int | None = None, fused: bool = False) -> torch.Tensor:
    """(S, B, 2, 8) points x (W, S, B) digits -> (W, rows, B, 3, 8) buckets."""
    return _jax_rows(_digit_tables(pts_stream, digits, c, signed, wgroup, fused), signed)


def bucket_accumulate_from_scalars(pts_stream, sc_stream, c: int, chunk: int = 32) -> torch.Tensor:
    """Unsigned buckets, digits from the scalar words (c divides 16):
    (S, B, 2, 8) x (S, B, 8) -> (W, 2^c, B, 3, 8)."""
    return _jax_rows(_scalar_tables(pts_stream, sc_stream, None, c, False), False)


def bucket_accumulate_from_scalars_signed(pts_stream, sc_stream, masks, c: int, chunk: int = 32,
                                          wpair: bool = True) -> torch.Tensor:
    """Signed buckets, digits from the scalar words and carry words (c
    divides 16): -> (W, 2^(c-1), B, 3, 8)."""
    return _jax_rows(_scalar_tables(pts_stream, sc_stream, masks, c, True), True)


def msm_single_fused(pts_stream, digits, c: int, chunk: int = 64, signed: bool = False,
                     wgroup: int | None = None, fused: bool = False) -> torch.Tensor:
    """The single MSM of the whole stream from its digit tensor -> (3, 8)."""
    _check_lanes(digits.shape[2])
    return _single(_digit_tables(pts_stream, digits, c, signed, wgroup, fused), c)


def msm_single_fused_sc(pts_stream, sc_stream, c: int, chunk: int = 64) -> torch.Tensor:
    """The single MSM with unsigned digits from the scalar words -> (3, 8)."""
    _check_lanes(pts_stream.shape[1])
    return _single(_scalar_tables(pts_stream, sc_stream, None, c, False), c)


def msm_single_fused_sc_signed(pts_stream, sc_stream, masks, c: int, chunk: int = 64,
                               wpair: bool = True) -> torch.Tensor:
    """The single MSM with signed digits from the scalar and carry words -> (3, 8)."""
    _check_lanes(pts_stream.shape[1])
    return _single(_scalar_tables(pts_stream, sc_stream, masks, c, True), c)


def batched_bucket_tail(buckets, c: int, nbuckets: int | None = None, shifted: bool = False) -> torch.Tensor:
    """(W, rows, B, 3, 8) buckets -> (B, 3, 8): each lane's own MSM, its
    weighted bucket sums and Horner (K7). ``nbuckets`` live rows (default
    2^c); ``shifted``: row i is the bucket of digit i + 1 (signed tables),
    else row d is digit d and row 0 is dropped."""
    nb = (1 << c) if nbuckets is None else nbuckets
    live = buckets[:, :nb] if shifted else buckets[:, 1:nb]
    return KB.tail(live.permute(0, 2, 1, 3, 4).contiguous(), c)
