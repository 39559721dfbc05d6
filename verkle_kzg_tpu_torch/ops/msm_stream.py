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

Routing. Every accumulation is the bucket-sorted kernel of
``cuda_msm_sorted``. A digit tensor goes to ``accumulate_digits``, which
reads the stream in place at its strides (lane b's points B apart): it
counts as K13 when the caller passes ``wgroup`` (the TPU's
``_accum_kernel_group``), else as K6 up to 128 rows a window and K10
above. The ``_from_scalars`` functions take K3/K9 (signed, with the
caller's carry words) or K8 (unsigned; ``accumulate``). The lane buckets
take the B lanes as the kernel's lanes; the single MSMs take the whole
stream as one lane, since their points need no lanes, so that no K2 fold
follows, then the tail K4. ``batched_bucket_tail`` is K7, at any c in
[1, 16]. Each bucket row holds the same group element as JAX's; the
projective words differ (the TPU kernels run their identity adds through
the complete formulas, the sorted sums add a bucket's chunks in a tree,
and the port's tails add in another order), so only group elements are
contract.

``chunk``, ``wpair``, ``wgroup`` and ``fused`` are accepted and have no
effect on any bucket's value: they sized the TPU's VMEM blocks, paired its
windows, grouped G windows a grid cell and pipelined its table passes. A
``wgroup`` below 1 raises, as it did for the TPU kernel's grid.
``msm_single_fused*`` raise for a lane count that is not a power of two,
as JAX asserts. Not ported, by
decision: ``interpret`` (there is no Pallas; the plain versions run on the
CPU) and the ``_donated`` twins (buffer donation is a ``jit`` notion).
"""

from __future__ import annotations

import torch

from . import cuda_msm as K
from . import cuda_msm_batched as KB
from . import cuda_msm_sorted as KS
from . import curve as C


def signed_table_size(c: int) -> int:
    """Bucket rows a window for signed digits: 2^(c-1), row i = digit i + 1."""
    return 1 << (c - 1)


def _check_lanes(b: int) -> None:
    if b < 1 or b & (b - 1):
        raise ValueError(f"lane count must be a power of two, got {b}")


def _group_key(wgroup) -> str | None:
    """The count a digit-tensor accumulation adds to: K13 for a caller that
    passes ``wgroup`` (at least 1), else the kernel's own (K6 or K10)."""
    if wgroup is None:
        return None
    if wgroup < 1:
        raise ValueError(f"wgroup must be at least 1, got {wgroup}")
    return "K13"


def _digit_tables(pts_stream, digits, c: int, signed: bool, wgroup) -> torch.Tensor:
    """(S, B, 2, 8) x (W, S, B) -> (W, B, rows, 3, 8) tables, row |d| - 1,
    the stream and its digits read in place through (B, S) views."""
    return KS.accumulate_digits(pts_stream.transpose(0, 1), digits.to(torch.int32).permute(0, 2, 1), c, signed,
                                key=_group_key(wgroup))


def _scalar_tables(pts_stream, sc_stream, masks, c: int, signed: bool) -> torch.Tensor:
    """(S, B, 2, 8) x (S, B, 8) [x (S, B, nwords)] -> (W, B, rows, 3, 8)
    tables from the digits K3/K9 (signed, with the carry words) or K8 take
    from the scalar words."""
    s, b = pts_stream.shape[:2]
    pts = pts_stream.transpose(0, 1).reshape(b * s, 2, 8).contiguous()
    sc = sc_stream.transpose(0, 1).reshape(b * s, 8).contiguous()
    m = None if masks is None else masks.transpose(0, 1).reshape(b * s, -1).contiguous()
    return KS.accumulate(pts, sc, c, b, m, signed)


def _jax_rows(tables: torch.Tensor, signed: bool) -> torch.Tensor:
    """(W, B, rows, 3, 8) -> JAX's (W, rows, B, 3, 8); unsigned with the
    identity as row 0."""
    out = tables.permute(0, 2, 1, 3, 4)
    if not signed:
        w, _, b = out.shape[:3]
        out = torch.cat([C.infinity((w, 1, b), out.device), out], dim=1)
    return out.contiguous()


def bucket_accumulate(pts_stream, digits, c: int, chunk: int = 64, signed: bool = False,
                      wpair: bool = True, wgroup: int | None = None, fused: bool = False) -> torch.Tensor:
    """(S, B, 2, 8) points x (W, S, B) digits -> (W, rows, B, 3, 8) buckets."""
    return _jax_rows(_digit_tables(pts_stream, digits, c, signed, wgroup), signed)


def bucket_accumulate_from_scalars(pts_stream, sc_stream, c: int, chunk: int = 32) -> torch.Tensor:
    """Unsigned buckets, digits from the scalar words (c divides 16):
    (S, B, 2, 8) x (S, B, 8) -> (W, 2^c, B, 3, 8)."""
    return _jax_rows(_scalar_tables(pts_stream, sc_stream, None, c, False), False)


def bucket_accumulate_from_scalars_signed(pts_stream, sc_stream, masks, c: int, chunk: int = 32,
                                          wpair: bool = True) -> torch.Tensor:
    """Signed buckets, digits from the scalar words and carry words (c
    divides 16): -> (W, 2^(c-1), B, 3, 8)."""
    return _jax_rows(_scalar_tables(pts_stream, sc_stream, masks, c, True), True)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """A lane stream (S, B, ...) as one lane of S B steps, in stream order."""
    return x.reshape(-1, *x.shape[2:]).contiguous()


def msm_single_fused(pts_stream, digits, c: int, chunk: int = 64, signed: bool = False,
                     wgroup: int | None = None, fused: bool = False) -> torch.Tensor:
    """The single MSM of the whole stream from its digit tensor -> (3, 8):
    the whole stream as one lane, so no K2 fold."""
    _check_lanes(digits.shape[2])
    one = digits.to(torch.int32).reshape(digits.shape[0], 1, -1)
    buckets = KS.accumulate_digits(_flat(pts_stream), one, c, signed, key=_group_key(wgroup))
    return K.tail(buckets[:, 0].contiguous(), c)


def msm_single_fused_sc(pts_stream, sc_stream, c: int, chunk: int = 64) -> torch.Tensor:
    """The single MSM with unsigned digits from the scalar words -> (3, 8):
    the whole stream as one lane, so no K2 fold."""
    _check_lanes(pts_stream.shape[1])
    buckets = KS.accumulate(_flat(pts_stream), _flat(sc_stream), c, 1, None, False)
    return K.tail(buckets[:, 0].contiguous(), c)


def msm_single_fused_sc_signed(pts_stream, sc_stream, masks, c: int, chunk: int = 64,
                               wpair: bool = True) -> torch.Tensor:
    """The single MSM with signed digits from the scalar and carry words ->
    (3, 8): the whole stream as one lane, so no K2 fold."""
    _check_lanes(pts_stream.shape[1])
    buckets = KS.accumulate(_flat(pts_stream), _flat(sc_stream), c, 1, _flat(masks))
    return K.tail(buckets[:, 0].contiguous(), c)


def batched_bucket_tail(buckets, c: int, nbuckets: int | None = None, shifted: bool = False) -> torch.Tensor:
    """(W, rows, B, 3, 8) buckets -> (B, 3, 8): each lane's own MSM, its
    weighted bucket sums and Horner (K7). ``nbuckets`` live rows (default
    2^c); ``shifted``: row i is the bucket of digit i + 1 (signed tables),
    else row d is digit d and row 0 is dropped."""
    nb = (1 << c) if nbuckets is None else nbuckets
    live = buckets[:, :nb] if shifted else buckets[:, 1:nb]
    return KB.tail(live.permute(0, 2, 1, 3, 4).contiguous(), c)
