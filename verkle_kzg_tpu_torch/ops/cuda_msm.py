"""Kernels K3 and K4: the single-MSM Pippenger accumulation and tail.

K3 replaces ``verkle_kzg_tpu/ops/pallas_msm.py``: the launch in
``_bucket_accumulate_from_scalars_signed_impl`` with body
``_accum_kernel_sc_signed_pair`` (helpers ``_gather_scatter_step_pair`` and
``_negate_y_sel``). It derives the balanced signed c = 8 digits from the
scalar words and the packed carry bits (``ops/msm.py::signed_carries``),
negates y where d < 0 and adds the point into bucket row |d| - 1.

The TPU has no scatter, so each of its lanes kept a private bucket column
and every step gathered and scattered the whole table with masks. Hopper
scatters freely, so here the point stream is cut into S segments and one
thread owns one (window, segment) pair with its own 128-row table in
global memory, (W, S, 128, 3, 8) in all. A step is then one table row read,
one lazy mixed add (11 Montgomery products) and one row write. The kernel
is bound by those products (integer throughput) and by the latency of
its scattered 96-byte row accesses; S is chosen so that the W * S threads
fill the card's 132 SMs at the MSM sizes that matter (S = 1024 at 2^20
points). K2 then folds the S partial tables (``ops/msm.py``).

K4 replaces ``pallas_msm._single_tail``'s second launch, with bodies
``_suffix_horner_kernel`` and ``_window_sum``: per window the weighted sum
sum_i (i + 1) B_i, then Horner from the top window down (8 doublings, then
an add), output reduced. It is one block of 128 threads: four threads per
window each run a 32-row suffix sum, one thread per window combines the
four, and one thread runs Horner. It is bound by the latency of that serial
chain (about 280 dependent point operations, 248 of them the doublings of
Horner), which no width hides; the design keeps the window sums shallow so
that Horner is almost all of it.

Both plain versions follow their kernel's order of additions and domain
(lazy), so kernel and plain version agree bit for bit. The plain tail adds
in another order than the JAX double suffix scan, so against the JAX
package only the group element is compared.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from . import curve as C
from . import field as F

W = 32  # windows of c = 8 bits
ROWS = 128  # signed buckets per window: |d| in [1, 128]
CHUNKS = 4  # K4 threads per window
MASK_WORDS = 2  # carry_mask_words(32)


def signed_digits(sc, masks) -> torch.Tensor:
    """The digits K3 derives: (n, 8) standard scalars x (n, 2) carry words
    -> (n, 32) int64, d_w = byte w + carry-in bit w - (carry-out bit w+1) << 8."""
    dev = sc.device
    v = sc.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.tensor([0, 8, 16, 24], device=dev)
    raw = ((v[..., None] >> shifts) & 0xFF).reshape(-1, W)
    mv = masks.to(torch.int64) & 0xFFFFFFFF
    bits = ((mv[..., None] >> torch.arange(32, device=dev)) & 1).reshape(-1, 32 * MASK_WORDS)
    return raw + bits[:, :W] - (bits[:, 1 : W + 1] << 8)


def plain_accumulate(pts, sc, masks, nseg: int, seg_len: int) -> torch.Tensor:
    """K3's plain version: (S*L, 2, 8) affine x (S*L, 8) standard scalars x
    (S*L, 2) carry words -> (32, S, 128, 3, 8) reduced bucket tables."""
    dev = pts.device
    d = signed_digits(sc, masks).reshape(nseg, seg_len, W).permute(2, 0, 1)  # (W, S, L)

    p = F.to_limbs(pts).reshape(nseg, seg_len, 2, F.LIMBS)
    neg_y = F.sub16(torch.zeros_like(p[..., 1, :]), p[..., 1, :], "fq")
    table = C.infinity16((W, nseg, ROWS), dev)
    wi = torch.arange(W, device=dev)[:, None]
    si = torch.arange(nseg, device=dev)[None, :]
    for i in range(seg_len):
        di = d[:, :, i]
        y = torch.where((di < 0)[..., None], neg_y[:, i], p[:, i, 1])
        q = torch.stack([p[:, i, 0].expand_as(y), y], dim=-2)
        row = di.abs().clamp(min=1) - 1
        cur = table[wi, si, row]
        new = C.mixed_add16(cur, q, lazy=True)
        table[wi, si, row] = torch.where((di != 0)[..., None, None], new, cur)
    return F.from_limbs(C.reduce16(table))


def accumulate(pts, sc, masks, nseg: int, seg_len: int) -> torch.Tensor:
    if pts.device.type == "cpu":
        return plain_accumulate(pts, sc, masks, nseg, seg_len)
    n = nseg * seg_len
    if pts.shape != (n, 2, 8) or sc.shape != (n, 8) or masks.shape != (n, MASK_WORDS):
        raise ValueError("msm accumulate: shapes do not match the segmentation")
    cuda_lib.require_cuda("msm.accumulate", pts, sc, masks)
    table = torch.empty((W, nseg, ROWS, 3, 8), dtype=torch.int32, device=pts.device)
    err = cuda_lib.lib().vkzg_msm_accumulate(
        pts.data_ptr(), sc.data_ptr(), masks.data_ptr(), table.data_ptr(),
        nseg, seg_len, cuda_lib.stream(pts),
    )
    cuda_lib.check(err, "vkzg_msm_accumulate")
    cuda_lib.launches["K3"] += 1
    return table


def plain_tail(buckets: torch.Tensor) -> torch.Tensor:
    """K4's plain version: (32, 128, 3, 8) reduced buckets (row i = bucket
    of digit i + 1) -> (3, 8) reduced projective sum_w 2^(8w) sum_i (i+1) B_wi."""
    b = F.to_limbs(buckets).reshape(W, CHUNKS, ROWS // CHUNKS, 3, F.LIMBS)
    s = C.infinity16((W, CHUNKS), buckets.device)
    t = s
    for j in range(ROWS // CHUNKS - 1, -1, -1):
        s = C.add16(s, b[:, :, j], lazy=True)
        t = C.add16(t, s, lazy=True)
    u = s[:, CHUNKS - 1]
    v = u
    for c in range(CHUNKS - 2, 0, -1):
        u = C.add16(u, s[:, c], lazy=True)
        v = C.add16(v, u, lazy=True)
    for _ in range(5):  # x 32 = rows per chunk
        v = C.double16(v, lazy=True)
    for c in range(CHUNKS):
        v = C.add16(v, t[:, c], lazy=True)
    acc = v[W - 1]
    for win in range(W - 2, -1, -1):
        for _ in range(8):
            acc = C.double16(acc, lazy=True)
        acc = C.add16(acc, v[win], lazy=True)
    return F.from_limbs(C.reduce16(acc))


def tail(buckets: torch.Tensor) -> torch.Tensor:
    if buckets.device.type == "cpu":
        return plain_tail(buckets)
    if buckets.shape != (W, ROWS, 3, 8):
        raise ValueError("msm tail: buckets must be (32, 128, 3, 8)")
    cuda_lib.require_cuda("msm.tail", buckets)
    out = torch.empty((3, 8), dtype=torch.int32, device=buckets.device)
    err = cuda_lib.lib().vkzg_msm_tail(buckets.data_ptr(), out.data_ptr(), cuda_lib.stream(buckets))
    cuda_lib.check(err, "vkzg_msm_tail")
    cuda_lib.launches["K4"] += 1
    return out
