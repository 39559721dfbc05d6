"""Kernels K1QUO and K1MP: the proof paths' last K1 chains, each in one launch.

K1QUO (``csrc/quotient.cu``, :func:`quotient`) is the in-domain quotient
q = (f - f_z) / (X - w^z) with its correction at i = z, for rows at once,
or their field sum (the multiproof's g). It replaces the K1 chain that ran
``verkle_kzg_tpu/poly/lagrange.py:26-40`` (``_quotient_in_domain``, one
jitted program there; here a sub, a product, a product, a negation and an
8-level add tree) with what fed it: the ratio product, ``Domain.invdiff_rows``
(a sub and a K1INV launch over (Zq, N, 8)) and, in the multiproof, the add
tree over the rows. A KZG prove at an index ran 15 K1 and 1 K1INV launches
around its MSM, each 20-45 us of host-bound time for a few microseconds of
work. The kernel needs no inversion: 1 / (w^i - w^z) = w^-z T[(i - z) mod N]
with the domain's table T[k] = 1 / (w^k - 1), T[0] = 0
(``Domain.invdiff_table``), and A'(w^z) / A'(w^i) = w^(i - z). The wrapper
and the plain version are ``poly/lagrange.py::quotient_in_domain`` and
``_quotient_in_domain_table``; the per-row plain version is JAX's
``_quotient_in_domain``.

K1MP (``csrc/multiproof.cu``, :func:`segment_sum`) is the multiproof's two
passes around its commits (``verkle_kzg_tpu/schemes/multiproof.py:78-129``:
``_scale_and_group`` and ``_h_accumulate``, jitted programs there):

  * the grouped pass, grouped[j] = sum over the queries m opened at z_j of
    r^m data[m], with r^m from power tables each block scans from r;
  * the h pass, h = sum_j grouped[j] / (t - z_j), and h - g, exact in the
    field, so the words equal those of JAX's sum over the M queries.

Both are one kernel, a weighted sum over the positions of each segment,
which the host plans (:func:`plan_segments`): it holds every z as an int,
so the order by z and the segments are uploaded with the call, and no
device sort, ``bincount`` or host sync runs. Before, the passes were about
66 K1 launches at 1,024 queries (the powers, the scaling, a segmented
Hillis-Steele scan of log2 M adds, the products and add tree of h).

What bounds them on the card is the launch and then dependent products
(0.68 us each on one thread, ``tools/fmul_probe.py``), not bytes: at 1,024
queries, 251 points and N = 256 the grouped pass is 262,144 products, the
quotient 3 x 64,256, the h pass 64,256 (about 0.004 ms of the card's
multiplies). So the work is cut so that no thread runs a long chain:
K1QUO takes a row a block, an element a thread, and sums its correction
by a tree; K1MP cuts each segment into chunks of at most ``CHUNK``
queries spread over the sub-lanes of a block, so a thousand queries at
one point are 32 chunks summed by a tree, not a chain of a thousand.

CPU tensors take the plain versions; a CUDA tensor takes the kernel or
raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.metrics import span, wait_for
from . import cuda_field as KF
from . import cuda_lib
from . import field as F

CHUNK = 32  # positions of a K1MP chunk at most (``csrc/multiproof.cu``)
DIGIT = 5  # exponent bits of a power-table level
QUO_ROWS = 4  # rows a K1QUO block sums in the summed mode
PLAIN_ELEMENTS = 1 << 21  # elements a product of the plain version takes at once


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Positions in segment order and their cut into chunks, all int64
    arrays: ``pos_row``/``pos_e`` (P,) each position's row and its exponent
    (mode 0) or weight index (mode 1); ``seg_start``/``seg_len`` (S,);
    ``chunk_seg``/``chunk_start``/``chunk_len`` (C,); ``seg_first``/
    ``seg_count`` (S,) each segment's chunks."""

    pos_row: np.ndarray
    pos_e: np.ndarray
    seg_start: np.ndarray
    seg_len: np.ndarray
    chunk_seg: np.ndarray
    chunk_start: np.ndarray
    chunk_len: np.ndarray
    seg_first: np.ndarray
    seg_count: np.ndarray

    def packed(self) -> np.ndarray:
        """The kernel's int32 plan: pos_row, pos_e, chunk_seg, chunk_start,
        chunk_len, seg_first, seg_count."""
        return np.concatenate([self.pos_row, self.pos_e, self.chunk_seg, self.chunk_start, self.chunk_len,
                               self.seg_first, self.seg_count]).astype(np.int32)


@span("kernels", "K1MP.plan")
def plan_segments(keys, rows) -> tuple:
    """Position m has segment key ``keys[m]`` and row ``rows[m]``; its
    exponent (weight index) is m. Returns the sorted distinct keys and the
    plan: positions in the stable order by key, one segment a key."""
    key = np.asarray(keys, dtype=np.int64)
    if key.size == 0:
        raise ValueError("segment sum: no positions")
    order = np.argsort(key, kind="stable")
    ks = key[order]
    seg_start = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    seg_len = np.diff(np.r_[seg_start, ks.size])
    seg_count = -(-seg_len // CHUNK)
    seg_first = np.r_[0, np.cumsum(seg_count)[:-1]]
    chunk_seg = np.repeat(np.arange(seg_start.size), seg_count)
    chunk_start = seg_start[chunk_seg] + (np.arange(chunk_seg.size) - seg_first[chunk_seg]) * CHUNK
    chunk_len = np.minimum(CHUNK, seg_start[chunk_seg] + seg_len[chunk_seg] - chunk_start)
    plan = SegmentPlan(np.asarray(rows, dtype=np.int64)[order], order, seg_start, seg_len, chunk_seg,
                       chunk_start, chunk_len, seg_first, seg_count)
    return ks[seg_start].tolist(), plan


def _k1(op: str, a, b):
    return KF.plain(op, a, b, "fr")


def plain_powers(r: torch.Tensor, m: int) -> torch.Tensor:
    """[1, r, ..., r^(m-1)] of (8,) Montgomery words -> (m, 8), by doubling
    the known prefix with one product a round (``F.powers_of_mont``'s
    algorithm on K1's plain version)."""
    out = F.const_words(F.SPECS["fr"].r_mod, r.device)[None]
    step = r[None]
    while out.shape[0] < m:
        out = torch.cat([out, _k1("mul", out, step.expand_as(out))])
        step = _k1("mul", step, step)
    return out[:m]


def plain_segment_sum(rows, weights, plan: SegmentPlan, mode: int, g=None):
    """K1MP's plain version on K1's plain version, on any device: each
    position's weight (mode 0: r^e from :func:`plain_powers`; mode 1:
    ``weights[e]``) times its row (in pieces of at most
    :data:`PLAIN_ELEMENTS` elements), then the positions of each segment
    summed pairwise, a round halving every segment (an odd one's last
    position passes), until one position a segment is left. Every sum is
    reduced, so the words equal the kernel's whatever the order."""
    dev = rows.device
    e = torch.from_numpy(plan.pos_e).to(dev)
    w = plain_powers(weights, int(plan.pos_e.max()) + 1)[e] if mode == 0 else weights[e]
    pos_row = torch.from_numpy(plan.pos_row).to(dev)
    step = max(1, PLAIN_ELEMENTS // rows.shape[1])  # positions a product call: its limb products stay a few GB
    x = torch.cat([_k1("mul", rows[pos_row[s : s + step]], w[s : s + step, None])
                   for s in range(0, pos_row.numel(), step)])
    lens = plan.seg_len.astype(np.int64)
    while lens.max() > 1:
        starts, half = np.r_[0, np.cumsum(lens)[:-1]], lens // 2
        new_lens = lens - half
        new_starts = np.r_[0, np.cumsum(new_lens)[:-1]]
        seg = np.repeat(np.arange(lens.size), half)  # each pair's segment and its index there
        i = np.arange(seg.size) - np.repeat(np.cumsum(half) - half, half)
        left = torch.from_numpy(starts[seg] + 2 * i).to(dev)
        odd = np.flatnonzero(lens % 2)  # their last position passes
        last = torch.from_numpy(starts[odd] + lens[odd] - 1).to(dev)
        y = torch.empty((int(new_lens.sum()),) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
        y[torch.from_numpy(new_starts[seg] + i).to(dev)] = _k1("add", x[left], x[left + 1])
        y[torch.from_numpy(new_starts[odd] + half[odd]).to(dev)] = x[last]
        x, lens = y, new_lens
    return x if g is None else (x, _k1("sub", x[0], g))


@span("kernels", "K1MP")
def segment_sum(rows: torch.Tensor, weights: torch.Tensor, plan: SegmentPlan, mode: int, g=None):
    """Kernel K1MP: out[j] = sum over segment j's positions k of
    w_k rows[pos_row[k]], rows (R, N, 8) Fr Montgomery words, N a power of
    two, out (S, N, 8). Mode 0: ``weights`` is r, (8,) Montgomery words,
    and w_k = r^pos_e[k]; mode 1: ``weights`` is (W, 8) and
    w_k = weights[pos_e[k]]. With ``g`` (N, 8) (one segment) also returns
    out[0] - g. One launch; CPU tensors take :func:`plain_segment_sum`."""
    if rows.device.type == "cpu":
        return plain_segment_sum(rows, weights, plan, mode, g)
    n = rows.shape[1] if rows.dim() == 3 else 0
    if rows.dim() != 3 or rows.shape[2] != F.WORDS or n & (n - 1) or n < 1:
        raise ValueError(f"segment sum: rows must be (R, N, 8) with N a power of two, got {tuple(rows.shape)}")
    if mode not in (0, 1) or weights.shape != ((F.WORDS,) if mode == 0 else (weights.shape[0], F.WORDS)):
        raise ValueError(f"segment sum: mode {mode} takes weights (8,) or (W, 8), got {tuple(weights.shape)}")
    segments, chunks, positions = plan.seg_len.size, plan.chunk_seg.size, plan.pos_row.size
    if g is not None and (segments != 1 or g.shape != (n, F.WORDS)):
        raise ValueError("segment sum: out - g needs one segment and g of shape (N, 8)")
    if not 0 <= plan.pos_row.min() <= plan.pos_row.max() < rows.shape[0] or (
            mode == 1 and plan.pos_e.max() >= weights.shape[0]):
        raise ValueError("segment sum: the plan indexes past the rows or weights")
    if plan.chunk_len.max() > CHUNK:
        raise ValueError(f"segment sum: a chunk holds at most {CHUNK} positions")
    dev = rows.device
    plan_t = wait_for("K1MP.upload", torch.from_numpy(plan.packed()).to, dev)
    cuda_lib.require_cuda("multiproof.segment_sum", rows, weights, plan_t, *(() if g is None else (g,)))
    tc = min(n, 32)
    multi = bool((plan.seg_count > 1).any())
    partials = torch.empty((chunks, n, F.WORDS), dtype=torch.int32, device=dev) if multi else None
    counters = torch.empty(segments * (n // tc), dtype=torch.int32, device=dev) if multi else None
    out = torch.empty((segments, n, F.WORDS), dtype=torch.int32, device=dev)
    out_minus = None if g is None else torch.empty((n, F.WORDS), dtype=torch.int32, device=dev)
    levels = power_levels(plan) if mode == 0 else 1
    err = cuda_lib.lib().vkzg_mp_segment_sum(
        rows.data_ptr(), weights.data_ptr(), plan_t.data_ptr(), _ptr(partials), _ptr(counters), out.data_ptr(),
        _ptr(out_minus), _ptr(g), positions, chunks, segments, n, levels, mode, cuda_lib.stream(rows),
    )
    cuda_lib.check(err, "vkzg_mp_segment_sum")
    cuda_lib.launches["K1MP"] += 1
    return out if g is None else (out, out_minus)


def power_levels(plan: SegmentPlan) -> int:
    """The power tables' levels that the grouped pass (mode 0) builds for
    ``plan``: base-32 digits of the largest exponent, at least one (2 up to
    1,024 queries, 3 up to 32,768, 4 up to 2^20)."""
    return max(1, -(-int(plan.pos_e.max()).bit_length() // DIGIT))


def _ptr(t):
    return None if t is None else t.data_ptr()


@span("kernels", "K1QUO")
def quotient(vals: torch.Tensor, zs, omegas: torch.Tensor, table: torch.Tensor, sum_rows: bool) -> torch.Tensor:
    """One K1QUO launch on the card: vals (Zq, N, 8) Fr Montgomery rows, zs
    their Zq domain indices (ints in [0, N)), the domain's omegas and
    ``invdiff_table`` (N, 8). Returns the quotient rows (Zq, N, 8), or with
    ``sum_rows`` their sum (N, 8). The wrapper that takes CPU tensors to
    the plain version is ``poly/lagrange.py::quotient_in_domain``."""
    if vals.device.type != "cuda":
        raise ValueError("quotient: the K1QUO launch takes CUDA tensors (the plain version is the CPU's)")
    zq, n = (vals.shape[0], vals.shape[1]) if vals.dim() == 3 else (0, 0)
    if vals.dim() != 3 or vals.shape[2] != F.WORDS or zq < 1 or n < 1 or n & (n - 1):
        raise ValueError(f"quotient: vals must be (Zq, N, 8) with N a power of two, got {tuple(vals.shape)}")
    if len(zs) != zq or omegas.shape != (n, F.WORDS) or table.shape != (n, F.WORDS):
        raise ValueError("quotient: one index a row, omegas and table (N, 8)")
    if any(not 0 <= z < n for z in zs):
        raise ValueError(f"quotient: domain indices must lie in [0, {n})")
    dev = vals.device
    idx = wait_for("K1QUO.upload", torch.tensor(list(zs), dtype=torch.int32).to, dev)
    cuda_lib.require_cuda("quotient", vals, idx, omegas, table)
    blocks = -(-zq // QUO_ROWS) if sum_rows else zq
    out = torch.empty((n, F.WORDS) if sum_rows else (zq, n, F.WORDS), dtype=torch.int32, device=dev)
    scratch = sum_rows and blocks > 1
    partials = torch.empty((blocks, n, F.WORDS), dtype=torch.int32, device=dev) if scratch else None
    counter = torch.empty(4, dtype=torch.int32, device=dev) if scratch else None
    err = cuda_lib.lib().vkzg_quotient(
        vals.data_ptr(), idx.data_ptr(), omegas.data_ptr(), table.data_ptr(), out.data_ptr(), _ptr(partials),
        _ptr(counter), zq, n, int(sum_rows), blocks, cuda_lib.stream(vals),
    )
    cuda_lib.check(err, "vkzg_quotient")
    cuda_lib.launches["K1QUO"] += 1
    return out
