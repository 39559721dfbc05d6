"""Kernels K2, K11 and K12: element-wise complete projective group law; K2FOLD.

Replaces ``verkle_kzg_tpu/ops/pallas_curve.py``: the launch ``_point_call``
(line 328) behind ``add`` (K2, body ``k_point_add``), ``double`` (K11,
line 350, body ``k_point_double``) and ``mixed_add`` (K12, line 358, body
``k_point_mixed_add``), all with reduced words out. K2 runs ``curve.add``;
no path of the port calls it since K2FOLD took its last callers. K11 runs
``curve.double``. ``curve.scalar_mul`` and the G1
NTT's butterflies run as one launch a call (G1SMUL, G1BFLY in
``cuda_g1_chain.py``, on the lazy warp point operations), no longer as a
K11 and a K2 launch a bit. K12 has no
caller on any path of either package; it makes ``curve.mixed_add`` run on
the card.
The lazy group law that K3-K10 inline lives beside them in
``csrc/bn254_curve.cuh``.

K2 does 12 Montgomery products and 21 modular add/subs on 48 words of
input, K11 8 products and 11 add/subs on 24 words, K12 11 products on 40
words. A product is about 500 dependent instructions (0.68 us on one
thread), so one thread's add is a chain of 12 of them, a mixed add of 11,
a doubling of 8. All three run in two regimes (:data:`SWITCH`,
:data:`GROUP`):

- few points: a group of threads a point, the operation's independent
  products on separate threads (``csrc/warp_point.cuh``'s ``warp_add`` /
  ``warp_double`` in the reduced domain, ``warp_mixed_add`` in the lazy
  one, operands in shared memory): 6 + 6 products for the add, 5 + 6 for
  the mixed add, 4 + 4 for the doubling, so a point's dependent chain is 2
  products and the sums between them;
- many points: one point a thread (``point_add<false>`` /
  ``point_double<false>``; ``point_mixed_add<true>``, the sorted sums'
  body). Once the card is
  full the products' throughput sets the time, and a group's idle threads
  and repeated sums cost more than the chain they hide: groups of 4 with
  two passes a level were slower at 32,768 points and at 2^20. At 2^20
  the add takes 2.7x its multiply bound, the port's Montgomery products'
  usual pace (the sorted sums run at 2.6x).

K12 runs the lazy domain in both regimes and reduces each coordinate once
at the end: every lazy intermediate lies below 2m and is congruent to the
reduced one, so the words are the reduced domain's, at about a tenth less
time (``tools/point_probe.cu``). Every intermediate of the reduced domain
is canonical, so all regimes give the one-thread reduced functions' words
and the plain versions'. Neither regime is a fallback for the other: a CUDA tensor runs
one of them or raises. The kernels pin 128 threads a block with
``__launch_bounds__`` and the build prints their registers and spills.
Each runs the same sequence of field operations as its Pallas body, so
kernel, plain version and the JAX package agree bit for bit. K12's (0, 0)
sentinel lanes keep p, as the Pallas kernel's final select does (a
group's ``keep`` flag; one thread skips the add).

Kernel K2FOLD (:func:`fold`): ``ops/msm.py::fold_reduce_lanes``, the sum of
each row of points by a halving tree, which ran as one K2 launch a level
(``plain_fold``; the JAX package's ``verkle_kzg_tpu/ops/msm.py:67``
``fold_reduce_lanes`` on ``pallas_curve.add``): the K5 products of the MSMs
under 64 points (``msm_auto``, ``_batched_naive_affine``) and of the sparse
verkle commits (``verkle/tree.py``, 8 terms a node). Six launches of 25-34 us
for the 51 points of a verkle verify, three for the sparse commits. What
bounds it is the tree's dependent point adds (one a level, about 6 us on
one thread), not bytes. The design is one launch for the whole tree:
``group`` threads share a row (a power of two up to 32, enough for the
first level's pairs), a block of 128 threads holds 128 / group rows, and
the levels step together on ``__syncthreads()``, in place in a scratch
buffer after the first. Pairs and the odd tail point take the plain
version's slots, so the projective words are its words.

Kernel K1AFF (``csrc/affine.cu``, :func:`affine_words`): projective points
to the standard-form canonical affine words that the host reads, (0, 0)
where Z = 0. It replaces the K1 work of the JAX package's
``verkle_kzg_tpu/ops/curve.py::projective_to_host_points`` (lines 320-329),
which runs ``to_affine`` (lines 273-284: ``batch_inv_mont`` and two
``mont_mul``, the ``pallas_call`` of ``ops/pallas_field.py:298``) on the
device before it reads the words. The port had read the projective words
and done the work in Python ints instead: three products out of Montgomery
form, a ``pow(z, -1, Q)`` and two products a point, about 0.7-0.8 s for the
30,000 node commitments of a 10,000-leaf verkle commit. Every
``curve.projective_to_host_points`` on a card tensor is now one launch and
one read. What bounds it is one inversion's dependent chain a row
(field_inv.cuh's ``finv``: 18 rounds of 31 steps on 64-bit registers,
Pornin's binary GCD, in place of about 500 steps on 256-bit words, which
took a one-point call to about 0.07 ms), not bytes (160 a point) or
products (about 7 a point). The design is a
block a row of up to 256 points, a point a thread: the Z's prefix and
suffix products scanned in shared memory, one inversion a row, each Z^-1
from the row's inverse and two scanned products; rows shrink (to one
point) until the launch has a block an SM, so that the inversions run side
by side and a call of a few points does no scan. Every product is reduced and an inverse is unique, so the words are
the plain version's, whatever the row split.
"""

from __future__ import annotations

import torch

from ..utils.metrics import span
from . import cuda_field as KF
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


def plain_fold(p: torch.Tensor) -> torch.Tensor:
    """K2FOLD's plain version: (rows, n, 3, 8) -> (rows, 1, 3, 8) by halving,
    pair (i, i + half) into slot i and the odd point carried to the end of
    the level, each level one K2 plain version."""
    while p.shape[1] > 1:
        n = p.shape[1]
        half = n // 2
        folded = plain(p[:, :half], p[:, half : 2 * half])
        p = torch.cat([folded, p[:, 2 * half :]], dim=1) if n % 2 else folded
    return p


@span("kernels", "K2FOLD")
def fold(p: torch.Tensor) -> torch.Tensor:
    """Kernel K2FOLD: the sum of each row of (rows, n, 3, 8) projective
    points -> (rows, 1, 3, 8), in one launch (none when n is 1)."""
    if p.device.type == "cpu":
        return plain_fold(p)
    if p.dim() != 4 or p.shape[2:] != (3, F.WORDS):
        raise ValueError(f"curve.fold: points must be (rows, n, 3, 8), got {tuple(p.shape)}")
    rows, n = p.shape[:2]
    p = p.contiguous()
    cuda_lib.require_cuda("curve.fold", p)
    if n == 1:
        return p
    work = torch.empty((rows, (n + 1) // 2, 3, F.WORDS), dtype=p.dtype, device=p.device)
    if rows:
        err = cuda_lib.lib().vkzg_point_fold(p.data_ptr(), work.data_ptr(), rows, n, cuda_lib.stream(p))
        cuda_lib.check(err, "vkzg_point_fold")
        cuda_lib.launches["K2FOLD"] += 1
    return work[:, :1]


# Set from tools/point_regimes.py on an NVIDIA H100 80GB HBM3 at 700 W,
# the kernel alone (torch.profiler), its first pass: K2 at 1-1,024 points
# 4.0-4.6 us with 8 threads a point (4.0-6.0 with 32, 5.8-6.7 with 4,
# 11.2-12.4 one a thread), K11 3.3-3.4 (7.0-8.0 one a thread); at 8,192 K2
# 10.5 us against 13.4 one a thread, K11 8.0 against 9.0; at 16,384 18.9
# against 13.7 and 14.1 against 9.2. At 2^20 one point a thread takes
# 0.545 ms (K2) and 0.309 (K11), groups of 4 0.818 and 0.388. A second
# pass right after 2^20-point launches reads the same, once each row counts
# the kernel records the profiler kept (0-10 of 10 there). K12 at 1-1,024
# points 3.1-3.2 us with 8 threads a point (3.1-4.5 with 32, 4.5-4.7 with
# 4, 9.4-10.3 one a thread); at 8,192 7.5 against 11.4, at 16,384 13.2
# against 11.6: its crossing falls where K2's does, so it shares SWITCH and
# GROUP. At 2^20 one point a thread takes 0.439 ms, groups of 4 0.579.
# Each output is exact in every group size. A call by CUDA events costs
# 0.02-0.13 ms at any count up to 32,768 in either regime: there the
# enqueue sets it, not the kernel.
#: Points at or below which K2, K11 and K12 run the few-point regime.
SWITCH = 8192
#: Threads a point in each regime (1: one point a thread).
GROUP = {"few": 8, "many": 1}
#: The group sizes the C entry points take.
GROUPS = (1, 4, 8, 32)

#: Launches of each regime of K2, K11 and K12 since the last
#: :func:`reset_regimes` (``cuda_lib.launches["K2"]``, ``["K11"]`` and
#: ``["K12"]`` count both).
regime_launches = {key: {"few": 0, "many": 0} for key in ("K2", "K11", "K12")}


def reset_regimes() -> None:
    for counts in regime_launches.values():
        for k in counts:
            counts[k] = 0


def regime(n: int) -> str:
    """The regime K2, K11 and K12 run ``n`` points in."""
    return "few" if n <= SWITCH else "many"


def _launch(fn: str, key: str, out: torch.Tensor, *ins: torch.Tensor, group: int) -> torch.Tensor:
    """Run kernel entry ``fn`` over the points of ``out`` with ``group``
    threads a point (one of :data:`GROUPS`) and count it."""
    cuda_lib.require_cuda("curve." + fn, out, *ins)
    n = out.numel() // (3 * F.WORDS)
    if n:
        err = getattr(cuda_lib.lib(), fn)(
            *(t.data_ptr() for t in ins), out.data_ptr(), n, group, cuda_lib.stream(out)
        )
        cuda_lib.check(err, fn)
        cuda_lib.launches[key] += 1
    return out


def _regime_launch(fn: str, key: str, out: torch.Tensor, *ins: torch.Tensor) -> torch.Tensor:
    """K2, K11 or K12 in the regime that the point count picks, counted."""
    n = out.numel() // (3 * F.WORDS)
    mode = regime(n)
    _launch(fn, key, out, *ins, group=GROUP[mode])
    if n:
        regime_launches[key][mode] += 1
    return out


@span("kernels", "K2")
def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if p.device.type == "cpu" and q.device.type == "cpu":
        return plain(p, q)
    p, q = torch.broadcast_tensors(p, q)
    p, q = p.contiguous(), q.contiguous()
    return _regime_launch("vkzg_point_add", "K2", torch.empty_like(p), p, q)


@span("kernels", "K11")
def double(p: torch.Tensor) -> torch.Tensor:
    if p.device.type == "cpu":
        return plain_double(p)
    p = p.contiguous()
    return _regime_launch("vkzg_point_double", "K11", torch.empty_like(p), p)


@span("kernels", "K12")
def mixed_add(p: torch.Tensor, q_aff: torch.Tensor) -> torch.Tensor:
    if p.device.type == "cpu" and q_aff.device.type == "cpu":
        return plain_mixed_add(p, q_aff)
    lead = torch.broadcast_shapes(p.shape[:-2], q_aff.shape[:-2])
    p = p.expand(lead + p.shape[-2:]).contiguous()
    q_aff = q_aff.expand(lead + q_aff.shape[-2:]).contiguous()
    return _regime_launch("vkzg_point_mixed_add", "K12", torch.empty_like(p), p, q_aff)


def affine_row(n: int, sms: int) -> int:
    """Points a K1AFF block takes for ``n`` points on a card of ``sms``
    SMs: 256, halved (down to 1) while the launch would have fewer blocks
    than SMs, so that the rows' inversions run side by side and a few
    points skip the scan."""
    row = 256
    while row > 1 and -(-n // row) < sms:
        row //= 2
    return row


def plain_affine_words(p: torch.Tensor) -> torch.Tensor:
    """K1AFF's plain version, on K1INV's and K1's plain versions, any
    device: (..., 3, 8) projective Montgomery words -> (N, 2, 8) standard
    canonical affine words, (0, 0) where Z = 0 (its inverse is 0)."""
    flat = p.reshape(-1, 3, F.WORDS)
    zinv = KF.plain_batch_inv(flat[None, :, 2], "fq")[0]
    xy = KF.plain("mul", flat[:, :2], zinv[:, None].expand(-1, 2, -1), "fq")
    return KF.plain("mul", xy, F.const_words(1, p.device).expand_as(xy), "fq")  # by the plain 1: out of the form


@span("kernels", "K1AFF")
def affine_words(p: torch.Tensor) -> torch.Tensor:
    """Kernel K1AFF: (..., 3, 8) projective Montgomery words -> (N, 2, 8)
    standard-form canonical affine x and y, (0, 0) where Z = 0, N the
    points of the leading axes, in one launch. CPU tensors take the plain
    version."""
    if p.device.type == "cpu":
        return plain_affine_words(p)
    if p.dim() < 2 or p.shape[-2:] != (3, F.WORDS):
        raise ValueError(f"curve.affine_words: points must be (..., 3, 8), got {tuple(p.shape)}")
    flat = p.reshape(-1, 3, F.WORDS).contiguous()
    cuda_lib.require_cuda("curve.affine_words", flat)
    n = flat.shape[0]
    out = torch.empty((n, 2, F.WORDS), dtype=flat.dtype, device=flat.device)
    if n:
        row = affine_row(n, torch.cuda.get_device_properties(flat.device).multi_processor_count)
        err = cuda_lib.lib().vkzg_affine(flat.data_ptr(), out.data_ptr(), n, row, cuda_lib.stream(flat))
        cuda_lib.check(err, "vkzg_affine")
        cuda_lib.launches["K1AFF"] += 1
    return out
