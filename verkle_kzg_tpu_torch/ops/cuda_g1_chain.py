"""Kernels G1SMUL and G1BFLY: the G1 scalar multiplication as one launch.

Replaces the chain of JAX's ``verkle_kzg_tpu/ops/curve.py::scalar_mul``
(line 239): a ``lax.scan`` over the 256 MSB-first bits of the scalars whose
every step is a doubling, a complete add and a select. The port ran each
step as three launches: K11 (``pallas_curve.py:328`` via ``double``,
``:350``), K2 (``:328``, ``add``) and a ``torch.where``. Its callers are
the G1 NTT's butterflies (``ops/ntt.py``), the 1/N of ``intt_g1`` and FK's
pointwise product (``schemes/fk.py``), 128-512 lanes a call.

- G1SMUL (``vkzg_g1_scalar_mul``) is ``curve.scalar_mul``: a
  double-and-add in the scan's order, a lane a group of threads.
- G1BFLY (``vkzg_g1_butterfly``) is one butterfly stage of the G1 NTT: a
  butterfly a group, t = w_j v by the same chain, then u + t and u + (-t),
  with -t negating Y as ``field.neg`` does. The bit-reversal gather stays
  in PyTorch.

What bounds them: at a few hundred lanes the card holds a warp or none
for each of its 528 schedulers, so the time is one lane's dependent chain
of about 381 point operations (254 doublings and about 127 adds for a
random 254-bit scalar), not the multiply rate. One thread ran that
chain on one thread, 12 Montgomery products an add and 8 a doubling in a
row (255 registers, spills) in the design before this one. Now a group of G threads runs a lane on
``csrc/warp_point.cuh``'s ``warp_double<true>`` / ``warp_add<true, G>``,
as K5 runs its mixed adds: each level's independent products on separate
threads, the operands in the group's shared scratch, so an operation's
chain is 2 products and the sums between them. The chain runs in the lazy
domain and each coordinate is reduced once at the end (G1BFLY also
reduces t before its two sums): every lazy intermediate lies below 2m and
is congruent to the reduced one, so the words are the reduced domain's.
Skips that change no word cut the chain: above the warp's highest set bit
every accumulator is the identity, whose doubling gives its own words, so
those rounds and the doubling at the top bit are skipped; the add runs on
a round where any group of the warp has the bit set, and a group whose
bit is 0 keeps its accumulator as the scan's select does. G1BFLY's groups
are j-major, so a warp's groups share a twiddle while
n / 2^(stage + 1) >= 32 / G: its skips are then one scalar's, and stage 0
(every twiddle 1) costs one add and no doubling.

Two regimes by lane count (:data:`SWITCH`, :data:`GROUP`), as K2's and
K11's: up to 1,024 lanes a group is a warp, so a warp runs one lane's
adds and no other's and the card holds a warp or two a scheduler; above,
4 threads a lane and 8 lanes a warp, so that a lane costs fewer warps
once the card is full. Every call on the port's paths is few-lane: FK's
product, the G1 NTTs' stages, ``intt_g1``'s 1/N and the four-step's
twiddle product take at most 512 lanes. No path reaches the many-lane
regime; it is there only so that ``curve.scalar_mul`` or a G1 NTT
called with more lanes runs no slower than the one-thread design before
the groups: a warp a lane falls behind that design between 8,192 and
32,768 lanes (at 32,768: 32.0 ms against 10.8; 4 threads a lane 7.6),
and 4 threads a lane beat a warp from 2,048 lanes on. Neither regime is a fallback for the other: a CUDA tensor
runs one of them or raises. The C entry points take only these two group
sizes.

The plain versions run the same operations on 16-bit limbs (``double16``,
``add16``) with the same skips taken over all lanes at once, so kernel,
plain version and the JAX scan agree word for word.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from . import curve as C
from . import field as F

# Set from tools/point_regimes.py --g1 on an NVIDIA H100 80GB HBM3 at
# 700 W, the kernel alone (torch.profiler): G1SMUL at 128 / 256 / 512 /
# 1,024 lanes 0.794 / 0.892 / 1.199 / 1.281 ms with 32 threads a lane (8:
# 0.986 / 0.990 / 1.132 / 1.136; 4: 1.314 / 1.304 / 1.291 / 1.396; one
# thread a lane, the design before: 10.33 / 10.33 / 10.28 / 10.31); at
# 2,048 / 8,192 / 32,768 lanes 2.290 / 8.394 / 32.03 with 32, 1.245 /
# 2.881 / 11.40 with 8, 1.402 / 2.021 / 7.553 with 4 (one thread 10.48 /
# 10.55 / 10.79). G1BFLY alike: stage 7 of 256 / stage 8 of 512 0.792 /
# 0.919 with 32 (8: 1.131 / 1.120; one thread 10.53 / 10.53). A group of
# 32 is the fastest over the paths' calls (at most 512 lanes) and beats 4
# up to 1,024 lanes; 4 is the fastest from 8,192 lanes on. 8 wins only at
# 512-2,048 lanes, by at most 6% where a path calls, so no regime runs it
# (tools/point_probe.cu keeps it to time). The one-thread design is slower
# than a group at every count. Every output exact in every group size.
#: Lanes at or below which G1SMUL and G1BFLY (a lane a butterfly) run the
#: few-lane regime.
SWITCH = 1024
#: Threads a lane in each regime.
GROUP = {"few": 32, "many": 4}
#: The group sizes the C entry points take: the regimes' own.
GROUPS = (4, 32)


def regime(lanes: int) -> str:
    """The regime G1SMUL and G1BFLY run ``lanes`` lanes in."""
    return "few" if lanes <= SWITCH else "many"


def _scalar_mul16(p16: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(..., 3, 16) limbs x (..., 8) scalar words of one shape -> limbs."""
    bits = C.scalar_bits_msb(k) != 0  # (256, ...)
    acc = C.infinity16(p16.shape[:-2], p16.device)
    live = bits.reshape(bits.shape[0], -1).any(1).nonzero()
    if live.numel() == 0:
        return acc
    top = int(live[0])
    for i in range(top, bits.shape[0]):
        if i > top:
            acc = C.double16(acc)
        bit = bits[i]
        if bool(bit.any()):
            acc = torch.where(bit[..., None, None], C.add16(acc, p16), acc)
    return acc


def plain_scalar_mul(p: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """G1SMUL's plain version: (..., 3, 8) reduced projective points x
    (..., 8) standard scalars -> (..., 3, 8), any device."""
    lead = torch.broadcast_shapes(p.shape[:-2], k.shape[:-1])
    p16 = F.to_limbs(p.expand(lead + p.shape[-2:]))
    return F.from_limbs(_scalar_mul16(p16, k.expand(lead + k.shape[-1:])))


def _pairs(n: int, stage: int, device) -> tuple:
    """(j, u index) of the n / 2 butterflies of a stage, blk-major."""
    half = 1 << stage
    t = torch.arange(n // 2, device=device)
    j = t % half
    return j, t // half * (2 * half) + j


def plain_butterfly(x: torch.Tensor, tw: torch.Tensor, stage: int) -> torch.Tensor:
    """G1BFLY's plain version: stage ``stage`` of the decimation-in-time G1
    NTT on (n, 3, 8) points, ``tw`` the (2^stage, 8) standard-form
    twiddles of one block, any device. The composition ``ntt.py`` ran
    before G1BFLY: t = tw_j v, then u + t and u + (-t)."""
    half = 1 << stage
    j, u_idx = _pairs(x.shape[0], stage, x.device)
    u = F.to_limbs(x[u_idx])
    t = _scalar_mul16(F.to_limbs(x[u_idx + half]), tw[j])
    tx, ty, tz = t.unbind(-2)
    neg = torch.stack([tx, F.sub16(torch.zeros_like(ty), ty, "fq"), tz], dim=-2)
    out = torch.empty_like(x)
    out[u_idx] = F.from_limbs(C.add16(u, t))
    out[u_idx + half] = F.from_limbs(C.add16(u, neg))
    return out


def _launch_scalar_mul(p: torch.Tensor, k: torch.Tensor, group: int) -> torch.Tensor:
    """G1SMUL over contiguous (n, 3, 8) points and (n, 8) scalars with
    ``group`` threads a lane (one of :data:`GROUPS`), counted."""
    cuda_lib.require_cuda("g1_chain.scalar_mul", p, k)
    out = torch.empty_like(p)
    n = out.numel() // (3 * F.WORDS)
    if n:
        err = cuda_lib.lib().vkzg_g1_scalar_mul(p.data_ptr(), k.data_ptr(), out.data_ptr(), n, group,
                                                cuda_lib.stream(out))
        cuda_lib.check(err, "vkzg_g1_scalar_mul")
        cuda_lib.launches["G1SMUL"] += 1
    return out


def _launch_butterfly(x: torch.Tensor, tw: torch.Tensor, stage: int, group: int) -> torch.Tensor:
    """G1BFLY over contiguous (n, 3, 8) points and (2^stage, 8) twiddles
    with ``group`` threads a butterfly (one of :data:`GROUPS`), counted."""
    cuda_lib.require_cuda("g1_chain.butterfly", x, tw)
    out = torch.empty_like(x)
    err = cuda_lib.lib().vkzg_g1_butterfly(x.data_ptr(), tw.data_ptr(), out.data_ptr(), x.shape[0], stage, group,
                                           cuda_lib.stream(out))
    cuda_lib.check(err, "vkzg_g1_butterfly")
    cuda_lib.launches["G1BFLY"] += 1
    return out


def scalar_mul(p: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k p on (..., 3, 8) points and (..., 8) scalars: G1SMUL, one launch."""
    if p.device.type == "cpu" and k.device.type == "cpu":
        return plain_scalar_mul(p, k)
    lead = torch.broadcast_shapes(p.shape[:-2], k.shape[:-1])
    p = p.expand(lead + (3, F.WORDS)).contiguous()
    k = k.expand(lead + (F.WORDS,)).contiguous()
    return _launch_scalar_mul(p, k, GROUP[regime(p.numel() // (3 * F.WORDS))])


def butterfly(x: torch.Tensor, tw: torch.Tensor, stage: int) -> torch.Tensor:
    """Stage ``stage`` of the G1 NTT on (n, 3, 8) points with the
    (2^stage, 8) twiddles of one block: G1BFLY, one launch."""
    if x.device.type == "cpu" and tw.device.type == "cpu":
        return plain_butterfly(x, tw, stage)
    n, half = x.shape[0], 1 << stage
    if x.shape != (n, 3, F.WORDS) or n & (n - 1) or n < 2 * half or tw.shape != (half, F.WORDS):
        raise ValueError("g1_chain.butterfly: x must be (n, 3, 8) with n a power of two >= 2^(stage + 1), "
                         "tw (2^stage, 8)")
    x, tw = x.contiguous(), tw.contiguous()
    return _launch_butterfly(x, tw, stage, GROUP[regime(n // 2)])
