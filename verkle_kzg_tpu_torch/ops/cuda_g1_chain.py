"""Kernels G1SMUL and G1BFLY: the G1 scalar multiplication as one launch.

Replaces the chain of JAX's ``verkle_kzg_tpu/ops/curve.py::scalar_mul``
(line 239): a ``lax.scan`` over the 256 MSB-first bits of the scalars whose
every step is a doubling, a complete add and a select. The port ran each
step as three launches: K11 (``pallas_curve.py:328`` via ``double``,
``:350``), K2 (``:328``, ``add``) and a ``torch.where``. Its callers are
the G1 NTT's butterflies (``ops/ntt.py``), the 1/N of ``intt_g1`` and FK's
pointwise product (``schemes/fk.py``), 128-512 lanes a call.

- G1SMUL (``vkzg_g1_scalar_mul``) is ``curve.scalar_mul``: one lane a
  thread; a double-and-add in the reduced domain with K11's and K2's device
  functions (``csrc/bn254_curve.cuh``), in the scan's order.
- G1BFLY (``vkzg_g1_butterfly``) is one butterfly stage of the G1 NTT: one
  butterfly a thread, t = w_j v by the same chain, then u + t and u + (-t),
  with -t negating Y as ``field.neg`` does. The bit-reversal gather stays
  in PyTorch.

What bounds them: at a few hundred lanes the card holds 4-16 warps, one
or none for each of its 528 schedulers, so the time is one thread's
dependent chain of up to 256 x (8 + 12) Montgomery products, not the
multiply rate (the launch chain spent most of its 62 us a bit launching).
The design therefore cuts the chain: above the warp's highest set bit
the accumulator is the identity, whose doubling gives its own words, so
those rounds and the doubling at the top bit are skipped; an add that no
lane of the warp keeps is jumped over, a lane whose bit is 0 skipping its
add as the scan's select discards it. Neither changes a word. G1BFLY's
threads are j-major, so a warp shares its twiddle while
n / 2^(stage + 1) >= 32: the skips are then whole-warp, and stage 0
(every twiddle 1) costs one add and no doubling. The block size is an
argument (32, 64 or 128 threads): ``chip_smoke.py`` phase 2 times all
three, and :data:`BLOCK` holds the fastest.

The plain versions run the same operations on 16-bit limbs (``double16``,
``add16``) with the same skips taken over all lanes at once, so kernel,
plain version and the JAX scan agree word for word.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from . import curve as C
from . import field as F

#: Threads a block; 32, 64 or 128 (``__launch_bounds__(128)``).
BLOCK = 64


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


def scalar_mul(p: torch.Tensor, k: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """k p on (..., 3, 8) points and (..., 8) scalars: G1SMUL, one launch."""
    if p.device.type == "cpu" and k.device.type == "cpu":
        return plain_scalar_mul(p, k)
    lead = torch.broadcast_shapes(p.shape[:-2], k.shape[:-1])
    p = p.expand(lead + (3, F.WORDS)).contiguous()
    k = k.expand(lead + (F.WORDS,)).contiguous()
    cuda_lib.require_cuda("g1_chain.scalar_mul", p, k)
    out = torch.empty_like(p)
    n = out.numel() // (3 * F.WORDS)
    if n:
        err = cuda_lib.lib().vkzg_g1_scalar_mul(
            p.data_ptr(), k.data_ptr(), out.data_ptr(), n, block or BLOCK, cuda_lib.stream(out)
        )
        cuda_lib.check(err, "vkzg_g1_scalar_mul")
        cuda_lib.launches["G1SMUL"] += 1
    return out


def butterfly(x: torch.Tensor, tw: torch.Tensor, stage: int, block: int | None = None) -> torch.Tensor:
    """Stage ``stage`` of the G1 NTT on (n, 3, 8) points with the
    (2^stage, 8) twiddles of one block: G1BFLY, one launch."""
    if x.device.type == "cpu" and tw.device.type == "cpu":
        return plain_butterfly(x, tw, stage)
    n, half = x.shape[0], 1 << stage
    if x.shape != (n, 3, F.WORDS) or n & (n - 1) or n < 2 * half or tw.shape != (half, F.WORDS):
        raise ValueError("g1_chain.butterfly: x must be (n, 3, 8) with n a power of two >= 2^(stage + 1), "
                         "tw (2^stage, 8)")
    x, tw = x.contiguous(), tw.contiguous()
    cuda_lib.require_cuda("g1_chain.butterfly", x, tw)
    out = torch.empty_like(x)
    err = cuda_lib.lib().vkzg_g1_butterfly(
        x.data_ptr(), tw.data_ptr(), out.data_ptr(), n, stage, block or BLOCK, cuda_lib.stream(out)
    )
    cuda_lib.check(err, "vkzg_g1_butterfly")
    cuda_lib.launches["G1BFLY"] += 1
    return out
