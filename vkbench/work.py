"""The yardstick of the kernel rooflines: the least work that an op's
inputs need, whatever implements it, and the least time one H100 takes for
it. Every count here is a function of the inputs' shapes and of the scalar
bits the inputs carry, never of a window width, a regime or a launch shape
that the program chooses.

Units. A field multiplication is one Montgomery product of 8-word (256-bit)
operands: 8 x 8 words of product and 8 x 8 of reduction, low and high
halves, and the 8 reduction factors, 264 32-bit multiplies. Group operations
count the field multiplications of the complete projective formulas for
a = 0 (Renes-Costello-Batina 2016, algorithms 7-9), multiplications by the
constant 3b not counted: an add 12, a mixed add (affine operand) 11, a
doubling 8. A scalar multiplication counts binary double-and-add on its own
bits: bit length - 1 doublings and popcount - 1 adds (none for 0 or 1).

Peaks (NVIDIA H100 SXM5): 3.35 TB/s of HBM3 (the data sheet), and
64 32-bit integer multiplies a clock per SM (CUDA C++ Programming Guide,
"Arithmetic Instructions", compute capability 9.0) x 132 SMs x 1.98 GHz,
the card's highest SM clock.
"""

from __future__ import annotations

import functools
import math

HBM_BYTES_PER_S = 3.35e12
INT_MUL_PER_S = 64 * 132 * 1.98e9
MULS_PER_FMUL = 264

FMUL_ADD = 12
FMUL_MIXED_ADD = 11
FMUL_DOUBLE = 8

#: BN254's scalar field (EIP-196) and the radix-2 domain's generator.
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
SCALAR_BITS = 254
_TWO_ADIC_ROOT = pow(5, (R - 1) >> 28, R)

#: Bytes of an element, an affine point and a projective point.
FIELD_BYTES = 32
AFFINE_BYTES = 64
PROJECTIVE_BYTES = 96


def least_seconds(fmuls: float, nbytes: float) -> tuple:
    """(seconds, "int_mul" or "hbm"): the larger of the multiplies over the
    card's integer-multiply rate and the bytes over its bandwidth."""
    by_mul = fmuls * MULS_PER_FMUL / INT_MUL_PER_S
    by_bytes = nbytes / HBM_BYTES_PER_S
    return (by_mul, "int_mul") if by_mul >= by_bytes else (by_bytes, "hbm")


def scalar_mul_fmuls(doublings: int, adds: int) -> int:
    """Field multiplications of double-and-add with these counts."""
    return doublings * FMUL_DOUBLE + adds * FMUL_ADD


def scalar_steps(k: int) -> tuple:
    """(doublings, adds) that binary double-and-add needs for k."""
    k %= R
    if k < 2:
        return 0, 0
    return k.bit_length() - 1, bin(k).count("1") - 1


def msm_fmuls(points: int, bits: int = SCALAR_BITS) -> int:
    """The least field multiplications of a bucket method over ``points``
    nonzero scalars of ``bits`` bits: for the window c that gives the
    fewest, ceil(bits / c) windows of a mixed add per nonzero digit
    (1 - 2^-c of them), 2^c - 2 adds to sum 2^(c - 1) signed buckets, then
    c doublings and an add a window."""
    if points == 0:
        return 0
    best = None
    for c in range(1, 24):
        w = -(-bits // c)
        accumulate = w * points * (1 - 2.0**-c) * FMUL_MIXED_ADD
        buckets = w * ((1 << c) - 2) * FMUL_ADD
        combine = (w - 1) * (c * FMUL_DOUBLE + FMUL_ADD)
        total = accumulate + buckets + combine
        best = total if best is None else min(best, total)
    return int(best)


def msm_bytes(points: int) -> int:
    """Each point (affine) and scalar read once, one projective point out."""
    return points * (AFFINE_BYTES + FIELD_BYTES) + PROJECTIVE_BYTES


@functools.lru_cache(maxsize=None)
def g1_ntt_fmuls(n: int, inverse: bool) -> int:
    """A size-n radix-2 transform of G1 points: n / 2 log2 n butterflies,
    each its twiddle's scalar multiplication and two adds; the inverse
    also multiplies the n outputs by 1 / n. The twiddles are w^(n/m j) of
    each stage's block size m, so their bits follow from n alone."""
    logn = n.bit_length() - 1
    assert n == 1 << logn and n > 1
    w = pow(_TWO_ADIC_ROOT, 1 << (28 - logn), R)
    if inverse:
        w = pow(w, R - 2, R)
    pows = [1] * (n // 2)
    for i in range(1, n // 2):
        pows[i] = pows[i - 1] * w % R
    steps = [scalar_steps(p) for p in pows]
    total = 0
    for s in range(logn):
        m = 1 << (s + 1)
        stride = n // m
        for j in range(m // 2):
            total += (n // m) * scalar_mul_fmuls(*steps[stride * j])
    total += (n // 2) * logn * 2 * FMUL_ADD
    if inverse:
        total += n * scalar_mul_fmuls(*scalar_steps(pow(n, R - 2, R)))
    return total


def g1_ntt_bytes(n: int) -> int:
    """n projective points in and out, the n / 2 twiddles read once."""
    return 2 * n * PROJECTIVE_BYTES + (n // 2) * FIELD_BYTES


def scalar_mul_bytes(n: int) -> int:
    """n projective points and n scalars in, n projective points out."""
    return n * (2 * PROJECTIVE_BYTES + FIELD_BYTES)


def scalar_word_steps(words) -> tuple:
    """(nonzero scalars, doublings, adds) over (n, 8) standard-form scalar
    words (little-endian 32-bit words, any integer dtype), by binary
    double-and-add on each scalar's own bits. Pure torch on the words'
    device; returns 0-dim tensors, so nothing waits for the device."""
    import torch

    w = words.to(torch.int64) & 0xFFFFFFFF
    x = w - ((w >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    pop = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    popcount = pop.sum(-1)
    nz = w != 0
    top = torch.where(nz, torch.arange(1, w.shape[-1] + 1, device=w.device), 0).amax(-1)
    top_word = torch.gather(w, -1, (top - 1).clamp(min=0)[..., None])[..., 0]
    bitlen = torch.where(top > 0, (top - 1) * 32 + torch.frexp(top_word.to(torch.float64))[1], 0)
    live = popcount > 0
    big = bitlen > 1
    doublings = torch.where(big, bitlen - 1, 0).sum()
    adds = torch.where(big, popcount - 1, 0).sum()
    return live.sum(), doublings, adds


def share_pct(least_s: float, device_s: float):
    """100 x least / measured, or None where nothing was measured."""
    if device_s <= 0 or not math.isfinite(device_s):
        return None
    return 100.0 * least_s / device_s
