"""Kernel K1: element-wise Fr/Fq Montgomery product and modular add/sub.

Replaces ``verkle_kzg_tpu/ops/pallas_field.py``: the launch
``_elementwise_call`` behind ``mont_mul``/``add``/``sub``, with its bodies
``k_mont_mul``, ``k_add`` and ``k_sub``. Their inlined lazy forms
(``k_mont_mul_lazy``, ``k_add_lazy``, ``k_sub_lazy``, ``k_mul9_lazy``) live
in ``csrc/bn254_field.cuh`` too, which every other kernel includes.

On the card: one element per thread, eight 32-bit words. The Montgomery
product is CIOS with 32x32->64-bit products, about 140 integer
multiply-adds per element, so K1 is bound by integer throughput when
its batch is large and by launch latency at the paths' vector widths
(256 elements; the IPA prove's rounds are K1IPA, ``cuda_ipa.py``). The
TPU needed 16-bit limbs because it has no widening multiply; Hopper has
one, so the design halves the limb count and keeps each element in
registers from load to store.

The plain version below is what the wrapper runs for CPU tensors; for a
CUDA tensor the wrapper launches the kernel or raises.

Kernel K1INV (``csrc/field_inv.cu``, :func:`inverse`): the inversions
``inv_mont`` and ``batch_inv_mont``. It replaces the K1 chain that ran the
JAX package's ``verkle_kzg_tpu/ops/field.py::inv_mont`` (line 327, a
``lax.scan`` of 254 squarings and a product a set bit, inside one jitted
program) and ``batch_inv_mont`` (line 342, Montgomery's trick with
associative scans, one program too). Run eagerly through K1, that chain
was 381 launches an inverse and 399 a batched inversion of 256 elements
(two Hillis-Steele scans of 8 launches, the inverse, two products), each
launch 20-34 us of host-bound time for a few microseconds of work: a
KZG prove was ~410 launches, phase 5's verkle prove 693.

What bounds it on the card is the inverse's dependent chain, not bytes or
multiplies: 8 KB a row at N = 256. The design is one launch for all rows.
N = 1 (``inv_mont`` on any shape, e.g. ``curve.to_affine``'s Z) takes a
thread an element. N > 1 takes a block a row: each thread's run of
elements is multiplied out, the run products are scanned both ways in
shared memory (8 levels at 256 threads), one thread inverts the row's
product, and each thread walks its run back with two products an element.
The inverse is Pornin's optimized binary GCD of (a R, m)
(``csrc/field_inv.cuh``: 18 rounds of 31 steps on 64-bit approximations in
registers, each round one update of the 256-bit values and their
cofactors, where a binary extended Euclid takes about 500 steps on 256-bit
words), then one Montgomery product: Fermat's a^(m - 2)
chains 381 products of ~500 instructions (0.68 us each on one thread,
``tools/fmul_probe.py``), ~0.26 ms. Every product is reduced, and an
inverse is unique, so the words are those of the JAX package's Fermat
chain, which the plain version below runs unchanged.
"""

from __future__ import annotations

import torch

from ..utils.metrics import span
from . import cuda_lib
from . import field as F

_OPS = {"mul": 0, "add": 1, "sub": 2}
_FIELDS = {"fq": 0, "fr": 1}


def plain(op: str, a: torch.Tensor, b: torch.Tensor, spec: str) -> torch.Tensor:
    """K1's plain version on (..., 8) int32 words, any device."""
    fn = {"mul": F.mont_mul16, "add": F.add16, "sub": F.sub16}[op]
    return F.from_limbs(fn(F.to_limbs(a), F.to_limbs(b), spec))


@span("kernels", "K1")
def binop(op: str, a: torch.Tensor, b: torch.Tensor, spec: str) -> torch.Tensor:
    """``op`` in {"mul", "add", "sub"} on reduced (..., 8) word tensors
    (broadcast against each other)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain(op, a, b, spec)
    a, b = torch.broadcast_tensors(a, b)
    a, b = a.contiguous(), b.contiguous()
    cuda_lib.require_cuda("field." + op, a, b)
    out = torch.empty_like(a)
    n = a.numel() // F.WORDS
    if n:
        err = cuda_lib.lib().vkzg_field_binop(
            _OPS[op], _FIELDS[spec], a.data_ptr(), b.data_ptr(), out.data_ptr(),
            n, cuda_lib.stream(a),
        )
        cuda_lib.check(err, "vkzg_field_binop")
        cuda_lib.launches["K1"] += 1
    return out


def plain_inv(a: torch.Tensor, spec: str) -> torch.Tensor:
    """Fermat inverse a^(m-2) of Montgomery words, Montgomery in and out,
    by square-and-multiply on K1's plain version (``ops/field.py::inv_mont``).
    Zero maps to zero: the first multiply by a zeroes the accumulator."""
    acc = F.const_words(F.SPECS[spec].r_mod, a.device).expand_as(a)
    for bit in bin(F.SPECS[spec].modulus - 2)[2:]:
        acc = plain("mul", acc, acc, spec)
        if bit == "1":
            acc = plain("mul", acc, a, spec)
    return acc


def _scan_products(a: torch.Tensor, spec: str) -> torch.Tensor:
    """Inclusive prefix products over the element axis (-2), Hillis-Steele:
    log2(N) rounds of products."""
    k = 1
    while k < a.shape[-2]:
        a = torch.cat([a[..., :k, :], plain("mul", a[..., k:, :], a[..., :-k, :], spec)], dim=-2)
        k *= 2
    return a


def plain_batch_inv(a: torch.Tensor, spec: str) -> torch.Tensor:
    """Montgomery's trick over the element axis (-2) of (..., N, 8)
    Montgomery words, each leading index on its own: prefix and suffix
    products, ONE Fermat inversion of each total, two products per element
    (``ops/field.py::batch_inv_mont``). Zero entries invert to zero
    (ark_ff::batch_inversion skips zeros)."""
    z = (a == 0).all(-1, keepdim=True)
    one = F.const_words(F.SPECS[spec].r_mod, a.device).expand_as(a[..., :1, :])
    safe = torch.where(z, one, a)
    prefix = _scan_products(safe, spec)
    suffix = _scan_products(safe.flip(-2), spec).flip(-2)
    total_inv = plain_inv(prefix[..., -1:, :].contiguous(), spec)
    left = torch.cat([one, prefix[..., :-1, :]], dim=-2)
    right = torch.cat([suffix[..., 1:, :], one], dim=-2)
    inv = plain("mul", plain("mul", left, right, spec), total_inv.expand_as(a), spec)
    return torch.where(z, a, inv)


@span("kernels", "K1INV")
def inverse(a: torch.Tensor, spec: str, batch: bool) -> torch.Tensor:
    """Kernel K1INV. ``batch=False``: the inverse of each reduced Montgomery
    element of ``a`` (..., 8); ``batch=True``: Montgomery's trick over the
    element axis (-2) of ``a`` (..., N, 8), each leading index on its own.
    Zero maps to zero. CPU tensors take the plain versions."""
    if a.device.type == "cpu":
        return plain_batch_inv(a, spec) if batch else plain_inv(a, spec)
    if a.shape[-1] != F.WORDS or (batch and a.dim() < 2):
        raise ValueError("field.inverse: words must be (..., 8), (..., N, 8) for a batch")
    a = a.contiguous()
    cuda_lib.require_cuda("field.inverse", a)
    out = torch.empty_like(a)
    n = a.shape[-2] if batch else 1
    rows = a.numel() // (F.WORDS * n) if n else 0
    if rows:
        err = cuda_lib.lib().vkzg_field_batch_inv(
            _FIELDS[spec], a.data_ptr(), out.data_ptr(), rows, n, cuda_lib.stream(a)
        )
        cuda_lib.check(err, "vkzg_field_batch_inv")
        cuda_lib.launches["K1INV"] += 1
    return out
