"""Kernel K1IPA: one halving round of the IPA prove in one launch, and the
prove's inner product <a, b> in another.

Replaces the K1 chain of the port's halving loop (``schemes/ipa.py::_halving_loop``):
each round's vector math, which the JAX package runs as one scanned body
(``verkle_kzg_tpu/schemes/ipa.py:214-269``, ``_fused_ipa_loop.round_body``) on
K1 (``verkle_kzg_tpu/ops/pallas_field.py:298``, ``_elementwise_call``). Run
eagerly through K1 that body was 29 launches a round with a ``b`` vector
(the gammas, two inner products of a product and a halving tree of adds
each, the two ``w`` products, ``from_mont``, the folds of a, b and the
weights) plus about 15 torch gathers, selects and copies, and one copy of
the challenge to the card: 241 K1 launches an IPA prove at domain 256, each
20-34 us of host time for a few microseconds of work on 256 elements.

What bounds it on the card is the launch, then the round's dependent chain
(about five products a thread at 256 elements, and a tree of eight adds),
not bytes or multiplies. The design is one launch a round: one block of
256 threads, each owning a strided run of slots, so any power-of-two length
runs. It folds the previous challenge x into a, b and the weights, reading
the input buffers and writing fresh output buffers (the fold reads
a[j + half], which another thread owns), then after one ``__syncthreads()``
builds both MSMs' scalars in standard form and the two inner products,
each summed in shared memory by a tree of reduced adds. x and w are read
from device memory, eight Montgomery words each: in the device loop FSX
(``cuda_fiat_shamir.py``) writes them there, so a round needs nothing from
the host; the host loop copies its int challenge to the card first. A
prove at 256 is 1 + 8 + 1 launches (the inner product, the rounds, the
fold that leaves the tip). Every product and sum is reduced, so the words
are unique: the order of a sum cannot change them, and kernel, plain
version and the JAX package agree bit for bit.

The plain versions below are what the wrappers run for CPU tensors: the
round as it ran on K1's plain functions (``cuda_field.plain``). For a CUDA
tensor the wrappers launch the kernel or raise.
"""

from __future__ import annotations

import torch

from ..utils.metrics import span
from . import cuda_field as KF
from . import cuda_lib
from . import field as F

_SPEC = "fr"


def _mul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return KF.plain("mul", p, q, _SPEC)


def _add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return KF.plain("add", p, q, _SPEC)


def as_mont(v, device) -> torch.Tensor:
    """A challenge as (8,) Montgomery words on ``device``: an int is
    converted on the host and copied there, a word tensor kept as it is."""
    return v if isinstance(v, torch.Tensor) else F.ints_to_mont([v], _SPEC, device)[0]


def _plain_sum(x: torch.Tensor) -> torch.Tensor:
    """(N, 8) -> (1, 8): the halving tree of reduced adds of ``F.sum_lanes``."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        folded = _add(x[:half], x[half : 2 * half])
        x = torch.cat([folded, x[2 * half :]]) if x.shape[0] % 2 else folded
    return x


def plain_inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> of (N, 8) Montgomery words -> (1, 8) Montgomery words."""
    return _plain_sum(_mul(a, b))


def plain_round(a, b, wts, x, w, half: int, ln: int):
    """K1IPA's plain version; see :func:`halving_round` for the arguments.
    The K1-op body of the halving loop as it ran before K1IPA, op for op:
    29 K1 plain calls a round with ``b`` at n = 256. Dead slots keep their
    words, as the kernel's do."""
    n, dev = a.shape[0], a.device
    i = torch.arange(n, device=dev)[:, None]
    if wts is None:
        wts = as_mont(1, dev).expand(n, F.WORDS)
    if half:
        xm = as_mont(x, dev).expand(n, F.WORDS)
        left = i < half
        idx_f = torch.where(left, i + half, 0)[:, 0]
        new_a = torch.where(left, _add(a, _mul(a[idx_f], xm)), a)
        if b is not None:
            b = torch.where(left, _add(b[idx_f], _mul(b, xm)), b)
        if ln:
            wts = torch.where(i % (2 * half) < half, _mul(wts, xm), wts)
        a = new_a
    if not ln:
        return a, b, None, None
    h = ln // 2
    pos = i % ln
    right = pos >= h
    zeros = torch.zeros_like(a)
    sc_l = torch.where(right, _mul(wts, a[torch.where(right, pos - h, 0)[:, 0]]), zeros)
    sc_r = torch.where(right, zeros, _mul(wts, a[torch.where(right, 0, pos + h)[:, 0]]))
    if b is not None:
        left = i < h
        idx_f = torch.where(left, i + h, 0)[:, 0]
        ip_l = _plain_sum(torch.where(left, _mul(a, b[idx_f]), zeros))
        ip_r = _plain_sum(torch.where(left, _mul(a[idx_f], b), zeros))
        wm = as_mont(w, dev)[None]
        sc_l = torch.cat([sc_l, _mul(wm, ip_l)])
        sc_r = torch.cat([sc_r, _mul(wm, ip_r)])
    one = F.const_words(1, dev)
    return a, b, wts, torch.stack([_mul(sc_l, one.expand_as(sc_l)), _mul(sc_r, one.expand_as(sc_r))])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


@span("kernels", "K1IPA")
def halving_round(a, b, wts, x, w, half: int, ln: int):
    """One K1IPA launch: an IPA halving round on (n, 8) Fr Montgomery words.

    ``a``, ``b``: the vectors, n a power of two (``b`` None in a commitment
    proof); ``wts``: the accumulated challenge weight of each original
    basis index (None: all one, before the first fold). With ``half`` > 0
    the previous round's challenge ``x`` folds in first:
    a[j] += x a[j + half], b[j] = b[j + half] + x b[j] for j < half, and
    wts[i] *= x where i mod 2 half < half. With ``ln`` > 0 (the round's
    length) the scalars of its two MSMs follow, in standard form, as
    (2, n, 8), or (2, n + 1, 8) with ``b``, whose slot n holds
    w <a_l, b_r> and w <a_r, b_l> for the challenge ``w``. A challenge is
    (8,) Montgomery words on a's device, or an int (:func:`as_mont`).

    Returns (a, b, wts, scalars), new tensors: b None without ``b``; wts and
    scalars None when ``ln`` is 0 (the final fold, which leaves the tip in
    a[0])."""
    if a.device.type == "cpu":
        return plain_round(a, b, wts, x, w, half, ln)
    n = a.shape[0]
    if a.shape != (n, F.WORDS) or not _pow2(n) or n < 2:
        raise ValueError(f"ipa round: a must be (n, 8) with n a power of two >= 2, got {tuple(a.shape)}")
    if half and (not _pow2(half) or 2 * half > n or x is None):
        raise ValueError(f"ipa round: fold half {half} must be a power of two <= n / 2, with x")
    if ln and (not _pow2(ln) or ln < 2 or ln > n or (b is not None and w is None)):
        raise ValueError(f"ipa round: length {ln} must be a power of two in [2, n], with w when b is given")
    given = [t for t in (a, b, wts) if t is not None]
    if any(t.shape != a.shape for t in given):
        raise ValueError("ipa round: a, b and wts must have one shape")
    xm = as_mont(x, a.device) if half else None
    wm = as_mont(w, a.device) if ln and b is not None else None
    if any(t is not None and t.shape != (F.WORDS,) for t in (xm, wm)):
        raise ValueError("ipa round: a challenge must be an int or (8,) Montgomery words")
    cuda_lib.require_cuda("ipa.halving_round", *given, *(t for t in (xm, wm) if t is not None))
    a_out = torch.empty_like(a)
    b_out = None if b is None else torch.empty_like(b)
    wts_out = torch.empty_like(a) if ln else None
    sc = torch.empty((2, n + (b is not None), F.WORDS), dtype=a.dtype, device=a.device) if ln else None
    err = cuda_lib.lib().vkzg_ipa_round(
        a.data_ptr(), _ptr(b), _ptr(wts), a_out.data_ptr(), _ptr(b_out), _ptr(wts_out), _ptr(sc),
        _ptr(xm), _ptr(wm), n, half, ln, cuda_lib.stream(a),
    )
    cuda_lib.check(err, "vkzg_ipa_round")
    cuda_lib.launches["K1IPA"] += 1
    return a_out, b_out, wts_out, sc


@span("kernels", "K1IPA")
def inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1IPA's inner product: <a, b> of (n, 8) Fr Montgomery words ->
    (1, 8) Montgomery words, one launch."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain_inner(a, b)
    if a.dim() != 2 or a.shape[1] != F.WORDS or a.shape != b.shape:
        raise ValueError(f"ipa inner: a and b must both be (n, 8), got {tuple(a.shape)}, {tuple(b.shape)}")
    cuda_lib.require_cuda("ipa.inner", a, b)
    out = torch.zeros((1, F.WORDS), dtype=a.dtype, device=a.device)
    err = cuda_lib.lib().vkzg_ipa_inner(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], cuda_lib.stream(a))
    cuda_lib.check(err, "vkzg_ipa_inner")
    cuda_lib.launches["K1IPA"] += 1
    return out
