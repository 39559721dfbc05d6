"""Kernel K1NTT: the Fr NTT and INTT of B contiguous segments, one launch a
transform.

Replaces the K1 chain of an Fr transform: the JAX package's
``verkle_kzg_tpu/ops/ntt.py::_fr_stage`` (lines 88-96, one jitted program
a stage, its products and sums through the ``pallas_call`` of
``ops/pallas_field.py:298``), which the port ran eagerly as a gather, three
K1 launches and two scatters a stage (:func:`plain`, on K1's plain
version; ``chip_smoke._k1_chain`` turns it into that K1 chain): 25-30 K1
launches and 0.8-1.3 ms for a transform at 256-512 (``PERF.md``), for a few
microseconds of products. What bounds a transform at the paths' sizes is
its log2(seg) dependent stages and the launch, not bytes (32 an element
each way) or products (seg / 2 a stage).

The design (``csrc/ntt_fr.cu``): a block a segment while the segment fits
a tile of :data:`TILE` elements in shared memory (32 bytes an element:
128 KB at 4,096, with the opt-in dynamic shared memory); the bit reversal
in the load, the stages with ``__syncthreads()`` between them, the
twiddles from the plan's Montgomery table (w_seg^k for k < seg / 2, then
1/seg), uploaded once per (seg, inverse, device), and the inverse's 1/seg
product at the store. Above the tile, the first log2(TILE) stages run so
(their butterfly blocks never cross a tile) and each remaining stage is one
more launch over device memory, a thread a butterfly. Every butterfly is
the plain version's reduced (u + w v, u - w v) with the same twiddle value,
so the words are its words and JAX's.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.metrics import span
from . import cuda_field as KF
from . import cuda_lib
from . import field as F

#: Elements a block transforms in shared memory (``csrc/ntt_fr.cu`` takes
#: up to 4,096).
TILE = 4096


def plain(x_mont: torch.Tensor, seg: int, inverse: bool = False) -> torch.Tensor:
    """K1NTT's plain version, any device: each stage a gather, K1's plain
    product, sum and difference, and a scatter over all B segments, as the
    JAX package's ``_fr_stage``; the inverse's 1/seg product last."""
    bitrev, stages = N._Plan(x_mont.shape[0], inverse).on(x_mont.device, True, seg)
    x = x_mont[bitrev]
    for u_idx, v_idx, tw in stages:
        u, v = x[u_idx], KF.plain("mul", x[v_idx], tw, "fr")
        x = torch.empty_like(x)
        x[u_idx] = KF.plain("add", u, v, "fr")
        x[v_idx] = KF.plain("sub", u, v, "fr")
    if not inverse:
        return x
    n_inv = N._Plan(seg, True).n_inv
    return KF.plain("mul", x, F.ints_to_mont([n_inv], "fr", x.device).expand_as(x), "fr")


@span("kernels", "K1NTT")
def ntt(x_mont: torch.Tensor, seg: int, inverse: bool = False) -> torch.Tensor:
    """Kernel K1NTT: (B seg, 8) Montgomery words in B contiguous segments ->
    each segment's size-seg NTT (INTT with its 1/seg): one CUDA launch up to
    :data:`TILE`, one more a stage above it, each counted. CPU tensors take
    the plain version."""
    if x_mont.device.type == "cpu":
        return plain(x_mont, seg, inverse)
    total = x_mont.shape[0]
    if x_mont.dim() != 2 or x_mont.shape[1] != F.WORDS:
        raise ValueError(f"ntt_fr: words must be (N, 8), got {tuple(x_mont.shape)}")
    if seg < 2 or seg & (seg - 1) or total % seg:
        raise ValueError(f"ntt_fr: the segment {seg} must be a power of two above 1 dividing N = {total}")
    x = x_mont.contiguous()
    table = N._Plan(seg, inverse).k1ntt_table(x.device)
    cuda_lib.require_cuda("ntt_fr", x, table)
    out = torch.empty_like(x)
    log_seg = seg.bit_length() - 1
    issued = ctypes.c_int64(0)
    err = cuda_lib.lib().vkzg_ntt_fr(
        x.data_ptr(), out.data_ptr(), table.data_ptr(), total, log_seg, min(log_seg, TILE.bit_length() - 1),
        int(inverse), cuda_lib.stream(x), ctypes.addressof(issued),
    )
    cuda_lib.check(err, "vkzg_ntt_fr")
    cuda_lib.launches["K1NTT"] += issued.value
    return out


from . import ntt as N  # noqa: E402  (the plans; ntt.py imports this module)
