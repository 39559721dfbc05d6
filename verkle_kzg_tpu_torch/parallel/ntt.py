"""The four-step (Bailey) NTT over Fr and over G1, across a mesh
(``verkle_kzg_tpu/parallel/ntt.py``).

N = n1 n2, and the input, whole on every rank, is the (n1, n2) matrix
A[j1, j2] = x[j1 n2 + j2]. On a mesh of d ranks, rank r:

  1. takes its n2 / d columns j2, the split the JAX package's
     ``P(None, None, axis)`` gives, each column a contiguous segment;
  2. runs the size-n1 NTTs along j1, all its columns at once
     (``ops/ntt.py``'s segmented transforms: one K1NTT launch, or one
     G1BFLY launch a stage);
  3. multiplies element [k1, j2] by w^(k1 j2) (K1 over Fr in Montgomery
     form; G1SMUL over G1 with standard-form scalars);
  4. exchanges with one ``all_to_all_single``, after which it holds the
     n1 / d rows k1 in [r n1 / d, (r + 1) n1 / d) of all n2 columns (the
     exchange GSPMD inserts for the JAX package's resharding constraint);
  5. runs the size-n2 NTTs along j2 of those rows;
  6. and one ``all_gather`` gives every rank the whole output in natural
     order, X[k2 n1 + k1].

Each sub-NTT of an inverse applies its own 1/n1 or 1/n2 after its stages,
as the JAX package's do. Without a mesh the same steps run on one device,
with no collective. The operations and their order are the JAX package's,
so Fr outputs and G1 projective coordinates are its words at any d.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..hostmath.field import fr_inv
from ..ops import curve as C
from ..ops import field as F
from ..ops import ntt as N
from ..params import R, fr_root_of_unity
from .mesh import Mesh, _on_mesh, all_gather


@functools.lru_cache(maxsize=None)
def _twiddle_matrix(n1: int, n2: int, inverse: bool, mont: bool, device: torch.device) -> torch.Tensor:
    """(n2 n1, 8) words of w^(k1 j2) at [j2 n1 + k1], w the size-n1 n2 root
    (its inverse for ``inverse``): Montgomery form for the Fr product
    (``ntt.py::_twiddle_matrix``), standard form for G1's scalar
    multiplication (``ntt.py::_twiddle_matrix_std``)."""
    w = fr_root_of_unity(n1 * n2)
    if inverse:
        w = fr_inv(w)
    vals = []
    for j2 in range(n2):
        step, v = pow(w, j2, R), 1
        for _ in range(n1):
            vals.append(v)
            v = v * step % R
    return F.ints_to_mont(vals, "fr", device) if mont else F.ints_to_words(vals, device)


def _exchange(mesh: Mesh | None, send: torch.Tensor) -> torch.Tensor:
    """(d, ...) -> (d, ...): block q goes to rank q, block p comes from rank p."""
    if mesh is None:
        return send
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    return recv


def _four_step(x: torch.Tensor, mesh: Mesh | None, n1: int | None, inverse: bool, g1: bool) -> torch.Tensor:
    n = x.shape[0]
    if n1 is None:
        n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    if n & (n - 1) or n1 * n2 != n or n1 < 2 or n2 < 2:
        raise ValueError(f"four-step NTT: N = {n} must be a power of two split as n1 x n2 with both above 1")
    d, r = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if mesh is not None:
        _on_mesh(mesh, "four-step NTT", x)
    if n1 % d or n2 % d:
        raise ValueError(f"four-step NTT: the mesh size {d} must divide both factors ({n1}, {n2})")
    sub = N.ntt_g1_segments if g1 else N.ntt_fr_segments
    tail = x.shape[1:]
    cols, rows = n2 // d, n1 // d  # a rank's columns j2 before the exchange, rows k1 after it
    # 1-2. this rank's columns, each a segment along j1, then their size-n1 NTTs -> [j2, k1]
    a = x.reshape((n1, n2) + tail)[:, r * cols : (r + 1) * cols].transpose(0, 1).reshape((cols * n1,) + tail)
    a = sub(a, n1, inverse)
    # 3. w^(k1 j2)
    tw = _twiddle_matrix(n1, n2, inverse, not g1, x.device)[r * cols * n1 : (r + 1) * cols * n1]
    a = C.scalar_mul(a, tw) if g1 else F.mont_mul(a, tw, "fr")
    # 4. rank q gets rows k1 in [q rows, (q + 1) rows): recv[p, b, i] = [k1 = r rows + i, j2 = p cols + b]
    send = a.reshape((cols, d, rows) + tail).transpose(0, 1).contiguous()
    recv = _exchange(mesh, send)
    a = recv.permute((2, 0, 1) + tuple(range(3, recv.dim()))).reshape((rows * n2,) + tail)
    # 5. size-n2 NTTs along j2 -> [k1, k2] = X[k2 n1 + k1]
    a = sub(a, n2, inverse).reshape((rows, n2) + tail)
    # 6. every rank's rows, in natural order
    full = a if mesh is None else all_gather(mesh, a).reshape((n1, n2) + tail)
    return full.transpose(0, 1).reshape((n,) + tail)


def ntt_fr_sharded(x_mont: torch.Tensor, mesh: Mesh | None = None, n1: int | None = None) -> torch.Tensor:
    """Forward NTT of an (N, 8) Montgomery vector over ``mesh`` (None: the
    same four steps on one device). ``n1`` defaults to 2^(floor(log2 N / 2))."""
    return _four_step(x_mont, mesh, n1, inverse=False, g1=False)


def intt_fr_sharded(x_mont: torch.Tensor, mesh: Mesh | None = None, n1: int | None = None) -> torch.Tensor:
    """Inverse NTT of an (N, 8) Montgomery vector over ``mesh``, 1/N folded in."""
    return _four_step(x_mont, mesh, n1, inverse=True, g1=False)


def ntt_g1_sharded(pts_proj: torch.Tensor, mesh: Mesh | None = None, n1: int | None = None) -> torch.Tensor:
    """Forward G1 NTT of (N, 3, 8) projective points over ``mesh``."""
    return _four_step(pts_proj, mesh, n1, inverse=False, g1=True)


def intt_g1_sharded(pts_proj: torch.Tensor, mesh: Mesh | None = None, n1: int | None = None) -> torch.Tensor:
    """Inverse G1 NTT of (N, 3, 8) projective points over ``mesh``, 1/N folded in."""
    return _four_step(pts_proj, mesh, n1, inverse=True, g1=True)
