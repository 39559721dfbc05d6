"""Sharded MSMs over a ``torch.distributed`` process group
(``verkle_kzg_tpu/parallel/mesh.py``).

The JAX package shards with ``shard_map`` over a device mesh; here the
mesh is a process group with one rank a card, and every function is SPMD:
each rank passes the same whole arrays, as the JAX caller passes global
arrays, and gets the same whole result back.

  * a single MSM pads N to a multiple of the mesh size d with (0, 0)
    points and zero scalars, each rank runs the local MSM (``msm_auto``:
    K3 + K4, or K5 + K2FOLD under 64 points) on its N/d slice, one
    ``all_gather`` brings the d partial points (d x 96 bytes) to every
    rank, and a K2FOLD halving tree sums them (``fold_reduce_lanes`` in
    the place of JAX's ``tree_reduce_points``);
  * batched MSMs (the verkle node commits, the multiproof's query stacks)
    shard the batch axis instead, padded to a multiple of d, and gather
    the lanes' results: pure data parallelism.

Only the group element is contract: the fold adds the partials in another
order than one device's MSM would.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from ..ops import field as F
from ..ops import msm as M
from ..utils import metrics

#: The backend that a mesh on each device type needs.
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a sharded function spreads over: their process group, its
    size, this process's rank in it (-1 on a rank outside it), the device
    this rank computes on, and the axis name (for parity with JAX)."""

    group: object
    size: int
    rank: int
    device: torch.device
    axis: str = "shard"


def make_mesh(n_devices: int | None = None, axis: str = "shard", device=None) -> Mesh:
    """A mesh over ranks 0..n_devices - 1 of the initialised default process
    group (all of them by default). Every rank must call it, since a smaller
    mesh is a ``dist.new_group``. ``device`` defaults to this rank's card,
    ``cuda:{LOCAL_RANK}``, or ``cuda:{rank % device_count}`` without that
    variable, over NCCL; ``device="cpu"`` needs a gloo group. A backend that
    does not fit the device raises."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group (init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: n_devices must be in [1, {world}], got {n_devices}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for a mesh over a gloo group")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    device = torch.device(device)
    backend = str(dist.get_backend())
    want = _BACKEND.get(device.type)
    if want is None or want not in backend:
        raise ValueError(f"make_mesh: a {backend} process group cannot run a mesh on {device} "
                         f"(the {device.type} device needs {want})")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    return Mesh(group=group, size=n, rank=dist.get_rank(group) if dist.get_rank() < n else -1,
                device=device, axis=axis)


def _on_mesh(mesh: Mesh, name: str, *tensors: torch.Tensor) -> None:
    """Raise unless this rank is in the mesh and every input lies on its device."""
    if mesh.rank < 0:
        raise ValueError(f"{name}: this rank is not in the mesh")
    for t in tensors:
        if t.device != mesh.device:
            raise ValueError(f"{name}: an input lies on {t.device}, the mesh's device is {mesh.device}")


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(...) on every rank -> (d, ...), rank p's tensor at index p."""
    out = torch.empty((mesh.size,) + t.shape, dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=mesh.group)
    return out


def _pad(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows appended along dim 0 up to ``rows``."""
    if rows == t.shape[0]:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


def msm_sharded(points_affine: torch.Tensor, scalars: torch.Tensor, mesh: Mesh, c: int = 8,
                lanes: int = 128) -> torch.Tensor:
    """One MSM over the mesh: (N, 2, 8) affine points x (N, 8) standard
    scalars, the same on every rank -> the (3, 8) projective sum on every
    rank."""
    _on_mesh(mesh, "msm_sharded", points_affine, scalars)
    n = points_affine.shape[0]
    metrics.record("msm.sharded.calls")
    metrics.record("msm.sharded.points", n)
    per = math.ceil(n / mesh.size)
    lo = mesh.rank * per
    pts = _pad(points_affine, per * mesh.size)[lo : lo + per].contiguous()
    sc = _pad(scalars, per * mesh.size)[lo : lo + per].contiguous()
    part = M._msm_auto_impl(pts, sc, c=c, lanes=lanes)
    return M.fold_reduce_lanes(all_gather(mesh, part), dim=0)[0]


def _batch_sharded(fn, points_affine: torch.Tensor, scalars: torch.Tensor, mesh: Mesh, c, shared: bool):
    """Run ``fn`` on this rank's lanes of the batch padded to a multiple of
    d, and gather every rank's lanes: (B, 3, 8) on every rank."""
    b = scalars.shape[0]
    per = math.ceil(b / mesh.size)
    lo = mesh.rank * per
    sc = _pad(scalars, per * mesh.size)[lo : lo + per].contiguous()
    pts = points_affine if shared else _pad(points_affine, per * mesh.size)[lo : lo + per].contiguous()
    return all_gather(mesh, fn(pts, sc, c)).reshape(per * mesh.size, 3, F.WORDS)[:b]


def msm_batched_sharded(points_affine: torch.Tensor, scalars: torch.Tensor, mesh: Mesh,
                        c: int | None = 8) -> torch.Tensor:
    """B independent MSMs, the batch sharded: (B, N, 2, 8) affine x
    (B, N, 8) standard scalars -> (B, 3, 8) on every rank."""
    _on_mesh(mesh, "msm_batched_sharded", points_affine, scalars)
    metrics.record("msm.batched_sharded.calls")
    metrics.record("msm.batched_sharded.points", scalars.shape[0] * scalars.shape[1])
    return _batch_sharded(M._msm_batched_impl, points_affine, scalars, mesh, c, shared=False)


def msm_fixed_base_sharded(points_affine: torch.Tensor, scalars: torch.Tensor, mesh: Mesh,
                           c: int | None = None) -> torch.Tensor:
    """A stack of MSMs over one basis, the batch sharded: (N, 2, 8) affine
    x (B, N, 8) standard scalars -> (B, 3, 8) on every rank. Every rank
    holds the whole basis (the CRS), which its lanes read in place; only
    the scalar vectors are split, so the ranks exchange nothing but the
    results (the verkle tree's dense commits on a mesh)."""
    _on_mesh(mesh, "msm_fixed_base_sharded", points_affine, scalars)
    metrics.record("msm.fixed_base_sharded.calls")
    metrics.record("msm.fixed_base_sharded.points", scalars.shape[0] * points_affine.shape[0])
    return _batch_sharded(M._msm_fixed_base_impl, points_affine, scalars, mesh, c, shared=True)
