"""Carry state across from the JAX package, so that both packages compute
on identical CRS and data (the tests use this).

The JAX package holds field elements as (16, N) uint32 planes of 16-bit
limbs; the port as (N, 8) int32 rows of 32-bit words. Both use the
Montgomery radix R = 2^256, so a Montgomery plane converts word for word.
This module takes the JAX package's objects as they are and imports
nothing of it.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import cuda_lib
from .poly import Domain, FrVector
from .schemes.ipa import IPA, IPAParams
from .schemes.kzg import KZG, KZGParams
from .utils.metrics import span, wait_for


@span("orchestration", "convert.limb_planes_to_tensor")
def limb_planes_to_tensor(planes, device) -> torch.Tensor:
    """(16, N) uint32 limb planes -> (N, 8) int32 words."""
    arr = np.asarray(planes, dtype=np.uint32)
    words = arr[0::2] | (arr[1::2] << np.uint32(16))
    return wait_for("convert.upload", torch.from_numpy(np.ascontiguousarray(words.T).view(np.int32)).to, device)


@span("orchestration", "convert.tensor_to_limb_planes")
def tensor_to_limb_planes(t: torch.Tensor) -> np.ndarray:
    """(N, 8) int32 words -> (16, N) uint32 limb planes."""
    w = np.ascontiguousarray(wait_for("convert.read", t.detach().cpu).numpy()).view(np.uint32).T  # (8, N)
    out = np.empty((16, w.shape[1]), dtype=np.uint32)
    out[0::2] = w & np.uint32(0xFFFF)
    out[1::2] = w >> np.uint32(16)
    return out


@span("orchestration", "convert.stream_to_words")
def _stream_to_words(arr, device) -> torch.Tensor:
    """A lane stream (S, ..., 16, B) of uint32 limb planes -> (S, B, ..., 8)
    int32 words."""
    arr = np.asarray(arr, dtype=np.uint32)
    words = arr[..., 0::2, :] | (arr[..., 1::2, :] << np.uint32(16))  # (S, ..., 8, B)
    return wait_for("convert.upload", torch.from_numpy(np.ascontiguousarray(np.moveaxis(words, -1, 1)).view(np.int32)).to,
                    device)


def pts_stream_from_jax(pts_stream, device) -> torch.Tensor:
    """A ``pallas_msm`` point stream (S, 2, 16, B) -> (S, B, 2, 8)."""
    return _stream_to_words(pts_stream, device)


def sc_stream_from_jax(sc_stream, device) -> torch.Tensor:
    """A ``pallas_msm`` scalar stream (S, 16, B) -> (S, B, 8)."""
    return _stream_to_words(sc_stream, device)


@span("orchestration", "convert.masks_from_jax")
def masks_from_jax(masks, device) -> torch.Tensor:
    """The signed carry masks of a stream, (S, nwords, B) uint32 ->
    (S, B, nwords) int32."""
    arr = np.ascontiguousarray(np.swapaxes(np.asarray(masks, dtype=np.uint32), 1, 2))
    return wait_for("convert.upload", torch.from_numpy(arr.view(np.int32)).to, device)


def ipa_params_from_jax(params, device=None) -> IPAParams:
    """``verkle_kzg_tpu.schemes.ipa.IPAParams`` -> the port's, reusing its
    host points (no second hash-to-curve run)."""
    return IPAParams(
        n=params.n,
        g_host=list(params.g_host),
        q_host=params.q_host,
        domain=Domain(params.domain.size),
        device=device,
    )


def kzg_params_from_jax(params, device=None) -> KZGParams:
    """``verkle_kzg_tpu.schemes.kzg.KZGParams`` -> the port's, reusing its
    host Lagrange SRS and G2 point (no second setup)."""
    return KZGParams(
        size=params.size,
        lagrange_host=list(params.lagrange_host),
        g2=params.g2,
        domain=Domain(params.domain.size),
        device=device,
    )


def frvector_from_jax(vec, device=None) -> FrVector:
    """``verkle_kzg_tpu.poly.FrVector`` -> the port's (same Montgomery values)."""
    vals = limb_planes_to_tensor(np.asarray(vec.vals), cuda_lib.resolve_device(device))
    return FrVector(vals, vec.max, Domain(vec.domain.size))


def prover_queries_from_jax(queries, device=None) -> list:
    """A list of ``verkle_kzg_tpu.schemes.ProverQuery`` -> the port's, one
    port vector per distinct JAX vector (queries that share a data object
    share it here too)."""
    from .schemes.multiproof import ProverQuery

    vecs = {}
    out = []
    for q in queries:
        if id(q.data) not in vecs:
            vecs[id(q.data)] = frvector_from_jax(q.data, device)
        out.append(ProverQuery(data=vecs[id(q.data)], commit=q.commit, z=q.z, y=q.y))
    return out


def verkle_tree_from_jax(jax_tree, params):
    """A ``verkle_kzg_tpu.verkle.VerkleTree`` -> the port's tree over
    ``params`` and its scheme (KZG for ``KZGParams``, else the IPA): the
    same geometry and the same nodes, stems and leaves, with no commitment
    cached, so that both packages commit the same state."""
    from .verkle.tree import ExtensionNode, InternalNode, VerkleTree

    def copy(node):
        if hasattr(node, "stem"):
            return ExtensionNode(stem=tuple(node.stem), leaves=dict(node.leaves))
        return InternalNode(children={u: copy(ch) for u, ch in node.children.items()})

    scheme = KZG if isinstance(params, KZGParams) else IPA
    tree = VerkleTree(
        scheme, params, jax_tree.key_len, ext_width=jax_tree.ext_width, internal_width=jax_tree.internal_width
    )
    tree.root = copy(jax_tree.root)
    return tree
