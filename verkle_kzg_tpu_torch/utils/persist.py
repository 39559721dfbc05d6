"""Checkpoint and resume of CRS parameters and verkle trees
(``verkle_kzg_tpu/utils/persist.py``), in the JAX package's ``.npz`` format,
so a file written by either package loads in the other.

A CRS setup (hash-to-curve or scalar-multiplication sweeps) and a whole
tree (structure, values and cached commitments) go into one ``.npz`` file;
a loaded tree keeps the cache-invalidate-on-insert contract. Points are
stored as (N, 2) uint8[32] little-endian coordinate pairs, (0, 0) for the
point at infinity (the native C ABI's convention). Host only: the loaded
params build their device tensors on ``device``, the CUDA card unless the
caller says otherwise.
"""

from __future__ import annotations

import json

import numpy as np


def _points_to_array(points) -> np.ndarray:
    out = np.zeros((len(points), 2, 32), dtype=np.uint8)
    for i, p in enumerate(points):
        if p is None:
            continue
        out[i, 0] = np.frombuffer(int(p[0]).to_bytes(32, "little"), dtype=np.uint8)
        out[i, 1] = np.frombuffer(int(p[1]).to_bytes(32, "little"), dtype=np.uint8)
    return out


def _array_to_points(arr) -> list:
    pts = []
    for row in arr:
        x = int.from_bytes(row[0].tobytes(), "little")
        y = int.from_bytes(row[1].tobytes(), "little")
        pts.append(None if (x == 0 and y == 0) else (x, y))
    return pts


def _load(path: str, kind: str):
    z = np.load(path)
    if str(z["kind"]) != kind:
        raise ValueError(f"{path} holds a {z['kind']} checkpoint, not {kind}")
    return z


# -- CRS ---------------------------------------------------------------------


def save_ipa_params(path: str, params) -> None:
    np.savez_compressed(
        path,
        kind="ipa",
        n=params.n,
        g=_points_to_array(params.g_host),
        q=_points_to_array([params.q_host]),
    )


def load_ipa_params(path: str, device=None):
    from ..poly import Domain
    from ..schemes.ipa import IPAParams

    z = _load(path, "ipa")
    n = int(z["n"])
    return IPAParams(
        n=n, g_host=_array_to_points(z["g"]), q_host=_array_to_points(z["q"])[0], domain=Domain(n), device=device
    )


def save_kzg_params(path: str, params) -> None:
    g2 = params.g2  # (Fq2, Fq2)
    g2_ints = [g2[0].c0, g2[0].c1, g2[1].c0, g2[1].c1]
    np.savez_compressed(
        path,
        kind="kzg",
        size=params.size,
        lagrange=_points_to_array(params.lagrange_host),
        g2=np.array([i.to_bytes(32, "little") for i in g2_ints], dtype="S32"),
    )


def load_kzg_params(path: str, device=None):
    from ..hostmath.field import Fq2
    from ..poly import Domain
    from ..schemes.kzg import KZGParams

    z = _load(path, "kzg")
    size = int(z["size"])
    g2i = [int.from_bytes(bytes(b), "little") for b in z["g2"]]
    return KZGParams(
        size=size,
        lagrange_host=_array_to_points(z["lagrange"]),
        g2=(Fq2(g2i[0], g2i[1]), Fq2(g2i[2], g2i[3])),
        domain=Domain(size),
        device=device,
    )


# -- Verkle tree ---------------------------------------------------------------


def save_tree(path: str, tree) -> None:
    """Structure, values and cached commitments (c1 and c2 included)."""
    from ..verkle.tree import ExtensionNode

    commits = []

    def enc_commit(c):
        if c is None:
            return -1
        commits.append(c)
        return len(commits) - 1

    def walk(node):
        if isinstance(node, ExtensionNode):
            return {
                "t": "ext",
                "stem": list(node.stem),
                "commit": enc_commit(node.commit),
                "c1": enc_commit(node.c1_commit),
                "c2": enc_commit(node.c2_commit),
                "leaves": {str(k): hex(v) for k, v in node.leaves.items()},
            }
        return {
            "t": "int",
            "commit": enc_commit(node.commit),
            "children": {str(k): walk(c) for k, c in node.children.items()},
        }

    structure = walk(tree.root)
    np.savez_compressed(
        path,
        kind="verkle",
        key_len=tree.key_len,
        ext_width=tree.ext_width,
        internal_width=tree.internal_width,
        structure=json.dumps(structure),
        commits=_points_to_array(commits),
    )


def load_tree(path: str, scheme, params, mesh=None):
    """The tree saved at ``path``, over ``scheme`` and ``params`` (and
    ``mesh``, as ``VerkleTree`` takes it)."""
    from ..verkle.tree import ExtensionNode, InternalNode, VerkleTree

    z = _load(path, "verkle")
    commits = _array_to_points(z["commits"])

    def dec_commit(i):
        return None if i < 0 else commits[i]

    def build(d):
        if d["t"] == "ext":
            return ExtensionNode(
                stem=tuple(d["stem"]),
                commit=dec_commit(d["commit"]),
                c1_commit=dec_commit(d["c1"]),
                c2_commit=dec_commit(d["c2"]),
                leaves={int(k): int(v, 16) for k, v in d["leaves"].items()},
            )
        return InternalNode(
            commit=dec_commit(d["commit"]),
            children={int(k): build(c) for k, c in d["children"].items()},
        )

    tree = VerkleTree(
        scheme, params, int(z["key_len"]), int(z["ext_width"]), internal_width=int(z["internal_width"]), mesh=mesh
    )
    tree.root = build(json.loads(str(z["structure"])))
    return tree
