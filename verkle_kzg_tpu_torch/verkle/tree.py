"""Ethereum-style verkle trie over the IPA or KZG, on PyTorch tensors
(``verkle_kzg_tpu/verkle/tree.py``, the reference's
``verkle-tree/src/{lib,node}.rs``).

The trie is a host-side pointer structure (insertion is O(depth) dict
work). Commitment generation, the hot path, is batched: every commitment
pass collects ALL dirty nodes and commits each tree level with a few
device calls on the card that ``params`` lives on, instead of the
reference's per-node serial MSMs (``node.rs:212-277``). Each node vector
is routed on its own:

  * at most ``SPARSE_NNZ_MAX`` nonzero slots (a 1-leaf extension's c1/c2
    vectors have 2 of 256): gather the few live basis points and multiply
    each by its scalar in ONE K5 launch (``curve.scalar_mul_affine``), then
    sum each node's T terms with one K2FOLD launch;
  * denser vectors: one lane-batched fixed-basis MSM per ``COMMIT_CHUNK``
    nodes (``msm.msm_fixed_base``: K6, K7; K5 and a K2FOLD fold below 64
    points).

PyTorch keeps no trace cache, so no batch is padded to a fixed shape.

Reference semantics kept, with their quirks (SURVEY.md §5):
  * ``Key::split`` returns the FULL key as the stem (quirk 5,
    ``verkle-tree/src/lib.rs:62-68``), so keys differing only in their last
    unit live in different extension nodes;
  * extension c1/c2 vectors have width = key length N by default (the
    reference reuses the key-length const generic at ``node.rs:226-241``);
    pass ``ext_width=256`` for the Ethereum-style wide layout;
  * internal nodes commit a WIDTH-256 vector regardless (quirk 4,
    ``node.rs:263-264``);
  * values are 256-bit, split into low/high 128-bit Fr halves
    (``verkle-tree/src/lib.rs:77-84``, test impl :194-202), placed at slots
    (2i)%W and (2i+1)%W of c1 (i < W/2) or c2;
  * extension commitment = commit([1, stem_as_field, c1_item, c2_item])
    (``node.rs:246-253``);
  * commitments are cached per node and invalidated along the insert path
    (``node.rs:145,156``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..errors import NodeError
from ..hostmath.serialize import fr_from_le_bytes_mod_order, g1_to_data_item
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..params import R
from ..utils import metrics

INTERNAL_WIDTH = 256  # hardcoded in the reference (node.rs:263-264)


@dataclasses.dataclass
class ExtensionNode:
    stem: tuple
    commit: object = None
    leaves: dict = dataclasses.field(default_factory=dict)  # unit -> int value
    c1_commit: object = None  # commitment to the low-half leaf vector
    c2_commit: object = None  # commitment to the high-half leaf vector


@dataclasses.dataclass
class InternalNode:
    commit: object = None
    children: dict = dataclasses.field(default_factory=dict)  # unit -> node


def _split_value(value: int):
    """256-bit value -> (low, high) Fr items: LE bytes [0:16] and [16:32]
    (the SplittableValue impl at ``verkle-tree/src/lib.rs:194-202``)."""
    b = int(value).to_bytes(32, "little")
    return (
        fr_from_le_bytes_mod_order(b[0:16]),
        fr_from_le_bytes_mod_order(b[16:32]),
    )


def _stem_item(stem: tuple) -> int:
    """bytes_to_item(stem bytes) — Fr::from_le_bytes_mod_order."""
    return fr_from_le_bytes_mod_order(bytes(stem))


class VerkleTree:
    """``VerkleTree`` (``verkle-tree/src/lib.rs:87-138``) over a scheme
    namespace (``schemes.IPA`` or ``schemes.KZG``) and its params. Its
    commitments are computed on ``params.device``, which is the CUDA card
    unless the params were made for another device. There is no ``mesh``: sharding across cards is still
    to be ported."""

    def __init__(
        self,
        scheme,
        params,
        key_len: int,
        ext_width: int | None = None,
        internal_width: int = INTERNAL_WIDTH,
    ):
        self.scheme = scheme
        self.params = params
        self.device = params.device
        self.key_len = key_len
        self.ext_width = ext_width if ext_width is not None else key_len
        # width of internal-node vectors; the reference hardcodes 256
        # (quirk 4, node.rs:263-264) — kept as the default, overridable for
        # narrow test trees.
        self.internal_width = internal_width
        self.root = InternalNode()

    # -- key machinery (lib.rs:30-73) ---------------------------------------

    def _split_key(self, key):
        key = tuple(key)
        if len(key) != self.key_len:
            raise NodeError(f"key length {len(key)} != {self.key_len}")
        return key, key[-1]  # full key as stem (reference quirk)

    @staticmethod
    def _next_diff_depth(a, b, cur_depth: int) -> int:
        d = cur_depth + 1
        while d < len(a):
            if a[d] != b[d]:
                break
            d += 1
        return d

    # -- ops (lib.rs:106-138) -------------------------------------------------

    def insert_single(self, key, value: int) -> None:
        stem, unit = self._split_key(key)
        self._insert(self.root, stem, [(unit, value)], 0)

    def get_single(self, key):
        stem, unit = self._split_key(key)
        node = self._get_stem(self.root, stem, 0)
        if node is None:
            return None
        return node.leaves.get(unit)

    def path_to_stem(self, stem):
        """(prefix, child-index, node) triples (``node.rs:101-119``)."""
        stem = tuple(stem)
        path = []
        node = self.root
        while isinstance(node, InternalNode):
            depth = len(path)
            child = node.children.get(stem[depth])
            if child is None:
                raise NodeError("Invalid path requested")
            path.append((stem[: depth + 1], stem[depth], node))
            node = child
        return path

    def _get_stem(self, node, stem, depth):
        if isinstance(node, ExtensionNode):
            return node if node.stem == stem else None
        child = node.children.get(stem[depth])
        if child is None:
            return None
        return self._get_stem(child, stem, depth + 1)

    def _insert(self, node, stem, values, cur_depth):
        """``node.rs:133-197`` with identical branching."""
        if isinstance(node, ExtensionNode):
            if node.stem != stem:
                raise NodeError("Traversed to extension node with differing stem")
            node.commit = None
            node.leaves.update(values)
            return

        node.commit = None
        k = stem[cur_depth]
        child = node.children.get(k)
        if child is None:
            node.children[k] = ExtensionNode(stem=stem, leaves=dict(values))
        elif isinstance(child, InternalNode):
            self._insert(child, stem, values, cur_depth + 1)
        else:  # extension child
            if child.stem == stem or cur_depth == self.key_len - 2:
                self._insert(child, stem, values, cur_depth + 1)
            else:
                depth = self._next_diff_depth(child.stem, stem, cur_depth)
                new_internal = InternalNode(
                    children={
                        stem[depth]: ExtensionNode(stem=stem, leaves=dict(values)),
                        child.stem[depth]: child,
                    }
                )
                node.children[k] = new_internal

    # -- batched commitment generation ---------------------------------------

    def commitment(self):
        """Root commitment with memoization, computed with batched device
        calls over all dirty nodes: the extensions first, then the internal
        levels from the deepest up (vs per-node MSMs in ``node.rs:212-277``)."""
        dirty_ext, dirty_internal = [], []
        self._collect_dirty(self.root, 0, dirty_ext, dirty_internal)
        metrics.record("verkle.commit.passes")
        metrics.record("verkle.commit.dirty_ext", len(dirty_ext))
        metrics.record("verkle.commit.dirty_internal", len(dirty_internal))

        if dirty_ext:
            self._commit_extensions(dirty_ext)

        # deepest level first so children resolve before parents
        for depth in sorted({d for d, _ in dirty_internal}, reverse=True):
            level = [n for d, n in dirty_internal if d == depth]
            self._commit_internals(level)

        return self.root.commit

    def _collect_dirty(self, node, depth, dirty_ext, dirty_internal):
        if isinstance(node, ExtensionNode):
            if node.commit is None:
                dirty_ext.append(node)
            return
        if node.commit is None:
            dirty_internal.append((depth, node))
            for child in node.children.values():
                self._collect_dirty(child, depth + 1, dirty_ext, dirty_internal)

    # Dense node vectors per msm_fixed_base call, as the JAX tree batches
    # them. At width 256 (c = 5, W = 52, 16 rows) the sorted accumulation
    # takes 52 x 2048 x 256 entries of 16 bytes of scratch (about 436 MB,
    # one window group under cuda_msm_sorted.SCRATCH_BYTES) and 52 x 2048 x
    # 16 buckets of 96 bytes (about 164 MB); the basis is shared, not
    # copied per lane.
    COMMIT_CHUNK = 2048

    # Sparse node vectors per K5 launch: a lane is a point and a scalar
    # (about 200 bytes of input and output), so the launch can be wide; a
    # 10k-leaf tree's 20k c1/c2 vectors go in one launch of 40k lanes.
    SPARSE_CHUNK = 1 << 15

    # Node vectors with at most this many nonzero coefficients take the
    # SPARSE commit path: gather the few live basis points and run batched
    # scalar-muls instead of a full width-N MSM per node. Verkle trees are
    # extremely sparse in practice (a 1-leaf extension's c1/c2 vectors have
    # 2 nonzeros of 256), so this is the production hot path; the reference
    # walks the full vector regardless (``utils.rs:16-19``).
    SPARSE_NNZ_MAX = 8

    def _batched_commit(self, sparse_vecs, width):
        """Commit a list of SPARSE vectors ({index: value} dicts, all of
        ``width``) with a few batched device calls.

        Routing is PER NODE: each vector with <= SPARSE_NNZ_MAX nonzeros
        takes the gather + scalar-mul path and the rest form a dense
        Pippenger batch, so one busy node (e.g. a fully-populated stem) does
        not drag a chunk of 1-leaf extensions onto the width-256 dense path."""
        nnz = [sorted(k for k, v in d.items() if v % R) for d in sparse_vecs]
        sparse_ix = [i for i, ix in enumerate(nnz) if len(ix) <= self.SPARSE_NNZ_MAX]
        dense_ix = [i for i, ix in enumerate(nnz) if len(ix) > self.SPARSE_NNZ_MAX]
        out = [None] * len(sparse_vecs)
        if sparse_ix:
            s_nnz = [nnz[i] for i in sparse_ix]
            s_max = max(1, max(len(ix) for ix in s_nnz))
            pts = self._sparse_commit([sparse_vecs[i] for i in sparse_ix], s_nnz, s_max, width)
            for i, pt in zip(sparse_ix, pts):
                out[i] = pt
        if dense_ix:
            pts = self._dense_commit([sparse_vecs[i] for i in dense_ix], width)
            for i, pt in zip(dense_ix, pts):
                out[i] = pt
        return out

    def _dense_commit(self, sparse_vecs, width):
        basis = self.scheme.basis_affine(self.params)[:width]
        out = []
        for start in range(0, len(sparse_vecs), self.COMMIT_CHUNK):
            chunk = sparse_vecs[start : start + self.COMMIT_CHUNK]
            flat = [0] * (len(chunk) * width)
            for bi, d in enumerate(chunk):
                for j, v in d.items():
                    flat[bi * width + j] = v % R
            scalars = F.ints_to_words(flat, self.device).reshape(len(chunk), width, F.WORDS)
            out.extend(C.projective_to_host_points(M.msm_fixed_base(basis, scalars)))
        return out

    def _sparse_commit(self, sparse_vecs, nnz, maxnnz, width):
        """Commit sparse vectors as T scalar-muls per node in one K5 launch,
        then one K2FOLD launch summing each node's T terms: device work scales
        with the NONZERO count, not the vector width. T is maxnnz rounded up
        to a power of two; pad slots use basis index 0 with a zero scalar,
        whose lane takes no bit and so yields the identity."""
        t = 1 << (maxnnz - 1).bit_length() if maxnnz > 1 else 1
        basis = self.scheme.basis_affine(self.params)[:width]
        out = []
        for start in range(0, len(sparse_vecs), self.SPARSE_CHUNK):
            chunk = sparse_vecs[start : start + self.SPARSE_CHUNK]
            chunk_nnz = nnz[start : start + self.SPARSE_CHUNK]
            b = len(chunk)
            idx = np.zeros((b, t), dtype=np.int64)
            scal_ints = [0] * (b * t)
            for bi in range(b):
                ix = chunk_nnz[bi]
                idx[bi, : len(ix)] = ix
                d = chunk[bi]
                for col, j in enumerate(ix):
                    scal_ints[bi * t + col] = d[j] % R
            pts = basis[torch.from_numpy(idx.reshape(-1)).to(self.device)]  # (b*t, 2, 8)
            prods = C.scalar_mul_affine(pts, F.ints_to_words(scal_ints, self.device))
            summed = M.fold_reduce_lanes(prods.reshape(b, t, 3, F.WORDS), dim=1)[:, 0]
            out.extend(C.projective_to_host_points(summed))
        return out

    # -- node vector layouts (shared by committing and proving) ---------------

    def _ext_leaf_dicts(self, node: ExtensionNode):
        """(c1, c2) SPARSE {slot: value} dicts per ``node.rs:226-241``."""
        w = self.ext_width
        half = w // 2
        c1, c2 = {}, {}
        for unit, value in node.leaves.items():
            low, high = _split_value(value)
            lo_idx, hi_idx = (2 * unit) % w, (2 * unit + 1) % w
            target = c1 if unit < half else c2
            target[lo_idx] = low
            target[hi_idx] = high
        return c1, c2

    def _ext_leaf_vectors(self, node: ExtensionNode):
        """Dense (c1, c2) views (multiproof data vectors)."""
        w = self.ext_width
        out = []
        for d in self._ext_leaf_dicts(node):
            vec = [0] * w
            for j, v in d.items():
                vec[j] = v
            out.append(vec)
        return out

    def _ext_data_vector(self, node: ExtensionNode):
        """[1, stem, c1_item, c2_item] (``node.rs:246-253``); requires the
        c1/c2 commitments to be populated."""
        return [
            1,
            _stem_item(node.stem),
            g1_to_data_item(node.c1_commit),
            g1_to_data_item(node.c2_commit),
        ]

    def _internal_vector(self, node: InternalNode):
        vec = [0] * self.internal_width
        for unit, child in node.children.items():
            assert child.commit is not None, "child committed before parent"
            vec[unit] = g1_to_data_item(child.commit)
        return vec

    def _commit_extensions(self, nodes):
        c_vectors = []
        for n in nodes:
            c1, c2 = self._ext_leaf_dicts(n)
            c_vectors.append(c1)
            c_vectors.append(c2)

        c_points = self._batched_commit(c_vectors, self.ext_width)
        for i, n in enumerate(nodes):
            n.c1_commit, n.c2_commit = c_points[2 * i], c_points[2 * i + 1]

        ext_points = self._batched_commit(
            [dict(enumerate(self._ext_data_vector(n))) for n in nodes], 4
        )
        for n, pt in zip(nodes, ext_points):
            n.commit = pt

    def _commit_internals(self, nodes):
        points = self._batched_commit(
            [
                {u: g1_to_data_item(ch.commit) for u, ch in n.children.items()}
                for n in nodes
            ],
            self.internal_width,
        )
        for n, pt in zip(nodes, points):
            n.commit = pt

    # -- proving (greenfield: the reference's proving impl block is EMPTY,
    #    ``verkle-tree/src/lib.rs:141-152``; this follows the Ethereum verkle
    #    proof shape — one multiproof over every (commitment, index, value)
    #    opening along the union of key paths) --------------------------------

    def _walk(self, stem):
        """Walk ``stem`` from the root: (internal_path, terminal, mode).

        ``internal_path`` is the (parent, depth, edge, child) list of internal
        links actually present; ``mode`` is one of
          ("P", depth)              — key present (terminal = its extension)
          ("E", depth)              — no child at stem[depth] of the internal
                                      node at depth (terminal = that node)
          ("O", depth, other_stem)  — path ends at an extension with a
                                      DIFFERENT stem (terminal = it)
          ("L", depth)              — extension with matching stem but no
                                      leaf at the key's unit (terminal = it)
        """
        path = []
        n = self.root
        depth = 0
        while isinstance(n, InternalNode):
            child = n.children.get(stem[depth])
            if child is None:
                return path, n, ("E", depth)
            path.append((n, depth, stem[depth], child))
            n = child
            depth += 1
        if n.stem != stem:
            return path, n, ("O", depth, n.stem)
        if stem[-1] not in n.leaves:
            return path, n, ("L", depth)
        return path, n, ("P", depth)

    def _canonical_queries(self, keys, values=None):
        """Walk ``keys`` (sorted) and produce the deduped opening list plus
        each key's path mode (see ``_walk``). Keys NOT in the tree generate
        ABSENCE openings (greenfield vs the empty proving block at
        ``verkle-tree/src/lib.rs:141-152``; Ethereum verkle semantics):

          * empty internal slot  -> open the parent's vector at the missing
            edge to 0;
          * extension with a different stem -> open its slots 0/1 to
            (1, other_stem_item) — the verifier checks the stems differ;
          * extension without the unit -> open the c1/c2 slots to 0 (this
            layout stores no presence marker, so "absent" and "value 0"
            commit identically — same as the reference's SplittableValue at
            ``verkle-tree/src/lib.rs:194-202``).

        ``values`` (optional dict key -> 256-bit int or None) overrides the
        tree's stored leaf values when deriving the leaf-opening y's — the
        verifier passes the CLAIMED values (None = claimed absent) so a
        mismatch surfaces as a query-structure mismatch.
        Returns (list of (commit, z, y, vector) tuples, modes dict).
        """
        half = self.ext_width // 2
        queries = []
        seen = set()
        modes = {}

        def add(commit, z, y, vec, dedup_key):
            if dedup_key in seen:
                return
            seen.add(dedup_key)
            queries.append((commit, z, y, vec))

        for key in sorted(tuple(k) for k in keys):
            stem, unit = self._split_key(key)
            path, terminal, mode = self._walk(stem)
            modes[key] = mode
            if values is not None:
                claimed = values.get(key)
                if (claimed is None) != (mode[0] != "P"):
                    raise NodeError(
                        f"claimed {'absence' if claimed is None else 'presence'}"
                        f" contradicts tree for key {key}"
                    )

            for parent, d, z, child in path:
                add(
                    parent.commit,
                    z,
                    g1_to_data_item(child.commit),
                    self._internal_vector(parent),
                    (id(parent), z),
                )
            if mode[0] == "E":
                add(
                    terminal.commit,
                    stem[mode[1]],
                    0,
                    self._internal_vector(terminal),
                    (id(terminal), stem[mode[1]]),
                )
                continue

            ext = terminal
            # extension-level openings: well-formedness + stem binding
            # (for "O" the bound stem is the OTHER extension's — proving the
            # searched stem is NOT here)
            ext_vec = self._ext_data_vector(ext)
            add(ext.commit, 0, 1, ext_vec, (id(ext), 0))
            add(ext.commit, 1, _stem_item(ext.stem), ext_vec, (id(ext), 1))
            if mode[0] == "O":
                continue

            # leaf openings inside c1 or c2 ("L": both slots open to 0)
            if mode[0] == "L":
                low = high = 0
            else:
                leaf_value = (
                    values[key] if values is not None else ext.leaves[unit]
                )
                low, high = _split_value(leaf_value)
            in_c1 = unit < half
            c_commit = ext.c1_commit if in_c1 else ext.c2_commit
            c_vec = self._ext_leaf_vectors(ext)[0 if in_c1 else 1]
            add(
                ext.commit,
                2 if in_c1 else 3,
                g1_to_data_item(c_commit),
                ext_vec,
                (id(ext), 2 if in_c1 else 3),
            )
            lo_idx, hi_idx = (2 * unit) % self.ext_width, (2 * unit + 1) % self.ext_width
            add(c_commit, lo_idx, low, c_vec, (id(ext), "c", in_c1, lo_idx))
            add(c_commit, hi_idx, high, c_vec, (id(ext), "c", in_c1, hi_idx))

        return queries, modes

    def prove_keys(self, keys):
        """One multiproof covering every opening along the given keys' paths
        — including ABSENCE openings for keys not in the tree.

        Returns a ``VerkleProof`` — a STATELESS verification object: it
        carries the multiproof, every non-root commitment touched (deduped,
        in first-use order over the sorted keys), and each key's path mode
        (depth + presence/absence kind). ``VerkleVerifier.verify``
        reconstructs the full opening list from (root commitment, keys,
        claimed values, proof) alone — no tree access — with parent/child
        linkage enforced because each parent opening's y is the data-item
        hash of the child's commitment.
        """
        from ..poly import FrVector
        from ..schemes.multiproof import ProverQuery, prove_multiproof

        self.commitment()  # ensure caches are fresh
        raw, modes = self._canonical_queries(keys, None)
        pqueries = [
            ProverQuery(
                data=FrVector.from_ints(vec, self.params.domain, device=self.device),
                commit=commit,
                z=z,
                y=y,
            )
            for (commit, z, y, vec) in raw
        ]
        proof = prove_multiproof(self.scheme, self.params, pqueries)

        # First-use-ordered non-root commitment stream: exactly what the
        # stateless reconstruction consumes (mode-dependent per key).
        commitments, seen = [], set()
        for key in sorted(tuple(k) for k in keys):
            stem, unit = self._split_key(key)
            mode = modes[key]
            depth = mode[1]
            node = self.root
            for d in range(depth):
                node = node.children[stem[d]]
                prefix = stem[: d + 1]
                if prefix not in seen:
                    seen.add(prefix)
                    commitments.append(node.commit)
            if mode[0] in ("E", "O"):
                continue
            in_c1 = unit < self.ext_width // 2
            ckey = (stem[:depth], 1 if in_c1 else 2)
            if ckey not in seen:
                seen.add(ckey)
                commitments.append(node.c1_commit if in_c1 else node.c2_commit)
        return VerkleProof(multiproof=proof, commitments=commitments, modes=modes)

    def verify_keys(self, keys, values, proof) -> bool:
        """Stateless check against THIS tree's root commitment (convenience
        wrapper; uses only the cached root commitment, never tree internals).
        ``values[key] = None`` claims the key is ABSENT."""
        return VerkleVerifier(
            scheme=self.scheme,
            params=self.params,
            key_len=self.key_len,
            ext_width=self.ext_width,
        ).verify(self.root.commit, keys, values, proof)


@dataclasses.dataclass
class VerkleProof:
    """Stateless verkle verification object (greenfield: the reference's
    proving impl block is empty, ``verkle-tree/src/lib.rs:141-152``; the
    shape follows Ethereum's verkle proofs — commitments-by-first-use plus
    per-key path modes alongside one multiproof)."""

    multiproof: object
    commitments: list  # non-root commitments, first-use order (sorted keys)
    #: key tuple -> ("P"|"E"|"L", depth) or ("O", depth, other_stem):
    #: presence / empty-slot / missing-leaf / other-stem path terminator
    modes: dict


@dataclasses.dataclass
class VerkleVerifier:
    """Verifies key->value openings against a ROOT COMMITMENT ONLY.

    Holds just the public tree geometry (key length / extension width) and
    the commitment scheme. The expected (commit, z, y) opening list is
    reconstructed from the proof's commitment stream: every internal-path
    opening's y is forced to be the data-item hash of the next commitment
    in the stream, the extension openings bind the stem and the c1/c2
    commitments, and the leaf openings bind the CLAIMED values — so a
    light client needs no trie state at all."""

    scheme: object
    params: object
    key_len: int
    ext_width: int

    def verify(self, root_commitment, keys, values, proof: VerkleProof) -> bool:
        from ..schemes.multiproof import VerifierQuery, verify_multiproof

        try:
            queries = self._reconstruct_queries(root_commitment, keys, values, proof)
        except (NodeError, KeyError, StopIteration, AssertionError):
            return False
        vqueries = [VerifierQuery(c, z, y) for (c, z, y) in queries]
        return verify_multiproof(self.scheme, self.params, vqueries, proof.multiproof)

    def _reconstruct_queries(self, root_commitment, keys, values, proof):
        half = self.ext_width // 2
        stream = iter(proof.commitments)
        assigned = {(): root_commitment}
        queries, seen = [], set()

        def add(commit, z, y, dedup_key):
            if dedup_key in seen:
                return
            seen.add(dedup_key)
            queries.append((commit, z, y))

        # protocol-level validation of attacker-supplied proofs must raise
        # typed errors, not assert (asserts vanish under python -O)
        for key in sorted(tuple(k) for k in keys):
            if len(key) != self.key_len:
                raise NodeError(f"key length {len(key)} != {self.key_len}")
            stem, unit = key, key[-1]  # full key as stem (reference quirk)
            mode = proof.modes[key]
            kind, depth = mode[0], mode[1]
            # claimed value None <=> proof claims the key is absent
            if (values[key] is None) != (kind != "P"):
                raise NodeError(
                    f"claimed value contradicts proof mode for key {key}"
                )
            if kind == "P" and depth < 1:
                raise NodeError(f"invalid proof depth {depth}")
            parent = root_commitment
            for d in range(depth):
                prefix = stem[: d + 1]
                child = assigned.get(prefix)
                if child is None:
                    child = next(stream)
                    assigned[prefix] = child
                add(parent, stem[d], g1_to_data_item(child), (stem[:d], stem[d]))
                parent = child
            if kind == "E":
                # absence: the internal node at ``depth`` has no child at
                # the key's next edge — its vector opens to 0 there
                add(parent, stem[depth], 0, (stem[:depth], stem[depth]))
                continue

            ext_commit = parent
            ext_prefix = stem[:depth]
            if kind == "O":
                # absence: the path ends at an extension bound (via slot 1)
                # to a DIFFERENT stem
                other = tuple(mode[2])
                if other == stem or len(other) != self.key_len:
                    raise NodeError("other-stem absence proof with own stem")
                if other[:depth] != stem[:depth]:
                    raise NodeError("other-stem does not share the path prefix")
                add(ext_commit, 0, 1, (ext_prefix, "ext", 0))
                add(ext_commit, 1, _stem_item(other), (ext_prefix, "ext", 1))
                continue
            add(ext_commit, 0, 1, (ext_prefix, "ext", 0))
            add(ext_commit, 1, _stem_item(stem), (ext_prefix, "ext", 1))

            in_c1 = unit < half
            ckey = (ext_prefix, 1 if in_c1 else 2)
            c_commit = assigned.get(ckey)
            if c_commit is None:
                c_commit = next(stream)
                assigned[ckey] = c_commit
            add(
                ext_commit,
                2 if in_c1 else 3,
                g1_to_data_item(c_commit),
                (ext_prefix, "ext", 2 if in_c1 else 3),
            )
            if kind == "L":
                # absence: the extension exists but holds no leaf at the
                # unit — both value slots open to 0. NB: this layout stores
                # no presence marker (SplittableValue, lib.rs:194-202), so
                # "absent" is indistinguishable from "present with value 0".
                low = high = 0
            else:
                low, high = _split_value(values[key])
            lo_idx = (2 * unit) % self.ext_width
            hi_idx = (2 * unit + 1) % self.ext_width
            add(c_commit, lo_idx, low, (ext_prefix, "c", in_c1, lo_idx))
            add(c_commit, hi_idx, high, (ext_prefix, "c", in_c1, hi_idx))

        # the whole stream must be consumed (no smuggled extras)
        if next(stream, None) is not None:
            raise NodeError("proof commitment stream not fully consumed")
        return queries
