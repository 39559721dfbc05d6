"""Verkle trie: host-side structure, device-batched commitments."""

from .tree import VerkleProof, VerkleTree, VerkleVerifier

__all__ = ["VerkleProof", "VerkleTree", "VerkleVerifier"]
