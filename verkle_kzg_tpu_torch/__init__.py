"""verkle_kzg_tpu_torch: the PyTorch + CUDA port of verkle_kzg_tpu.

It runs the same protocols on an NVIDIA Hopper card, with the same values
at the public boundary (host ints, canonical affine points, proof objects,
transcript bytes): the IPA at any power-of-two domain (commit, prove,
verify, the commitment proof), the multiproof over it, and the verkle tree
(build, commit, prove keys with absence proofs, stateless verify).

Layer map:
  verkle     VerkleTree, VerkleProof, VerkleVerifier
  schemes    IPA, the multiproof
  poly       Domain, FrVector
  ops        field (K1), curve (K2, K5), single-MSM (K3, K4) and batched-MSM
             (K6, K7) kernels with their plain PyTorch versions; ``csrc/``
             holds the CUDA sources
  convert    bridge from the JAX package's objects (for tests)
  utils      metrics counters

Host-side modules of its own, copied from the JAX package (which this
package never imports): ``params``, ``errors``, ``hostmath`` (field, curve,
hashing, serialize), ``fiatshamir.transcript`` and ``native`` (the ctypes
loader of the repo's C++ oracle, ``native/vkzg.cpp``). This package
imports ``torch`` and never ``jax``.

The entry points (``ipa_setup``, ``IPAParams``, ``FrVector.from_ints``,
``VerkleTree`` through its params, the multiproof through its params) run
on the CUDA card unless the caller passes ``device="cpu"``; without a card
they raise.
"""
