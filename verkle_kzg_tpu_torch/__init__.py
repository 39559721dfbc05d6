"""verkle_kzg_tpu_torch: the PyTorch + CUDA port of verkle_kzg_tpu.

It runs the same protocols on an NVIDIA Hopper card, with the same values
at the public boundary (host ints, canonical affine points, proof objects,
transcript bytes): the IPA at any power-of-two domain (commit, prove,
verify, the commitment proof), KZG (commit, prove, verify, the FK
all-points prover), the multiproof over either, and the verkle tree (build,
commit, prove keys with absence proofs, stateless verify).

Layer map:
  verkle     VerkleTree, VerkleProof, VerkleVerifier
  schemes    IPA, KZG, FK, the multiproof
  poly       Domain, FrVector
  ops        field (K1), curve (K2, K11, K12, K5), single-MSM (K3, K4, K8,
             K9, K10) and batched-MSM (K6, K7) kernels with their plain
             PyTorch versions, and the Fr and G1 NTTs over them; ``csrc/``
             holds the CUDA sources
  parallel   sharding across cards over torch.distributed: the sharded
             single, batched and fixed-base MSMs, the four-step Fr and G1
             NTTs (``make_mesh`` over an initialised process group)
  convert    bridge from the JAX package's objects (for tests)
  utils      metrics counters, persistence (the JAX package's ``.npz``
             format), torch.profiler hooks

Host-side modules of its own, copied from the JAX package (which this
package never imports): ``params``, ``errors``, ``hostmath`` (field,
curve, hashing, pairing, serialize), ``fiatshamir.transcript`` and
``native`` (the ctypes loader of the repo's C++ oracle,
``native/vkzg.cpp``). This package imports ``torch`` and never ``jax``.

The entry points (``ipa_setup``, ``IPAParams``, ``kzg_setup``,
``KZGParams``, ``kzg_generate_monomial_srs``, ``FrVector.from_ints``,
``VerkleTree`` through its params, the multiproof through its params) run
on the CUDA card unless the caller passes ``device="cpu"``; without a card
they raise. So does ``parallel.make_mesh``, whose CPU form needs a gloo
process group.
"""

__version__ = "0.1.0"

__all__ = [
    "fiatshamir",
    "hostmath",
    "ops",
    "params",
    "parallel",
    "poly",
    "schemes",
    "verkle",
]
