"""Commitment schemes: the IPA and the multiproof over it (KZG and FK come
later)."""

from .generators import DEFAULT_IPA_SEED, ipa_generate_points
from .ipa import IPA, IPACommitProof, IPAParams, IPAProof, ipa_setup
from .multiproof import Multiproof, ProverQuery, VerifierQuery, prove_multiproof, verify_multiproof

__all__ = [
    "DEFAULT_IPA_SEED",
    "IPA",
    "IPACommitProof",
    "IPAParams",
    "IPAProof",
    "Multiproof",
    "ProverQuery",
    "VerifierQuery",
    "ipa_generate_points",
    "ipa_setup",
    "prove_multiproof",
    "verify_multiproof",
]
