"""Commitment schemes: the IPA, KZG (with the FK all-points prover), and
the multiproof over either."""

from .generators import DEFAULT_IPA_SEED, DEFAULT_KZG_SECRET, ipa_generate_points, kzg_g2, kzg_generate_monomial_srs
from .ipa import IPA, IPACommitProof, IPAParams, IPAProof, ipa_setup
from .kzg import KZG, KZGParams, KZGProof, kzg_setup
from .multiproof import Multiproof, ProverQuery, VerifierQuery, prove_multiproof, verify_multiproof

__all__ = [
    "DEFAULT_IPA_SEED",
    "DEFAULT_KZG_SECRET",
    "IPA",
    "IPACommitProof",
    "IPAParams",
    "IPAProof",
    "KZG",
    "KZGParams",
    "KZGProof",
    "Multiproof",
    "ProverQuery",
    "VerifierQuery",
    "ipa_generate_points",
    "ipa_setup",
    "kzg_g2",
    "kzg_generate_monomial_srs",
    "kzg_setup",
    "prove_multiproof",
    "verify_multiproof",
]
