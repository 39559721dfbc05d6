"""KZG vector commitment in Lagrange (evaluation) form
(``verkle_kzg_tpu/schemes/kzg.py``, the reference's ``vector-commit/src/kzg/mod.rs``),
on PyTorch tensors.

* The SRS commits to the Lagrange polynomials, l_i(alpha) G, so commit and
  prove never leave evaluation form (``kzg/mod.rs:28-57``).
* Setup derives that SRS directly: l_i(alpha) on the host, then one K5
  launch multiplies the generator by all N of them. The reference reaches
  the same group elements by an IFFT over the monomial SRS
  (``kzg/mod.rs:115-124``); the secret of this test-only setup is known
  (s = 100), so evaluating l_i(alpha) is the cheaper construction with the
  same output. The G1 IFFT (``ops/ntt.py``) backs the FK prover.
* Commit and prove are single MSMs (``ops/msm.py::msm_auto``); the
  quotients are ``poly/lagrange.py``'s K1 passes.
* Verify's two pairings run as one 2-pairing product on the host
  (``hostmath/pairing.py``, native first), as the reference leans on
  arkworks there (``kzg/mod.rs:182-186``). Each verify is the span
  ``protocol.kzg.verify_point`` and its pairing product the span
  ``protocol.kzg.pairing`` inside it (``utils/metrics.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..errors import KZGError
from ..hostmath.curve import g1_add, g1_generator, g1_mul, g1_neg, g2_add, g2_generator, g2_mul, g2_neg
from ..hostmath.field import Fq12, fr_batch_inverse
from ..hostmath.pairing import multi_pairing
from ..ops import cuda_lib
from ..ops import curve as C
from ..ops import msm as M
from ..params import R
from ..poly import Domain, FrVector
from ..utils.metrics import span
from .generators import DEFAULT_KZG_SECRET, generator_multiples, kzg_g2


@dataclasses.dataclass
class KZGParams:
    """KZGKey (``kzg/mod.rs:28-57``): the Lagrange SRS as host points, alpha H
    in G2, the domain, and the device the SRS tensor lives on: the CUDA card
    unless ``device`` says otherwise."""

    size: int
    lagrange_host: list
    g2: tuple
    domain: Domain
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = cuda_lib.resolve_device(self.device)

    @functools.cached_property
    def lagrange_affine(self) -> torch.Tensor:
        return C.host_points_to_affine(self.lagrange_host, self.device)

    def max_size(self) -> int:
        return self.size


@dataclasses.dataclass
class KZGProof:
    proof: tuple  # pi, a host G1 point
    y: int


def kzg_setup(max_items: int, secret: int = DEFAULT_KZG_SECRET, device=None) -> KZGParams:
    """The Lagrange SRS [l_i(alpha) G] and [alpha H] (see the module
    docstring), on the CUDA card unless ``device`` says otherwise."""
    device = cuda_lib.resolve_device(device)
    domain = Domain(max_items)
    n = domain.size
    # l_i(alpha) = (alpha^N - 1) / N * w^i / (alpha - w^i)
    t = (pow(secret, n, R) - 1) * domain.size_inv % R
    denoms = fr_batch_inverse([(secret - w) % R for w in domain.omegas])
    lag = [t * w % R * d % R for w, d in zip(domain.omegas, denoms)]
    return KZGParams(
        size=n, lagrange_host=generator_multiples(lag, device), g2=kzg_g2(secret), domain=domain, device=device
    )


class KZG:
    """Namespace mirroring the reference's VectorCommitment impl for KZG.
    Its proofs open no transcript: ``transcript`` arguments are accepted
    for the multiproof's calls and ignored."""

    @staticmethod
    def basis_affine(params: KZGParams) -> torch.Tensor:
        """The (N, 2, 8) commitment basis, for batched commits (the verkle tree)."""
        return params.lagrange_affine

    @staticmethod
    @span("protocol", "kzg.commit")
    def commit(params: KZGParams, data: FrVector, mesh=None):
        """C = <lagrange_srs, a>: one MSM (``kzg/mod.rs:126-134``); with
        ``mesh``, split across its ranks (``parallel.msm_sharded``)."""
        scalars = data.to_scalars_standard()
        if mesh is not None:
            from ..parallel.mesh import msm_sharded

            out = msm_sharded(params.lagrange_affine, scalars, mesh)
        else:
            out = M.msm_auto(params.lagrange_affine, scalars)
        return C.projective_to_host_points(out)[0]

    @staticmethod
    def prove(params: KZGParams, commitment, index: int, data: FrVector) -> KZGProof:
        return KZG.prove_point(params, commitment, index, data, None)

    @staticmethod
    @span("protocol", "kzg.prove")
    def prove_point(params: KZGParams, commitment, point: int, data: FrVector, transcript=None) -> KZGProof:
        """``kzg/mod.rs:136-154``. The in-domain test is the reference's
        ``point <= max_size`` (its own boundary quirk, SURVEY.md §5 item 2):
        point == max_size would panic in the reference; here it raises."""
        evaluation = data.evaluate(point)
        if point <= params.size:
            if point == params.size:
                raise KZGError(
                    "point == max_size is out of range for the in-domain quotient (reference panics here too)"
                )
            q = data.divide_by_vanishing(point)
        else:
            q = data.divide_by_vanishing_outside(point)
        out = M.msm_auto(params.lagrange_affine, q.to_scalars_standard())
        return KZGProof(proof=C.projective_to_host_points(out)[0], y=evaluation)

    @staticmethod
    def verify(params: KZGParams, commitment, index: int, proof: KZGProof) -> bool:
        return KZG.verify_point(params, commitment, index, proof, None)

    @staticmethod
    @span("protocol", "kzg.verify_point")
    def verify_point(params: KZGParams, commitment, point: int, proof: KZGProof, transcript=None) -> bool:
        """e(pi, alpha H - p H) == e(C - y G, H) (``kzg/mod.rs:165-189``),
        checked as one 2-pairing product with the right side negated (one
        shared final exponentiation). In-domain points (< max_size) map to
        w^point."""
        p = params.domain.element(point) if point < params.size else point
        h = g2_generator()
        lhs_g2 = g2_add(params.g2, g2_neg(g2_mul(h, p)))
        rhs_g1 = g1_add(commitment, g1_neg(g1_mul(g1_generator(), proof.y)))
        with span("protocol", "kzg.pairing"):
            return multi_pairing([(proof.proof, lhs_g2), (g1_neg(rhs_g1), h)]) == Fq12.one()

    @staticmethod
    def prove_batch(params, commitment, indexes, data):
        """todo!() in the reference (``kzg/mod.rs:156-163``); use
        prove_multiproof or prove_all_points."""
        raise NotImplementedError("prove_batch is todo!() in the reference; use prove_multiproof")

    @staticmethod
    def verify_batch(params, commitment, proof):
        raise NotImplementedError("verify_batch is todo!() in the reference; use verify_multiproof")

    @staticmethod
    def prove_all_points(params: KZGParams, data: FrVector) -> list:
        """Feist-Khovratovich amortized all-points prover (``kzg/mod.rs:200-235``),
        over the NTTs of ``ops/ntt.py`` (``schemes/fk.py``)."""
        from . import fk  # fk imports this module

        return fk.prove_all_points(params, data)
