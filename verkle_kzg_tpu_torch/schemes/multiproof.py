"""PCS multiproof (Dankrad Feist's random-linear-combination batch opening)
over the IPA or KZG, on PyTorch tensors (``verkle_kzg_tpu/schemes/multiproof.py``,
the reference's ``vector-commit/src/multiproof.rs``).

Every per-query computation runs on the device of ``params`` in three
launches (``ops/cuda_multiproof.py``), the JAX package's three jitted
programs (``verkle_kzg_tpu/schemes/multiproof.py:78-129``):

  * :func:`_scale_and_group`, kernel K1MP: grouped[j] = sum over the queries
    m opened at the j-th distinct point of r^m data[m], the powers of r made
    in the kernel; the host plans the order by z and the segments from the
    ints it holds, so no device sort or host sync runs (the JAX package's
    lazy uint32 column scatter is a device trick of the TPU and is not
    needed here);
  * :func:`_quotients_sum`, kernel K1QUO: g = the sum of the in-domain
    quotients of the grouped rows, from the domain's tables, no inversion;
  * :func:`_h_accumulate`, kernel K1MP: h = sum_j grouped[j] / (t - z_j)
    and h - g, exact in the field, so equal to the sum over the queries.

Transcript bytes match the reference exactly (labels "C"/"z"/"y"/"r"/"D"/
"t"/"E"; z is appended as an 8-byte LE usize). Quirk 1 (SURVEY.md §5) is
followed as the JAX package follows it: the reference's verifier computes
g2_of_t but never checks it against the proof's claimed y
(``multiproof.rs:194-209``), so neither does this one.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fiatshamir.transcript import Transcript
from ..hostmath.curve import g1_add, g1_neg
from ..hostmath.field import fr_batch_inverse
from ..ops import cuda_multiproof as KM
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..params import R
from ..poly import FrVector
from ..poly.lagrange import quotient_in_domain
from ..utils import metrics
from ..utils.metrics import span


@dataclasses.dataclass
class ProverQuery:
    """(data, commitment, z, y) (``multiproof.rs:26-41``)."""

    data: FrVector
    commit: tuple
    z: int
    y: int

    def to_verifier_query(self) -> "VerifierQuery":
        return VerifierQuery(self.commit, self.z, self.y)


@dataclasses.dataclass
class VerifierQuery:
    commit: tuple
    z: int
    y: int


@dataclasses.dataclass
class Multiproof:
    proof: object  # the scheme's proof of the final opening
    d: tuple  # commitment to g(x)


@span("protocol", "multiproof.absorb")
def _absorb_queries(t: Transcript, queries) -> None:
    for q in queries:
        t.append_point(q.commit, "C")
        t.append_usize(q.z, "z")
        t.append_scalar(q.y, "y")


@span("protocol", "multiproof.group")
def _scale_and_group(stack: torch.Tensor, sel: list, r: torch.Tensor, zs: list):
    """Kernel K1MP's grouped pass: the (U, N, 8) distinct data vectors, each
    query's vector ``sel[m]`` and point ``zs[m]``, and r as (8,) Montgomery
    words -> the sorted distinct points and (Zq, N, 8) rows, each the field
    sum of r^m data[m] over the queries m opened at that point."""
    distinct, plan = KM.plan_segments(zs, sel)
    return distinct, KM.segment_sum(stack, r, plan, mode=0)


@span("protocol", "multiproof.quotients")
def _quotients_sum(grouped: torch.Tensor, domain, zs: list) -> torch.Tensor:
    """g(x) = sum over the distinct opening points z of the in-domain
    quotient of that point's grouped row (``multiproof.py::_quotients_sum_impl``):
    (Zq, N, 8) -> (N, 8), one K1QUO launch."""
    return quotient_in_domain(grouped, zs, domain, sum_rows=True)


@span("protocol", "multiproof.h")
def _h_accumulate(grouped: torch.Tensor, inv: torch.Tensor, g: torch.Tensor) -> tuple:
    """Kernel K1MP's h pass: h = sum_j grouped[j] inv[j] for the (Zq, 8)
    Montgomery inverses 1 / (t - z_j), and h - g; both (N, 8)."""
    zq = grouped.shape[0]
    _, plan = KM.plan_segments([0] * zq, range(zq))
    h, h_minus_g = KM.segment_sum(grouped, inv, plan, mode=1, g=g)
    return h[0], h_minus_g


@span("protocol", "multiproof.prove")
def prove_multiproof(scheme, params, queries: list, mesh=None) -> Multiproof:
    """``multiproof.rs:99-176``. ``scheme`` is the IPA or the KZG namespace;
    every tensor lives on ``params.device``. With ``mesh``, the D and E
    commitments split across its ranks (``parallel.msm_sharded``), in the
    place of the reference's rayon pool (``multiproof.rs:119-132``)."""
    dev = params.device
    domain = params.domain
    n = domain.size
    m = len(queries)
    metrics.record("multiproof.prove.queries", m)
    t = Transcript("multiproof")
    _absorb_queries(t, queries)
    r = t.digest("r", True)

    # stack each distinct data vector once (the verkle path opens the same
    # node vector at several points); the kernel gathers per query
    uniq, sel = {}, []
    for q in queries:
        sel.append(uniq.setdefault(id(q.data), (len(uniq), q.data.vals))[0])
    stack = torch.stack([vals for _, vals in uniq.values()])
    r_mont = F.ints_to_mont([r], "fr", dev)[0]
    distinct, grouped = _scale_and_group(stack, sel, r_mont, [q.z for q in queries])
    g = FrVector(_quotients_sum(grouped, domain, distinct), n, domain)

    d_commit = scheme.commit(params, g, mesh=mesh)
    t.append_point(d_commit, "D")
    t_chal = t.digest("t", True)

    # 1 / (t - z) for integer z in 0..N (``utils.rs:57-62``), one a distinct point
    inversions = fr_batch_inverse([(t_chal - i) % R for i in range(n)])
    inv = F.ints_to_mont([inversions[z] for z in distinct], "fr", dev)
    h_vals, h_minus_g = _h_accumulate(grouped, inv, g.vals)
    h = FrVector(h_vals, n, domain)

    e_commit = scheme.commit(params, h, mesh=mesh)
    t.append_point(e_commit, "E")

    h_minus_g = FrVector(h_minus_g, n, domain)
    proof = scheme.prove_point(params, g1_add(e_commit, g1_neg(d_commit)), t_chal, h_minus_g, t)
    return Multiproof(proof=proof, d=d_commit)


@span("protocol", "multiproof.verify")
def verify_multiproof(scheme, params, queries: list, proof: Multiproof, mesh=None) -> bool:
    """``multiproof.rs:178-215``: the E aggregation is one MSM over the
    distinct commitments (``msm_auto``; K5 below 64 of them), split across
    the ranks of ``mesh`` when one is given (``parallel.msm_sharded``)."""
    n = params.domain.size
    t = Transcript("multiproof")
    _absorb_queries(t, queries)
    r = t.digest("r", True)
    t.append_point(proof.d, "D")
    t_chal = t.digest("t", True)

    inversions = fr_batch_inverse([(t_chal - i) % R for i in range(n)])
    e_coeffs: dict = {}
    r_pow = 1
    for q in queries:
        e_coeff = r_pow * inversions[q.z] % R
        e_coeffs[q.commit] = (e_coeffs.get(q.commit, 0) + e_coeff) % R
        # the reference also accumulates g2_of_t += e_coeff * y here and
        # never uses it (quirk 1; see the module docstring)
        r_pow = r_pow * r % R

    commits = list(e_coeffs)
    pts = C.host_points_to_affine(commits, params.device)
    scalars = F.ints_to_words([e_coeffs[c] for c in commits], params.device)
    if mesh is not None:
        from ..parallel.mesh import msm_sharded

        e_dev = msm_sharded(pts, scalars, mesh)
    else:
        e_dev = M.msm_auto(pts, scalars)
    e_commit = C.projective_to_host_points(e_dev)[0]
    t.append_point(e_commit, "E")
    return scheme.verify_point(params, g1_add(e_commit, g1_neg(proof.d)), t_chal, proof.proof, t)
