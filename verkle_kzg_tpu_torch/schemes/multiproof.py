"""PCS multiproof (Dankrad Feist's random-linear-combination batch opening)
over the IPA, on PyTorch tensors (``verkle_kzg_tpu/schemes/multiproof.py``,
the reference's ``vector-commit/src/multiproof.rs``).

Every per-query computation runs on the device of ``params`` as a few
batched K1 passes over an (M, N, 8) tensor:

  * query scaling by r^i: one broadcast Montgomery product;
  * grouping by evaluation point: the queries are sorted by z and summed
    within each run of equal z by a segmented Hillis-Steele scan of K1 adds
    (log2 M passes), exact in the field (the JAX package's lazy uint32
    column scatter is a device trick of the TPU and is not needed here);
  * per-point quotients: ``poly/lagrange.py::_quotient_in_domain`` for all
    distinct points at once, fed by ``Domain.invdiff_rows``;
  * h(x) accumulation: a broadcast product and a K1 add tree.

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
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..params import R
from ..poly import FrVector
from ..poly.lagrange import _quotient_in_domain
from ..utils import metrics


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


def _absorb_queries(t: Transcript, queries) -> None:
    for q in queries:
        t.append_point(q.commit, "C")
        t.append_usize(q.z, "z")
        t.append_scalar(q.y, "y")


def _group_by_z(scaled: torch.Tensor, zs: list):
    """(M, N, 8) scaled query rows and their M opening points -> the sorted
    distinct points and (Zq, N, 8) rows, each the field sum of the rows
    opened at that point: sort by z, then a segmented inclusive scan of K1
    adds (a row takes the partial sum k rows back only within its own run),
    whose last row in each run is the run's sum."""
    distinct = sorted(set(zs))
    rank = {z: i for i, z in enumerate(distinct)}
    seg = torch.tensor([rank[z] for z in zs], device=scaled.device)
    seg, order = torch.sort(seg, stable=True)
    x = scaled[order]
    k = 1
    while k < x.shape[0]:
        same = (seg[k:] == seg[:-k])[:, None, None]
        x = torch.cat([x[:k], torch.where(same, F.add(x[k:], x[:-k], "fr"), x[k:])])
        k *= 2
    ends = torch.cumsum(torch.bincount(seg, minlength=len(distinct)), 0) - 1
    return distinct, x[ends]


def _quotients_sum(grouped: torch.Tensor, domain, z_idx: torch.Tensor) -> torch.Tensor:
    """g(x) = sum over the distinct opening points z of the in-domain
    quotient of that point's grouped row (``multiproof.py::_quotients_sum_impl``):
    (Zq, N, 8) -> (N, 8)."""
    dev = grouped.device
    ratio = F.mont_mul(domain.d_vanishing(dev)[z_idx][:, None], domain.d_vanishing_inv(dev)[None], "fr")
    q = _quotient_in_domain(grouped, domain.invdiff_rows(z_idx), ratio, z_idx)
    return F.sum_axis(q, 0, "fr")[0]


def prove_multiproof(scheme, params, queries: list) -> Multiproof:
    """``multiproof.rs:99-176``. ``scheme`` is the IPA namespace; every
    tensor lives on ``params.device``."""
    dev = params.device
    domain = params.domain
    n = domain.size
    m = len(queries)
    metrics.record("multiproof.prove.calls")
    metrics.record("multiproof.prove.queries", m)
    t = Transcript("multiproof")
    _absorb_queries(t, queries)
    r = t.digest("r", True)

    # stack each distinct data vector once (the verkle path opens the same
    # node vector at several points) and gather per query
    uniq, sel = {}, []
    for q in queries:
        sel.append(uniq.setdefault(id(q.data), (len(uniq), q.data.vals))[0])
    stack = torch.stack([vals for _, vals in uniq.values()])
    data = stack[torch.tensor(sel, device=dev)]  # (M, N, 8)
    r_pows = F.powers_of_mont(F.ints_to_mont([r], "fr", dev)[0], m, "fr")  # (M, 8)
    scaled = F.mont_mul(data, r_pows[:, None], "fr")

    distinct, grouped = _group_by_z(scaled, [q.z for q in queries])
    g = FrVector(_quotients_sum(grouped, domain, torch.tensor(distinct, device=dev)), n, domain)

    d_commit = scheme.commit(params, g)
    t.append_point(d_commit, "D")
    t_chal = t.digest("t", True)

    # 1 / (t - z) for integer z in 0..N (``utils.rs:57-62``)
    inversions = fr_batch_inverse([(t_chal - i) % R for i in range(n)])
    inv_q = F.ints_to_mont([inversions[q.z] for q in queries], "fr", dev)  # (M, 8)
    h = FrVector(F.sum_axis(F.mont_mul(scaled, inv_q[:, None], "fr"), 0, "fr")[0], n, domain)

    e_commit = scheme.commit(params, h)
    t.append_point(e_commit, "E")

    proof = scheme.prove_point(params, g1_add(e_commit, g1_neg(d_commit)), t_chal, h - g, t)
    return Multiproof(proof=proof, d=d_commit)


def verify_multiproof(scheme, params, queries: list, proof: Multiproof) -> bool:
    """``multiproof.rs:178-215``: the E aggregation is one MSM over the
    distinct commitments (``msm_auto``; K5 below 64 of them)."""
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
    e_commit = C.projective_to_host_points(M.msm_auto(pts, scalars))[0]
    t.append_point(e_commit, "E")
    return scheme.verify_point(params, g1_add(e_commit, g1_neg(proof.d)), t_chal, proof.proof, t)
