"""IPA (inner-product argument) vector commitment in evaluation form
(``verkle_kzg_tpu/schemes/ipa.py``), on PyTorch tensors.

The data vector, the barycentric b vector and the CRS live on one device;
every group operation is a single Pippenger MSM (``ops/msm.py``), and the
prove's vector math is kernel K1IPA (``ops/cuda_ipa.py``): one launch for
<a, b>, one a halving round, one for the last fold. Proofs, transcript
bytes and commitments are bit-identical to the JAX package's.

Prove is a loop sequenced on the host, in coefficient space. Each halving
round keeps the JAX fused loop's math (``_fused_ipa_loop``): per ORIGINAL
basis index i the accumulated challenge weight W(i) (the product of the
past challenges x_k for the rounds in which i sat in the left half), so
the folded generator at slot j is sum_{i mod len == j} W(i) g_i, and both
cross terms are one MSM each over the FIXED basis g || q:

    y_l = <g_r, a_l> + (w <a_l, b_r>) q = MSM(g || q, gamma_l || w ip_l)

with gamma_l(i) = W(i) a[(i mod len) - half] for i in the right half of
its block and 0 elsewhere (y_r mirrored). Folding the generators in point
space instead would cost a 256-bit scalar multiplication and an inversion
per round. The Fiat-Shamir digests stay on the host, through the shared
``Transcript``, in the order the reference uses (``ipa/mod.rs:268-319``):
a card attached to its own host pays no round trip for them.

The reference's direction quirks hold: the generators fold as
g <- g_r + x g_l, and an in-domain point is the integer index (one-hot b).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..fiatshamir.transcript import Transcript
from ..params import R

from ..ops import cuda_ipa as KI
from ..ops import cuda_lib
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..poly import Domain, FrVector
from ..utils import metrics
from .generators import DEFAULT_IPA_SEED, ipa_generate_points


@dataclasses.dataclass
class IPAParams:
    """N basis points g, the inner-product point q, the domain, and the
    device the CRS tensors live on (``ipa/mod.rs:22-68``): the CUDA card
    unless ``device`` says otherwise."""

    n: int
    g_host: list
    q_host: tuple
    domain: Domain
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = cuda_lib.resolve_device(self.device)

    @functools.cached_property
    def g_affine(self) -> torch.Tensor:
        return C.host_points_to_affine(self.g_host, self.device)

    @functools.cached_property
    def q_affine(self) -> torch.Tensor:
        return C.host_points_to_affine([self.q_host], self.device)

    def max_size(self) -> int:
        return self.n


@dataclasses.dataclass
class IPAProof:
    l: list
    r: list
    tip: int
    y: int


@dataclasses.dataclass
class IPACommitProof:
    l: list
    r: list
    tip: int


def ipa_setup(n: int, seed: bytes = DEFAULT_IPA_SEED, device=None) -> IPAParams:
    """N + 1 hash-to-curve points (``ipa/mod.rs:121-128``), on the CUDA card
    unless ``device`` says otherwise."""
    device = cuda_lib.resolve_device(device)
    pts = ipa_generate_points(n + 1, seed)
    return IPAParams(n=n, g_host=pts[:n], q_host=pts[n], domain=Domain(n), device=device)


class IPA:
    """Namespace mirroring the reference's VectorCommitment impl for IPA."""

    transcript_label = "ipa"

    @staticmethod
    def basis_affine(params: IPAParams) -> torch.Tensor:
        """The (N, 2, 8) commitment basis, for batched commits (the verkle tree)."""
        return params.g_affine

    @staticmethod
    def commit(params: IPAParams, data: FrVector, mesh=None):
        """C = <g, a>: one MSM (``ipa/mod.rs:130-135``); with ``mesh``, the
        points and scalars split across its ranks (``parallel.msm_sharded``)."""
        scalars = data.to_scalars_standard()
        if mesh is not None:
            from ..parallel.mesh import msm_sharded

            out = msm_sharded(params.g_affine, scalars, mesh)
        else:
            out = M.msm_auto(params.g_affine, scalars)
        return C.projective_to_host_points(out)[0]

    @staticmethod
    def prove(params: IPAParams, commitment, index: int, data: FrVector) -> IPAProof:
        return IPA.prove_point(params, commitment, index, data, None)

    @staticmethod
    def prove_point(params: IPAParams, commitment, point: int, data: FrVector, transcript=None) -> IPAProof:
        metrics.record("ipa.prove.calls")
        a = data.vals
        b = F.ints_to_mont(params.domain.barycentric_coefficients(point), "fr", a.device)
        n = a.shape[0]
        t = transcript if transcript is not None else Transcript(IPA.transcript_label)
        t.append_point(commitment, "C")
        t.append_scalar(point % R, "input point")
        y = F.mont_to_ints(KI.inner(a, b), "fr")[0]
        t.append_scalar(y, "output point")
        w = t.digest("w", True)
        if n == 1:
            return IPAProof(l=[], r=[], tip=F.mont_to_ints(a, "fr")[0], y=y)
        basis = torch.cat([params.g_affine[:n], params.q_affine])
        l_pts, r_pts, tip = _halving_loop(basis, a, b, w, t)
        return IPAProof(l=l_pts, r=r_pts, tip=tip, y=y)

    @staticmethod
    def verify(params: IPAParams, commitment, index: int, proof: IPAProof) -> bool:
        return IPA.verify_point(params, commitment, index, proof, None)

    @staticmethod
    def verify_point(params: IPAParams, commitment, point: int, proof: IPAProof, transcript=None) -> bool:
        """``ipa/mod.rs:321-360`` as ONE MSM over {g_i, q, C, L_i, R_i}
        checked against the identity: every challenge replays from the
        proof's L/R points, so the whole check needs no other group work."""
        metrics.record("ipa.verify.calls")
        b = params.domain.barycentric_coefficients(point)
        t = transcript if transcript is not None else Transcript(IPA.transcript_label)
        t.append_point(commitment, "C")
        t.append_scalar(point % R, "input point")
        t.append_scalar(proof.y, "output point")
        w = t.digest("w", True)
        xs = _replay_rounds(t, proof)
        coeffs = _fold_coeffs(xs)
        prod_all, cl, cr = _round_chain_coeffs(xs)
        combined_b = sum(bi * ci % R for bi, ci in zip(b, coeffs)) % R
        # c_0 = C + (w y) q; the check  sum tip coeffs_i g_i
        #   + w (tip b' - prod_all y) q - prod_all C - sum cl_i L_i
        #   - sum cr_i R_i == 0
        sc = [proof.tip * ci % R for ci in coeffs]
        sc += [w * ((proof.tip * combined_b - prod_all * proof.y) % R) % R, (-prod_all) % R]
        sc += [(-x) % R for x in cl] + [(-x) % R for x in cr]
        extra = [params.q_host, commitment] + list(proof.l) + list(proof.r)
        return _msm_is_zero(params, len(coeffs), extra, sc)

    @staticmethod
    def prove_batch(params, commitment, indexes, data):
        """todo!() in the reference (``ipa/mod.rs:156-163``); use prove_multiproof."""
        raise NotImplementedError("prove_batch is todo!() in the reference; use prove_multiproof")

    @staticmethod
    def verify_batch(params, commitment, proof):
        raise NotImplementedError("verify_batch is todo!() in the reference; use verify_multiproof")

    @staticmethod
    def prove_commitment(params: IPAParams, commitment, data: FrVector) -> IPACommitProof:
        """Proof that ``commitment`` opens to data[:max] (``ipa/mod.rs:199-236``).
        A watermark that is not a power of two is zero-padded to the next
        one (COMPAT quirk 10): the commitment is unchanged and the proof
        verifies against g[..2^k], where the reference's fold drops the tail
        element of each odd half."""
        m = data.max
        n2 = 1 << (m - 1).bit_length() if m > 1 else 1
        a = torch.nn.functional.pad(data.vals[:m], (0, 0, 0, n2 - m))
        t = Transcript(IPA.transcript_label)
        t.append_point(commitment, "C")
        t.digest("x", True)  # state <- fr(x0) || "x"; x0 itself is unused
        if n2 == 1:
            return IPACommitProof(l=[], r=[], tip=F.mont_to_ints(a, "fr")[0])
        l_pts, r_pts, tip = _halving_loop(params.g_affine[:n2], a, None, None, t)
        return IPACommitProof(l=l_pts, r=r_pts, tip=tip)

    @staticmethod
    def verify_commitment_proof(params: IPAParams, commitment, proof: IPACommitProof) -> bool:
        """``ipa/mod.rs:238-265`` as one MSM over {g_i, C, L_i, R_i}."""
        t = Transcript(IPA.transcript_label)
        t.append_point(commitment, "C")
        t.digest("x", True)
        xs = _replay_rounds(t, proof)
        coeffs = _fold_coeffs(xs)
        prod_all, cl, cr = _round_chain_coeffs(xs)
        sc = [proof.tip * ci % R for ci in coeffs] + [(-prod_all) % R]
        sc += [(-x) % R for x in cl] + [(-x) % R for x in cr]
        extra = [commitment] + list(proof.l) + list(proof.r)
        return _msm_is_zero(params, len(coeffs), extra, sc)


def _halving_loop(basis, a, b, w, t: Transcript):
    """The halving rounds over the fixed ``basis`` (g, plus q as its last
    point when ``b`` is given, with ``w`` the inner-product challenge),
    challenges drawn from ``t``. Each round is one K1IPA launch, which folds
    the previous challenge into a, b and the weights and builds the two
    MSMs' scalars (``cuda_ipa.halving_round``); one more launch folds the
    last challenge. Returns the L and R points and the tip."""
    n = a.shape[0]
    assert n & (n - 1) == 0, "the halving loop needs a power-of-two length"
    wts, x, half, ln = None, None, 0, n
    l_pts, r_pts = [], []
    while ln > 1:
        a, b, wts, sc = KI.halving_round(a, b, wts, x, w, half, ln)
        y_l = M.msm_auto(basis, sc[0])
        y_r = M.msm_auto(basis, sc[1])
        p_l, p_r = C.projective_to_host_points(torch.stack([y_l, y_r]))
        l_pts.append(p_l)
        r_pts.append(p_r)
        t.append_point(p_l, "L")
        t.append_point(p_r, "R")
        x = t.digest("x", True)
        half = ln = ln // 2
    a = KI.halving_round(a, None, None, x, None, half, 0)[0]
    return l_pts, r_pts, F.mont_to_ints(a[:1], "fr")[0]


def _replay_rounds(t: Transcript, proof) -> list:
    xs = []
    for li, ri in zip(proof.l, proof.r):
        t.append_point(li, "L")
        t.append_point(ri, "R")
        xs.append(t.digest("x", True))
    return xs


def _fold_coeffs(xs: list) -> list:
    """Coefficient of each g_i in the fully folded generator."""
    coeffs = [1]
    for x in xs:
        coeffs = [v for c in coeffs for v in (c * x % R, c)]
    return coeffs


def _round_chain_coeffs(xs: list):
    """c_final = prod_all c_0 + sum cl_i L_i + sum cr_i R_i for the
    verifier's chain c_{i+1} = L_i + x_i c_i + x_i^2 R_i (``ipa.py:593-604``)."""
    k = len(xs)
    suffix = [1] * (k + 1)
    for i in range(k - 1, -1, -1):
        suffix[i] = suffix[i + 1] * xs[i] % R
    cl = [suffix[i + 1] for i in range(k)]
    cr = [xs[i] * xs[i] % R * suffix[i + 1] % R for i in range(k)]
    return suffix[0], cl, cr


def _msm_is_zero(params: IPAParams, ng: int, extra_pts: list, scalars: list) -> bool:
    """One MSM over g[:ng] || extra_pts, checked against the identity."""
    pts = torch.cat([params.g_affine[:ng], C.host_points_to_affine(extra_pts, params.device)])
    out = M.msm_auto(pts, F.ints_to_words(scalars, params.device))
    return C.projective_to_host_points(out)[0] is None
