"""IPA (inner-product argument) vector commitment in evaluation form
(``verkle_kzg_tpu/schemes/ipa.py``), on PyTorch tensors.

The data vector, the barycentric b vector and the CRS live on one device;
every group operation is a single MSM (``ops/msm.py``): the commit's and
the prove's over the CRS run kernel FBMSM on the parameters' fixed-base
table (:meth:`IPAParams.basis`, built on a card at the first call), the
verify's a Pippenger MSM. The prove's vector math is kernel K1IPA
(``ops/cuda_ipa.py``): one launch for <a, b>, one a halving round, one for
the last fold. Proofs, transcript bytes and commitments are bit-identical
to the JAX package's.

Prove runs in coefficient space, as the JAX fused loop does
(``_fused_ipa_loop``): per ORIGINAL basis index i the accumulated challenge
weight W(i) (the product of the past challenges x_k for the rounds in
which i sat in the left half), so the folded generator at slot j is
sum_{i mod len == j} W(i) g_i, and both cross terms are one MSM each over
the FIXED basis g || q:

    y_l = <g_r, a_l> + (w <a_l, b_r>) q = MSM(g || q, gamma_l || w ip_l)

with gamma_l(i) = W(i) a[(i mod len) - half] for i in the right half of
its block and 0 elsewhere (y_r mirrored). Folding the generators in point
space instead would cost a 256-bit scalar multiplication and an inversion
per round.

The loop is device-resident (:func:`_low_level_ipa`), as in JAX: the host
uploads the transcript state once; each round's challenge is drawn on the
device by kernel FSX (``ops/cuda_fiat_shamir.py``: the points' affine form
and compression, SHA-256, hash-to-field), which also writes the round's L
and R into the proof buffer; the host reads the finished proof once and
replays the digest chain so that the caller's ``Transcript`` ends in the
device's state. :func:`_low_level_ipa_hostloop`, the loop sequenced on the
host with every digest in ``Transcript`` (the reference's order,
``ipa/mod.rs:268-319``), is the independent second implementation that
the tests hold it to. On the CPU both run the kernels' plain versions.

The reference's direction quirks hold: the generators fold as
g <- g_r + x g_l, and an in-domain point is the integer index (one-hot b).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..fiatshamir.transcript import Transcript
from ..params import R

from ..ops import cuda_fiat_shamir as FSX
from ..ops import cuda_ipa as KI
from ..ops import cuda_lib
from ..ops import cuda_msm_table as KT
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..ops import sha256 as S
from ..poly import Domain, FrVector
from ..utils.metrics import span, wait_for
from .generators import DEFAULT_IPA_SEED, ipa_generate_points


@dataclasses.dataclass
class IPAParams:
    """N basis points g, the inner-product point q, the domain, and the
    device the CRS tensors live on (``ipa/mod.rs:22-68``): the CUDA card
    unless ``device`` says otherwise. The parameters also own ``table``, the
    fixed-base table of g || q (``ops/msm.py::build_table``, q in row N),
    whose rows stand for the basis in the commit's and the prove's MSMs
    (:meth:`basis`). On a card it is built at the first :meth:`basis`, where
    it lands in set-up; on the CPU it stays None unless a caller sets one (of
    any width the plain version takes)."""

    n: int
    g_host: list
    q_host: tuple
    domain: Domain
    device: torch.device | str | None = None
    table: KT.Table | None = dataclasses.field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = cuda_lib.resolve_device(self.device)

    def basis(self, n: int, q: bool = False):
        """The basis g[:n], then q when ``q``, as ``msm_auto`` takes it: the
        table's rows where there is a table, else the affine points."""
        if self.table is None and self.device.type == "cuda":
            self.table = M.build_table(torch.cat([self.g_affine, self.q_affine]))
        if self.table is not None:
            return self.table.rows(n, self.n if q else None)
        return torch.cat([self.g_affine[:n], self.q_affine]) if q else self.g_affine[:n]

    @functools.cached_property
    def g_affine(self) -> torch.Tensor:
        return C.host_points_to_affine(self.g_host, self.device)

    @functools.cached_property
    def g_proj(self) -> torch.Tensor:
        """(N, 3, 8) projective basis."""
        return C.from_affine(self.g_affine)

    @functools.cached_property
    def q_proj(self) -> torch.Tensor:
        """(1, 3, 8) projective q."""
        return C.host_point_to_projective(self.q_host, self.device)

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
    @span("protocol", "ipa.commit")
    def commit(params: IPAParams, data: FrVector, mesh=None):
        """C = <g, a>: one MSM (``ipa/mod.rs:130-135``); with ``mesh``, the
        points and scalars split across its ranks (``parallel.msm_sharded``)."""
        scalars = data.to_scalars_standard()
        if mesh is not None:
            from ..parallel.mesh import msm_sharded

            out = msm_sharded(params.g_affine, scalars, mesh)
        else:
            out = M.msm_auto(params.basis(params.n), scalars)
        return C.projective_to_host_points(out)[0]

    @staticmethod
    def prove(params: IPAParams, commitment, index: int, data: FrVector) -> IPAProof:
        return IPA.prove_point(params, commitment, index, data, None)

    @staticmethod
    @span("protocol", "ipa.prove")
    def prove_point(params: IPAParams, commitment, point: int, data: FrVector, transcript=None) -> IPAProof:
        b = F.ints_to_mont(params.domain.barycentric_coefficients(point), "fr", data.vals.device)
        return _low_level_ipa(params, data.vals, b, commitment, point, transcript)

    @staticmethod
    def verify(params: IPAParams, commitment, index: int, proof: IPAProof) -> bool:
        return IPA.verify_point(params, commitment, index, proof, None)

    @staticmethod
    @span("protocol", "ipa.verify")
    def verify_point(params: IPAParams, commitment, point: int, proof: IPAProof, transcript=None) -> bool:
        """``ipa/mod.rs:321-360`` as ONE MSM over {g_i, q, C, L_i, R_i}
        checked against the identity: every challenge replays from the
        proof's L/R points, so the whole check needs no other group work."""
        b = params.domain.barycentric_coefficients(point)
        t = transcript if transcript is not None else Transcript(IPA.transcript_label)
        t.append_point(commitment, "C")
        t.append_scalar(point % R, "input point")
        t.append_scalar(proof.y, "output point")
        w = t.digest("w", True)
        xs = _replay_rounds(t, proof.l, proof.r)
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
        return _commitment_proof(params, commitment, data)

    @staticmethod
    def verify_commitment_proof(params: IPAParams, commitment, proof: IPACommitProof) -> bool:
        """``ipa/mod.rs:238-265`` as one MSM over {g_i, C, L_i, R_i}."""
        t = Transcript(IPA.transcript_label)
        t.append_point(commitment, "C")
        t.digest("x", True)
        xs = _replay_rounds(t, proof.l, proof.r)
        coeffs = _fold_coeffs(xs)
        prod_all, cl, cr = _round_chain_coeffs(xs)
        sc = [proof.tip * ci % R for ci in coeffs] + [(-prod_all) % R]
        sc += [(-x) % R for x in cl] + [(-x) % R for x in cr]
        extra = [commitment] + list(proof.l) + list(proof.r)
        return _msm_is_zero(params, len(coeffs), extra, sc)


def _state_to_device(t: Transcript, device) -> torch.Tensor:
    """The transcript's state as (len,) uint8 on ``device``: the device
    loop's one upload."""
    return S.const_bytes(bytes(t._state), device)


def _read_back(*parts: torch.Tensor) -> torch.Tensor:
    """The device loop's one device -> host read: the parts' (..., 8) words
    in one (rows, 8) host tensor."""
    return wait_for("ipa.read_back", torch.cat([p.reshape(-1, F.WORDS) for p in parts]).cpu)


@span("protocol", "ipa.rounds")
def _device_rounds(basis, a, b, w, state, dst: bytes) -> tuple:
    """The halving rounds with every challenge drawn on the device: per
    round one K1IPA launch (the fold of the previous challenge, the two
    MSMs' scalars), the two MSMs over the fixed ``basis``
    (:meth:`IPAParams.basis`: g, plus q as its last point when ``b`` is
    given, ``w`` the inner-product challenge's Montgomery words), then one
    FSX launch that draws the challenge from ``state`` (the transcript state, (len,) uint8) and writes the round's
    affine pair into the proof buffer; one more K1IPA launch folds the last
    challenge. Nothing is read back and the host does not wait: every size
    and every length is known to it. -> (pairs (rounds, 2, 2, 8) Montgomery
    affine, tip (1, 8) Montgomery), on the device."""
    n = a.shape[0]
    assert n & (n - 1) == 0, "the halving loop needs a power-of-two length"
    pairs = torch.empty((n.bit_length() - 1, 2, 2, F.WORDS), dtype=torch.int32, device=a.device)
    wts, x, half, ln = None, None, 0, n
    for k in range(pairs.shape[0]):
        a, b, wts, sc = KI.halving_round(a, b, wts, x, w, half, ln)
        y_l = M.msm_auto(basis, sc[0])
        y_r = M.msm_auto(basis, sc[1])
        xs, state = FSX.challenge(state, dst, [b"L", y_l, b"R", y_r], b"x", pairs, k)
        x = xs[1]
        half = ln = ln // 2
    a = KI.halving_round(a, None, None, x, None, half, 0)[0]
    return pairs, a[:1]


@span("protocol", "ipa.unpack")
def _unpack_fused(t: Transcript, pairs, tip) -> tuple:
    """The device loop's proof, already on the host, as host values; then
    the digest chain replayed through ``t``, so that the caller's transcript
    ends in the state the device's chain reached (the multiproof's later
    digests read it). -> (L points, R points, tip)."""
    l_pts, r_pts = [], []
    for pair in pairs:
        p_l, p_r = C.affine_to_host_points(pair)
        l_pts.append(p_l)
        r_pts.append(p_r)
    _replay_rounds(t, l_pts, r_pts)
    return l_pts, r_pts, F.mont_to_ints(tip, "fr")[0]


def _low_level_ipa(params: IPAParams, a, b, commitment, input_point: int, transcript) -> IPAProof:
    """The prove (``ipa/mod.rs:268-319``) as the device loop: the host
    appends the public inputs and uploads the transcript state once; the
    inner product (K1IPA), the challenge w (FSX) and every round
    (:func:`_device_rounds`) follow on the device with no host sync; then
    ONE device -> host read of the L/R pairs, the tip and y, and the host
    replays the digests over them. On the CPU the same sequence runs the
    kernels' plain versions."""
    n = a.shape[0]
    t = transcript if transcript is not None else Transcript(IPA.transcript_label)
    t.append_point(commitment, "C")
    t.append_scalar(input_point % R, "input point")
    y = KI.inner(a, b)
    if n == 1:
        y_int = F.mont_to_ints(y, "fr")[0]
        t.append_scalar(y_int, "output point")
        t.digest("w", True)
        return IPAProof(l=[], r=[], tip=F.mont_to_ints(a, "fr")[0], y=y_int)
    state = _state_to_device(t, a.device)
    w, state = FSX.challenge(state, t._dst, [b"output point", y], b"w")
    pairs, tip = _device_rounds(params.basis(n, q=True), a, b, w[1], state, t._dst)
    host = _read_back(pairs, tip, y)
    y_int = F.mont_to_ints(host[-1:], "fr")[0]
    t.append_scalar(y_int, "output point")
    t.digest("w", True)
    l_pts, r_pts, tip_int = _unpack_fused(t, host[:-2].reshape(-1, 2, 2, F.WORDS), host[-2:-1])
    return IPAProof(l=l_pts, r=r_pts, tip=tip_int, y=y_int)


def _low_level_ipa_hostloop(params: IPAParams, a, b, commitment, input_point: int, transcript) -> IPAProof:
    """The prove sequenced on the host, the independent second
    implementation that the tests hold the device loop to: y and each
    round's L and R are read back, every challenge is drawn by the host
    ``Transcript`` (hashlib) and copied to the card for the next K1IPA
    launch."""
    n = a.shape[0]
    t = transcript if transcript is not None else Transcript(IPA.transcript_label)
    t.append_point(commitment, "C")
    t.append_scalar(input_point % R, "input point")
    y = F.mont_to_ints(KI.inner(a, b), "fr")[0]
    t.append_scalar(y, "output point")
    w = t.digest("w", True)
    if n == 1:
        return IPAProof(l=[], r=[], tip=F.mont_to_ints(a, "fr")[0], y=y)
    l_pts, r_pts, tip = _halving_loop(params.basis(n, q=True), a, b, w, t)
    return IPAProof(l=l_pts, r=r_pts, tip=tip, y=y)


def _commitment_proof(params: IPAParams, commitment, data: FrVector, hostloop: bool = False) -> IPACommitProof:
    """:meth:`IPA.prove_commitment` on the device loop, or on the host loop
    when ``hostloop`` (the second implementation, for the tests)."""
    m = data.max
    n2 = 1 << (m - 1).bit_length() if m > 1 else 1
    a = torch.nn.functional.pad(data.vals[:m], (0, 0, 0, n2 - m))
    t = Transcript(IPA.transcript_label)
    t.append_point(commitment, "C")
    t.digest("x", True)  # state <- fr(x0) || "x"; x0 itself is unused
    if n2 == 1:
        return IPACommitProof(l=[], r=[], tip=F.mont_to_ints(a, "fr")[0])
    basis = params.basis(n2)
    if hostloop:
        return IPACommitProof(*_halving_loop(basis, a, None, None, t))
    pairs, tip = _device_rounds(basis, a, None, None, _state_to_device(t, a.device), t._dst)
    host = _read_back(pairs, tip)
    return IPACommitProof(*_unpack_fused(t, host[:-1].reshape(-1, 2, 2, F.WORDS), host[-1:]))


def _halving_loop(basis, a, b, w, t: Transcript):
    """The host loop's rounds over the fixed ``basis`` (:meth:`IPAParams.basis`:
    g, plus q as its last point when ``b`` is given, with ``w`` the
    inner-product challenge, an int), challenges drawn from ``t``: per round
    one K1IPA launch, the two MSMs, a read of L and R, their digest on the host, and the
    challenge's copy to the card; one more launch folds the last
    challenge. Returns the L and R points and the tip."""
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


def _replay_rounds(t: Transcript, l_pts: list, r_pts: list) -> list:
    """The rounds' challenges drawn again from ``t`` over their L and R."""
    xs = []
    for li, ri in zip(l_pts, r_pts):
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
