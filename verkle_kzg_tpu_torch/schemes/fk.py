"""Feist-Khovratovich amortized KZG all-points prover, over the Fr and G1
NTTs of ``ops/ntt.py`` (``verkle_kzg_tpu/schemes/fk.py``).

The reference (``vector-commit/src/kzg/mod.rs:200-235``) builds the
circulant product but returns its raw output as the proofs, without the
final domain-sized FFT that turns the coefficients of h into the proofs
h(w^i); its own test (``kzg/mod.rs:299-308``) lacks ``#[test]`` and never
runs. Like the JAX package, this follows the full FK pipeline (a documented
fix, SURVEY.md §5):

  1. c = INTT(evals), the coefficients of f;
  2. a = G1-NTT(lagrange SRS), the monomial SRS [s^i G] (setup made
     lagrange = ifft(monomial), so the inverse map is the forward NTT);
  3. h_j = sum_d c_{j+1+d} a_d as one length-2N circular convolution:
     three NTTs (Fr, G1, G1 inverse) and a pointwise scalar multiplication;
  4. the proofs pi_i = h(w^i), one final G1 NTT;
  5. pi_i opens f at w^i to y_i = evals_i, as ``KZG.verify`` checks.

The convolution runs at the full domain size N, whatever the data's length.
"""

from __future__ import annotations

import functools

import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops.ntt import intt_fr, intt_g1, ntt_fr, ntt_g1
from ..poly import FrVector
from ..utils.metrics import span
from .kzg import KZGParams, KZGProof


@span("protocol", "fk.prove_all_points")
def prove_all_points(params: KZGParams, data: FrVector, mesh=None) -> list:
    """The N proofs of ``data`` at every domain point, on ``params.device``.
    With ``mesh``, every transform (Fr and G1, at N and 2N) is the four-step
    across its ranks (``parallel/ntt.py``), which needs the mesh size to
    divide both factors of N and of 2N; the pointwise product stays local."""
    n = params.size
    assert data.domain.size == n
    dev = params.device
    if mesh is not None:
        from ..parallel import ntt as P

        ntt_fr_, intt_fr_, ntt_g1_, intt_g1_ = (
            functools.partial(f, mesh=mesh)
            for f in (P.ntt_fr_sharded, P.intt_fr_sharded, P.ntt_g1_sharded, P.intt_g1_sharded)
        )
    else:
        ntt_fr_, intt_fr_, ntt_g1_, intt_g1_ = ntt_fr, intt_fr, ntt_g1, intt_g1

    c = intt_fr_(data.vals)  # (N, 8) Montgomery coefficients of f
    mono = ntt_g1_(C.from_affine(params.lagrange_affine))  # [s^i G], (N, 3, 8)

    # circulant Toeplitz product at size 2N:
    #   c_hat = [c_0 .. c_{N-1}, 0 x N]
    #   s_hat = [a_{N-2}, ..., a_0, 0 x (N + 1)]   (a_i = s^i G)
    #   r = INTT_G1(NTT_G1(s_hat) .* NTT_Fr(c_hat)), h_j = r_{N-1+j}
    c_hat = torch.cat([c, torch.zeros_like(c)])
    s_hat = torch.cat([mono[: n - 1].flip(0), C.infinity((n + 1,), dev)])
    y_f = ntt_fr_(c_hat)
    v_g = ntt_g1_(s_hat)
    r = intt_g1_(C.scalar_mul(v_g, F.from_mont(y_f, "fr")))
    h = torch.cat([r[n - 1 : 2 * n - 2], C.infinity((1,), dev)])

    pis = C.projective_to_host_points(ntt_g1_(h))
    return [KZGProof(proof=pi, y=y) for pi, y in zip(pis, data.to_ints())]
