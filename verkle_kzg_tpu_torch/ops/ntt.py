"""Radix-2 NTT/INTT over Fr and over G1 points (``verkle_kzg_tpu/ops/ntt.py``).

The substitute for ark_poly's EvaluationDomain::{fft, ifft}: the reference
uses it for the G1 Lagrange SRS (``kzg/mod.rs:121``) and for the
Feist-Khovratovich all-points prover (``kzg/mod.rs:215-224``,
``lagrange_basis.rs:146-148``).

Decimation in time: a bit-reversal gather, then log2(N) butterfly stages,
each the same gather/compute/scatter over N/2 pairs with its u/v position
indices and twiddles as data (:class:`_Plan`). Fr butterflies
(u + w v, u - w v) are K1 products and add/subs; G1 butterflies multiply v by
the twiddle with ``curve.scalar_mul`` (K11, K2 and a select per bit) and
take u + v and u + (-v) with K2 and a K1 negation. The operations and their
order are the JAX package's, so Fr outputs and G1 projective coordinates
are the same words.

Conventions match ark_poly: ``ntt_*`` maps natural-order coefficients to
natural-order evaluations [p(w^i)]; ``intt_*`` is its inverse, with the 1/N
scaling folded in. Layout: Fr vectors are ``(N, 8)`` Montgomery words, G1
vectors ``(N, 3, 8)`` projective points; the transform runs over axis 0.
"""

from __future__ import annotations

import functools

import torch

from ..hostmath.field import fr_inv
from ..params import R, fr_root_of_unity
from . import curve as C
from . import field as F


@functools.lru_cache(maxsize=None)
class _Plan:
    """The bit reversal and per-stage (u_idx, v_idx, twiddles) of a size-N
    transform as host values (``inverse`` takes w^-1 twiddles), made once
    per (n, inverse), with their device tensors made once per device."""

    def __init__(self, n: int, inverse: bool):
        assert n & (n - 1) == 0 and n > 1, "the NTT needs a power-of-two size above 1"
        self.n = n
        logn = n.bit_length() - 1
        omega = fr_root_of_unity(n)
        if inverse:
            omega = fr_inv(omega)
        self.bitrev = [int(format(i, f"0{logn}b")[::-1], 2) for i in range(n)]
        pows = [1] * n
        for i in range(1, n):
            pows[i] = pows[i - 1] * omega % R
        self.stages = []
        for s in range(logn):
            m = 1 << (s + 1)  # block size
            half = m >> 1
            u_idx, v_idx, tw = [], [], []
            for blk in range(0, n, m):
                for j in range(half):
                    u_idx.append(blk + j)
                    v_idx.append(blk + j + half)
                    tw.append(pows[(n // m) * j])
            self.stages.append((u_idx, v_idx, tw))
        self.n_inv = fr_inv(n) if inverse else None
        self._mirrors: dict = {}

    def on(self, device, field: bool):
        """(bitrev, [(u_idx, v_idx, twiddles)]) on ``device``: twiddles as
        Montgomery words for the Fr butterflies (``field``), else as
        standard scalar words for the G1 scalar multiplication."""
        key = (torch.device(device), field)
        if key not in self._mirrors:
            words = (lambda v: F.ints_to_mont(v, "fr", device)) if field else (lambda v: F.ints_to_words(v, device))
            idx = functools.partial(torch.tensor, dtype=torch.int64, device=device)
            self._mirrors[key] = (
                idx(self.bitrev),
                [(idx(u), idx(v), words(tw)) for u, v, tw in self.stages],
            )
        return self._mirrors[key]


def _run(x: torch.Tensor, plan: _Plan, butterfly, field: bool) -> torch.Tensor:
    bitrev, stages = plan.on(x.device, field)
    x = x[bitrev]
    for u_idx, v_idx, tw in stages:
        hi, lo = butterfly(x[u_idx], x[v_idx], tw)
        x = torch.empty_like(x)
        x[u_idx] = hi
        x[v_idx] = lo
    return x


def _fr_butterfly(u, v, tw):
    """(u + w v, u - w v) over Fr, Montgomery words (``ntt.py::_fr_stage``)."""
    v = F.mont_mul(v, tw, "fr")
    return F.add(u, v, "fr"), F.sub(u, v, "fr")


def _g1_butterfly(u, v, tw):
    """(u + w v, u - w v) over G1, standard-form twiddles (``ntt.py::_g1_stage``)."""
    v = C.scalar_mul(v, tw)
    return C.add(u, v), C.add(u, C.neg(v))


def ntt_fr(x_mont: torch.Tensor) -> torch.Tensor:
    """(N, 8) coefficients -> evaluations [p(w^i)] (ark fft semantics)."""
    return _run(x_mont, _Plan(x_mont.shape[0], False), _fr_butterfly, True)


def intt_fr(x_mont: torch.Tensor) -> torch.Tensor:
    """(N, 8) evaluations -> coefficients (ark ifft semantics, 1/N folded in)."""
    plan = _Plan(x_mont.shape[0], True)
    out = _run(x_mont, plan, _fr_butterfly, True)
    return F.mont_mul(out, F.ints_to_mont([plan.n_inv], "fr", out.device), "fr")


def ntt_g1(pts_proj: torch.Tensor) -> torch.Tensor:
    """(N, 3, 8) projective points -> the G1 NTT."""
    return _run(pts_proj, _Plan(pts_proj.shape[0], False), _g1_butterfly, False)


def intt_g1(pts_proj: torch.Tensor) -> torch.Tensor:
    """(N, 3, 8) projective points -> the G1 inverse NTT, 1/N folded in."""
    n = pts_proj.shape[0]
    plan = _Plan(n, True)
    out = _run(pts_proj, plan, _g1_butterfly, False)
    return C.scalar_mul(out, F.ints_to_words([plan.n_inv], out.device).expand(n, F.WORDS))
