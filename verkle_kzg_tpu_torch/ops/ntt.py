"""Radix-2 NTT/INTT over Fr and over G1 points (``verkle_kzg_tpu/ops/ntt.py``).

The substitute for ark_poly's EvaluationDomain::{fft, ifft}: the reference
uses it for the G1 Lagrange SRS (``kzg/mod.rs:121``) and for the
Feist-Khovratovich all-points prover (``kzg/mod.rs:215-224``,
``lagrange_basis.rs:146-148``).

Decimation in time: a bit-reversal gather, then log2(N) butterfly stages
with their u/v position indices and twiddles as data (:class:`_Plan`). An
Fr stage (u + w v, u - w v) is a gather, K1 products and add/subs and a
scatter; a G1 stage is one G1BFLY launch (``cuda_g1_chain.butterfly``),
which multiplies v by the twiddle with ``curve.scalar_mul``'s chain and
takes u + v and u + (-v) in one kernel. The operations and their order are
the JAX package's, so Fr outputs and G1 projective coordinates are the
same words. The same stages transform B contiguous segments at once, each
on its own (``ntt_fr_segments``, ``ntt_g1_segments``): the sub-NTTs of the
four-step in ``parallel/ntt.py``, one pass or one G1BFLY launch a stage.

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
from . import cuda_g1_chain as G
from . import curve as C
from . import field as F


def _bitrev(n: int) -> list:
    """The bit reversal of 0..n - 1 over log2(n) bits."""
    logn = n.bit_length() - 1
    return [int(format(i, f"0{logn}b")[::-1], 2) for i in range(n)]


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
        self.bitrev = _bitrev(n)
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

    def on(self, device, field: bool, seg: int | None = None):
        """The plan on ``device`` of the n / seg transforms of size ``seg``
        (default n), one on each contiguous segment: a bit reversal within
        each segment, then the first log2(seg) stages, whose blocks never
        cross a segment and whose twiddles, w_{2^(s+1)}^j, do not depend on
        n. For the Fr butterflies (``field``) (order, [(u_idx, v_idx,
        Montgomery twiddles)]); for G1BFLY (order, [standard-form twiddles
        of stage s's first block]), since butterfly j of every block takes
        w_j."""
        seg = seg or self.n
        key = (torch.device(device), field, seg)
        if key not in self._mirrors:
            idx = functools.partial(torch.tensor, dtype=torch.int64, device=device)
            stages = self.stages[: seg.bit_length() - 1]
            if field:
                stages = [(idx(u), idx(v), F.ints_to_mont(tw, "fr", device)) for u, v, tw in stages]
            else:
                stages = [F.ints_to_words(tw[: 1 << s], device) for s, (_, _, tw) in enumerate(stages)]
            order = [s + i for s in range(0, self.n, seg) for i in _bitrev(seg)]
            self._mirrors[key] = (idx(order), stages)
        return self._mirrors[key]


def ntt_fr_segments(x_mont: torch.Tensor, seg: int, inverse: bool = False) -> torch.Tensor:
    """(B seg, 8) Montgomery words, B contiguous segments of ``seg``
    elements -> each segment's size-seg NTT (INTT with its 1/seg), the
    butterflies of all B segments in one pass a stage: (u + w v, u - w v)
    over Fr (``ntt.py::_fr_stage``), a gather, K1 products and add/subs and
    a scatter. B = 1 is the whole vector's transform; B > 1 the four-step's
    sub-NTTs (``parallel/ntt.py``)."""
    bitrev, stages = _Plan(x_mont.shape[0], inverse).on(x_mont.device, True, seg)
    x = x_mont[bitrev]
    for u_idx, v_idx, tw in stages:
        u, v = x[u_idx], F.mont_mul(x[v_idx], tw, "fr")
        x = torch.empty_like(x)
        x[u_idx] = F.add(u, v, "fr")
        x[v_idx] = F.sub(u, v, "fr")
    if not inverse:
        return x
    return F.mont_mul(x, F.ints_to_mont([fr_inv(seg)], "fr", x.device), "fr")


def ntt_g1_segments(pts_proj: torch.Tensor, seg: int, inverse: bool = False) -> torch.Tensor:
    """(B seg, 3, 8) projective points in B contiguous segments -> each
    segment's size-seg G1 NTT (INTT with its 1/seg, one G1SMUL): one
    G1BFLY launch a stage over all B segments (``ntt.py::_g1_stage``)."""
    n = pts_proj.shape[0]
    bitrev, twiddles = _Plan(n, inverse).on(pts_proj.device, False, seg)
    x = pts_proj[bitrev]
    for s, tw in enumerate(twiddles):
        x = G.butterfly(x, tw, s)
    if not inverse:
        return x
    return C.scalar_mul(x, F.ints_to_words([fr_inv(seg)], x.device).expand(n, F.WORDS))


def ntt_fr(x_mont: torch.Tensor) -> torch.Tensor:
    """(N, 8) coefficients -> evaluations [p(w^i)] (ark fft semantics)."""
    return ntt_fr_segments(x_mont, x_mont.shape[0])


def intt_fr(x_mont: torch.Tensor) -> torch.Tensor:
    """(N, 8) evaluations -> coefficients (ark ifft semantics, 1/N folded in)."""
    return ntt_fr_segments(x_mont, x_mont.shape[0], inverse=True)


def ntt_g1(pts_proj: torch.Tensor) -> torch.Tensor:
    """(N, 3, 8) projective points -> the G1 NTT."""
    return ntt_g1_segments(pts_proj, pts_proj.shape[0])


def intt_g1(pts_proj: torch.Tensor) -> torch.Tensor:
    """(N, 3, 8) projective points -> the G1 inverse NTT, 1/N folded in."""
    return ntt_g1_segments(pts_proj, pts_proj.shape[0], inverse=True)
