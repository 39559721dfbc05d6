"""Radix-2 evaluation domain over Fr (``verkle_kzg_tpu/poly/domain.py``).

The host keeps python-int mirrors (the IPA needs just the barycentric
coefficients of one point at a time, KZG's verify one domain element); the
device mirrors are Montgomery ``(N, 8)`` word tensors, made once per device
on first use. The in-domain quotients (K1QUO) read ``omegas`` and
``invdiff_table``; ``invdiff_rows`` is the JAX package's per-row form.
"""

from __future__ import annotations

import functools

import torch

from ..hostmath.field import fr_batch_inverse, fr_inv
from ..params import R, fr_root_of_unity

from ..ops import field as F


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


@functools.lru_cache(maxsize=None)
class Domain:
    """Evaluation domain of ``size`` rounded up to a power of two."""

    def __init__(self, size: int):
        self.size = _next_pow2(size)
        n = self.size
        self.omega = fr_root_of_unity(n)
        self.size_inv = fr_inv(n)
        self.omegas = [1] * n
        for i in range(1, n):
            self.omegas[i] = self.omegas[i - 1] * self.omega % R
        # A'(w^i) = N / w^i and inverses (``precompute.rs:46-58``)
        self.vanishing = [n * fr_inv(w) % R for w in self.omegas]
        self.vanishing_inv = fr_batch_inverse(self.vanishing)
        self._mirrors: dict = {}

    def d_omegas(self, device) -> torch.Tensor:
        return self._mirror("omegas", device)

    def d_vanishing(self, device) -> torch.Tensor:
        return self._mirror("vanishing", device)

    def d_vanishing_inv(self, device) -> torch.Tensor:
        return self._mirror("vanishing_inv", device)

    @functools.cached_property
    def invdiff_table(self) -> list:
        """T[k] = 1 / (w^k - 1), T[0] = 0, so that 1 / (w^i - w^z) =
        w^-z T[(i - z) mod N]: the in-domain quotient's inverses from one
        table and the omegas, made on the host at first use."""
        return [0] + (fr_batch_inverse([(w - 1) % R for w in self.omegas[1:]]) if self.size > 1 else [])

    def d_invdiff_table(self, device) -> torch.Tensor:
        return self._mirror("invdiff_table", device)

    def invdiff_rows(self, z_sel: torch.Tensor) -> torch.Tensor:
        """(Zq,) domain indices (an int64 tensor on the target device) ->
        (Zq, N, 8) Montgomery rows InvDiff[k, i] = 1 / (w^i - w^z_k), zero
        where i == z_k (``poly/domain.py::invdiff_rows``): one broadcast
        subtract and one batched inversion per row, for the selected
        indices only."""
        omegas = self.d_omegas(z_sel.device)
        diff = F.sub(omegas[None], omegas[z_sel][:, None], "fr")
        return F.batch_inv_mont(diff, "fr")

    def _mirror(self, name: str, device) -> torch.Tensor:
        key = (name, torch.device(device))
        if key not in self._mirrors:
            self._mirrors[key] = F.ints_to_mont(getattr(self, name), "fr", device)
        return self._mirrors[key]

    def element(self, index: int) -> int:
        """w^index (``lagrange_basis.rs:86-88``)."""
        return self.omegas[index % self.size]

    def barycentric_coefficients(self, point: int) -> list:
        """The b vector: one-hot inside the integer-index domain (the
        reference's ``point < size`` shortcut, COMPAT quirk 2), else
        b_i = ((z^N - 1) / N) * w^i / (z - w^i)."""
        n = self.size
        if 0 <= point < n:
            res = [0] * n
            res[point] = 1
            return res
        t = (pow(point, n, R) - 1) * self.size_inv % R
        denoms = fr_batch_inverse([(point - w) % R for w in self.omegas])
        return [t * w % R * d % R for w, d in zip(self.omegas, denoms)]
