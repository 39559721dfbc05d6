"""Evaluation-form data vector (``verkle_kzg_tpu/poly/lagrange.py``).

``vals`` is an ``(N, 8)`` int32 tensor of Montgomery words on one device,
zero-padded past the ``max`` watermark. ``evaluate`` keeps the reference's
three paths and their boundaries (COMPAT quirks 2 and 3). The in-domain
quotient is :func:`_quotient_in_domain`, batched over its leading axis for
the multiproof; the out-of-domain one is :func:`_quotient_out_domain`, and
``interpolate`` goes to coefficient form through the Fr INTT.
"""

from __future__ import annotations

import dataclasses

import torch

from ..hostmath.serialize import fr_from_le_bytes_mod_order
from ..params import R

from ..ops import cuda_lib
from ..ops import field as F
from ..ops.ntt import intt_fr
from .domain import Domain


def _quotient_in_domain(vals, invdiff_rows, ratio_rows, index):
    """q = (f - f[z]) / (X - w^z) on the domain, with the q[z] correction
    term of ``lagrange_basis.rs:91-119`` (``poly/lagrange.py::_quotient_in_domain``),
    for a batch of rows at once: vals, invdiff_rows (1 / (w^i - w^z), zero
    at i = z) and ratio_rows (A'(w^z) / A'(w^i)) are (Zq, N, 8) Montgomery
    words, index the (Zq,) int64 domain indices z."""
    rows = torch.arange(vals.shape[0], device=vals.device)
    f_z = vals[rows, index][:, None]  # (Zq, 1, 8)
    q = F.mont_mul(F.sub(vals, f_z, "fr"), invdiff_rows, "fr")  # zero at i = z
    # q[z] = sum_i -(f_i - f_z) * ratio_i * invdiff_i
    corr = F.sum_lanes(F.neg(F.mont_mul(q, ratio_rows, "fr"), "fr"), "fr")  # (Zq, 1, 8)
    at_z = torch.arange(vals.shape[1], device=vals.device)[None, :] == index[:, None]
    return torch.where(at_z[..., None], corr, q)


def _quotient_out_domain(vals, eval_mont, inv_terms):
    """q_i = (f_i - f(z)) / (w^i - z) (``lagrange_basis.rs:121-142``):
    (N, 8) values, the (1, 8) Montgomery evaluation f(z) and the (N, 8)
    Montgomery inverses 1 / (w^i - z)."""
    return F.mont_mul(F.sub(vals, eval_mont, "fr"), inv_terms, "fr")


@dataclasses.dataclass
class FrVector:
    vals: torch.Tensor
    max: int
    domain: Domain

    @staticmethod
    def from_ints(data, domain: Domain | None = None, device=None) -> "FrVector":
        """On the CUDA card unless ``device`` says otherwise."""
        data = [d % R for d in data]
        if domain is None:
            domain = Domain(len(data))
        assert len(data) <= domain.size
        padded = data + [0] * (domain.size - len(data))
        return FrVector(F.ints_to_mont(padded, "fr", cuda_lib.resolve_device(device)), len(data), domain)

    @staticmethod
    def zero(domain: Domain, device=None) -> "FrVector":
        vals = torch.zeros((domain.size, F.WORDS), dtype=torch.int32, device=cuda_lib.resolve_device(device))
        return FrVector(vals, domain.size, domain)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to_ints(self) -> list:
        return F.mont_to_ints(self.vals, "fr")

    def to_scalars_standard(self) -> torch.Tensor:
        """(N, 8) standard-form words for MSM consumption (K1)."""
        return F.from_mont(self.vals, "fr")

    def get(self, index: int) -> int:
        return F.mont_to_ints(self.vals[index : index + 1], "fr")[0]

    def evaluate(self, point: int) -> int:
        """Stored / zero inside the domain / barycentric, with the
        reference's boundaries (``lagrange_basis.rs:59-72``)."""
        if point <= self.max - 1:
            return self.get(point)
        if point <= self.domain.size:
            return 0
        return self.evaluate_outside_domain(point)

    def evaluate_outside_domain(self, point: int) -> int:
        b = self.domain.barycentric_coefficients(point)
        return sum(v * c % R for v, c in zip(self.to_ints(), b)) % R

    def divide_by_vanishing(self, index: int) -> "FrVector":
        """In-domain quotient at domain index ``index`` (``lagrange_basis.rs:91-119``)."""
        dev = self.device
        z = torch.tensor([index], device=dev)
        dom = self.domain
        ratio = F.mont_mul(dom.d_vanishing(dev)[z], dom.d_vanishing_inv(dev), "fr")[None]
        q = _quotient_in_domain(self.vals[None], dom.invdiff_rows(z), ratio, z)[0]
        return FrVector(q, dom.size, dom)

    def divide_by_vanishing_outside(self, point: int) -> "FrVector":
        """Out-of-domain quotient at ``point`` (``lagrange_basis.rs:121-142``):
        one batched inversion of (w^i - z) through K1."""
        dev = self.device
        ev = F.ints_to_mont([self.evaluate(point)], "fr", dev)
        diff = F.sub(self.domain.d_omegas(dev), F.ints_to_mont([point], "fr", dev), "fr")
        q = _quotient_out_domain(self.vals, ev, F.batch_inv_mont(diff, "fr"))
        return FrVector(q, self.domain.size, self.domain)

    def __add__(self, other: "FrVector") -> "FrVector":
        assert self.domain is other.domain
        return FrVector(F.add(self.vals, other.vals, "fr"), max(self.max, other.max), self.domain)

    def __sub__(self, other: "FrVector") -> "FrVector":
        assert self.domain is other.domain
        return FrVector(F.sub(self.vals, other.vals, "fr"), max(self.max, other.max), self.domain)

    def scale(self, k: int) -> "FrVector":
        k_mont = F.ints_to_mont([k], "fr", self.device)
        return FrVector(F.mont_mul(self.vals, k_mont, "fr"), self.max, self.domain)

    def set_evaluation(self, index: int, value: int) -> "FrVector":
        """Returns the updated vector; ``self`` is left as it was."""
        vals = self.vals.clone()
        vals[index] = F.ints_to_mont([value], "fr", self.device)[0]
        return FrVector(vals, self.max, self.domain)

    def inner_product_ints(self, other_ints: list) -> int:
        return sum(v * o % R for v, o in zip(self.to_ints(), other_ints)) % R

    def get_all(self) -> list:
        """All (index, value) pairs (``lib.rs:46``)."""
        return list(enumerate(self.to_ints()))

    @staticmethod
    def bytes_to_item(raw: bytes) -> int:
        """Fr::from_le_bytes_mod_order (``lagrange_basis.rs:175-178``)."""
        return fr_from_le_bytes_mod_order(raw)

    def interpolate(self) -> list:
        """Coefficient form through the Fr INTT (``lagrange_basis.rs:146-148``;
        FK needs it)."""
        return F.mont_to_ints(intt_fr(self.vals), "fr")
