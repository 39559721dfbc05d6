"""Evaluation-form data vector (``verkle_kzg_tpu/poly/lagrange.py``).

``vals`` is an ``(N, 8)`` int32 tensor of Montgomery words on one device,
zero-padded past the ``max`` watermark. ``evaluate`` keeps the reference's
three paths and their boundaries (COMPAT quirks 2 and 3). The in-domain
quotient is kernel K1QUO (:func:`quotient_in_domain`, one launch for rows at
once or their sum, the multiproof's g); its plain versions are
:func:`_quotient_in_domain` (the JAX package's per-row form) and
:func:`_quotient_in_domain_table` (the kernel's table form). The
out-of-domain one is :func:`_quotient_out_domain`, and ``interpolate`` goes
to coefficient form through the Fr INTT.
"""

from __future__ import annotations

import dataclasses

import torch

from ..hostmath.serialize import fr_from_le_bytes_mod_order
from ..params import R
from ..utils.metrics import span

from ..ops import cuda_field as KF
from ..ops import cuda_lib
from ..ops import cuda_multiproof as KM
from ..ops import field as F
from ..ops.ntt import intt_fr
from .domain import Domain


def _k1(op: str, a, b):
    """K1's plain version (``ops/cuda_field.py::plain``) on Fr words, on any
    device: the plain quotients run on the card's tensors as on the CPU's."""
    return KF.plain(op, a, b, "fr")


def _sum_rows(x, dim: int):
    """The halving tree of reduced K1 adds of ``F.sum_axis`` over ``dim``
    (not the word axis), kept with size 1, on K1's plain version."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        folded = _k1("add", x[:half], x[half : 2 * half])
        x = torch.cat([folded, x[2 * half :]]) if x.shape[0] % 2 else folded
    return x.movedim(0, dim)


def _quotient_in_domain(vals, invdiff_rows, ratio_rows, index):
    """q = (f - f[z]) / (X - w^z) on the domain, with the q[z] correction
    term of ``lagrange_basis.rs:91-119`` (``poly/lagrange.py::_quotient_in_domain``),
    for a batch of rows at once: vals, invdiff_rows (1 / (w^i - w^z), zero
    at i = z) and ratio_rows (A'(w^z) / A'(w^i)) are (Zq, N, 8) Montgomery
    words, index the (Zq,) int64 domain indices z. K1QUO's plain version of
    the per-row mode, on K1's plain version."""
    rows = torch.arange(vals.shape[0], device=vals.device)
    f_z = vals[rows, index][:, None]  # (Zq, 1, 8)
    q = _k1("mul", _k1("sub", vals, f_z), invdiff_rows)  # zero at i = z
    # q[z] = sum_i -(f_i - f_z) * ratio_i * invdiff_i
    terms = _k1("mul", q, ratio_rows)
    corr = _sum_rows(_k1("sub", torch.zeros_like(terms), terms), 1)  # (Zq, 1, 8)
    at_z = torch.arange(vals.shape[1], device=vals.device)[None, :] == index[:, None]
    return torch.where(at_z[..., None], corr, q)


def _quotient_in_domain_table(vals, index, omegas, table, sum_rows: bool = False):
    """K1QUO's plain version: :func:`_quotient_in_domain` fed from the
    domain's tables, as the kernel reads them: 1 / (w^i - w^z) =
    w^-z T[(i - z) mod N] (``Domain.invdiff_table``) and A'(w^z) / A'(w^i) =
    w^(i - z), since A'(w^i) = N w^-i. vals (Zq, N, 8), index (Zq,) int64
    on vals' device; with ``sum_rows`` the rows' field sum (N, 8)."""
    n = vals.shape[1]
    k = (torch.arange(n, device=vals.device)[None, :] - index[:, None]) % n  # (Zq, N)
    invdiff = _k1("mul", omegas[(-index) % n][:, None], table[k])
    q = _quotient_in_domain(vals, invdiff, omegas[k], index)
    return _sum_rows(q, 0)[0] if sum_rows else q


def quotient_in_domain(vals, zs, domain: Domain, sum_rows: bool = False):
    """Kernel K1QUO: the in-domain quotients of rows vals (Zq, N, 8) at
    their domain indices ``zs`` (Zq ints), (Zq, N, 8), or with ``sum_rows``
    their field sum (N, 8). One launch, no inversion; CPU tensors take
    :func:`_quotient_in_domain_table`."""
    dev = vals.device
    omegas, table = domain.d_omegas(dev), domain.d_invdiff_table(dev)
    if dev.type == "cpu":
        return _quotient_in_domain_table(vals, torch.tensor(list(zs), dtype=torch.int64), omegas, table, sum_rows)
    return KM.quotient(vals, zs, omegas, table, sum_rows)


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

    @span("protocol", "poly.to_ints")
    def to_ints(self) -> list:
        return F.mont_to_ints(self.vals, "fr")

    def to_scalars_standard(self) -> torch.Tensor:
        """(N, 8) standard-form words for MSM consumption (K1)."""
        return F.from_mont(self.vals, "fr")

    def get(self, index: int) -> int:
        return F.mont_to_ints(self.vals[index : index + 1], "fr")[0]

    @span("protocol", "poly.evaluate")
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
        """In-domain quotient at domain index ``index`` (``lagrange_basis.rs:91-119``):
        one K1QUO launch."""
        q = quotient_in_domain(self.vals[None], [index], self.domain)[0]
        return FrVector(q, self.domain.size, self.domain)

    @span("protocol", "poly.quotient_outside")
    def divide_by_vanishing_outside(self, point: int) -> "FrVector":
        """Out-of-domain quotient at ``point`` (``lagrange_basis.rs:121-142``):
        one batched inversion of (w^i - z), one K1INV launch."""
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
