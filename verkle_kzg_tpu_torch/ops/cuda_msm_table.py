"""Kernel FBMSM: a single MSM over a basis whose fixed-base table is held on
the device (``csrc/msm_table.cu``), and its plain version.

For rows i of the basis (the IPA's g_0..g_(N-1), then q), windows
w < W = 256 / c and multiples m in [1, 2^(c-1)], a :class:`Table` holds
T[i][w][m - 1] = m 2^(c w) P_i as affine Montgomery words
(``ops/msm.py::build_table`` builds it on the device). The MSM of standard
scalars k_j over rows r_j is then one signed table point a (point,
window) digit, summed: sum_(j, w) sign(d_jw) T[r_j][w][|d_jw| - 1], with
the balanced signed digits of the sorted accumulation's carry rule
(``cuda_msm_sorted.carry_digits``), digit 0 and the (0, 0) sentinel adding
nothing. No sort, no bucket, no window sum and no Horner: the doublings
were paid once, when the table was built.

It replaces no TPU kernel: the JAX package runs these MSMs as a
variable-base bucket method (K3 + K4 here, whose tail is a dependent chain
of about a millisecond a call). See the source's note for the schedule and
what bounds it: GROUP_THREADS threads a point operation, PER_GROUP entries
a group accumulated by the lazy mixed add from the identity, a tree over
the GROUPS groups of a block, and in the last block to finish the same
tree over the blocks' partials, reduced once. The plain version below adds
in that order, so kernel and plain version agree word for word; against
K3 + K4 only the group element is compared.

One call counts one FBMSM launch in ``cuda_lib.launches`` (a CUDA launch
and a memset of the last-block counter).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.metrics import span
from . import cuda_lib
from . import cuda_msm_sorted as KS
from . import curve as C
from . import field as F

#: The table's window width, the one width the kernel is built for
#: (``csrc/msm_table.cu``'s C): of the widths whose digits lie in one scalar
#: word (``cuda_msm.IN_KERNEL_C``), c = 16's table is absurd (8.6 GB at 257
#: rows) and c = 1, 2 add 4-8x c = 8's entries. On an NVIDIA H100 80GB HBM3
#: at 700 W a call at 257 / 256 points took 0.0586 / 0.0557 ms by CUDA events
#: at c = 8 and 0.0670 / 0.0650 at c = 4 (PERF.md section 6): c = 8 adds half
#: the entries (8,224 against 16,448 at 257 points) in half the blocks, so
#: its last block sums fewer partials. Its table is 67.4 MB (c = 4: 8.4 MB).
#: The plain version takes any c that divides 32, so CPU tests can build
#: cheap c = 4 tables.
TABLE_C = 8
GROUP_THREADS = 8  # threads a point operation
GROUPS = 32  # groups a block
PER_GROUP = 4  # (scalar, window) entries a group accumulates


@dataclasses.dataclass(frozen=True)
class Table:
    """The fixed-base table of a basis: ``points`` (rows, W, 2^(c-1), 2, 8)
    affine Montgomery words, row i window w multiple m at [i, w, m - 1]."""

    points: torch.Tensor
    c: int

    def rows(self, prefix: int, extra: int | None = None) -> "TableRows":
        """The basis of a call: rows 0..prefix-1, then row ``extra``."""
        if not 0 <= prefix <= self.points.shape[0] or (extra is not None and not 0 <= extra < self.points.shape[0]):
            raise ValueError(f"table rows: prefix {prefix}, extra {extra} of {self.points.shape[0]} rows")
        return TableRows(self, prefix, extra)


@dataclasses.dataclass(frozen=True)
class TableRows:
    """A call's basis as rows of a :class:`Table`, standing for the basis'
    points wherever ``msm_auto`` takes them: scalar j takes row j below
    ``prefix`` and row ``extra`` at j = prefix."""

    table: Table
    prefix: int
    extra: int | None = None

    @property
    def count(self) -> int:
        return self.prefix + (self.extra is not None)


def windows(c: int) -> int:
    return 256 // c


def segments(c: int) -> int:
    """Groups a scalar: its windows in runs of PER_GROUP."""
    return windows(c) // PER_GROUP


def blocks(n: int, c: int) -> int:
    """Blocks of a call over n scalars."""
    return math.ceil(n * segments(c) / GROUPS)


def check_c(c: int) -> None:
    """A table width the plain version takes: c divides 32, so each digit
    lies in one scalar word (and W = 256 / c splits into runs of PER_GROUP)."""
    if c < 1 or 32 % c:
        raise ValueError(f"a fixed-base table takes c dividing 32, got {c}")


def _rows_of(rows: TableRows, device) -> torch.Tensor:
    idx = torch.arange(rows.count, device=device)
    if rows.extra is not None:
        idx[rows.prefix] = rows.extra
    return idx


def _tree(acc: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The block tree on (blocks, GROUPS, 3, 16) lazy limbs, ``count`` (blocks,)
    groups holding a sum in each: at level h, group g with g % 2h = 0 adds
    group g + h where g + h < count. -> (blocks, 3, 16), group 0."""
    h = 1
    while h < GROUPS:
        left = torch.arange(0, GROUPS, 2 * h, device=acc.device)
        bi, li = (left[None, :] + h < count[:, None]).nonzero(as_tuple=True)
        if bi.numel():
            lo = left[li]
            acc[bi, lo] = C.add16(acc[bi, lo], acc[bi, lo + h], lazy=True)
        h *= 2
    return acc[:, 0]


def plain_msm(rows: TableRows, scalars: torch.Tensor) -> torch.Tensor:
    """FBMSM's plain version, any device: (n, 8) standard scalars over the
    rows of a table -> (3, 8) reduced projective, in the kernel's order."""
    table, c = rows.table.points, rows.table.c
    check_c(c)
    dev = scalars.device
    n, segs = scalars.shape[0], segments(c)
    if n == 0:
        return C.infinity((), dev)
    ng, nb = n * segs, blocks(n, c)
    digits = KS.carry_digits(scalars, c).reshape(ng, PER_GROUP)  # group gi = j segs + s: windows s PER_GROUP..
    row = _rows_of(rows, dev).repeat_interleave(segs)
    w0 = torch.arange(ng, device=dev) % segs * PER_GROUP
    acc = C.infinity16((nb * GROUPS,), dev)
    for e in range(PER_GROUP):
        d = digits[:, e]
        pts = table[row, w0 + e, (d.abs() - 1).clamp(min=0)]  # (ng, 2, 8), a copy
        neg_y = F.sub16(torch.zeros_like(F.to_limbs(pts[:, 1])), F.to_limbs(pts[:, 1]), "fq")
        pts[:, 1] = torch.where((d < 0)[:, None], F.from_limbs(neg_y), pts[:, 1])
        pts[d == 0] = 0  # the (0, 0) sentinel: the mixed add keeps the accumulator
        acc[:ng] = C.mixed_add16(acc[:ng], F.to_limbs(pts), lazy=True)
    acc = acc.reshape(nb, GROUPS, 3, F.LIMBS)
    part = _tree(acc, ng - torch.arange(nb, device=dev) * GROUPS)
    if nb > 1:  # the last block: group g sums partials g, g + GROUPS, ...
        fin = C.infinity16((GROUPS,), dev)
        m = min(nb, GROUPS)
        fin[:m] = part[:m]
        for r in range(1, math.ceil(nb / GROUPS)):
            idx = torch.arange(GROUPS, device=dev) + r * GROUPS
            take = idx < nb
            fin[take] = C.add16(fin[take], part[idx[take]], lazy=True)
        part = _tree(fin[None], torch.tensor([m], device=dev))
    return F.from_limbs(C.reduce16(part[0]))


@span("kernels", "FBMSM")
def msm(rows: TableRows, scalars: torch.Tensor) -> torch.Tensor:
    """Kernel FBMSM: (n, 8) standard scalars over the basis ``rows`` (n of
    them) -> (3, 8) reduced projective, one launch. CPU tensors take the
    plain version, at any width; a CUDA tensor the kernel, whose table has
    to be at TABLE_C, or an error."""
    table = rows.table
    if scalars.shape != (rows.count, F.WORDS):
        raise ValueError(f"table msm: {tuple(scalars.shape)} scalars for a basis of {rows.count} rows")
    if scalars.device.type == "cpu" and table.points.device.type == "cpu":
        return plain_msm(rows, scalars)
    if table.c != TABLE_C:
        raise ValueError(f"table msm: the kernel is built for c = {TABLE_C}, the table has c = {table.c}")
    if rows.count == 0:
        return C.infinity((), scalars.device)
    scalars = scalars.contiguous()
    cuda_lib.require_cuda("msm_table.msm", table.points, scalars)
    n = rows.count
    nb = blocks(n, table.c)
    work = torch.empty(4 + 24 * nb, dtype=torch.int32, device=scalars.device)
    out = torch.empty((3, F.WORDS), dtype=torch.int32, device=scalars.device)
    extra = -1 if rows.extra is None else rows.extra
    err = cuda_lib.lib().vkzg_msm_table(table.points.data_ptr(), scalars.data_ptr(), n, rows.prefix, extra,
                                        table.c, nb, work.data_ptr(), out.data_ptr(), cuda_lib.stream(scalars))
    cuda_lib.check(err, "vkzg_msm_table")
    cuda_lib.launches["FBMSM"] += 1
    return out
