"""Fr / Fq arithmetic on tensors of 32-bit words, in PyTorch.

The counterpart of ``verkle_kzg_tpu/ops/field.py``. A batch of field
elements is an ``int32`` tensor of shape ``(..., N, 8)``: eight
little-endian 32-bit words per element, one element per row, read as
unsigned by the CUDA kernels. Montgomery form uses R = 2^256, so the
Montgomery *integers* equal the JAX package's; only the limb split differs
(see ``convert.py`` for the bridge to the JAX (16, N) limb planes).

Two layers live here:

  * the public API on word tensors: the constructors and predicates
    (``zeros``, ``one_mont``, ``const_mont``, ``is_zero``, ``eq``,
    ``select``), element-wise ``mont_mul``, ``mont_sq``, ``add``, ``double``,
    ``sub``, ``neg``, ``to_mont``, ``from_mont``, ``inv_mont``, and across
    elements ``sum_lanes``/``sum_axis``, ``batch_inv_mont`` and
    ``powers_of_mont``. Every product and modular add/sub goes through
    kernel K1, every inversion through K1INV (``cuda_field.py``), which
    run their plain versions only for tensors on the CPU;
  * the plain arithmetic itself, on 16-bit limbs widened to ``int64``
    (``(..., 16)``). PyTorch on the CPU has no unsigned 32-bit ``+``, ``>>``
    or comparisons, and a 32x32-bit product does not fit in signed int64,
    so the plain versions of K1-K4 all compute on these limbs.

The plain Montgomery product forms the full 512-bit product and reduces
it with the whole m = T * (-p^-1) mod R at once rather than limb by limb
(CIOS). The two give the same integer: m is the unique value below R that
makes T + m*p divisible by R, so (T + m*p) / R, the lazy [0, 2p) result,
is identical, and the kernel and its plain version agree bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import FQ, FR, FieldSpec
from ..utils.metrics import span, wait_for

SPECS: dict[str, FieldSpec] = {"fq": FQ, "fr": FR}
WORDS = 8
LIMBS = 16
_M16 = 0xFFFF


# ---------------------------------------------------------------------------
# Host <-> tensor conversion (python ints, exact)
# ---------------------------------------------------------------------------


@span("orchestration", "field.ints_to_words")
def ints_to_words(xs, device) -> torch.Tensor:
    """Python ints in [0, 2^256) -> (len(xs), 8) int32 words."""
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<u4").reshape(len(xs), WORDS)
    return wait_for("field.upload", torch.from_numpy(arr.view(np.int32).copy()).to, device)


@span("orchestration", "field.words_to_ints")
def words_to_ints(t: torch.Tensor) -> list:
    """(..., 8) int32 words -> flat list of python ints (row-major)."""
    arr = np.ascontiguousarray(wait_for("field.read", t.detach().cpu).numpy()).astype("<i4")
    flat = arr.reshape(-1, WORDS).tobytes()
    return [int.from_bytes(flat[32 * i : 32 * i + 32], "little") for i in range(len(flat) // 32)]


@span("orchestration", "field.ints_to_mont")
def ints_to_mont(xs, spec: str, device) -> torch.Tensor:
    """Python ints -> (len(xs), 8) Montgomery words, computed on the host."""
    m = SPECS[spec].modulus
    return ints_to_words([(int(x) % m << 256) % m for x in xs], device)


@span("orchestration", "field.mont_to_ints")
def mont_to_ints(t: torch.Tensor, spec: str) -> list:
    fs = SPECS[spec]
    rinv = pow(1 << 256, -1, fs.modulus)
    return [v * rinv % fs.modulus for v in words_to_ints(t)]


# ---------------------------------------------------------------------------
# Word <-> 16-bit limb views used by every plain version
# ---------------------------------------------------------------------------


def to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 16) int64 limbs of 16 bits."""
    v = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([v & _M16, v >> 16], dim=-1).reshape(w.shape[:-1] + (LIMBS,))


def from_limbs(x: torch.Tensor) -> torch.Tensor:
    """(..., 16) normalized int64 limbs -> (..., 8) int32 words."""
    v = x[..., 0::2] | (x[..., 1::2] << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _int_limbs(x: int, n: int = LIMBS) -> tuple:
    return tuple((x >> (16 * i)) & _M16 for i in range(n))


@functools.lru_cache(maxsize=None)
def consts(spec: str, device: str) -> dict:
    """Per-field limb constants on ``device``: the modulus m and 2m, their
    16-bit complements (plus one in limb 0) for the carry-out compare, and
    -m^-1 mod 2^256 for the Montgomery reduction."""
    fs = SPECS[spec]
    m = fs.modulus

    def t(x):
        return torch.tensor(_int_limbs(x), dtype=torch.int64, device=device)

    def neg_plus_one(x):  # 2^256 - x as limbs: (0xFFFF ^ limb) + 1 at limb 0
        out = [_M16 ^ v for v in _int_limbs(x)]
        out[0] += 1
        return torch.tensor(out, dtype=torch.int64, device=device)

    e0 = torch.zeros(LIMBS, dtype=torch.int64, device=device)
    e0[0] = 1
    return {
        "m": t(m),
        "m2": t(2 * m),
        "neg_m": neg_plus_one(m),
        "neg_m2": neg_plus_one(2 * m),
        "nprime": t((-pow(m, -1, 1 << 256)) % (1 << 256)),
        "e0": e0,
    }


@functools.lru_cache(maxsize=None)
def _positions(n: int, device: str) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def carry(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Exact 16-bit carry propagation over the last axis of non-negative
    int64 columns below 2^bits. Carries out of the top limb are dropped.

    Carry-save passes bring every column to at most 2^16, so a column
    either generates a carry (2^16), propagates one (0xFFFF) or stops one.
    A column then carries out iff the last generator at or below it sits
    above the last stopper, which two running maxima find in a fixed
    number of tensor ops (a serial ripple would cost one op per limb,
    and the plain versions are bound by the count of tensor ops)."""
    while True:
        hi = x >> 16
        x = x & _M16  # a new tensor: the in-place shifted add below is safe
        x[..., 1:] += hi[..., :-1]
        if bits <= 17:
            break
        bits = max(bits - 16, 16) + 1
    pos = _positions(x.shape[-1], str(x.device))
    gen = torch.where(x > _M16, pos, -1).cummax(-1).values
    stop = torch.where(x < _M16, pos, -1).cummax(-1).values
    x[..., 1:] += (gen > stop)[..., :-1]
    return x & _M16


@functools.lru_cache(maxsize=None)
def _conv_index(device: str, low_only: bool):
    i = torch.arange(LIMBS, device=device)
    idx = (i[:, None] + i[None, :]).flatten()
    if not low_only:
        return idx, None
    sel = torch.nonzero(idx < LIMBS).flatten()
    return idx[sel], sel


def _conv(a: torch.Tensor, b: torch.Tensor, low_only: bool = False) -> torch.Tensor:
    """Column sums of the schoolbook product of two 16-limb operands:
    31 columns, or only the 16 low ones (the product mod 2^256)."""
    p = (a[..., :, None] * b[..., None, :]).flatten(-2)
    idx, sel = _conv_index(str(p.device), low_only)
    if sel is not None:
        p = p[..., sel]
    ncols = LIMBS if low_only else 2 * LIMBS - 1
    out = torch.zeros(p.shape[:-1] + (ncols,), dtype=torch.int64, device=p.device)
    return out.index_add_(-1, idx, p)


# ---------------------------------------------------------------------------
# Plain limb arithmetic: reduced [0, m) and lazy [0, 2m) domains
# ---------------------------------------------------------------------------


# Small batches on the CPU take the same integers through Python ints: a
# chain of one-point operations (a Horner loop, a double-and-add over a few
# lanes) is otherwise bound by the per-call cost of the ~70 tensor ops of
# one limb product. Each int formula below is the integer its limb twin
# computes (the twin's docstring), so the two paths agree bit for bit.
# SMALL is where add16's two paths cross; the int product stays the faster
# well past it (``tools/plain_field_crossover.py`` measures both).
SMALL = 256  # elements


def _small(*xs: torch.Tensor) -> bool:
    return all(x.device.type == "cpu" and x.numel() <= SMALL * LIMBS for x in xs)


def _ints(x: torch.Tensor) -> list:
    """(..., 16) normalized limbs -> python ints, row-major."""
    buf = x.numpy().astype("<u2").tobytes()
    return [int.from_bytes(buf[i : i + 32], "little") for i in range(0, len(buf), 32)]


def _limbs(vals, like: torch.Tensor) -> torch.Tensor:
    """Python ints in [0, 2^256) -> limbs shaped like ``like``."""
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return torch.from_numpy(np.frombuffer(buf, dtype="<u2").astype(np.int64)).reshape(like.shape)


@functools.lru_cache(maxsize=None)
def _nprime(spec: str) -> int:
    return (-pow(SPECS[spec].modulus, -1, 1 << 256)) % (1 << 256)


def cond_sub16(x: torch.Tensor, spec: str) -> torch.Tensor:
    """[0, 2m) -> [0, m): subtract m when the complement add x + (2^256 - m)
    carries out of the top limb."""
    if _small(x):
        m = SPECS[spec].modulus
        return _limbs([v - m if v >= m else v for v in _ints(x)], x)
    t = carry(torch.nn.functional.pad(x + consts(spec, str(x.device))["neg_m"], (0, 1)), 18)
    return torch.where(t[..., LIMBS:] > 0, t[..., :LIMBS], x)


def _pick(keep_if_carry: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Both candidates carried in one call (stacked on a new leading axis);
    the first wins when it carries out of limb 15."""
    both = carry(torch.nn.functional.pad(torch.stack([keep_if_carry, other]), (0, 1)), 19)
    return torch.where(both[0, ..., LIMBS:] > 0, both[0, ..., :LIMBS], both[1, ..., :LIMBS])


def add16(a: torch.Tensor, b: torch.Tensor, spec: str, lazy: bool = False) -> torch.Tensor:
    """a + b, minus m (2m when ``lazy``) when that carries past 2^256, i.e.
    when a + b >= m (2m)."""
    a, b = torch.broadcast_tensors(a, b)
    if _small(a):
        m = SPECS[spec].modulus << lazy
        return _limbs([s - m if s >= m else s for s in map(int.__add__, _ints(a), _ints(b))], a)
    c = consts(spec, str(a.device))
    s = a + b
    return _pick(s + (c["neg_m2"] if lazy else c["neg_m"]), s)


def sub16(a: torch.Tensor, b: torch.Tensor, spec: str, lazy: bool = False) -> torch.Tensor:
    """a - b when a + ~b + 1 carries (a >= b), else a - b + m (2m when
    ``lazy``) taken mod 2^256."""
    a, b = torch.broadcast_tensors(a, b)
    if _small(a):
        m, top = SPECS[spec].modulus << lazy, (1 << 256) - 1
        return _limbs([x - y if x >= y else (x - y + m) & top for x, y in zip(_ints(a), _ints(b))], a)
    c = consts(spec, str(a.device))
    d = a + (b ^ _M16) + c["e0"]
    return _pick(d, d + (c["m2"] if lazy else c["m"]))


@functools.lru_cache(maxsize=None)
def _toeplitz(spec: str, name: str, device: str, low_only: bool) -> torch.Tensor:
    """(16, 31) float64 matrix (16 columns when ``low_only``) with row i
    holding the constant's limbs at columns i .. i + 15: x @ it gives the
    column sums of the schoolbook product of x with the constant."""
    k = consts(spec, device)[name]
    i = torch.arange(LIMBS, device=device)
    out = torch.zeros(LIMBS, 2 * LIMBS - 1, dtype=torch.float64, device=device)
    out[i[:, None], i[:, None] + i[None, :]] = k.to(torch.float64)[None, :].expand(LIMBS, LIMBS)
    return out[:, :LIMBS] if low_only else out


def _conv_const(x: torch.Tensor, spec: str, name: str, low_only: bool = False) -> torch.Tensor:
    """:func:`_conv` of normalized limbs x with a field constant, as one
    float64 matrix product: each column is below 16 * 2^32 = 2^36, so every
    sum is exact in a double's 53-bit mantissa."""
    t = _toeplitz(spec, name, str(x.device), low_only)
    return (x.to(torch.float64) @ t).to(torch.int64)


def mont_mul16(a: torch.Tensor, b: torch.Tensor, spec: str, lazy: bool = False) -> torch.Tensor:
    """Montgomery product a*b/R = (T + m p) / R with T = a b and
    m = T (-p^-1) mod R, taken mod 2^256. Inputs in [0, 2m) give a lazy
    result in [0, 2m) (4m < R for BN254); ``lazy=False`` reduces it to
    [0, m)."""
    a, b = torch.broadcast_tensors(a, b)
    if _small(a):
        p, np_, top = SPECS[spec].modulus, _nprime(spec), (1 << 256) - 1
        out = []
        for x, y in zip(_ints(a), _ints(b)):
            t = x * y
            u = ((t + ((t & top) * np_ & top) * p) >> 256) & top
            out.append(u - p if not lazy and u >= p else u)
        return _limbs(out, a)
    t = _conv(a, b)  # 31 columns < 2^36
    low = carry(t[..., :LIMBS], 37)  # T mod R, normalized
    m = carry(_conv_const(low, spec, "nprime", low_only=True), 37)
    u = carry(torch.nn.functional.pad(t + _conv_const(m, spec, "m"), (0, 2)), 38)
    out = u[..., LIMBS : 2 * LIMBS]
    return out if lazy else cond_sub16(out, spec)


# ---------------------------------------------------------------------------
# Public element-wise API on (..., 8) int32 words
# ---------------------------------------------------------------------------


def zeros(lead=(), b: int | None = None, *, device) -> torch.Tensor:
    """(lead..., b, 8) zero words; b None gives (lead..., 8)
    (``ops/field.py::zeros``)."""
    return torch.zeros(tuple(lead) + ((b,) if b is not None else ()) + (WORDS,), dtype=torch.int32, device=device)


def one_mont(spec: str, lead=(), b: int | None = None, *, device) -> torch.Tensor:
    """The multiplicative identity in Montgomery form (R mod m), broadcast to
    (lead..., b, 8), or (lead..., 8) when b is None (``ops/field.py::one_mont``)."""
    shape = tuple(lead) + ((b,) if b is not None else ()) + (WORDS,)
    return const_words(SPECS[spec].r_mod, device).expand(shape)


def const_mont(value: int, spec: str, device) -> torch.Tensor:
    """The integer ``value`` in Montgomery form: one (8,) word vector,
    computed on the host (``ops/field.py::const_mont``)."""
    return ints_to_mont([value], spec, device)[0]


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(..., 8) -> (...) bool (``ops/field.py::is_zero``)."""
    return (a == 0).all(-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Word equality of each element: (..., 8) x (..., 8) -> (...) bool; for
    reduced elements, equality of the values (``ops/field.py::eq``)."""
    return (a == b).all(-1)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mask`` (broadcastable to a's shape less the word axis) picks whole
    elements of ``a``, else of ``b`` (``ops/field.py::select``)."""
    return torch.where(mask[..., None], a, b)


def mont_mul(a: torch.Tensor, b: torch.Tensor, spec: str) -> torch.Tensor:
    """Montgomery product of reduced operands, reduced. Kernel K1."""
    return _k1.binop("mul", a, b, spec)


def mont_sq(a: torch.Tensor, spec: str) -> torch.Tensor:
    """a * a / R (``ops/field.py::mont_sq``). Kernel K1."""
    return mont_mul(a, a, spec)


def add(a: torch.Tensor, b: torch.Tensor, spec: str) -> torch.Tensor:
    return _k1.binop("add", a, b, spec)


def double(a: torch.Tensor, spec: str) -> torch.Tensor:
    """2a mod m (``ops/field.py::double``). Kernel K1."""
    return add(a, a, spec)


def sub(a: torch.Tensor, b: torch.Tensor, spec: str) -> torch.Tensor:
    return _k1.binop("sub", a, b, spec)


def neg(a: torch.Tensor, spec: str) -> torch.Tensor:
    """-a mod m (0 stays 0: 0 - 0 + m reduces to 0)."""
    return sub(torch.zeros_like(a), a, spec)


def const_words(value: int, device) -> torch.Tensor:
    """One (8,) word vector holding ``value``."""
    return ints_to_words([value], device)[0]


def to_mont(a: torch.Tensor, spec: str) -> torch.Tensor:
    """Standard -> Montgomery: a * R^2 / R."""
    r2 = const_words(SPECS[spec].r2_mod, a.device)
    return mont_mul(a, r2.expand_as(a), spec)


def from_mont(a: torch.Tensor, spec: str) -> torch.Tensor:
    """Montgomery -> standard: a * 1 / R."""
    return mont_mul(a, const_words(1, a.device).expand_as(a), spec)


def inv_mont(a: torch.Tensor, spec: str) -> torch.Tensor:
    """Inverse of each element of (..., 8) Montgomery words, Montgomery in
    and out (``ops/field.py::inv_mont``); zero maps to zero. Kernel K1INV."""
    return _k1.inverse(a, spec, batch=False)


def sum_lanes(a: torch.Tensor, spec: str) -> torch.Tensor:
    """Modular sum over the element axis (-2): (..., N, 8) -> (..., 1, 8).

    Replaces the JAX package's ``lazy_sum_lanes``/``reduce_columns``, which
    sum 16-bit columns lazily in uint32 (bounded to 2^15 terms) and then
    reduce once. Here a halving tree of reduced adds runs through K1, so
    no column bound applies and the result is the same reduced element."""
    while a.shape[-2] > 1:
        n = a.shape[-2]
        half = n // 2
        folded = add(a[..., :half, :], a[..., half : 2 * half, :], spec)
        if n % 2:
            folded = torch.cat([folded, a[..., 2 * half :, :]], dim=-2)
        a = folded
    return a


def sum_axis(a: torch.Tensor, dim: int, spec: str) -> torch.Tensor:
    """Modular sum over a batch axis ``dim`` (not the word axis), kept with
    size 1: the exact counterpart of the JAX package's ``lazy_sum``, as the
    K1 add tree of :func:`sum_lanes`."""
    dim = dim % a.dim()
    assert dim != a.dim() - 1, "sum_axis: the word axis is not a batch axis"
    return sum_lanes(a.movedim(dim, -2), spec).movedim(-2, dim)


def batch_inv_mont(a: torch.Tensor, spec: str, axis: int = -2) -> torch.Tensor:
    """Montgomery's trick over the batch axis ``axis`` of (..., 8)
    Montgomery words, by default the element axis (-2, the JAX package's
    lane axis), each other index on its own (``ops/field.py::batch_inv_mont``);
    zero entries invert to zero (ark_ff::batch_inversion skips zeros).
    Kernel K1INV, one launch."""
    axis = axis % a.dim()
    if axis == a.dim() - 1:
        raise ValueError("batch_inv_mont: the word axis is not a batch axis")
    if axis == a.dim() - 2:
        return _k1.inverse(a, spec, batch=True)
    return _k1.inverse(a.movedim(axis, -2), spec, batch=True).movedim(-2, axis)


def powers_of_mont(x_mont: torch.Tensor, n: int, spec: str) -> torch.Tensor:
    """[1, x, ..., x^(n-1)] of one (8,) Montgomery element -> (n, 8), by
    doubling the known prefix with one K1 product per round
    (``ops/field.py::powers_of_mont``, ``utils.rs:44-55``)."""
    out = const_words(SPECS[spec].r_mod, x_mont.device)[None]
    step = x_mont[None]  # x^len(out)
    while out.shape[0] < n:
        out = torch.cat([out, mont_mul(out, step.expand_as(out), spec)])
        step = mont_mul(step, step, spec)
    return out[:n]


from . import cuda_field as _k1  # noqa: E402  (K1 and K1INV wrappers; they import this module)
