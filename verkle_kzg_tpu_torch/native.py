"""ctypes bridge to the native host runtime (native/vkzg.cpp).

The reference is 100%-native Rust; this module is our native host layer:
fast CPU MSM/scalar-mul/CRS oracles used for setup and for validating device
kernels at sizes where python bigints are impractical. Falls back cleanly
to the pure-python hostmath oracle when the .so hasn't been built
(`make -C native`), so the framework never hard-requires the toolchain.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

_REPO = pathlib.Path(__file__).resolve().parents[1]
_SO = _REPO / "native" / "libvkzg.so"

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _SO.exists():
        try:  # best-effort build; stays pure-python on failure
            subprocess.run(
                ["make", "-C", str(_REPO / "native")],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    lib.vkzg_g1_msm_naive.restype = None
    lib.vkzg_g1_msm_pippenger.restype = None
    lib.vkzg_g1_scalar_mul_batch.restype = None
    lib.vkzg_ipa_crs.restype = ctypes.c_uint64
    lib.vkzg_kzg_srs.restype = None
    lib.vkzg_multi_pairing.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


# -- byte helpers (host affine points <-> packed LE buffers) -----------------


def _pack_points(points) -> bytes:
    out = bytearray()
    for p in points:
        if p is None:
            out += bytes(64)
        else:
            out += int(p[0]).to_bytes(32, "little") + int(p[1]).to_bytes(32, "little")
    return bytes(out)


def _pack_scalars(scalars) -> bytes:
    return b"".join(int(s).to_bytes(32, "little") for s in scalars)


def _unpack_points(buf: bytes, n: int) -> list:
    out = []
    for i in range(n):
        x = int.from_bytes(buf[64 * i : 64 * i + 32], "little")
        y = int.from_bytes(buf[64 * i + 32 : 64 * i + 64], "little")
        out.append(None if (x == 0 and y == 0) else (x, y))
    return out


# -- public API ----------------------------------------------------------------


def g1_msm(points, scalars, c: int = 12):
    """Pippenger MSM -> host affine point (None = infinity)."""
    lib = _load()
    if lib is None:
        from .hostmath.curve import g1_msm_naive

        return g1_msm_naive(points, scalars)
    n = len(points)
    out = ctypes.create_string_buffer(64)
    lib.vkzg_g1_msm_pippenger(
        _pack_points(points), _pack_scalars(scalars), n, ctypes.c_uint(c), out
    )
    return _unpack_points(out.raw, 1)[0]


def g1_msm_serial(points, scalars):
    """The reference's MSM primitive, measured honestly: a naive SERIAL
    fold of one full double-and-add scalar-mul + add per point
    (``vector-commit/src/utils.rs:16-19``) in optimized C++ (u64x4
    Montgomery, Jacobian). This is the baseline line for BASELINE.md."""
    lib = _load()
    if lib is None:
        from .hostmath.curve import g1_msm_naive

        return g1_msm_naive(points, scalars)
    n = len(points)
    out = ctypes.create_string_buffer(64)
    lib.vkzg_g1_msm_naive(_pack_points(points), _pack_scalars(scalars), n, out)
    return _unpack_points(out.raw, 1)[0]


def g1_scalar_mul_batch(points, scalars) -> list:
    lib = _load()
    if lib is None:
        from .hostmath.curve import g1_mul

        return [g1_mul(p, k) for p, k in zip(points, scalars)]
    n = len(points)
    out = ctypes.create_string_buffer(64 * n)
    lib.vkzg_g1_scalar_mul_batch(_pack_points(points), _pack_scalars(scalars), n, out)
    return _unpack_points(out.raw, n)


def ipa_crs(seed: bytes, num: int) -> list:
    """Hash-to-curve CRS, bit-compatible with IPAPointGenerator::gen."""
    lib = _load()
    if lib is None:
        from .hostmath.hashing import eth_try_and_increment

        return eth_try_and_increment(seed, num)
    out = ctypes.create_string_buffer(64 * num)
    lib.vkzg_ipa_crs(seed, len(seed), num, out)
    return _unpack_points(out.raw, num)


def multi_pairing(pairs):
    """Product of BN254 pairings with one shared final exponentiation,
    bit-identical to ``hostmath.pairing.multi_pairing`` (the arkworks
    ``Pairing::multi_pairing`` analog used by KZG verify,
    ``vector-commit/src/kzg/mod.rs:182-186``). ``pairs`` is a list of
    (g1_affine, g2_affine) with None = infinity; g2 points are (Fq2, Fq2)
    tuples. Returns the 12 standard-form Fq coefficients (c0.c0.c0,
    c0.c0.c1, ..., c1.c2.c1) as ints, or None if the .so is unavailable."""
    lib = _load()
    if lib is None:
        return None
    g1b = bytearray()
    g2b = bytearray()
    for p, q in pairs:
        g1b += bytes(64) if p is None else (
            int(p[0]).to_bytes(32, "little") + int(p[1]).to_bytes(32, "little")
        )
        if q is None:
            g2b += bytes(128)
        else:
            x, y = q
            for v in (x.c0, x.c1, y.c0, y.c1):
                g2b += int(v).to_bytes(32, "little")
    out = ctypes.create_string_buffer(384)
    lib.vkzg_multi_pairing(bytes(g1b), bytes(g2b), len(pairs), out)
    return [int.from_bytes(out.raw[32 * i : 32 * i + 32], "little") for i in range(12)]


def kzg_monomial_srs(g, secret: int, num: int) -> list:
    """[s^i * G] (KZGRandomPointGenerator::gen semantics)."""
    lib = _load()
    if lib is None:
        from .hostmath.curve import g1_mul
        from .params import R

        powers, cur = [], 1
        for _ in range(num):
            powers.append(cur)
            cur = cur * secret % R
        return [g1_mul(g, p) for p in powers]
    out = ctypes.create_string_buffer(64 * num)
    lib.vkzg_kzg_srs(
        _pack_points([g]), int(secret).to_bytes(32, "little"), num, out
    )
    return _unpack_points(out.raw, num)
