"""Kernel FSX: one Fiat-Shamir challenge of the IPA prove drawn on the card
in one launch, and the device SHA-256 behind ``ops/sha256.py``.

FSX replaces no Pallas kernel. Its JAX counterpart is jnp code inside the
fused halving loop (``verkle_kzg_tpu/schemes/ipa.py:236-252``: ``to_affine``
of the round's pair, ``sha256.g1_compressed_bytes``, ``hash_to_fr``,
``to_mont``), which XLA compiles into the loop's one device program. Run
eagerly as torch ops, one challenge would be thousands of launches (a
digest is five SHA-256 compressions of 64 dependent rounds); run on the
host, as the host loop (``schemes/ipa.py::_low_level_ipa_hostloop``) does,
it costs a device->host read of each round's points, their affine
conversion in Python, and the challenge's copy back.

What bounds it on the card is its dependent chain, not bytes or
multiplies: one inversion over Fq (K1INV's, ``csrc/field_inv.cuh``: 18
rounds of 31 register steps), then five compressions of 64
rounds each, all serial. The design is one block of one warp. Lane 0
converts the message's points to affine with ONE inversion (Montgomery's
trick over their Z: two lanes inverting a point each would run their
divergent loops one after the other) and compresses them; for each
64-byte block the lanes read the block's bytes from the message's segments
(the state in device memory, labels passed by value, the serialized
elements) and lane 0 runs the compression. The message is never copied
into one buffer, so a transcript state of any length streams through.
Inversion, products and the reduction are ``bn254_field.cuh``'s; every
value is reduced, so the words are unique and kernel, plain version and
``hostmath`` agree byte for byte.

A launch writes the challenge in standard and Montgomery form (the
Montgomery words are what K1IPA reads for the next fold), the
transcript's new state fr_to_bytes(x) || label, and, for a halving round,
the two affine points into the proof buffer at the round's slot, so the
prove reads the proof back once at the end.

The plain versions below are what the wrappers run for CPU tensors: the
same message through ``ops/sha256.py``'s plain functions, the points
through ``curve.to_affine`` (K1INV's and K1's plain versions). For a CUDA
tensor the wrappers launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.metrics import span
from . import cuda_lib
from . import curve as C
from . import field as F
from . import sha256 as S

MAX_SEGS = 8
MAX_POINTS = 4
POOL = 320
_SEG_BYTES, _SEG_CONST, _SEG_FR, _SEG_POINT = range(4)
_MODE_DIGEST, _MODE_EXPAND, _MODE_FIELD = range(3)


class _Seg(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int32), ("len", ctypes.c_int32), ("off", ctypes.c_int32),
                ("pad", ctypes.c_int32), ("ptr", ctypes.c_void_p)]


class _Args(ctypes.Structure):
    """``csrc/fiat_shamir.cu``'s Args, field for field."""

    _fields_ = [("seg", _Seg * MAX_SEGS), ("nseg", ctypes.c_int32), ("mode", ctypes.c_int32),
                ("out_len", ctypes.c_int32), ("dst_off", ctypes.c_int32), ("dst_len", ctypes.c_int32),
                ("label_off", ctypes.c_int32), ("label_len", ctypes.c_int32), ("slot", ctypes.c_int32),
                ("pool", ctypes.c_uint8 * POOL)]


def _is_point(p: torch.Tensor) -> bool:
    return p.shape[-2:] == (3, F.WORDS)


def _check_parts(parts) -> None:
    for p in parts:
        if not isinstance(p, bytes) and not _is_point(p) and p.numel() != F.WORDS:
            raise ValueError(f"fiat-shamir: a part is bytes, 8 Fr words or a (3, 8) point, got {tuple(p.shape)}")


def plain_challenge(state: torch.Tensor, dst: bytes, parts, label: bytes, pairs=None, slot: int = 0):
    """FSX's plain version; see :func:`challenge` for the arguments."""
    _check_parts(parts)
    dev = state.device
    pieces, points = [state], [p.reshape(3, F.WORDS) for p in parts if isinstance(p, torch.Tensor) and _is_point(p)]
    comp = None
    if points:
        aff = C.to_affine(torch.stack(points))
        comp = iter(S.plain_g1_compressed_bytes(aff))
        if pairs is not None:
            pairs[slot] = aff
    for p in parts:
        if isinstance(p, bytes):
            pieces.append(S.const_bytes(p, dev))
        elif _is_point(p):
            pieces.append(next(comp))
        else:
            pieces.append(S.fr_to_bytes(F.from_mont(p.reshape(F.WORDS), "fr")))
    tag = S.const_bytes(label, dev)
    x = S.plain_hash_to_fr(torch.cat(pieces + [tag]), dst)
    return torch.stack([x, F.to_mont(x, "fr")]), torch.cat([S.fr_to_bytes(x), tag])


def _args(mode: int, msg: torch.Tensor, parts, dst: bytes, out_len: int, label: bytes, slot: int) -> tuple:
    """The launch's Args: the message segments (``msg`` first, then each
    part, then ``label``), the DST and the label in the constant pool."""
    _check_parts(parts)
    a = _Args()
    pool = bytearray()
    keep = [msg]

    def seg(kind, length=0, off=0, ptr=None):
        if a.nseg == MAX_SEGS:
            raise ValueError(f"fiat-shamir: at most {MAX_SEGS} message segments")
        a.seg[a.nseg] = _Seg(kind, length, off, 0, ptr)
        a.nseg += 1

    def const(raw: bytes) -> int:
        off = len(pool)
        pool.extend(raw)
        return off

    if msg.numel():
        seg(_SEG_BYTES, msg.numel(), 0, msg.data_ptr())
    points = 0
    for p in list(parts) + ([label] if label else []):
        if isinstance(p, bytes):
            seg(_SEG_CONST, len(p), const(p))
            continue
        p = p.contiguous()
        cuda_lib.require_cuda("fiat_shamir", p)
        if p.device != msg.device:
            raise ValueError("fiat-shamir: every tensor must lie on the message's card")
        keep.append(p)
        points += _is_point(p)
        seg(_SEG_POINT if _is_point(p) else _SEG_FR, 32, 0, p.data_ptr())
    if points > MAX_POINTS:
        raise ValueError(f"fiat-shamir: at most {MAX_POINTS} points a challenge")
    a.dst_off, a.dst_len = const(dst), len(dst)
    a.label_off, a.label_len = const(label), len(label)
    if len(dst) > 255 or len(pool) > POOL:
        raise ValueError(f"fiat-shamir: a DST of at most 255 bytes, and labels and DST of {POOL} in all")
    ctypes.memmove(a.pool, bytes(pool), len(pool))
    a.mode, a.out_len, a.slot = mode, out_len, slot
    return a, points, keep


def _launch(a: _Args, msg: torch.Tensor, out_bytes=None, x_out=None, state_out=None, pairs=None) -> None:
    ptr = [None if t is None else t.data_ptr() for t in (out_bytes, x_out, state_out, pairs)]
    err = cuda_lib.lib().vkzg_fsx(ctypes.byref(a), *ptr, cuda_lib.stream(msg))
    cuda_lib.check(err, "vkzg_fsx")
    cuda_lib.launches["FSX"] += 1


def _check_msg(msg: torch.Tensor, name: str) -> torch.Tensor:
    if msg.dim() != 1 or msg.dtype != torch.uint8 or msg.device.type != "cuda":
        raise ValueError(f"{name}: the message must be a 1-D uint8 tensor on a CUDA device")
    return msg.contiguous()


@span("kernels", "FSX")
def challenge(state: torch.Tensor, dst: bytes, parts, label: bytes, pairs=None, slot: int = 0):
    """Kernel FSX: one Fiat-Shamir challenge, hash_to_fr(state || parts ||
    label, dst), and the transcript's new state.

    ``state``: the (len,) uint8 transcript state; ``parts``: host ``bytes``
    (labels), Fr elements (8 Montgomery words, serialized as their standard
    form) and projective G1 points ((3, 8) words, compressed), in order;
    ``label``: the digest's label, appended to the message and kept after
    the challenge in the new state. With ``pairs`` ((K, P, 2, 8) int32) the
    affine words of the P points are written to ``pairs[slot]``.

    Returns ((2, 8) words: the challenge in standard form, then in
    Montgomery form; the (32 + len(label),) uint8 new state). One launch,
    no host sync: every length is known to the host."""
    if state.device.type == "cpu":
        return plain_challenge(state, dst, parts, label, pairs, slot)
    state = _check_msg(state, "fiat_shamir.challenge")
    a, points, keep = _args(_MODE_FIELD, state, parts, dst, S.FR_HASH_LEN, label, slot)
    if pairs is not None:
        if pairs.dim() != 4 or pairs.shape[1:] != (points, 2, F.WORDS) or not 0 <= slot < pairs.shape[0]:
            raise ValueError(f"fiat_shamir.challenge: pairs must be (K, {points}, 2, 8) with slot < K")
        cuda_lib.require_cuda("fiat_shamir.challenge", pairs)
    x = torch.empty((2, F.WORDS), dtype=torch.int32, device=state.device)
    new_state = torch.empty(32 + len(label), dtype=torch.uint8, device=state.device)
    _launch(a, state, x_out=x, state_out=new_state, pairs=pairs)
    return x, new_state


@span("kernels", "FSX")
def digest(msg: torch.Tensor) -> torch.Tensor:
    """FSX's digest mode: the SHA-256 of (n,) uint8 bytes on a card -> (32,)."""
    msg = _check_msg(msg, "sha256_bytes")
    a, _, _ = _args(_MODE_DIGEST, msg, [], b"", 32, b"", 0)
    out = torch.empty(32, dtype=torch.uint8, device=msg.device)
    _launch(a, msg, out_bytes=out)
    return out


@span("kernels", "FSX")
def expand(msg: torch.Tensor, dst: bytes, len_in_bytes: int) -> torch.Tensor:
    """FSX's expand mode: RFC 9380 ``expand_message_xmd`` on a card."""
    msg = _check_msg(msg, "expand_message_xmd")
    if not 0 < len_in_bytes <= 255 * 32:
        raise S.TranscriptError("expand_message_xmd bounds exceeded")
    a, _, _ = _args(_MODE_EXPAND, msg, [], dst, len_in_bytes, b"", 0)
    out = torch.empty(len_in_bytes, dtype=torch.uint8, device=msg.device)
    _launch(a, msg, out_bytes=out)
    return out


@span("kernels", "FSX")
def compress(aff: torch.Tensor) -> torch.Tensor:
    """FSX's point compression on a card: (B, 2, 8) Montgomery affine ->
    (B, 32) uint8, a thread a point, one launch."""
    aff = aff.contiguous()
    cuda_lib.require_cuda("g1_compressed_bytes", aff)
    out = torch.empty((aff.shape[0], 32), dtype=torch.uint8, device=aff.device)
    if aff.shape[0]:
        err = cuda_lib.lib().vkzg_fsx_compress(aff.data_ptr(), out.data_ptr(), aff.shape[0], cuda_lib.stream(aff))
        cuda_lib.check(err, "vkzg_fsx_compress")
        cuda_lib.launches["FSX"] += 1
    return out
