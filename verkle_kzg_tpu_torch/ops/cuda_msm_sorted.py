"""Kernels K3, K9, K8, K10, K6 and K13: every MSM bucket accumulation, as one
bucket-sorted Pippenger fed by two digit sources (``csrc/msm_sorted.cu``).

They replace six TPU kernels of ``verkle_kzg_tpu/ops/pallas_msm.py``:

  * K3: signed digits from the scalar words, c in {1, 2, 4, 8}, the launch
    at line 700 (``_accum_kernel_sc_signed_pair``; c = 8 is the default
    single MSM);
  * K9: the same at c = 16, the launch at line 719
    (``_accum_kernel_sc_signed``);
  * K8: unsigned digits from the scalar words, c in {1, 2, 4, 8, 16}, the
    launch at line 330 (``_accum_kernel_sc``);
  * K6, K10 and K13: digits from a digit tensor as the caller recoded them
    (``ops/msm.py::window_digits_signed`` or ``window_digits``), any c in
    [1, 16]. The JAX package chose among three kernels by VMEM table size:
    ``_accum_kernel_pair`` (line 853, K6) up to 128 rows a window,
    ``_accum_kernel`` (line 883, K10) above, and ``_accum_kernel_group``
    (line 807, K13) when a lane-stream caller passes ``wgroup``
    (``ops/msm_stream.py``). Here one kernel takes them all;
    :func:`launch_key` names the count a call adds to (K6 or K10 by the
    rows, K13 when the caller says so).

For each of B point streams ("lanes"), window w and row i, bucket (w, b, i)
is the sum of the lane's points whose window-w digit is +-(i + 1), y
negated for a negative digit; digit 0 and the (0, 0) sentinel add nothing.
A window has 2^(c-1) rows for balanced signed digits and 2^c - 1 for
unsigned ones (row d - 1 holds digit d; the TPU's unsigned kernel kept 2^c
rows with a trash row 0). Output (W, B, rows, 3, 8), W = ceil(256 / c),
reduced, the identity in empty rows: the layout K4 (``cuda_msm.tail``), K7
and the lane-stream functions take. From the scalar words the points are
(B S, 2, 8), lane b's at [b S, (b + 1) S). A digit tensor is any (W, B, S)
view and its points any (B, S, 2, 8) view: the kernel reads both at their
strides, so a basis every lane shares (``msm_fixed_base``) is an
``expand`` with lane stride 0, never copied per lane, and a lane stream
(S, B, ...) is read in place through its transpose.

The TPU has no scatter, so its kernels ran every step as a masked gather and
scatter of a lane's whole bucket column. Hopper scatters freely, so the
live entries are sorted by bucket and summed in registers, in four stages,
each a hand-written kernel (the source's note has the details):

  1. digits: a thread a scalar takes its raw digits from the scalar words
     and, signed, balances them with the carry rule of
     ``ops/msm.py::signed_carries`` computed in registers
     (:func:`carry_digits`), or with the caller's carry words; or a thread
     a (lane, step) reads its digits from the digit tensor. Each live
     (window, lane, step) becomes key (window, lane, |d| - 1), value the
     index of its point and sign;
  2. sort: a stable counting sort by key over tiles of points, in LSD
     passes of at most 8 bits of the row (:func:`bins`): one pass up to 256
     rows, two above; each bucket's entries then come in ascending step
     order;
  3. sums: the E entries in :func:`chunk_len` chunks, a thread a chunk, one
     lazy mixed add an entry from the identity; a run inside its chunk is a
     whole bucket, the runs at a chunk's edges are partials;
  4. combine: each spanning bucket's partials in a binary tree, then reduced.

Only the digits stage and the sort's bins depend on the source and the
width; the sums and the combine see keys. The plain version below follows
the same digits, the same stable order, the same chunks and the same tree,
so kernel and plain version agree word for word. Words differ from a
sequential bucket walk (the JAX kernels') wherever a bucket spans chunks:
only the group element is contract.

What bounds the kernels: 11 Montgomery products a live entry, 264 32-bit
multiplies each (5.8 ms at 2^20 points, c = 8, on 132 SMs x 64 a clock x
1.98 GHz); the point gathers and the sort's traffic are a few percent, and
the bucket rows' identity fill (100 MB at c = 16 unsigned) a fixed cost of
a wide window. The sums run at about 2.6x that bound on the card whatever
their occupancy, chunk count or prefetch (``tools/sorted_variants.py``);
that the product's integer instructions set the pace is a hypothesis no
profiler reading has tested.

One call counts one launch of K3, K9, K8, K10, K6 or K13 (:func:`launch_key`)
in ``cuda_lib.launches``; the C entry point counts each CUDA launch it issues
(5-7 a window group with one sort pass, 8-12 with two), which the wrapper
adds to ``cuda_lib.cuda_launches``. :func:`launch` can also return the four
stages' times, from CUDA events the call records between them. The windows
run in groups (:func:`window_groups`) above SCRATCH_BYTES of key/value
scratch or MAX_COUNTS histogram slots: the order within a bucket stays the
same, and each group's entries are cut into chunks of their own, in the
plain version alike. That bound is the accumulation's whole memory cap:
no point segments, no per-thread tables.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.metrics import span, wait_for
from . import cuda_lib
from . import cuda_msm as K
from . import curve as C
from . import field as F

SCRATCH_BYTES = 4 << 30  # the key/value scratch of one call at most: windows go in groups above it
MAX_COUNTS = 8192  # the digit kernels' shared histogram, windows x first-pass bins (msm_sorted.cu)
TARGET = 132 * 256  # chunks at most, a thread each: 256 on each of the 132 SMs
L_MIN = 2  # entries a chunk at least
STAGES = ("digits", "sort", "sums", "combine")


def windows(c: int) -> int:
    return K.windows(c)


def rows(c: int, signed: bool = True) -> int:
    return K.rows(c, signed)


def launch_key(c: int, signed: bool = True, tensor: bool = False) -> str:
    """A digit tensor: K6 up to 128 rows a window, K10 above (the TPU's
    paired and unpaired kernels, ``pallas_msm.py:834-840``); from the
    scalar words K8 unsigned, K9 signed at c = 16, else K3."""
    if tensor:
        return "K6" if rows(c, signed) <= 128 else "K10"
    if not signed:
        return "K8"
    return "K9" if c == 16 else "K3"


def _check_words(c: int) -> None:
    if c not in K.IN_KERNEL_C:
        raise ValueError(f"digits from the scalar words need c dividing 16, got {c}")


def _check_tensor(c: int) -> None:
    if not 1 <= c <= 16:
        raise ValueError(f"the digit-tensor accumulation takes c in [1, 16], got {c}")


def _stride(t: torch.Tensor, i: int) -> int:
    """Dimension i's stride, 0 for a dimension of one (it is never stepped)."""
    return 0 if t.shape[i] == 1 else t.stride(i)


def point_lanes(pts: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """(B S, 2, 8) points, or any (B, S, 2, 8) view of them, as a (B, S, 2,
    8) view the digits kernel can address: whole points at strides that are
    multiples of a point (any other view is copied)."""
    if pts.dim() == 3:
        if pts.shape[0] != b * s:
            raise ValueError(f"msm accumulate: {pts.shape[0]} points for {b} lanes of {s}")
        pts = pts.reshape(b, s, 2, 8)
    if pts.stride()[2:] != (8, 1) or _stride(pts, 0) % 16 or _stride(pts, 1) % 16:
        pts = pts.contiguous()
    return pts


def tensor_layout(pts: torch.Tensor, digits: torch.Tensor) -> tuple:
    """The digits kernel's strides for a :func:`point_lanes` view and (W, B,
    S) digits: a point's lane and step strides in points (lane 0: a basis
    every lane shares), a digit's window, lane and step strides in
    elements."""
    return _stride(pts, 0) // 16, _stride(pts, 1) // 16, _stride(digits, 0), _stride(digits, 1), _stride(digits, 2)


def bins(c: int, signed: bool = True) -> tuple:
    """The sort passes' bins: the first over the row's low 8 bits (all of
    them up to 256 rows), the second over the bits above, or 0 for none."""
    bits = (rows(c, signed) - 1).bit_length()
    return 1 << min(bits, 8), (1 << (bits - 8)) if bits > 8 else 0


def entry_bytes(c: int, signed: bool = True) -> int:
    """Scratch bytes a (window, point) entry: dense keys and values, and
    the sorted pair of each pass."""
    return 24 if bins(c, signed)[1] else 16


def window_groups(n: int, c: int, lanes: int = 1, signed: bool = True) -> list:
    """(w0, wg) runs of windows whose scratch fits SCRATCH_BYTES, whose
    first-pass histogram fits MAX_COUNTS, and whose keys (window, lane,
    row) and entry positions fit 31 bits."""
    w, nrows = windows(c), rows(c, signed)
    wg = SCRATCH_BYTES // (entry_bytes(c, signed) * max(n, 1))
    wg = max(1, min(w, wg, MAX_COUNTS // bins(c, signed)[0], (2**31 - 1) // (lanes * nrows),
                    (2**31 - 1) // max(n, 1)))
    return [(w0, min(wg, w - w0)) for w0 in range(0, w, wg)]


def chunk_len(entries: int) -> int:
    """Entries a chunk of the sums: at least L_MIN, and at most TARGET chunks."""
    return max(L_MIN, -(-entries // TARGET))


def carry_digits(sc: torch.Tensor, c: int) -> torch.Tensor:
    """The digits kernel's recoding: (n, 8) standard scalars -> (n, W) int64
    balanced digits. Window w's carry out is raw_w > 2^(c-1), or raw_w =
    2^(c-1) with a nonzero raw digit below w, none out of the top window;
    d_w = raw_w + carry in - carry out << c. Equal to
    ``scalar_digits(sc, signed_carries(sc, c), c, True)``, ties included."""
    raw = K.scalar_digits(sc, None, c, False)
    w, half = raw.shape[1], 1 << (c - 1)
    out = torch.empty_like(raw)
    cin = torch.zeros_like(raw[:, 0])
    nz = torch.zeros_like(raw[:, 0], dtype=torch.bool)
    for i in range(w):
        r = raw[:, i]
        cout = ((r > half) | ((r == half) & nz)).to(torch.int64) if i < w - 1 else torch.zeros_like(r)
        out[:, i] = r + cin - (cout << c)
        nz |= r != 0
        cin = cout
    return out


def word_digits(sc: torch.Tensor, c: int, signed: bool = True, masks=None) -> torch.Tensor:
    """The digits kernel's digits from the scalar words: (n, 8) standard
    scalars -> (n, W) int64; signed from the carry rule or the given carry
    words, unsigned the raw digits."""
    if not signed:
        return K.scalar_digits(sc, None, c, False)
    return carry_digits(sc, c) if masks is None else K.scalar_digits(sc, masks, c, True)


def _pieces(fn, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """fn(p, q) over the leading axis: in pieces of ``K._BATCH`` on the CPU,
    where the limb arithmetic is fastest near that batch, whole on a card."""
    if p.device.type != "cpu" or p.shape[0] <= K._BATCH:
        return fn(p, q)
    return torch.cat([fn(p[i : i + K._BATCH], q[i : i + K._BATCH]) for i in range(0, p.shape[0], K._BATCH)])


def _add16(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return _pieces(lambda a, b: C.add16(a, b, lazy=True), p, q)


def _mixed_add16(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return _pieces(lambda a, b: C.mixed_add16(a, b, lazy=True), p, q)


def _sums(out: torch.Tensor, pts: torch.Tensor, keys: torch.Tensor, pidx: torch.Tensor,
          neg: torch.Tensor) -> None:
    """Stages 3 and 4 on sorted entries (keys, point index, sign) into
    ``out`` (rows, 3, 8), indexed by key: the chunks walked step by step,
    vectorised over chunks, then each spanning bucket's tree."""
    e = keys.numel()
    if not e:
        return
    dev = keys.device
    length = chunk_len(e)
    nch = -(-e // length)
    aff = F.to_limbs(pts[pidx])
    neg_y = F.sub16(torch.zeros_like(aff[:, 1]), aff[:, 1], "fq")
    aff[:, 1] = torch.where(neg[:, None], neg_y, aff[:, 1])
    kpad = torch.cat([keys, keys.new_full((nch * length - e,), -1)]).reshape(nch, length)
    first = torch.arange(nch, device=dev) * length
    hi = (first + length).clamp(max=e)
    first_cont = torch.zeros(nch, dtype=torch.bool, device=dev)
    first_cont[1:] = keys[first[1:] - 1] == keys[first[1:]]
    last_open = torch.zeros(nch, dtype=torch.bool, device=dev)
    inner = hi < e
    last_open[inner] = keys[hi[inner]] == keys[hi[inner] - 1]
    acc = C.infinity16((nch,), dev)
    open_p, cont_p = acc.clone(), acc.clone()
    run_lo = first.clone()

    def finish(sel, run_key, run_hi):
        cont = sel & (run_lo == first) & first_cont
        opened = sel & ~cont & (run_hi == hi) & last_open
        whole = sel & ~cont & ~opened
        cont_p[cont] = acc[cont]
        open_p[opened] = acc[opened]
        out[run_key[whole]] = F.from_limbs(C.reduce16(acc[whole]))
        acc[sel] = C.infinity16((), dev)
        run_lo[sel] = run_hi[sel]

    for s in range(length):
        valid = first + s < hi
        if s:
            ended = valid & (kpad[:, s] != kpad[:, s - 1])
            if bool(ended.any()):
                finish(ended, kpad[:, s - 1], first + s)
        idx = valid.nonzero().flatten()
        acc[idx] = _mixed_add16(acc[idx], aff[first[idx] + s])
    finish(torch.ones(nch, dtype=torch.bool, device=dev), keys[hi - 1], hi)

    # Stage 4: leaf j of a bucket spanning chunks k0..k1 is k0's open
    # partial (j = 0) or the cont partial of k0 + j; node (h, base) =
    # node (h - 1, base) + node (h - 1, base + 2^(h-1)) where that exists.
    k0 = (last_open & ~(first_cont & (keys[first] == keys[hi - 1]))).nonzero().flatten()
    if not k0.numel():
        return
    key = keys[hi[k0] - 1]
    k1 = (torch.searchsorted(keys, key, right=True) - 1) // length
    m = k1 - k0 + 1
    top = int(m.max())
    j = torch.arange(top, device=dev)
    leaves = cont_p[(k0[:, None] + j).clamp(max=nch - 1)]
    leaves[:, 0] = open_p[k0]
    size = 1
    while size < top:
        base = torch.arange(0, top, 2 * size, device=dev)
        bi, li = (base[None, :] + size < m[:, None]).nonzero(as_tuple=True)
        left = base[li]
        leaves[bi, left] = _add16(leaves[bi, left], leaves[bi, left + size])
        size *= 2
    out[key] = F.from_limbs(C.reduce16(leaves[:, 0]))


def _plain(pts: torch.Tensor, digits: torch.Tensor, c: int, lanes: int, signed: bool) -> torch.Tensor:
    """Every source's plain version from its (W, n) int64 digits: a stable
    sort of the live (window, point) entries by key, then the chunks and
    the tree, window group by window group -> (W, B, rows, 3, 8)."""
    dev = pts.device
    n = pts.shape[0]
    w, nrows = windows(c), rows(c, signed)
    out = C.infinity((w * lanes * nrows,), dev)
    if n == 0:
        return out.reshape(w, lanes, nrows, 3, 8)
    live = (digits != 0) & ~C.affine_is_infinity(pts)[None, :]
    p = torch.arange(n, device=dev)
    for w0, wg in window_groups(n, c, lanes, signed):
        d, on = digits[w0 : w0 + wg], live[w0 : w0 + wg]  # (wg, n), (window, point) order
        seg = torch.arange(wg, device=dev)[:, None] * lanes + p // (n // lanes)
        keys, order = torch.sort((seg * nrows + d.abs() - 1)[on], stable=True)
        pidx = p.expand(wg, n)[on][order]
        _sums(out[w0 * lanes * nrows : (w0 + wg) * lanes * nrows], pts, keys, pidx, (d < 0)[on][order])
    return out.reshape(w, lanes, nrows, 3, 8)


def plain_accumulate(pts: torch.Tensor, sc: torch.Tensor, c: int = 8, lanes: int = 1,
                     masks: torch.Tensor | None = None, signed: bool = True) -> torch.Tensor:
    """The plain version of K3 / K9 (signed) and K8 (unsigned): (B S, 2, 8)
    affine x (B S, 8) standard scalars [x (B S, nwords) carry words, signed]
    -> (W, B, rows, 3, 8) reduced buckets, in the kernels' order."""
    _check_words(c)
    return _plain(pts, word_digits(sc, c, signed, masks).T, c, lanes, signed)


def plain_accumulate_digits(pts: torch.Tensor, digits: torch.Tensor, c: int, signed: bool = True) -> torch.Tensor:
    """The plain version of K6, K10 and K13: (B S, 2, 8) or (B, S, 2, 8)
    affine x (W, B, S) int32 digits (balanced signed, or unsigned in
    [0, 2^c)) -> (W, B, rows, 3, 8); lane b's entries in step order, as
    the kernel takes them whatever the views' strides."""
    _check_tensor(c)
    w, b, s = digits.shape
    flat = point_lanes(pts, b, s).reshape(b * s, 2, 8)
    return _plain(flat, digits.reshape(w, b * s).to(torch.int64), c, b, signed)


def workspace_words(n: int, c: int, lanes: int, wg: int, signed: bool = True, from_words: bool = True) -> int:
    """The int32 workspace of one window group's call."""
    words = ctypes.c_int64()
    err = cuda_lib.lib().vkzg_msm_sorted_plan(n, lanes, c, int(signed), int(from_words), wg, TARGET,
                                              ctypes.byref(words))
    cuda_lib.check(err, "vkzg_msm_sorted_plan")
    return words.value


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def launch(pts, sc, digits, masks, out, c: int, signed: bool, w0: int, wg: int, timed: bool = False) -> tuple:
    """Windows [w0, w0 + wg) into ``out`` (W, B, rows, 3, 8), with the
    digits from ``sc`` (and ``masks``) or from ``digits`` (the other None;
    ``pts`` then (B S, 2, 8) or a (B, S, 2, 8) view, read at its strides):
    -> (the CUDA launches the call issued, as the C entry point counted
    them, and, when ``timed``, {stage: ms} from events between the stages,
    else None; a timed call waits for its last stage). Counts nothing:
    :func:`accumulate` and :func:`accumulate_digits` do."""
    lanes = out.shape[1]
    layout = None
    if digits is None:
        n = pts.shape[0]
    else:
        b, s = digits.shape[1:]
        pts = point_lanes(pts, b, s)
        n, layout = b * s, (ctypes.c_int64 * 5)(*tensor_layout(pts, digits))
    words = workspace_words(n, c, lanes, wg, signed, digits is None)
    work = torch.empty(words, dtype=torch.int32, device=pts.device)
    group = out[w0 : w0 + wg]
    issued = ctypes.c_int64(0)
    ms = (ctypes.c_float * len(STAGES))() if timed else None
    err = cuda_lib.lib().vkzg_msm_sorted(
        pts.data_ptr(), _ptr(sc), _ptr(masks), _ptr(digits), group.data_ptr(), work.data_ptr(), work.numel(),
        n, lanes, c, int(signed), w0, wg, TARGET, L_MIN, layout, ctypes.addressof(ms) if timed else None,
        ctypes.addressof(issued), cuda_lib.stream(pts),
    )
    cuda_lib.check(err, "vkzg_msm_sorted")
    return issued.value, (dict(zip(STAGES, ms)) if timed else None)


def _run(pts, sc, digits, masks, c: int, lanes: int, signed: bool, key: str) -> torch.Tensor:
    """Every window group on the card, counted as one launch of ``key``."""
    out = torch.empty((windows(c), lanes, rows(c, signed), 3, 8), dtype=torch.int32, device=pts.device)
    n = pts.shape[0] if digits is None else digits.shape[1] * digits.shape[2]
    groups = window_groups(n, c, lanes, signed)
    issued = sum(launch(pts, sc, digits, masks, out, c, signed, w0, wg)[0] for w0, wg in groups)
    cuda_lib.launches[key] += 1
    cuda_lib.cuda_launches[key] += issued
    return out


def accumulate(pts: torch.Tensor, sc: torch.Tensor, c: int = 8, lanes: int = 1,
               masks: torch.Tensor | None = None, signed: bool = True) -> torch.Tensor:
    """K3 (c in {1, 2, 4, 8}) / K9 (c = 16) signed, K8 unsigned: (B S, 2, 8)
    affine x (B S, 8) standard scalars [x (B S, W // 32 + 1) carry words,
    signed only; without them the kernel computes the carries] ->
    (W, B, rows, 3, 8) reduced buckets. The plain version on the CPU; on a
    card the kernels or an error."""
    key = launch_key(c, signed)
    with span("kernels", key):
        if pts.device.type == "cpu":
            return plain_accumulate(pts, sc, c, lanes, masks, signed)
        _check_words(c)
        n = pts.shape[0]
        if pts.shape != (n, 2, 8) or sc.shape != (n, 8) or lanes < 1 or n % lanes:
            raise ValueError("msm accumulate: (B S, 2, 8) points and (B S, 8) scalars in B lanes")
        if masks is not None and (not signed or masks.shape != (n, K.mask_words(c))):
            raise ValueError("msm accumulate: carry words must be (n, W // 32 + 1), and only for signed digits")
        cuda_lib.require_cuda("msm.accumulate_sorted", pts, sc, *(() if masks is None else (masks,)))
        if n == 0:
            return C.infinity((windows(c), lanes, rows(c, signed)), pts.device)
        return _run(pts, sc, None, masks, c, lanes, signed, key)


def accumulate_digits(pts: torch.Tensor, digits: torch.Tensor, c: int, signed: bool = True,
                      key: str | None = None) -> torch.Tensor:
    """K6 / K10 (:func:`launch_key`), or K13 when ``key`` says so: (B S, 2,
    8) affine points or any (B, S, 2, 8) view of them x any (W, B, S) view
    of int32 digits, |d| at most the window's rows (as
    ``ops/msm.py::window_digits_signed`` and ``window_digits`` give them)
    -> (W, B, rows, 3, 8) reduced buckets. The plain version on the CPU; on
    a card the kernels or an error."""
    key = key or launch_key(c, signed, True)
    with span("kernels", key):
        if pts.device.type == "cpu":
            return plain_accumulate_digits(pts, digits, c, signed)
        _check_tensor(c)
        w, b, s = digits.shape
        pts = point_lanes(pts, b, s)
        if w != windows(c) or b < 1 or pts.shape != (b, s, 2, 8):
            raise ValueError("msm accumulate: (B, S, 2, 8) points and (ceil(256 / c), B, S) digits")
        for t in (pts, digits):  # views at any strides: the kernel reads them so
            if t.device.type != "cuda" or t.device != pts.device or t.dtype != torch.int32:
                raise ValueError("msm accumulate_digits: int32 points and digits on one CUDA device")
        if pts.data_ptr() % 16:
            raise ValueError("msm accumulate_digits: points must be 16-byte aligned (loaded four words at a time)")
        if s == 0:
            return C.infinity((w, b, rows(c, signed)), pts.device)
        return _run(pts, None, digits, None, c, b, signed, key)


def live_tensor_entries(pts: torch.Tensor, digits: torch.Tensor) -> int:
    """Live (window, point) entries of (n, 2, 8) points (or a (B, S, 2, 8)
    view) and their (W, n) or (W, B, S) digits: nonzero digit, not the
    (0, 0) sentinel."""
    on = digits.reshape(digits.shape[0], -1) != 0
    return wait_for("msm.live_entries", int, (on & ~C.affine_is_infinity(pts.reshape(-1, 2, 8))[None, :]).sum())


def live_entries(pts: torch.Tensor, sc: torch.Tensor, c: int, masks=None, signed: bool = True) -> int:
    """Live (window, point) entries of points and their scalars' digits."""
    return live_tensor_entries(pts, word_digits(sc, c, signed, masks).T)
