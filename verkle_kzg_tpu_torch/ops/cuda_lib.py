"""Build and load the port's CUDA kernels (K1-K13, K1INV, K1IPA, K1QUO, K1MP,
K1AFF, K1NTT, K2FOLD, G1SMUL, G1BFLY, FSX, FBMSM) and count their launches.

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and the objects are
linked into ONE shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, into ``verkle_kzg_tpu_torch/_build/``
(git-ignored), under a name keyed by a digest of the sources, so an edited
source is rebuilt and an unchanged one is loaded as it is. There is no
fallback: a missing ``nvcc`` or a failed build raises.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise through :func:`check` when it is not zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"

#: Launches per kernel since the last :func:`reset_launches`. Each wrapper
#: adds one where it launches its kernel, and nowhere else. There is one
#: key per TPU counterpart: K3, K9, K8, K10, K6 and K13 count one a call of
#: the sorted accumulation, whatever its CUDA launches (``cuda_msm_sorted.py``:
#: signed and unsigned digits from the scalar words; digits from a tensor,
#: K6 up to 128 rows a window, K10 above, K13 for the lane-stream callers
#: that pass ``wgroup``). K4 and K7
#: count one per tail: one CUDA launch up to 1,024 bucket rows a window,
#: three or four above (``cuda_msm.tail_launches``).
#: G1SMUL and G1BFLY fuse the K11 + K2 chain of ``curve.scalar_mul``
#: (``cuda_g1_chain.py``), K1INV the K1 chain of a batched inversion
#: (``cuda_field.py``), K1IPA the K1 chain of an IPA halving round
#: (``cuda_ipa.py``), K1QUO that of the in-domain quotient and K1MP those of
#: the multiproof's grouped sums and h (``cuda_multiproof.py``), K1AFF the
#: projective -> affine conversion of ``curve.projective_to_host_points``
#: (``cuda_curve.py``), K1NTT the K1 chain of an Fr NTT (``cuda_ntt.py``,
#: one count a CUDA launch: one a transform up to the tile, one more a stage
#: above it), K2FOLD the K2 chain of a point fold (``cuda_curve.py``).
#: FSX, a Fiat-Shamir challenge or digest on the card (``cuda_fiat_shamir.py``),
#: stands for no Pallas kernel: its JAX counterpart is jnp code. FBMSM, a
#: single MSM over a fixed-base table (``cuda_msm_table.py``), stands for
#: none either: the JAX package has no such table.
launches = {**{f"K{i}": 0 for i in range(1, 14)}, "K1INV": 0, "K1IPA": 0, "K1QUO": 0, "K1MP": 0,
            "K1AFF": 0, "K1NTT": 0, "K2FOLD": 0, "G1SMUL": 0, "G1BFLY": 0, "FSX": 0, "FBMSM": 0}

#: CUDA launches since the last :func:`reset_launches` of the kernels whose
#: one count above stands for several: the sorted accumulation's, whose C
#: entry point counts each ``<<<>>>`` it issues.
cuda_launches = {"K3": 0, "K9": 0, "K8": 0, "K10": 0, "K6": 0, "K13": 0}

_lib = None
_P = ctypes.c_void_p
_I = ctypes.c_int64

# C signatures: every pointer and the stream as void*, sizes as int64.
_SIGNATURES = {
    "vkzg_field_binop": [ctypes.c_int, ctypes.c_int, _P, _P, _P, _I, _P],
    "vkzg_point_add": [_P, _P, _P, _I, ctypes.c_int, _P],
    "vkzg_point_double": [_P, _P, _I, ctypes.c_int, _P],
    "vkzg_point_mixed_add": [_P, _P, _P, _I, ctypes.c_int, _P],
    "vkzg_point_fold": [_P, _P, _I, _I, _P],
    "vkzg_ipa_round": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "vkzg_ipa_inner": [_P, _P, _P, _I, _P],
    "vkzg_msm_sorted_plan": [_I, _I, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             _P],
    "vkzg_msm_sorted": [_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P],
    "vkzg_msm_tail": [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, _P],
    "vkzg_scalar_mul": [_P, _P, _P, _P, _I, _P],
    "vkzg_field_batch_inv": [ctypes.c_int, _P, _P, _I, _I, _P],
    "vkzg_msm_batched_tail": [_P, _P, _P, _P, _P, _P, ctypes.c_int, _I, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, _P],
    "vkzg_g1_scalar_mul": [_P, _P, _P, _I, ctypes.c_int, _P],
    "vkzg_g1_butterfly": [_P, _P, _P, _I, ctypes.c_int, ctypes.c_int, _P],
    "vkzg_fsx": [_P, _P, _P, _P, _P, _P],
    "vkzg_fsx_compress": [_P, _P, _I, _P],
    "vkzg_quotient": [_P, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_int, _I, _P],
    "vkzg_mp_segment_sum": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_int, ctypes.c_int, _P],
    "vkzg_affine": [_P, _P, _I, ctypes.c_int, _P],
    "vkzg_ntt_fr": [_P, _P, _P, _I, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P],
    "vkzg_msm_table": [_P, _P, _I, _I, _I, ctypes.c_int, _I, _P, _P, _P],
}


def reset_launches() -> None:
    for counts in (launches, cuda_launches):
        for k in counts:
            counts[k] = 0


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build() -> pathlib.Path:
    """Compile the kernels if this source digest has no library yet: one
    ``nvcc -c`` per source in parallel, then one link."""
    digest = _digest()
    so = BUILD / f"libvkzg_torch_{digest}.so"
    if so.exists():
        return so
    objdir = BUILD / f"obj_{digest}_{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC"]
    jobs = []
    for src in _sources():
        obj = objdir / (src.stem + ".o")
        cmd = [nvcc, *flags, "-Xptxas", "-v", "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out[-4000:]}")
    (BUILD / "ptxas.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *flags, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in jobs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    shutil.rmtree(objdir, ignore_errors=True)
    return so


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous int32 tensor on one card,
    aligned to 16 bytes (the kernels load words four at a time)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must all lie on one CUDA device")
        if t.dtype != torch.int32 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous, 16-byte aligned int32")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    CUDA card. Without a card and without an explicit device this raises;
    the entry points never fall back to the CPU quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the plain PyTorch versions")
    return torch.device("cuda")
