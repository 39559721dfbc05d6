"""Time K5's two regimes on the card, to set ``ops/cuda_scalar_mul.py``'s
SWITCH and ``csrc/scalar_mul.cu``'s block shapes.

    python -m verkle_kzg_tpu_torch.tools.k5_regimes

For each lane count in :data:`LANES` (uniform scalars below r over the IPA
basis) and at the verkle commit's c1/c2 shape (40,000 lanes, 128-bit
scalars on every other lane and zero on the rest):

- the path's kernel in each regime, through
  ``cuda_scalar_mul.scalar_mul_affine`` with SWITCH set for the call;
- the variant builds of ``csrc/scalar_mul.cu`` in :data:`VARIANTS`, each
  compiled here with other ``K5_MANY_GROUP`` (threads a lane above the
  switch) and warps a block (``K5_FEW_WARPS`` = ``K5_MANY_WARPS``), all
  ``nvcc`` processes started together, and called through their own C
  entry point: one warp a lane for the variants of 4 threads a lane, the
  many-lane regime for all.

Every output is held word for word against the plain version (up to
:data:`PLAIN_UP_TO` lanes) or against the path's first output (above).
Each time is the mean of 3 calls after a warm-up, by CUDA events. Prints
one JSON line a lane count; then the registers and spill bytes ptxas gave
each instantiation, the path's (``_build/ptxas.log``) and the variants';
then a summary: the lane counts at which one warp a lane is the faster on
the path, and the fastest variant of each regime at the commit shape.
Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import random
import re
import subprocess

import torch

from ..ops import cuda_lib
from ..ops import cuda_scalar_mul as K5
from ..ops import field as F
from ..params import R

LANES = (1, 19, 32, 256, 512, 768, 1024, 1152, 1280, 1408, 1536, 1792, 2048, 4096, 16384, 40000)
#: (threads a lane above the switch, warps a block in both regimes).
VARIANTS = ((4, 1), (4, 2), (4, 4), (8, 1), (8, 2), (8, 4))
PLAIN_UP_TO = 2048


def _ms(fn, reps: int = 3) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas(log: str) -> dict:
    """{instantiation: registers and spill bytes} of the scalar_mul_kernel
    entries in a ``-Xptxas -v`` log."""
    lines, found = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for \S*scalar_mul_kernelILi(\d+)ELi(\d+)E", line)
        if m:
            spill = [int(v) for v in re.findall(r"(\d+) bytes", lines[i + 1])]
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            found[f"G={m.group(1)}, warps={m.group(2)}"] = {
                "registers": int(regs.group(1)) if regs else None,
                "spill_store_bytes": spill[1], "spill_load_bytes": spill[2]}
    return found


def build_variants() -> dict:
    """{(group, warps): (library, ptxas)}, one ``nvcc`` a variant, all
    started together."""
    cuda_lib.BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for group, warps in VARIANTS:
        so = cuda_lib.BUILD / f"k5_variant_{group}x{warps}.so"
        cmd = [cuda_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-DK5_MANY_GROUP={group}", f"-DK5_FEW_WARPS={warps}",
               f"-DK5_MANY_WARPS={warps}", "-I", str(cuda_lib.CSRC), str(cuda_lib.CSRC / "scalar_mul.cu"),
               "-o", str(so)]
        jobs[(group, warps)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                      text=True))
    built = {}
    for key, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        lib.vkzg_scalar_mul.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
        lib.vkzg_scalar_mul.restype = ctypes.c_int
        built[key] = (lib, ptxas(log))
    return built


def _variant_call(lib, pts, sc, order):
    out = torch.empty((pts.shape[0], 3, F.WORDS), dtype=torch.int32, device=pts.device)
    err = lib.vkzg_scalar_mul(pts.data_ptr(), sc.data_ptr(), None if order is None else order.data_ptr(),
                              out.data_ptr(), pts.shape[0], cuda_lib.stream(pts))
    cuda_lib.check(err, "k5 variant")
    return out


def _path_call(pts, sc, regime):
    """The path's wrapper with SWITCH set so that this call takes ``regime``."""
    saved = K5.SWITCH
    K5.SWITCH = pts.shape[0] if regime == "few" else pts.shape[0] - 1
    try:
        return K5.scalar_mul_affine(pts, sc)
    finally:
        K5.SWITCH = saved


def main() -> None:
    from ..schemes import ipa_setup

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    basis = ipa_setup(256, device=dev).g_affine  # builds the path's library
    variants = build_variants()
    rng = random.Random(5)
    cases = [(n, "uniform", [rng.randrange(R) for _ in range(n)]) for n in LANES]
    cases.append((40000, "commit c1/c2", [rng.getrandbits(128) if i % 2 == 0 else 0 for i in range(40000)]))
    rows = []
    for n, kind, ks in cases:
        idx = torch.tensor([rng.randrange(256) for _ in range(n)], device=dev)
        pts, sc = basis[idx].contiguous(), F.ints_to_words(ks, dev)
        order = K5.lane_order(pts, sc).to(torch.int32)
        want = K5.plain(pts, sc) if n <= PLAIN_UP_TO else _path_call(pts, sc, "many")
        row = {"n": n, "scalars": kind, "ms": {}, "variants_ms": {}}
        for regime in ("few", "many"):
            assert torch.equal(_path_call(pts, sc, regime), want), (n, kind, regime)
            row["ms"][regime] = _ms(lambda: _path_call(pts, sc, regime))
        for (group, warps), (lib, _) in variants.items():
            runs = [("many", order)] + ([("few", None)] if group == 4 else [])
            for regime, o in runs:
                name = f"few, warps={warps}" if regime == "few" else f"many, G={group}, warps={warps}"
                assert torch.equal(_variant_call(lib, pts, sc, o), want), (n, kind, name)
                row["variants_ms"][name] = _ms(lambda: _variant_call(lib, pts, sc, o))
        rows.append(row)
        print("k5 regimes:", json.dumps(row), f"[{card}]", flush=True)
    path_regs = ptxas((cuda_lib.BUILD / "ptxas.log").read_text())
    print("k5 ptxas:", json.dumps({"path": path_regs, **{f"variant {g}x{w}": v[1] for (g, w), v in variants.items()}}),
          flush=True)
    uniform = [r for r in rows if r["scalars"] == "uniform"]
    commit = rows[-1]["variants_ms"]
    print("k5 regimes summary:", json.dumps({
        "few_faster_at": [r["n"] for r in uniform if r["ms"]["few"] <= r["ms"]["many"]],
        "switch": K5.SWITCH,
        "fastest_many_variant_at_commit": min((k for k in commit if k.startswith("many")), key=commit.get),
        "fastest_few_variant_at_1_lane": min((k for k in rows[0]["variants_ms"] if k.startswith("few")),
                                             key=rows[0]["variants_ms"].get),
        "card": card,
    }), flush=True)


if __name__ == "__main__":
    main()
