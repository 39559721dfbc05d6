"""Time variant builds of ``csrc/msm_sorted.cu`` (K3/K9; K8 and K10 share
its sums and combine) on the card, to see what bounds its sums and its
combine.

    python -m verkle_kzg_tpu_torch.tools.sorted_variants

Variants, each a copy of the source with one edit, all ``nvcc`` processes
started together:

- the sums kernel's launch bounds (2, 3 or 4 resident blocks of 128 an
  SM, so 168 to 128 registers) x a prefetch to L1 of the point 1 or 2
  entries ahead (``blocks{b}_prefetch{d}``; the path's build is
  ``blocks4_prefetch0``), each at 132 x 256, 384, 512 and 1,024 chunks
  (``cuda_msm_sorted.TARGET``);
- the combine with each side's add inlined apart (``two_adds``), and two
  timing-only variants whose buckets are WRONG by design (``WRONG_WORDS``):
  the combine with no add at all (``no_add``) and with no tree
  (``no_tree``: only its searches and loads).

Shapes: 257 points and 2^12 equal scalars at c = 8, 2^20 points at c = 8
and 2^22 at c = 16 (phase 4's points). Each variant's buckets are held
against the path's build at the same chunk count (``same``; a variant
outside ``WRONG_WORDS`` that differs raises), and its sums and combine
timed by the CUDA events the entry point records between its stages
(the median of 3 calls after a warm-up). Prints one JSON line a run and the
registers and spill bytes ptxas gave each variant's sums and combine
kernels. Each edit must match its line of the source exactly once. Needs a
CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import random
import re
import statistics
import subprocess

import torch

from ..hostmath import curve as hc
from ..ops import cuda_lib
from ..ops import cuda_msm_sorted as KS
from ..ops import curve as C
from ..ops import field as F
from ..params import R

SUMS_BOUNDS = "__global__ void __launch_bounds__(SUM_THREADS, 4) sorted_sums_kernel("
SUMS_LOAD = "    const uint32_t v = (uint32_t)vals[i];\n"
COMBINE_ADD = "    point_add<true>(acc, left, right);\n"
TREE = "  for (int h = 0; ((int64_t)1 << h) < m; ++h) {"
TARGETS = (132 * 256, 132 * 384, 132 * 512, 132 * 1024)
WRONG_WORDS = ("no_add", "no_tree")  # timing only: these variants' buckets are wrong


def _prefetch(dist: int) -> str:
    return SUMS_LOAD + (
        f"    if (i + {dist} < hi) {{\n"
        f"      const uint32_t vn = (uint32_t)vals[i + {dist}];\n"
        '      asm volatile("prefetch.global.L1 [%0];" :: "l"(pts + 16 * (int64_t)(vn & 0x7fffffffu)));\n'
        "    }\n"
    )


def variants(src: str) -> dict:
    """{name: source}, each one edit away from the path's source."""
    for needle in (SUMS_BOUNDS, SUMS_LOAD, COMBINE_ADD, TREE):
        if src.count(needle) != 1:
            raise RuntimeError(f"msm_sorted.cu has {src.count(needle)} copies of the edited line {needle!r}")
    out = {}
    for blocks in (4, 3, 2):
        for dist in (0, 1, 2):
            s = src.replace(SUMS_BOUNDS, SUMS_BOUNDS.replace(", 4)", f", {blocks})"))
            out[f"blocks{blocks}_prefetch{dist}"] = s.replace(SUMS_LOAD, _prefetch(dist)) if dist else s
    out["two_adds"] = src.replace(COMBINE_ADD, "    if (idx == base) point_add<true>(acc, acc, other);\n"
                                               "    else point_add<true>(acc, other, acc);\n")
    out["no_add"] = src.replace(COMBINE_ADD, "    acc.x[0] ^= other.x[0];\n")
    out["no_tree"] = src.replace(TREE, "  for (int h = 0; h < 0; ++h) {")
    return out


def build(sources: dict) -> dict:
    """{name: (ctypes library, {kernel: ptxas registers and spills})}."""
    out_dir = cuda_lib.BUILD / "sorted_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        cmd = [cuda_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-shared", "-Xptxas", "-v", "-I", str(cuda_lib.CSRC), str(cu), "-o", str(so)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")
        lines, regs = log.splitlines(), {}
        for i, line in enumerate(lines):
            m = re.search(r"Function properties for \S*(sorted_sums|sorted_combine)", line)
            if m:
                spill = [int(v) for v in re.findall(r"(\d+) bytes", lines[i + 1])]
                used = re.search(r"Used (\d+) registers", lines[i + 2])
                regs[m.group(1)] = {"registers": int(used.group(1)) if used else None, "spill_bytes": spill[1:3]}
        lib = ctypes.CDLL(str(so))
        lib.vkzg_msm_sorted.argtypes = cuda_lib._SIGNATURES["vkzg_msm_sorted"]
        lib.vkzg_msm_sorted_plan.argtypes = cuda_lib._SIGNATURES["vkzg_msm_sorted_plan"]
        libs[name] = (lib, regs)
    return libs


def stages(lib, pts, sc, c: int, target: int, ref, reps: int = 3) -> dict:
    """One variant's call at one chunk count: same words as ``ref``, and
    the median sums and combine ms of ``reps`` event-timed calls."""
    n, w = pts.shape[0], KS.windows(c)
    words, issued = ctypes.c_int64(), ctypes.c_int64()
    cuda_lib.check(lib.vkzg_msm_sorted_plan(n, 1, c, 1, 1, w, target, ctypes.byref(words)), "plan")
    work = torch.empty(words.value, dtype=torch.int32, device=pts.device)
    out = torch.empty_like(ref)
    ms = (ctypes.c_float * len(KS.STAGES))()

    def run(timed):
        cuda_lib.check(lib.vkzg_msm_sorted(pts.data_ptr(), sc.data_ptr(), 0, 0, out.data_ptr(), work.data_ptr(),
                                           work.numel(), n, 1, c, 1, 0, w, target, KS.L_MIN, None,
                                           ctypes.addressof(ms) if timed else None, ctypes.byref(issued),
                                           cuda_lib.stream(pts)), "vkzg_msm_sorted")
        return dict(zip(KS.STAGES, ms)) if timed else None

    run(False)
    torch.cuda.synchronize()
    same = bool(torch.equal(out, ref))
    runs = [run(True) for _ in range(reps)]
    return {"same": same, **{f"{s}_ms": statistics.median(r[s] for r in runs) for s in ("sums", "combine")}}


def shapes(dev) -> list:
    """(name, points, scalars, c): 257 points and 2^12 equal scalars over 64
    multiples of G, 2^20 and 2^22 points of phase 4 (k G, k = 1..2^20)."""
    import chip_smoke

    rng = random.Random(3)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(96)) for _ in range(64)]
    out = []
    for n, equal in ((257, False), (1 << 12, True)):
        ks = [rng.randrange(R) for _ in range(n)]
        ks = [ks[0]] * n if equal else ks
        pts = C.host_points_to_affine([base[i % 64] for i in range(n)], dev)
        out.append((f"{n}{' equal scalars' if equal else ''}, c = 8", pts, F.ints_to_words(ks, dev), 8))
    big = chip_smoke.msm_points(1 << 20).to(dev)
    for log2, c in ((20, 8), (22, 16)):
        pts = big.repeat(1 << (log2 - 20), 1, 1).contiguous()
        ks = [rng.randrange(R) for _ in range(1 << log2)]
        out.append((f"2^{log2}, c = {c}", pts, F.ints_to_words(ks, dev), c))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("sorted_variants: no CUDA device")
        return 2
    dev = torch.device("cuda")
    libs = build(variants((cuda_lib.CSRC / "msm_sorted.cu").read_text()))
    for name, (_, regs) in libs.items():
        print("ptxas:", name, json.dumps(regs), flush=True)
    default = KS.TARGET
    try:
        for shape, pts, sc, c in shapes(dev):
            for target in TARGETS:
                KS.TARGET = target
                ref = KS.accumulate(pts, sc, c)
                for name, (lib, _) in libs.items():
                    if not name.startswith("blocks") and target != default:
                        continue
                    line = {"shape": shape, "chunks_at_most": target, "variant": name,
                            **stages(lib, pts, sc, c, target, ref)}
                    if not line["same"] and name not in WRONG_WORDS:
                        raise RuntimeError(f"variant {name} disagrees with the path's build: {line}")
                    print("variant:", json.dumps(line), flush=True)
    finally:
        KS.TARGET = default
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
