"""Read and time two Montgomery products on the card: ``csrc/bn254_field.cuh``'s
``fmul`` (CIOS on 64-bit accumulators, every kernel's) and ``fmul_cc``
(the same CIOS over PTX carry chains, in ``tools/fmul_probe.cu`` only: it
was slower, so no kernel uses it).

    python -m verkle_kzg_tpu_torch.tools.fmul_probe

Builds ``tools/fmul_probe.cu`` with nvcc for sm_90a into the git-ignored
``_build/``, then prints one JSON line: per product, the SASS instructions
of a kernel that holds one Fq product (``cuobjdump -sass``; the kernel adds
about 20 of its own for the loads and stores), its IMAD-family count, its
local-memory loads and stores (LDL / STL), and the microseconds of one
dependent product in a one-thread chain of 4,096 (CUDA events, three runs
each, in turns); and whether the two products gave the same words on 2^16
random lazy pairs (lazy and reduced outputs). Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import random
import re
import subprocess
from collections import Counter

import torch

from ..ops import cuda_lib
from ..ops import field as F
from ..params import FQ

_SRC = cuda_lib._PKG / "tools" / "fmul_probe.cu"


def _build() -> str:
    so = cuda_lib.BUILD / "fmul_probe.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", str(cuda_lib.CSRC), str(_SRC), "-o", str(so)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return str(so)


def _sass(so: str) -> dict:
    """Opcode counts per kernel of the library's SASS."""
    cuobjdump = str(pathlib.Path(cuda_lib._nvcc()).resolve().parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], check=True, capture_output=True, text=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            kernels[name][m.group(1).split(".")[0]] += 1
    return kernels


def main() -> None:
    so = _build()
    lib = ctypes.CDLL(so)
    for fn, args in (("probe_compare", [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]),
                     ("probe_chain", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = random.Random(0)
    n = 1 << 16
    two_m = 2 * FQ.modulus
    a = F.ints_to_words([rng.randrange(two_m) for _ in range(n - 2)] + [two_m - 1, 0], dev)
    b = F.ints_to_words([rng.randrange(two_m) for _ in range(n - 2)] + [two_m - 1, two_m - 1], dev)
    out = torch.empty((n, 4, 8), dtype=torch.int32, device=dev)
    cuda_lib.check(lib.probe_compare(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, stream), "probe_compare")
    torch.cuda.synchronize()
    same = bool(torch.equal(out[:, 0], out[:, 1]) and torch.equal(out[:, 2], out[:, 3]))

    chain_n = 4096
    io = torch.cat([a[:1], b[:1]]).contiguous()
    times = {False: [], True: []}
    for _ in range(3):
        for cc in (False, True):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            cuda_lib.check(lib.probe_chain(io.data_ptr(), chain_n, int(cc), stream), "probe_chain")
            end.record()
            torch.cuda.synchronize()
            times[cc].append(start.elapsed_time(end) * 1000 / chain_n)

    sass = _sass(so)
    rec = {"same_words_on_2^16_pairs": same, "card": torch.cuda.get_device_name(0)}
    for cc, label in ((False, "fmul"), (True, "fmul_cc")):
        k = next(v for name, v in sass.items() if "one_product" in name and ("ILb1E" in name) == cc)
        rec[label] = {
            "sass_instructions_one_product_kernel": sum(k.values()),
            "imad_family": sum(v for op, v in k.items() if op.startswith("IMAD")),
            "iadd3": k.get("IADD3", 0),
            "ldl_stl": k.get("LDL", 0) + k.get("STL", 0),
            "us_per_dependent_product": sorted(times[cc]),
        }
    chain_ldl = {name: v.get("LDL", 0) + v.get("STL", 0) for name, v in sass.items() if "product_chain" in name}
    rec["chain_kernels_ldl_stl"] = chain_ldl
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
