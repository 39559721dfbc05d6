"""Time K2's and K11's group sizes on the card, to set
``ops/cuda_curve.py``'s SWITCH and GROUP.

    python -m verkle_kzg_tpu_torch.tools.point_regimes [--parent DIR]

For each point count in :data:`POINTS` and each group size the C entry
points take (``cuda_curve.GROUPS``: 1 thread a point, or 4, 8, 32), for
the add and the doubling: the ms a call by CUDA events (the mean of
:data:`REPS` calls after a warm-up) and the kernel alone (``torch.profiler``,
the union of the calls' kernel intervals). Inputs: sums of two points
(Z != 1) with the edge lanes first (the identity on either side and on
both, P + P, P + (-P)). Every output is held word for word against the
plain version up to :data:`PLAIN_UP_TO` points, above it against the
one-thread kernel's output and, on a strided slice of 2^15 points, against
the plain version. Prints one JSON line a point count and op; then the
registers and spills ptxas gave each instantiation (``_build/ptxas.log``);
then a summary: the fastest group of each regime by the kernel alone, and
the largest count at which the few-point regime's group is at least as
fast as the many-point regime's.

Then the variants of ``tools/point_probe.cu`` (built here with nvcc, no
path runs them) at :data:`PROBE_POINTS`: one point a thread with a floor
of 1, 4, 6 or 8 blocks an SM in ``__launch_bounds__``, in the reduced
domain and in the lazy one reduced at the end, and the groups of 8 and 32
on the lazy warp point operations, beside the path's two regimes; each
held word for word against the path's one-thread kernel, with its
registers and spills. Then the regime rows at :data:`AGAIN_POINTS` once
more. Each row ends with the SM and memory clocks read just after it.

With ``--parent DIR`` (a checkout of the parent commit, e.g. from ``git
archive``) it first builds that checkout's kernels into
``_build/parent/`` and times the lazy callers of ``csrc/warp_point.cuh``
through the same wrappers on either library in turns (parent, change,
change, parent): K5 at 1, 51 and 1,024 lanes and at the verkle commit's
40,000, and the K4 and K7 tails at c = 8 and c = 5; the words of the two
libraries must be equal. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import random
import re
import subprocess

import torch

from ..ops import cuda_curve as KC
from ..ops import cuda_lib

POINTS = (1, 32, 256, 1024, 2048, 4096, 8192, 16384, 32768, 1 << 16, 1 << 18, 1 << 20)
PLAIN_UP_TO = 32768
SLICE = 1 << 15
REPS = 10
OPS = {"add": ("vkzg_point_add", "K2"), "double": ("vkzg_point_double", "K11")}
PROBE_POINTS = (1, 256, 32768, 1 << 20)
#: Counts timed once more at the end, after the variants' 2^20 launches.
AGAIN_POINTS = (1, 256, 1024, 8192, 16384)
#: (lazy, group, minimum blocks an SM) of each probe variant.
PROBE_VARIANTS = tuple((lazy, 1, minb) for lazy in (0, 1) for minb in (1, 4, 6, 8)) + ((1, 8, 1), (1, 32, 1))
_PROBE = cuda_lib._PKG / "tools" / "point_probe.cu"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def clocks() -> dict:
    """The card's SM and memory clocks now, in MHz (``nvidia-smi``): a
    row's times depend on the state the card is in."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    sm, mem = (int(v) for v in out.stdout.strip().splitlines()[0].split(","))
    return {"sm_mhz": sm, "mem_mhz": mem}


def events_ms(fn, reps: int = REPS) -> float:
    """Mean ms a call over ``reps`` calls after one warm-up, CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int = REPS) -> float:
    """Mean ms of kernel time a call (torch.profiler: the union of the
    CUDA kernel intervals of ``reps`` calls after one warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, lo, hi = 0.0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += 0.0 if hi is None else hi - lo
    return busy / 1e3 / reps


def edge_pairs(n: int, seed: int, device) -> tuple:
    """(p, q), (n, 3, 8) reduced projective points on ``device``: sums of
    two points (Z != 1) drawn from a pool of 64, and in the first lanes the
    identity + q, p + the identity, the identity twice, P + P and P + (-P)."""
    from ..hostmath import curve as hc
    from ..ops import curve as C

    rng = random.Random(seed)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(128)) for _ in range(64)]
    a = C.from_affine(C.host_points_to_affine(base, "cpu"))
    pool = KC.plain(a, a.roll(1, 0)).to(device)
    g = torch.Generator().manual_seed(seed)
    p = pool[torch.randint(0, 64, (n,), generator=g).to(device)]
    q = pool[torch.randint(0, 64, (n,), generator=g).to(device)]
    inf = C.infinity((), device)
    edges = [(inf, None), (None, inf), (inf, inf), (None, "same"), (None, "neg")]
    for i, (ep, eq) in enumerate(edges[:n]):
        if ep is not None:
            p[i] = ep
        if eq is not None:
            q[i] = p[i] if eq == "same" else (C.neg(p[i].cpu()).to(device) if eq == "neg" else eq)
    return p.contiguous(), q.contiguous()


def run_group(op: str, group: int, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """K2 (``op`` "add") or K11 with ``group`` threads a point, whatever the
    switch says."""
    fn, key = OPS[op]
    ins = (p, q) if op == "add" else (p,)
    return KC._launch(fn, key, torch.empty_like(p), *ins, group=group)


def plain(op: str, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return KC.plain(p, q) if op == "add" else KC.plain_double(p)


def ptxas(log: str) -> dict:
    """{instantiation: registers and spill bytes} of K2's and K11's entries
    in a ``-Xptxas -v`` log."""
    lines, found = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for (\S*(point_group_kernelILb[01]ELi\d+E|point_add_kernel|"
                      r"point_double_kernel)\S*)", line)
        if m:
            name = m.group(2)
            g = re.match(r"point_group_kernelILb([01])ELi(\d+)E", name)
            key = f"{'add' if g.group(1) == '1' else 'double'}, G={g.group(2)}" if g else name
            spill = [int(v) for v in re.findall(r"(\d+) bytes", lines[i + 1])]
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            found[key] = {"registers": int(regs.group(1)) if regs else None,
                          "spill_store_bytes": spill[1], "spill_load_bytes": spill[2]}
    return found


def regime_rows(card: str, points=POINTS, tag: str = "point regimes:") -> list:
    """One row a point count and op: every group size's ms a call and
    kernel alone, the outputs checked; printed after ``tag``."""
    dev = torch.device("cuda")
    rows = []
    for n in points:
        p, q = edge_pairs(n, 17 + n.bit_length(), dev)
        for op in OPS:
            outs = {g: run_group(op, g, p, q) for g in KC.GROUPS}
            if n <= PLAIN_UP_TO:
                want = plain(op, p, q)
            else:
                want = outs[1]
                idx = torch.arange(0, n, n // SLICE, device=dev)
                assert torch.equal(want[idx], plain(op, p[idx], q[idx])), (op, n, "slice")
            for g, out in outs.items():
                assert torch.equal(out, want), (op, n, g)
            row = {"op": op, "n": n,
                   "ms": {g: events_ms(lambda g=g: run_group(op, g, p, q)) for g in KC.GROUPS},
                   "kernel_ms": {g: kernel_ms(lambda g=g: run_group(op, g, p, q)) for g in KC.GROUPS},
                   **clocks()}
            rows.append(row)
            print(tag, json.dumps(row), f"[{card}]", flush=True)
    return rows


def regimes(card: str) -> None:
    rows = regime_rows(card)
    print("point ptxas:", json.dumps(ptxas((cuda_lib.BUILD / "ptxas.log").read_text())), flush=True)
    summary = {"card": card, "switch": KC.SWITCH, "group": KC.GROUP}
    for op in OPS:
        mine = [r for r in rows if r["op"] == op]
        few = [r for r in mine if r["n"] <= 1024]
        many = [r for r in mine if r["n"] >= 32768]
        fg = min((8, 32), key=lambda g: sum(r["kernel_ms"][g] for r in few))
        mg = min((1, 4), key=lambda g: sum(r["kernel_ms"][g] for r in many))
        summary[op] = {"fastest_few_group": fg, "fastest_many_group": mg,
                       "few_not_slower_up_to": max((r["n"] for r in mine
                                                    if r["kernel_ms"][fg] <= r["kernel_ms"][mg]), default=0)}
    print("point regimes summary:", json.dumps(summary), flush=True)


def _probe_ptxas(log: str) -> dict:
    """{variant: registers and spill bytes} of the probe's kernels."""
    lines, found = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for \S*probe_(thread|lazy_group)_kernelILb([01])E(?:Lb([01])E)?Li(\d+)E",
                      line)
        if m:
            kind, add, lazy, num = m.groups()
            op = "add" if add == "1" else "double"
            key = (f"{op}, thread, {'lazy' if lazy == '1' else 'reduced'}, minb={num}" if kind == "thread"
                   else f"{op}, lazy group, G={num}")
            spill = [int(v) for v in re.findall(r"(\d+) bytes", lines[i + 1])]
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            found[key] = {"registers": int(regs.group(1)) if regs else None,
                          "spill_store_bytes": spill[1], "spill_load_bytes": spill[2]}
    return found


def variants(card: str) -> None:
    """Time the probe's variants beside the path's one-thread kernel."""
    so = cuda_lib.BUILD / "point_probe.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(cuda_lib.CSRC), str(_PROBE), "-o", str(so)]
    built = subprocess.run(cmd, capture_output=True, text=True)
    if built.returncode:
        raise RuntimeError(f"nvcc failed for {_PROBE.name}:\n{built.stdout[-3000:]}{built.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    lib.point_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p]
    lib.point_probe.restype = ctypes.c_int

    def call(op, lazy, group, minb, p, q):
        out = torch.empty_like(p)
        err = lib.point_probe(int(op == "add"), lazy, group, minb, p.data_ptr(), q.data_ptr(), out.data_ptr(),
                              p.shape[0], cuda_lib.stream(p))
        cuda_lib.check(err, "point_probe")
        return out

    dev = torch.device("cuda")
    for n in PROBE_POINTS:
        p, q = edge_pairs(n, 29 + n.bit_length(), dev)
        for op in OPS:
            want = run_group(op, 1, p, q)
            row = {"op": op, "n": n}
            for g in (1, KC.GROUP["few"]):  # the path's two regimes, timed here beside the variants
                assert torch.equal(run_group(op, g, p, q), want), (op, n, g)
                row[f"path, G={g}"] = {"ms": events_ms(lambda g=g: run_group(op, g, p, q)),
                                       "kernel_ms": kernel_ms(lambda g=g: run_group(op, g, p, q))}
            for lazy, group, minb in PROBE_VARIANTS:
                run = lambda lazy=lazy, group=group, minb=minb: call(op, lazy, group, minb, p, q)  # noqa: E731
                assert torch.equal(run(), want), (op, n, lazy, group, minb)
                name = f"{'lazy' if lazy else 'reduced'}, G={group}" + (f", minb={minb}" if group == 1 else "")
                row[name] = {"ms": events_ms(run), "kernel_ms": kernel_ms(run)}
            row.update(clocks())
            print("point variants:", json.dumps(row), f"[{card}]", flush=True)
    print("point variants ptxas:", json.dumps(_probe_ptxas(built.stdout + built.stderr)), flush=True)


def _parent_library(root: pathlib.Path):
    """Build the checkout at ``root``'s kernels into ``_build/parent/`` and
    load them with the signatures of the entry points timed here."""
    saved = cuda_lib.CSRC, cuda_lib.BUILD
    cuda_lib.CSRC, cuda_lib.BUILD = root / "verkle_kzg_tpu_torch" / "csrc", saved[1] / "parent"
    try:
        so = cuda_lib.build()
    finally:
        cuda_lib.CSRC, cuda_lib.BUILD = saved
    handle = ctypes.CDLL(str(so))
    for name in ("vkzg_scalar_mul", "vkzg_msm_tail", "vkzg_msm_batched_tail"):
        fn = getattr(handle, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return handle


def lazy_callers(root: pathlib.Path, card: str) -> None:
    """K5 and the tails through their wrappers on the parent's library and
    on this one, in turns; their words must be equal."""
    from ..hostmath import curve as hc
    from ..ops import cuda_msm as K
    from ..ops import cuda_msm_batched as KB
    from ..ops import cuda_scalar_mul as K5
    from ..ops import curve as C
    from ..ops import field as F
    from ..params import R
    from ..schemes import ipa_setup

    dev = torch.device("cuda")
    mine = cuda_lib.lib()
    libs = {"parent": _parent_library(root), "change": mine}
    basis = ipa_setup(256, device=dev).g_affine
    rng = random.Random(23)
    cases = []
    for n, bits in ((1, 254), (51, 254), (1024, 254), (40000, 128)):
        idx = torch.tensor([rng.randrange(256) for _ in range(n)], device=dev)
        ks = [rng.randrange(1 << (bits - 1), min(R, 1 << bits)) if bits == 254 or i % 2 == 0 else 0
              for i in range(n)]
        pa, sc = basis[idx].contiguous(), F.ints_to_words(ks, dev)
        cases.append((f"K5@{n}", lambda pa=pa, sc=sc: K5.scalar_mul_affine(pa, sc)))
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(96)) for _ in range(32)]
    a = C.from_affine(C.host_points_to_affine(base, "cpu"))
    pool = KC.plain(a, a.roll(3, 0)).to(dev)
    g = torch.Generator().manual_seed(23)
    for key, c, lanes in (("K4", 8, 1), ("K7", 5, 40)):
        shape = (K.windows(c), lanes, K.rows(c, True))
        bk = pool[torch.randint(0, 32, shape, generator=g).to(dev)]
        bk[(torch.rand(shape, generator=g) > 0.9).to(dev)] = C.infinity((), dev)
        bk = bk[:, 0].contiguous() if lanes == 1 else bk.contiguous()
        cases.append((f"{key}@c{c}-{lanes}", (lambda bk=bk, c=c: K.tail(bk, c)) if lanes == 1
                      else (lambda bk=bk, c=c: KB.tail(bk, c))))
    rows = {name: {} for name, _ in cases}
    outs = {}
    try:
        for turn, which in enumerate(("parent", "change", "change", "parent")):
            cuda_lib._lib = libs[which]
            for name, fn in cases:
                out = fn()
                torch.cuda.synchronize()
                if name in outs:
                    assert torch.equal(out, outs[name]), (name, which)
                outs[name] = out
                rows[name][f"{turn}_{which}"] = {"ms": events_ms(fn, 5), "kernel_ms": kernel_ms(fn, 5)}
    finally:
        cuda_lib._lib = mine
    for name, row in rows.items():
        print("lazy callers:", name, json.dumps(row), f"[{card}]", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a checkout of the parent commit: time K5 and the tails on both libraries")
    args = ap.parse_args()
    card = card_line()
    cuda_lib.lib()
    if args.parent is not None:
        lazy_callers(args.parent.resolve(), card)
    regimes(card)
    variants(card)
    regime_rows(card, AGAIN_POINTS, "point regimes again:")


if __name__ == "__main__":
    main()
