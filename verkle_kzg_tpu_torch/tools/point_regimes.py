"""Time K2's, K11's and K12's group sizes on the card, to set
``ops/cuda_curve.py``'s SWITCH and GROUP.

    python -m verkle_kzg_tpu_torch.tools.point_regimes [--parent DIR]

For each point count in :data:`POINTS` and the switch +- 1, each group
size the C entry points take (``cuda_curve.GROUPS``: 1 thread a point, or
4, 8, 32), for the add, the doubling and the mixed add: the ms a call by
CUDA events (the mean of :data:`REPS` calls after a warm-up) and the
kernel alone (``torch.profiler``, the union of the calls' kernel
intervals). Inputs: sums of two points (Z != 1) with the edge lanes first
(the add: the identity on either side and on both, P + P, P + (-P); the
mixed add: the identity + Q, the (0, 0) sentinel, P + P, P + (-P), and
more sentinels among live lanes). Every output is held word for word
against the plain version up to :data:`PLAIN_UP_TO` points, above it
against the one-thread kernel's output and, on a strided slice of 2^15
points, against the plain version. Prints one JSON line a point count and
op; then the registers and spills ptxas gave each instantiation
(``_build/ptxas.log``); then a summary: the fastest group of each regime by
the kernel alone, and the largest count at which the few-point regime's
group is at least as fast as the many-point regime's.

Then the variants of ``tools/point_probe.cu`` (built here with nvcc, no
path runs them) at :data:`PROBE_POINTS`: one point a thread with a floor
of 1, 4, 6 or 8 blocks an SM in ``__launch_bounds__``, in the reduced
domain (K12's one-thread design before its lazy regimes at a floor of 1)
and in the lazy one reduced at the end, and for K2 and K11 the groups of 8
and 32 on the lazy warp point operations, beside the path's two regimes;
each held word for word against the path's one-thread kernel, with its
registers and spills. Then the regime rows at :data:`AGAIN_POINTS` once
more, after those 2^20-point launches. Each row ends with the SM and memory
clocks read just after it. Last, the sorted sums that share K12's
one-thread body: K3 at 2^20 points, c = 8, its live entries and its four
stages by CUDA events, beside K12's many-point kernel at 2^20 in ns a
point.

With ``--parent DIR`` (a checkout of the parent commit, e.g. from ``git
archive``) it first builds that checkout's kernels into
``_build/parent/`` and times the lazy callers of ``csrc/warp_point.cuh``
through the same wrappers on either library in turns (parent, change,
change, parent): K5 at 1, 51 and 1,024 lanes and at the verkle commit's
40,000, the K4 and K7 tails at c = 8 and c = 5, and K12 at 1 and 32,768
points (the parent's entry point through its own signature); the words of
the two libraries must be equal. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import random
import re
import statistics
import subprocess

import torch

from ..ops import cuda_curve as KC
from ..ops import cuda_lib

POINTS = (1, 32, 256, 1024, 2048, 4096, 8192, 16384, 32768, 1 << 16, 1 << 18, 1 << 20)
PLAIN_UP_TO = 32768
SLICE = 1 << 15
REPS = 10
OPS = {"add": ("vkzg_point_add", "K2"), "double": ("vkzg_point_double", "K11"),
       "mixed": ("vkzg_point_mixed_add", "K12")}
PROBE_POINTS = (1, 256, 32768, 1 << 20)
#: Counts timed once more at the end, after the variants' 2^20 launches.
AGAIN_POINTS = (1, 256, 1024, 8192, 16384)
#: (lazy, group, minimum blocks an SM) of each probe variant; K12 takes the
#: one-thread ones (its lazy groups are the path's).
PROBE_VARIANTS = tuple((lazy, 1, minb) for lazy in (0, 1) for minb in (1, 4, 6, 8)) + ((1, 8, 1), (1, 32, 1))
#: The probe's code of each op.
PROBE_OP = {"double": 0, "add": 1, "mixed": 2}
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


def kernel_ms(fn, reps: int = REPS, per_call: int | None = 1, name: str | None = None) -> tuple:
    """(ms of kernel time a call, the CUDA kernel records seen) from
    torch.profiler over ``reps`` calls after one warm-up: the union of the
    recorded kernel intervals over the calls they cover. The profiler can
    drop records (later profiles in one process kept 5 of 10, or none),
    so with ``per_call`` kernels a call the union is divided by the calls
    recorded, ``records / per_call``; with ``per_call`` None (a call of
    several kernels, some of them torch's) by ``reps``, and a short count
    shows a reading too low. With ``name``, only the records whose kernel
    name holds it are kept (a wrapper's own kernel among torch's copies
    and fills)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and (name is None or name in e.name))
    busy, lo, hi = 0.0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += 0.0 if hi is None else hi - lo
    calls = reps if per_call is None else len(spans) / per_call
    return (busy / 1e3 / calls if calls else None), len(spans)


def edge_pairs(n: int, seed: int, device, op: str = "add") -> tuple:
    """(p, q) on ``device``: p (n, 3, 8) reduced projective points, sums of
    two points (Z != 1) drawn from a pool of 64; q the same (op "add" or
    "double") or (n, 2, 8) affine points of the pool and their negatives
    (op "mixed"). In the first lanes, the add: the identity + q, p + the
    identity, the identity twice, P + P and P + (-P); the mixed add: the
    identity + q, the (0, 0) sentinel, P + P, P + (-P), then a sentinel
    every 37 lanes from lane 9 (among live lanes of their warps)."""
    from ..hostmath import curve as hc
    from ..ops import curve as C

    rng = random.Random(seed)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(128)) for _ in range(64)]
    a = C.from_affine(C.host_points_to_affine(base, "cpu"))
    pool = KC.plain(a, a.roll(1, 0)).to(device)
    g = torch.Generator().manual_seed(seed)
    ip = torch.randint(0, 64, (n,), generator=g)
    iq = torch.randint(0, 64, (n,), generator=g)
    p = pool[ip.to(device)]
    inf = C.infinity((), device)
    if op == "mixed":
        sums = [hc.g1_add(x, y) for x, y in zip(base, base[-1:] + base[:-1])]
        aff = C.host_points_to_affine(sums + [hc.g1_neg(s) for s in sums], device)
        if n > 2:
            iq[2] = ip[2]  # P + P
        if n > 3:
            iq[3] = 64 + ip[3]  # P + (-P)
        q = aff[iq.to(device)]
        p[0] = inf
        q[1:2] = 0
        q[9::37] = 0
        return p.contiguous(), q.contiguous()
    q = pool[iq.to(device)]
    edges = [(inf, None), (None, inf), (inf, inf), (None, "same"), (None, "neg")]
    for i, (ep, eq) in enumerate(edges[:n]):
        if ep is not None:
            p[i] = ep
        if eq is not None:
            q[i] = p[i] if eq == "same" else (C.neg(p[i].cpu()).to(device) if eq == "neg" else eq)
    return p.contiguous(), q.contiguous()


def run_group(op: str, group: int, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """K2 (``op`` "add"), K11 ("double") or K12 ("mixed") with ``group``
    threads a point, whatever the switch says."""
    fn, key = OPS[op]
    ins = (p,) if op == "double" else (p, q)
    return KC._launch(fn, key, torch.empty_like(p), *ins, group=group)


def plain(op: str, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return {"add": KC.plain, "mixed": KC.plain_mixed_add}[op](p, q) if op != "double" else KC.plain_double(p)


def ptxas(log: str) -> dict:
    """{instantiation: registers and spill bytes} of K2's, K11's and K12's
    entries in a ``-Xptxas -v`` log."""
    ops = {"0": "double", "1": "add", "2": "mixed"}
    lines, found = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for (\S*(point_group_kernelILi[012]ELi\d+E|point_add_kernel|"
                      r"point_double_kernel|point_mixed_add_kernel)\S*)", line)
        if m:
            name = m.group(2)
            g = re.match(r"point_group_kernelILi([012])ELi(\d+)E", name)
            key = f"{ops[g.group(1)]}, G={g.group(2)}" if g else name
            spill = [int(v) for v in re.findall(r"(\d+) bytes", lines[i + 1])]
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            found[key] = {"registers": int(regs.group(1)) if regs else None,
                          "spill_store_bytes": spill[1], "spill_load_bytes": spill[2]}
    return found


def with_switch(points) -> list:
    """``points`` and the regime switch +- 1, in order."""
    return sorted(set(points) | {KC.SWITCH - 1, KC.SWITCH, KC.SWITCH + 1})


def regime_rows(card: str, points=POINTS, tag: str = "point regimes:") -> list:
    """One row a point count and op: every group size's ms a call and
    kernel alone, the outputs checked; printed after ``tag``."""
    dev = torch.device("cuda")
    rows = []
    for n in with_switch(points):
        for op in OPS:
            p, q = edge_pairs(n, 17 + n.bit_length(), dev, op)
            outs = {g: run_group(op, g, p, q) for g in KC.GROUPS}
            if n <= PLAIN_UP_TO:
                want = plain(op, p, q)
            else:
                want = outs[1]
                idx = torch.arange(0, n, n // SLICE, device=dev)
                assert torch.equal(want[idx], plain(op, p[idx], q[idx])), (op, n, "slice")
            for g, out in outs.items():
                assert torch.equal(out, want), (op, n, g)
            kern = {g: kernel_ms(lambda g=g: run_group(op, g, p, q)) for g in KC.GROUPS}
            row = {"op": op, "n": n,
                   "ms": {g: events_ms(lambda g=g: run_group(op, g, p, q)) for g in KC.GROUPS},
                   "kernel_ms": {g: k[0] for g, k in kern.items()},
                   "kernel_records": {g: k[1] for g, k in kern.items()},
                   **clocks()}
            rows.append(row)
            print(tag, json.dumps(row), f"[{card}]", flush=True)
    return rows


def _ms(row: dict, group: int) -> float:
    """A row's kernel ms for ``group``, infinite where no record was seen."""
    ms = row["kernel_ms"][group]
    return float("inf") if ms is None else ms


def summarize(rows: list, card: str, tag: str) -> dict:
    """For each op, the fastest group of each regime by the kernel alone
    (few: 1-1,024 points; many: 32,768 and more) and the largest count at
    which the few-point group is at least as fast; printed after ``tag``."""
    summary = {"card": card, "switch": KC.SWITCH, "group": KC.GROUP}
    for op in OPS:
        mine = [r for r in rows if r["op"] == op]
        few = [r for r in mine if r["n"] <= 1024] or mine
        many = [r for r in mine if r["n"] >= 32768] or mine
        fg = min((4, 8, 32), key=lambda g: sum(_ms(r, g) for r in few))
        mg = min((1, 4), key=lambda g: sum(_ms(r, g) for r in many))
        summary[op] = {"fastest_few_group": fg, "fastest_many_group": mg,
                       "few_not_slower_up_to": max((r["n"] for r in mine if _ms(r, fg) <= _ms(r, mg)), default=0)}
    print(tag, json.dumps(summary), flush=True)
    return summary


def regimes(card: str) -> list:
    rows = regime_rows(card)
    print("point ptxas:", json.dumps(ptxas((cuda_lib.BUILD / "ptxas.log").read_text())), flush=True)
    summarize(rows, card, "point regimes summary:")
    return rows


def _probe_ptxas(log: str) -> dict:
    """{variant: registers and spill bytes} of the probe's kernels."""
    lines, found = log.splitlines(), {}
    ops = {"0": "double", "1": "add", "2": "mixed"}
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for \S*probe_(thread_kernelILi([012])ELb([01])E|"
                      r"lazy_group_kernelILb([01])E)Li(\d+)E", line)
        if m:
            _, op, lazy, add, num = m.groups()
            key = (f"{ops[op]}, thread, {'lazy' if lazy == '1' else 'reduced'}, minb={num}" if op is not None
                   else f"{'add' if add == '1' else 'double'}, lazy group, G={num}")
            spill = [int(v) for v in re.findall(r"(\d+) bytes", lines[i + 1])]
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            found[key] = {"registers": int(regs.group(1)) if regs else None,
                          "spill_store_bytes": spill[1], "spill_load_bytes": spill[2]}
    return found


def probe_build() -> subprocess.Popen:
    """Start nvcc on ``tools/point_probe.cu`` into ``_build/point_probe.so``
    (a caller may build the path's library meanwhile)."""
    so = cuda_lib.BUILD / "point_probe.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(cuda_lib.CSRC), str(_PROBE), "-o", str(so)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


class Probe:
    """The built probe (:func:`probe_build`'s process, waited for): its
    variants by name, and ptxas's registers and spills for each."""

    def __init__(self, proc: subprocess.Popen):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {_PROBE.name}:\n{log[-6000:]}")
        self.ptxas = _probe_ptxas(log)
        self._lib = ctypes.CDLL(str(cuda_lib.BUILD / "point_probe.so"))
        self._lib.point_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p]
        self._lib.point_probe.restype = ctypes.c_int

    def __call__(self, op: str, lazy: int, group: int, minb: int, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """One variant over (p, q) as :func:`run_group` takes them."""
        out = torch.empty_like(p)
        err = self._lib.point_probe(PROBE_OP[op], lazy, group, minb, p.data_ptr(), q.data_ptr(), out.data_ptr(),
                                    p.shape[0], cuda_lib.stream(p))
        cuda_lib.check(err, "point_probe")
        return out


def variants(card: str) -> None:
    """Time the probe's variants beside the path's two regimes."""
    call = Probe(probe_build())
    dev = torch.device("cuda")
    for n in PROBE_POINTS:
        for op in OPS:
            p, q = edge_pairs(n, 29 + n.bit_length(), dev, op)
            want = run_group(op, 1, p, q)
            row = {"op": op, "n": n}
            for g in (1, KC.GROUP["few"]):  # the path's two regimes, timed here beside the variants
                assert torch.equal(run_group(op, g, p, q), want), (op, n, g)
                ms, records = kernel_ms(lambda g=g: run_group(op, g, p, q))
                row[f"path, G={g}"] = {"ms": events_ms(lambda g=g: run_group(op, g, p, q)),
                                       "kernel_ms": ms, "kernel_records": records}
            for lazy, group, minb in PROBE_VARIANTS:
                if op == "mixed" and group > 1:
                    continue
                run = lambda lazy=lazy, group=group, minb=minb: call(op, lazy, group, minb, p, q)  # noqa: E731
                assert torch.equal(run(), want), (op, n, lazy, group, minb)
                name = f"{'lazy' if lazy else 'reduced'}, G={group}" + (f", minb={minb}" if group == 1 else "")
                ms, records = kernel_ms(run)
                row[name] = {"ms": events_ms(run), "kernel_ms": ms, "kernel_records": records}
            row.update(clocks())
            print("point variants:", json.dumps(row), f"[{card}]", flush=True)
    print("point variants ptxas:", json.dumps(call.ptxas), flush=True)


def sorted_sums(card: str, rows: list, n: int = 1 << 20, c: int = 8, reps: int = 5) -> None:
    """K3 at ``n`` points and c (random scalars, 64 distinct points): its
    live entries (a lazy mixed add each in the sums stage) and its four
    stages by CUDA events (the median of ``reps`` calls), beside K12's
    many-point kernel alone at ``n`` from ``rows``, in ns a point and a
    mixed add (its live lanes, those whose q is not the sentinel)."""
    from ..hostmath import curve as hc
    from ..ops import cuda_msm_sorted as KS
    from ..ops import curve as C
    from ..ops import field as F
    from ..params import R

    dev = torch.device("cuda")
    rng = random.Random(41)
    base = [hc.g1_mul(hc.g1_generator(), rng.getrandbits(128)) for _ in range(64)]
    pa = C.host_points_to_affine(base, dev).repeat(n // 64, 1, 1).contiguous()
    sc = F.ints_to_words([rng.randrange(R) for _ in range(n)], dev)
    (w0, wg), = KS.window_groups(n, c)
    out = torch.empty((KS.windows(c), 1, KS.rows(c), 3, 8), dtype=torch.int32, device=dev)
    KS.launch(pa, sc, None, None, out, c, True, w0, wg)
    runs = [KS.launch(pa, sc, None, None, out, c, True, w0, wg, timed=True)[1] for _ in range(reps)]
    stages = {st: statistics.median(r[st] for r in runs) for st in KS.STAGES}
    live = KS.live_entries(pa, sc, c)
    k12 = [r for r in rows if r["op"] == "mixed" and r["n"] == n]
    many = k12[0]["kernel_ms"][KC.GROUP["many"]] if k12 else None
    q = edge_pairs(n, 17 + n.bit_length(), dev, "mixed")[1]  # the row's inputs: its sentinel lanes add nothing
    adds = int((~C.affine_is_infinity(q)).sum())
    rec = {"n": n, "c": c, "live_entries": live, "stages_ms": stages,
           "spread_ms": {st: [min(r[st] for r in runs), max(r[st] for r in runs)] for st in KS.STAGES},
           "sums_ns_per_entry": stages["sums"] * 1e6 / live,
           "k12_many_kernel_ms": many, "k12_live_lanes": adds,
           "k12_many_ns_per_point": None if many is None else many * 1e6 / n,
           "k12_many_ns_per_add": None if many is None else many * 1e6 / adds, **clocks()}
    print("sorted sums:", json.dumps(rec), f"[{card}]", flush=True)


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
    handle.vkzg_point_mixed_add.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p]
    handle.vkzg_point_mixed_add.restype = ctypes.c_int  # the parent's K12: one point a thread, no group
    return handle


def lazy_callers(root: pathlib.Path, card: str) -> None:
    """K5, the tails and K12 through their wrappers on the parent's library
    and on this one, in turns; their words must be equal."""
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

    def k12(p, q):
        """K12's wrapper; on the parent's library its wrapper's steps, the
        same but for the regime, through the parent's signature."""
        if cuda_lib._lib is not libs["parent"]:
            return KC.mixed_add(p, q)
        lead = torch.broadcast_shapes(p.shape[:-2], q.shape[:-2])
        p, q = p.expand(lead + p.shape[-2:]).contiguous(), q.expand(lead + q.shape[-2:]).contiguous()
        out = torch.empty_like(p)
        cuda_lib.require_cuda("curve.vkzg_point_mixed_add", out, p, q)
        err = libs["parent"].vkzg_point_mixed_add(p.data_ptr(), q.data_ptr(), out.data_ptr(), p.shape[0],
                                                  cuda_lib.stream(p))
        cuda_lib.check(err, "vkzg_point_mixed_add")
        cuda_lib.launches["K12"] += 1
        return out

    for n in (1, 32768):
        p, q = edge_pairs(n, 47, dev, "mixed")
        cases.append((f"K12@{n}", lambda p=p, q=q: k12(p, q)))
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
                ms, records = kernel_ms(fn, 5, 1 if name.startswith("K12") else None)
                rows[name][f"{turn}_{which}"] = {"ms": events_ms(fn, 5), "kernel_ms": ms, "kernel_records": records}
    finally:
        cuda_lib._lib = mine
    for name, row in rows.items():
        print("lazy callers:", name, json.dumps(row), f"[{card}]", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a checkout of the parent commit: time K5, the tails and K12 on both libraries")
    args = ap.parse_args()
    card = card_line()
    cuda_lib.lib()
    if args.parent is not None:
        lazy_callers(args.parent.resolve(), card)
    rows = regimes(card)
    variants(card)
    summarize(regime_rows(card, AGAIN_POINTS, "point regimes again:"), card, "point regimes again summary:")
    sorted_sums(card, rows)


if __name__ == "__main__":
    main()
