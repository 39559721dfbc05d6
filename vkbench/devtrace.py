"""The traced run's device timeline: ``torch.profiler`` over a few ops, its
Chrome trace written to disk and read back: the union of the device's
operation intervals (busy), the idle gaps labelled by the benchmark's
innermost host span around them, the operations that took most time, and
the check of the profiler's kernel records against the program's launch
counters (the profiler drops records of some kernels on the H100, so the
busy time it gives is a lower bound wherever records are missing).
"""

from __future__ import annotations

import collections
import dataclasses
import gzip
import json
import pathlib
import re

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
SPAN_PREFIX = "vk."
OP_SPAN = "vk.op"
TOP = 10


@dataclasses.dataclass
class Timeline:
    kernels: list  # (identifier, start_us, dur_us)
    spans: list  # (name, start_us, dur_us)
    lo: float  # the traced window, microseconds
    hi: float

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6


def kernel_id(name: str) -> str:
    """A kernel's bare function name: no return type, namespace, template
    arguments or parameters."""
    name = re.sub(r"^void\s+", "", name.strip().replace("(anonymous namespace)::", ""))
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.rsplit("::", 1)[-1].strip()


def read(path: pathlib.Path) -> Timeline | None:
    """The device operations and the ``vk.*`` spans of a Chrome trace;
    None where it holds no ``vk.op`` span."""
    events = json.loads(path.read_text()).get("traceEvents", [])
    kernels, spans = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            kernels.append((kernel_id(name) if cat == "kernel" else cat, float(ev["ts"]), float(ev["dur"])))
        elif name.startswith(SPAN_PREFIX) and cat in ("user_annotation", "cpu_op", "python_function"):
            spans.append((name, float(ev["ts"]), float(ev["dur"])))
    ops = [s for s in spans if s[0] == OP_SPAN]
    if not ops:
        return None
    lo = min(s[1] for s in ops)
    hi = max(s[1] + s[2] for s in ops)
    return Timeline(kernels, spans, lo, hi)


def busy_intervals(tl: Timeline) -> list:
    """The union of the device operations' intervals inside the window."""
    ivs = sorted((max(ts, tl.lo), min(ts + dur, tl.hi)) for _, ts, dur in tl.kernels)
    merged: list = []
    for a, b in ivs:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(tl: Timeline) -> float:
    return sum(b - a for a, b in busy_intervals(tl)) / 1e6


def _innermost(spans: list, t: float) -> str:
    best = None
    for name, ts, dur in spans:
        if ts <= t <= ts + dur and (best is None or ts > best[1]):
            best = (name, ts)
    return best[0] if best else "host"


def idle_gaps(tl: Timeline) -> list:
    """[[span, seconds]]: the idle time inside the window, summed by the
    innermost ``vk.*`` span the host was in at each gap's middle; the
    largest first, at most ten."""
    sums: dict = collections.defaultdict(float)
    edge = tl.lo
    for a, b in busy_intervals(tl) + [[tl.hi, tl.hi]]:
        if a > edge:
            sums[_innermost(tl.spans, (edge + a) / 2)] += (a - edge) / 1e6
        edge = max(edge, b)
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]


def device_ops(tl: Timeline) -> list:
    """[[operation, seconds]]: the device's time by kernel, largest first."""
    sums: dict = collections.defaultdict(float)
    for name, ts, dur in tl.kernels:
        a, b = max(ts, tl.lo), min(ts + dur, tl.hi)
        if b > a:
            sums[name] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]


def missing_records(tl: Timeline, groups: list, launches: dict, cuda_launches: dict) -> dict:
    """{group: records missing} where the trace holds fewer kernel records
    of a group than the program counted launches of it. ``groups`` is
    ``kernel_names.json``'s list; a group ``exact`` in its CUDA launches
    takes its count from ``cuda_launches``, the others count at least one
    record a launch."""
    found = collections.Counter(name for name, _, _ in tl.kernels)
    out = {}
    for g in groups:
        counts = cuda_launches if g.get("exact") else launches
        want = sum(counts.get(k, 0) for k in g["keys"])
        have = sum(found[k] for k in g["kernels"])
        if have < want:
            out["+".join(g["keys"])] = want - have
    return out


def save_gz(src: pathlib.Path) -> pathlib.Path:
    dst = src.with_suffix(src.suffix + ".gz")
    with open(src, "rb") as f, gzip.open(dst, "wb") as g:
        g.write(f.read())
    src.unlink()
    return dst
