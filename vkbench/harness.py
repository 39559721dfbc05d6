"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything that belongs to one cell, configuration, op kind or metric is a
file of its own that this module finds by name:

* ``BENCHMARK.json`` (beside this folder): the cell's chips and which
  metrics it reports;
* ``workloads/<cell>.json``: its configuration, op kind and traffic;
* ``configs/<config>.json``: the configuration's sizes and source;
* ``traffic/<op>.py``: makes the inputs from the seed, prepares the
  program, runs one op, and asks the reference for the answers;
* ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: a reader
  ``read(run)`` each, which returns the metric or None (then the metric is
  left out of the line); a reader may declare ``PROBES``.

The window is a closed loop with one caller: the next op starts when the
previous one has returned its host objects. Inputs come from a small pool
made in set-up and are cycled.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

from . import devtrace
from .probes import Probes

ROOT = pathlib.Path(__file__).resolve().parent

#: Top-level module names that no run may load: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "verkle_kzg_tpu")


@dataclasses.dataclass
class Run:
    """What the readers read."""

    cell: str
    n_ops: int
    latencies_s: list
    window_s: float
    setup_s: float
    launches: dict
    cuda_launches: dict
    counters: dict
    probes: Probes | None = None
    timeline: devtrace.Timeline | None = None
    missing: dict = dataclasses.field(default_factory=dict)


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: pathlib.Path):
    """A module from its file, under a name made from the file's path."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    name = "vkbench_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, cell: str, root: pathlib.Path = ROOT) -> tuple:
    """(the BENCHMARK.json entry, the workload file, the configuration file)
    of ``cell``."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell not in entries:
        raise KeyError(f"BENCHMARK.json has no workload {cell!r}")
    wl = load_json(root / "workloads" / f"{cell}.json")
    cfg = load_json(root / "configs" / f"{wl['config']}.json")
    return entries[cell], wl, cfg


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def percentile(values: list, q: float) -> float:
    """The nearest-rank q-th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(cuda: bool) -> None:
    if cuda:
        import torch

        torch.cuda.synchronize()


def _card_info() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             root: pathlib.Path = ROOT, t0: float | None = None, cfg_over: dict | None = None,
             wl_over: dict | None = None, out=None, err=None, out_dir: pathlib.Path | None = None) -> int:
    """Run one cell; print the result line last on ``out``. -> exit code."""
    t0 = time.perf_counter() if t0 is None else t0
    out = out or sys.stdout
    err = err or sys.stderr
    cuda = device == "cuda"

    import torch

    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.utils import metrics as counters

    bench = load_json(root.parent / "BENCHMARK.json")
    entry, wl, cfg = cell_spec(bench, cell, root)
    wl = {**wl, **(wl_over or {})}
    cfg = {**cfg, **(cfg_over or {})}
    op = load_module(root / "traffic" / f"{wl['op']}.py")
    wanted = metrics_for(bench, cell, trace)
    folder = "layer_metrics" if trace else "end_to_end"
    readers = {m["name"]: load_module(root / folder / f"{m['name']}.py") for m in wanted}
    units = {m["name"]: m["unit"] for m in wanted}

    # ---- set-up: the library, the parameters, the inputs, the warm-up
    if cuda:
        cuda_lib.lib()
    inputs = op.make_inputs(cfg, wl, seed)
    state = op.prepare(cfg, wl, inputs, device)
    pool = len(inputs["pool"])
    for i in range(pool):
        op.run(state, i)
    if trace and cuda:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            op.run(state, 0)
            _sync(cuda)
    _sync(cuda)
    gc.collect()
    setup_s = time.perf_counter() - t0

    # ---- the window
    specs = list(getattr(op, "SPANS", [])) + [p for r in readers.values() for p in getattr(r, "PROBES", [])]
    probes = Probes(specs, cuda) if trace else None
    trace_ops = int(wl.get("trace_ops", 8)) if trace else 0
    results, latencies, failed = [], [], 0
    prof = None
    counters.reset_counters()
    cuda_lib.reset_launches()
    prof_launches = None
    if probes is not None:
        probes.__enter__()
    try:
        if trace_ops:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                          + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))
            prof.__enter__()
        start = time.perf_counter()
        deadline = start + seconds
        end = start
        i = 0
        while end < deadline:
            k = i % pool
            t_call = time.perf_counter()
            try:
                if trace:
                    with torch.profiler.record_function("vk.op"):
                        answer = op.run(state, k)
                else:
                    answer = op.run(state, k)
            except Exception:  # a failed op ends the window and the run is not correct
                traceback.print_exc(file=err)
                failed += 1
                end = time.perf_counter()
                break
            end = time.perf_counter()
            latencies.append(end - t_call)
            results.append((k, answer))
            gc.freeze()  # the answers kept for the check are no work for the collector
            i += 1
            if prof is not None and i == trace_ops:
                _sync(cuda)
                prof.__exit__(None, None, None)
                prof_launches = (dict(cuda_lib.launches), dict(cuda_lib.cuda_launches))
        window_s = end - start
    finally:
        if prof is not None and prof_launches is None:
            _sync(cuda)
            prof.__exit__(None, None, None)
            prof_launches = (dict(cuda_lib.launches), dict(cuda_lib.cuda_launches))
        if probes is not None:
            probes.__exit__(None, None, None)
    _sync(cuda)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_ops = len(results)
    print(f"vkbench: {cell} seed {seed}: {n_ops} ops in {window_s:.6f} s, set-up {setup_s:.6f} s", file=out)
    if cuda:
        print(f"vkbench: card {_card_info()}", file=err)

    run = Run(cell, n_ops, latencies, window_s, setup_s, dict(cuda_lib.launches),
              dict(cuda_lib.cuda_launches), counters.counters(), probes)
    if probes is not None:
        probes.settle()
    if prof is not None:
        out_dir = out_dir or (root.parent / "vkbench_out")
        out_dir.mkdir(parents=True, exist_ok=True)
        trace_file = out_dir / f"{cell}-{seed}.trace.json"
        prof.export_chrome_trace(str(trace_file))
        run.timeline = devtrace.read(trace_file)
        groups = load_json(root / "kernel_names.json")["groups"]
        if run.timeline is not None and cuda:
            run.missing = devtrace.missing_records(run.timeline, groups, *prof_launches)
        trace_file = devtrace.save_gz(trace_file)
        print(f"vkbench: trace of {min(trace_ops, n_ops)} ops in {trace_file}", file=err)
        if run.missing:
            print(f"vkbench: the profiler kept fewer kernel records than the program launched: {run.missing}; "
                  "busy_s is a lower bound and device_idle_pct an upper bound", file=err)
        else:
            print("vkbench: the profiler kept a record of every counted launch", file=err)

    metrics = {}
    for name, reader in readers.items():
        got = reader.read(run) if n_ops else None
        if isinstance(got, tuple):
            got, note = got
            print(f"vkbench: {name}: {note}", file=err)
        if got is None:
            print(f"vkbench: {name}: nothing to read in this run, left out", file=err)
            continue
        metrics[name] = {"value": got, "unit": units[name]}

    # ---- the check, once the program's state is freed
    gc.unfreeze()
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    expected = op.expected(cfg, wl, inputs)
    wrong = sum(1 for k, answer in results if answer != expected[k])
    wrong_pct = 100.0 * wrong / n_ops if n_ops else 100.0
    print(f"vkbench: reference {time.perf_counter() - t_ref:.3f} s; {wrong} of {n_ops} answers differ", file=err)
    correct = failed == 0 and n_ops > 0 and wrong == 0
    checks = {"wrong_pct": {"value": wrong_pct, "limit": 0}}

    bad = forbidden_modules()
    if bad:
        print(f"vkbench: the run loaded {bad}; no result", file=err)
        return 1

    device_info = {
        "platform": "gpu" if cuda else device,
        "kind": torch.cuda.get_device_name(0) if cuda else device,
        "count": int(entry["chips"]),
        "memory_peak_bytes": int(memory_peak),
    }
    line = {"correct": correct, "attempted": n_ops + failed, "failed": failed, "metrics": metrics,
            "device": device_info}
    if trace and run.timeline is not None:
        device_info["busy_s"] = devtrace.busy_s(run.timeline)
        device_info["window_s"] = run.timeline.window_s
        line["breakdown"] = {"device_ops": devtrace.device_ops(run.timeline),
                             "idle_gaps": devtrace.idle_gaps(run.timeline)}
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=err)
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return 0
