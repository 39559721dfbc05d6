"""The program's spans (``utils/metrics.span``) on the CPU: a span's self
time is its wall time less the spans opened inside it; it opens a
``record_function`` only while the profiler runs, and then its
``vk.<layer>.<site>`` event is in the exported trace; a tiny multiproof
and a tiny FK prove record spans of all four layers; and the benchmark's
traced run reads the four per-layer metrics from them.

The two ops run through the benchmark's harness (``vkbench/harness.py``)
in fresh interpreters, one a cell, side by side: the harness refuses to
report from a process that has loaded JAX, as this one has, and the tiny
ops' plain versions take seconds each. The harness's traced run keeps
its profiler off (``trace_ops`` 0) here: over the plain versions' tensor
ops it would take a minute a cell, and the spans' profiler events are
checked on their own below."""

import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from verkle_kzg_tpu_torch.utils import metrics
from verkle_kzg_tpu_torch.utils.metrics import span
from verkle_kzg_tpu_torch.utils.profiling import device_trace

REPO = pathlib.Path(__file__).resolve().parents[1]
LAYERS = ("protocol", "orchestration", "kernels", "wait")
METRICS = ("host_ms_per_op.protocol", "host_ms_per_op.orchestration", "host_ms_per_op.kernels", "wait_ms_per_op")
SEED = 2**31 + 977

#: Each cell at the benchmark rehearsal's tiny size: a width-8 vector opened
#: at 4 points; a blob of 8 elements.
CELLS = {
    "ipa-d256.mp-prove-1024": ({"width": 8}, {"queries": 4, "pool": 1, "trace_ops": 0}),
    "kzg-blob4096.fk-all-4096": ({"field_elements_per_blob": 8}, {"pool": 1, "trace_ops": 0}),
}

_RUN = """
import io, json, sys
import torch
torch.set_num_threads(1)
from vkbench import harness
from verkle_kzg_tpu_torch.utils import metrics
cell, cfg_over, wl_over, seed = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3]), int(sys.argv[4])
out, err = io.StringIO(), io.StringIO()
rc = harness.run_cell(cell, seed, 0.01, True, device="cpu", cfg_over=cfg_over, wl_over=wl_over, out=out, err=err)
print(json.dumps({"rc": rc, "out": out.getvalue(), "err": err.getvalue(), "counters": metrics.counters()}))
"""


def _counter(name: str) -> float:
    return metrics.counters().get(name, 0.0)


def test_self_time_is_wall_time_less_the_spans_inside():
    metrics.reset_counters()
    inner = span("kernels", "test.inner")

    @span("protocol", "test.outer")
    def outer(depth):
        time.sleep(0.01)
        with inner:
            time.sleep(0.02)
            if depth:
                outer(depth - 1)  # a span may recurse

    outer(0)
    got = metrics.counters()
    assert got["span.protocol.test.outer.calls"] == 1 and got["span.kernels.test.inner.calls"] == 1
    assert got["span.kernels.test.inner.self_s"] == got["span.kernels.test.inner.s"] >= 0.02
    assert got["span.protocol.test.outer.self_s"] == pytest.approx(
        got["span.protocol.test.outer.s"] - got["span.kernels.test.inner.s"], abs=1e-9)
    assert 0.01 <= got["span.protocol.test.outer.self_s"] < got["span.protocol.test.outer.s"]

    metrics.reset_counters()
    t0 = time.perf_counter()
    outer(1)
    wall = time.perf_counter() - t0
    got = metrics.counters()
    assert got["span.protocol.test.outer.calls"] == 2 and got["span.kernels.test.inner.calls"] == 2
    # every second of the outermost call is the self time of one span
    total = sum(v for k, v in got.items() if k.endswith(".self_s"))
    assert wall - 0.005 < total <= wall
    assert metrics.innermost() is None


def test_a_span_opens_no_record_function_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    with span("wait", "test.read"):
        assert metrics.innermost() == "vk.wait.test.read"
    assert opened == []
    assert _counter("span.wait.test.read.calls") >= 1


def test_the_trace_holds_the_spans_on_the_profilers_timeline(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        with span("protocol", "test.prove"):
            with span("orchestration", "test.msm"):
                torch.arange(1000).sum()
            metrics.wait_for("test.read", torch.arange(10).tolist)
    events = json.loads(next(tmp_path.glob("*.json")).read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("ph") == "X" and e["name"].startswith("vk.")}
    assert set(spans) == {"vk.protocol.test.prove", "vk.orchestration.test.msm", "vk.wait.test.read"}
    outer = spans["vk.protocol.test.prove"]
    for name in ("vk.orchestration.test.msm", "vk.wait.test.read"):  # nested on the one clock
        assert outer["ts"] <= spans[name]["ts"] and spans[name]["ts"] + spans[name]["dur"] <= outer["ts"] + outer["dur"]
    assert {"vk.protocol.test.prove", "vk.wait.test.read"} <= {e.key for e in prof.key_averages()}


@pytest.fixture(scope="module")
def harness_runs():
    """Each cell's traced run in a fresh interpreter, both at once:
    {cell: (the result line, stderr, the counters after the run)}."""
    procs = {
        cell: subprocess.Popen([sys.executable, "-c", _RUN, cell, json.dumps(cfg), json.dumps(wl), str(SEED)],
                               cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cell, (cfg, wl) in CELLS.items()
    }
    runs = {}
    for cell, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        got = json.loads(out.strip().splitlines()[-1])
        assert got["rc"] == 0, got["err"][-4000:]
        runs[cell] = (json.loads(got["out"].strip().splitlines()[-1]), got["err"], got["counters"])
    return runs


@pytest.mark.parametrize("cell", CELLS)
def test_an_op_records_spans_of_every_layer(harness_runs, cell):
    _, err, counters = harness_runs[cell]
    calls = {layer: sum(v for k, v in counters.items() if k.startswith(f"span.{layer}.") and k.endswith(".calls"))
             for layer in LAYERS}
    assert all(calls[layer] > 0 for layer in LAYERS), calls
    top = "span.protocol.multiproof.prove" if cell.startswith("ipa") else "span.protocol.fk.prove_all_points"
    assert counters[f"{top}.calls"] == 1  # the window's one op
    # the outermost span's wall time is the self time of every span in it
    total = sum(v for k, v in counters.items() if k.endswith(".self_s"))
    assert total == pytest.approx(counters[f"{top}.s"], rel=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_run_reads_the_four_host_metrics(harness_runs, cell):
    line, err, counters = harness_runs[cell]
    assert line["correct"] is True, err
    got = {name: line["metrics"][name]["value"] for name in METRICS}
    assert all(line["metrics"][name]["unit"] == "ms" for name in METRICS)
    assert all(v >= 0 for v in got.values()) and got["host_ms_per_op.kernels"] > 0, got
    total_ms = 1e3 * sum(v for k, v in counters.items() if k.endswith(".self_s"))
    assert sum(got.values()) == pytest.approx(total_ms, rel=1e-6)
    assert all(f"vkbench: {name}: " in err for name in METRICS)
