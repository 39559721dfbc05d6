"""A rehearsal of the harness on the CPU: every cell of BENCHMARK.json,
found by name, runs its op at a tiny size through the same op modules on
the port's plain versions and comes out correct; a cell and a metric added
as files are picked up with no code edited; the control and the faults a
cell can have come out not correct.

Run from the repository's root:
    python -m pytest vkbench/tests -q -o addopts= -p no:randomly
"""

import io
import json
import pathlib
import shutil

import pytest

from vkbench import control, harness

REPO = harness.ROOT.parent
BENCH = harness.load_json(REPO / "BENCHMARK.json")
SEED = 2**31 + 977

#: Tiny sizes of each configuration and op kind for the CPU.
CFG_TINY = {"ipa-d256": {"width": 8}, "kzg-blob4096": {"field_elements_per_blob": 8}}
WL_TINY = {"mp_prove": {"queries": 4, "pool": 2}, "blobs": {"blobs": 2, "pool": 2}, "fk_all": {"pool": 2}}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _tiny(cell, root=harness.ROOT):
    _, wl, _ = harness.cell_spec(harness.load_json(root.parent / "BENCHMARK.json"), cell, root)
    return CFG_TINY[wl["config"]], {**WL_TINY[wl["op"]], "trace_ops": 1}


def _run(cell, trace=False, root=harness.ROOT, tmp=None, seed=SEED):
    cfg_over, wl_over = _tiny(cell, root)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(cell, seed, 0.01, trace, device="cpu", root=root, cfg_over=cfg_over,
                          wl_over=wl_over, out=out, err=err, out_dir=tmp)
    assert rc == 0, err.getvalue()
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1]), lines, err.getvalue()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(cell):
    line, lines, err = _run(cell)
    assert line["correct"] is True, err
    assert list(line)[-1] == "checks" and line["checks"]["wrong_pct"] == {"value": 0.0, "limit": 0}
    want = {m["name"] for m in harness.metrics_for(BENCH, cell, False)}
    assert set(line["metrics"]) == want
    assert "ops in" in lines[-2]
    assert err.rstrip().splitlines()[-1].startswith("check wrong_pct")


def test_traced_run_reads_its_per_layer_metrics(tmp_path):
    cell = "ipa-d256.mp-prove-1024"
    line, _, err = _run(cell, trace=True, tmp=tmp_path)
    assert line["correct"] is True, err
    assert line["metrics"]["msm_points_per_op"]["value"] > 0
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(tmp_path.glob("*.trace.json.gz"))


def test_a_new_cell_and_metric_are_files_only(tmp_path):
    """Copy the benchmark, add a cell and a per-layer metric as files and
    BENCHMARK.json entries, and run it: no existing file is edited."""
    root = tmp_path / "vkbench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "workloads" / "ipa-d256.mp-prove-2.json").write_text(json.dumps(
        {"config": "ipa-d256", "op": "mp_prove", "queries": 2, "pool": 1, "why": "two openings"}))
    (root / "layer_metrics" / "ops_traced.py").write_text(
        "def read(run):\n    return float(run.n_ops)\n")
    bench["workloads"].append({"name": "ipa-d256.mp-prove-2", "config": "ipa-d256", "traffic": "mp-prove-2",
                               "chips": 1, "why": "two openings"})
    bench["per_layer"].append({"name": "ops_traced", "unit": "ops", "better": "higher", "source": "host_clock",
                               "layer": "protocol", "moves": "ops_per_s", "workloads": ["ipa-d256.mp-prove-2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    line, _, err = _run("ipa-d256.mp-prove-2", trace=True, root=root, tmp=tmp_path)
    assert line["correct"] is True, err
    assert line["metrics"]["ops_traced"]["value"] >= 1
    for p, raw in before.items():
        assert p.read_bytes() == raw, p


def _with_every_workload(tmp_path):
    """A copy of the benchmark whose BENCHMARK.json lists every workload
    file under ``workloads/``, those kept for later cells too."""
    root = tmp_path / "vkbench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    listed = {w["name"] for w in bench["workloads"]}
    for path in sorted((root / "workloads").glob("*.json")):
        if path.stem not in listed:
            wl = json.loads(path.read_text())
            bench["workloads"].append({"name": path.stem, "config": wl["config"], "traffic": path.stem.split(".", 1)[1],
                                       "chips": 1, "why": wl["why"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_workloads_kept_for_later_cells_stay_correct(tmp_path):
    root = _with_every_workload(tmp_path)
    later = sorted({p.stem for p in (root / "workloads").glob("*.json")} - set(CELLS))
    for cell in later:
        line, _, err = _run(cell, root=root, tmp=tmp_path)
        assert line["correct"] is True, err
        assert control.control_reading(cell, SEED, root=root, cfg_over=_tiny(cell, root)[0],
                                       wl_over=_tiny(cell, root)[1]) > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    cfg_over, wl_over = _tiny(cell)
    assert control.control_reading(cell, SEED, cfg_over=cfg_over, wl_over=wl_over) > 0


def _stale(fn):
    """A step that returns its state unchanged: each call answers with the
    answer of the call before it."""
    last = []

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        last.append(out)
        return last[-2] if len(last) > 1 else out

    return wrapper


def _half_batch(fn):
    """Half of the batch left out: the queries' first half alone."""

    def wrapper(scheme, params, queries, *a, **k):
        return fn(scheme, params, queries[: max(1, len(queries) // 2)], *a, **k)

    return wrapper


def _half_points(fn):
    """Half of the batch left out: the proofs of the first half alone."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        return out[: len(out) // 2]

    return wrapper


def _altered(fn):
    """An answer altered where it is produced: the last point read back is
    the generator."""

    def wrapper(p):
        out = fn(p)
        return out[:-1] + [(1, 2)]

    return wrapper


_FAULTS = {
    "ipa-d256.mp-prove-1024": [("verkle_kzg_tpu_torch.schemes", "prove_multiproof", _stale),
                               ("verkle_kzg_tpu_torch.schemes", "prove_multiproof", _half_batch)],
    "kzg-blob4096.fk-all-4096": [("verkle_kzg_tpu_torch.schemes.fk", "prove_all_points", _stale),
                                 ("verkle_kzg_tpu_torch.schemes.fk", "prove_all_points", _half_points)],
}
_CASES = [(cell, *f) for cell, faults in _FAULTS.items() for f in faults]
_CASES += [(cell, "verkle_kzg_tpu_torch.ops.curve", "projective_to_host_points", _altered) for cell in CELLS]


@pytest.mark.parametrize("cell,module,attr,fault", _CASES, ids=lambda v: getattr(v, "__name__", str(v)))
def test_a_broken_timed_path_is_not_correct(cell, module, attr, fault, monkeypatch):
    import importlib

    owner = importlib.import_module(module)
    monkeypatch.setattr(owner, attr, fault(getattr(owner, attr)))
    line, _, _ = _run(cell)
    assert line["correct"] is False
    assert line["checks"]["wrong_pct"]["value"] > line["checks"]["wrong_pct"]["limit"]


def test_the_command_needs_a_card():
    """Without a CUDA card the command exits non-zero and prints no result."""
    import subprocess
    import sys

    res = subprocess.run([sys.executable, "vkbench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_the_harness_alone_does_not_run(tmp_path):
    """In a directory with only BENCHMARK.json and vkbench/, it exits non-zero."""
    import subprocess
    import sys

    shutil.copytree(harness.ROOT, tmp_path / "vkbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    res = subprocess.run([sys.executable, "vkbench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
