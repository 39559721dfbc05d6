"""What the benchmark loads: no run imports JAX or the JAX package (the top
level of each module's name compared whole), and the reference imports
nothing of the program."""

import ast
import json
import pathlib
import subprocess
import sys

from vkbench import harness

REPO = harness.ROOT.parent

_DRIVE = """
import io, json, sys
from vkbench import harness
out = io.StringIO()
rc = harness.run_cell({cell!r}, 5, 0.01, False, device="cpu", cfg_over={cfg!r}, wl_over={wl!r},
                      out=out, err=io.StringIO())
print(json.dumps({{"rc": rc, "line": out.getvalue().strip().splitlines()[-1],
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_run_loads_no_jax():
    code = _DRIVE.format(cell="kzg-blob4096.fk-all-4096", cfg={"field_elements_per_blob": 4}, wl={"pool": 1})
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0 and json.loads(got["line"])["correct"] is True
    assert not set(got["top"]) & set(harness.FORBIDDEN), got["top"]
    assert "verkle_kzg_tpu_torch" in got["top"]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import vkbench.reference.ipa, vkbench.reference.kzg; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    top = set(ast.literal_eval(res.stdout.strip()))
    assert not top & {"verkle_kzg_tpu_torch", "torch", "numpy", *harness.FORBIDDEN}, top


def test_no_source_names_jax_or_the_jax_package():
    for path in harness.ROOT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)
                assert name.split(".")[0] not in ("bench", "benchmarks"), (path, name)
