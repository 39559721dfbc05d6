"""The control of the benchmark's check: the plain reference put in the
program's place with one guarantee of the configuration broken (every
scalar that meets a group element cut to its low 128 bits), judged by the
same comparison as a run. It has to come out not correct.

    python3 vkbench/control.py --workload <cell> --seed <n> [--seed <n> ...]

Prints, for each seed, the number compared (``wrong_pct``) beside its limit.
It needs no card: the reference is plain Python.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]


def control_reading(cell: str, seed: int, root: pathlib.Path | None = None,
                    cfg_over: dict | None = None, wl_over: dict | None = None) -> float:
    """wrong_pct of the control against the reference, over the pool."""
    from vkbench import harness

    root = root or harness.ROOT
    bench = harness.load_json(root.parent / "BENCHMARK.json")
    _, wl, cfg = harness.cell_spec(bench, cell, root)
    wl = {**wl, **(wl_over or {})}
    cfg = {**cfg, **(cfg_over or {})}
    op = harness.load_module(root / "traffic" / f"{wl['op']}.py")
    inputs = op.make_inputs(cfg, wl, seed)
    want = op.expected(cfg, wl, inputs)
    got = op.expected(cfg, wl, inputs, truncate=True)
    return 100.0 * sum(a != b for a, b in zip(got, want)) / len(want)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    sys.path[0] = str(REPO)
    for seed in args.seed:
        t = time.perf_counter()
        value = control_reading(args.workload, seed)
        print(f"control {args.workload} seed {seed}: wrong_pct {value} (limit 0), {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
