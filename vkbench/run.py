"""The benchmark of verkle_kzg_tpu_torch on NVIDIA cards.

    python3 vkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` once, from the root of a checkout, and
prints one JSON line last on standard output. Without a CUDA card, or with
fewer cards than the cell asks for, it exits with code 3 and prints no
result. Every build and cache stays inside the checkout: the port builds
its kernels into ``verkle_kzg_tpu_torch/_build/``, and any Triton or
extension cache goes under ``.vkbench_cache/``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache = REPO / ".vkbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[0] = str(REPO)

    import torch

    from vkbench import harness

    bench = harness.load_json(REPO / "BENCHMARK.json")
    entry, _, _ = harness.cell_spec(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"vkbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    return harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)


if __name__ == "__main__":
    sys.exit(main())
