"""Time the plain field products on the CPU through Python ints and through
16-bit limbs, at batch sizes 1 .. 4096, to place ``ops/field.py::SMALL``:
the largest batch the int path takes.

    python -m verkle_kzg_tpu_torch.tools.plain_field_crossover [--threads 1]

Prints one line per size (microseconds per call of ``mont_mul16`` and
``add16``, lazy, on Fq, each path) and then the largest size at which the
int path's product is still the faster.
"""

from __future__ import annotations

import argparse
import random
import time

import torch

from ..ops import field as F
from ..params import FQ


def _us(fn, reps: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=1, help="torch CPU threads")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    rng = random.Random(0)
    keep = F.SMALL
    faster_up_to = 0
    try:
        for n in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096):
            a = F.to_limbs(F.ints_to_words([rng.randrange(2 * FQ.modulus) for _ in range(n)], "cpu"))
            b = F.to_limbs(F.ints_to_words([rng.randrange(2 * FQ.modulus) for _ in range(n)], "cpu"))
            reps = max(3, 2000 // n)
            row = {}
            for path, small in (("int", n), ("limb", 0)):
                F.SMALL = small
                row[path] = (_us(lambda: F.mont_mul16(a, b, "fq", lazy=True), reps),
                             _us(lambda: F.add16(a, b, "fq", lazy=True), reps))
            if row["int"][0] < row["limb"][0]:
                faster_up_to = n
            print(f"n = {n:5d}  mont_mul16 int {row['int'][0]:10.1f} us  limb {row['limb'][0]:10.1f} us"
                  f"  |  add16 int {row['int'][1]:10.1f} us  limb {row['limb'][1]:10.1f} us", flush=True)
    finally:
        F.SMALL = keep
    print(f"int path's product faster up to n = {faster_up_to} ({args.threads} thread(s))")


if __name__ == "__main__":
    main()
