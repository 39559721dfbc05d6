"""The program's kernel launches an op, summed over its counters
(``ops/cuda_lib.py``'s ``launches``: one count a K-kernel call, a sorted
accumulation one whatever CUDA launches it makes), over every op of the
traced run's window."""


def read(run):
    total = sum(run.launches.values())
    return total / run.n_ops if total else None
