"""Points an op hands to the MSMs: the program's ``msm.*.points`` counters
(``utils/metrics.py``, recorded by ``ops/msm.py``'s entry points) over every
op of the traced run's window."""

KEYS = ("msm.single.points", "msm.batched.points", "msm.fixed_base.points")


def read(run):
    total = sum(run.counters.get(k, 0) for k in KEYS)
    return total / run.n_ops if total else None
