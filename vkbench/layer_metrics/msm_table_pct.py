"""The share of the single MSMs that ran over a fixed-base table: 100 x the
program's ``msm.table.calls`` counter (``ops/msm.py::msm_auto``, one a call
that takes kernel FBMSM, zero a call that does not) over its
``span.orchestration.msm_auto.calls``, over every op of the traced run's
window. A program without the counter records none, and the reader then
reads nothing; a program that has it but takes no table reads 0."""


def read(run):
    table = run.counters.get("msm.table.calls")
    calls = run.counters.get("span.orchestration.msm_auto.calls")
    if table is None or not calls:
        return None
    return 100.0 * table / calls, f"{table / run.n_ops:.1f} of {calls / run.n_ops:.1f} msm_auto calls an op"
