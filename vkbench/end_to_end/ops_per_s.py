"""Ops completed over the whole window, by the host clock."""


def read(run):
    return run.n_ops / run.window_s if run.n_ops and run.window_s > 0 else None
