"""100 x (1 - the union of the device's operation intervals / the traced
window), from ``torch.profiler`` over the window's first ops. Where the
profiler kept fewer kernel records than the program launched (the run says
so), this is an upper bound."""

from vkbench import devtrace


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    value = 100.0 * (1.0 - devtrace.busy_s(tl) / tl.window_s)
    if run.missing:
        return value, f"an upper bound: records missing {run.missing}"
    return value
