"""The MSMs' share of their roofline: the least time one H100 needs for the
MSM work of the window's ops (``work.py``: a bucket method over each call's
nonzero scalars, at the window that needs the fewest operations; the
scalars are kept by reference and counted once the window has closed) over the
device time of the ``ops.msm.msm_auto`` calls, by CUDA events recorded on
the stream around each call (the program's callers look it up as
``M.msm_auto``)."""

from vkbench import work

PROBES = [{
    "module": "verkle_kzg_tpu_torch.ops.msm", "attr": "msm_auto", "tag": "msm", "events": True,
    "keep": lambda points, scalars, *a, **k: scalars,
}]


def read(run):
    calls = run.probes.by_tag("msm") if run.probes else []
    if not calls or any(c.ms is None for c in calls):
        return None
    least, by = 0.0, set()
    for c in calls:
        live = int((c.kept != 0).any(-1).sum())
        s, b = work.least_seconds(work.msm_fmuls(live), work.msm_bytes(live))
        least += s
        by.add(b)
    device_s = sum(c.ms for c in calls) / 1e3
    share = work.share_pct(least, device_s)
    return share, f"{len(calls)} calls, least {least:.6f} s (bound by {', '.join(sorted(by))}) of {device_s:.6f} s"
