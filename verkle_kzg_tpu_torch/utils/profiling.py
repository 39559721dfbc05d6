"""``torch.profiler`` capture (``verkle_kzg_tpu/utils/profiling.py``; the
reference's analogue is the criterion + pprof flamegraph wiring at
``benches/ipa.rs:161-169``).

Usage::

    from verkle_kzg_tpu_torch.utils.profiling import device_trace
    with device_trace("vkzg-trace") as prof:
        IPA.commit(crs, data)
        torch.cuda.synchronize()
    print(prof.key_averages().table())

The directory gets a Chrome trace (TensorBoard's profile plugin and
Perfetto open it) with the host's calls and each CUDA kernel on the
card's timeline. The program's spans (``utils/metrics.span``) appear in it
as ``vk.<layer>.<site>`` events on the same clock. On the H100 the
benchmark's traced runs of both cells have kept a record of every kernel
launch that ``ops/cuda_lib.launches`` counted, since kernels are named
without their anonymous namespace; earlier smoke readings that lacked
some records have no cause shown. Compare the kernel records with the
launch counters (``vkbench/devtrace.py`` does) before reading device busy
time from a trace.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile everything inside the block, host and CUDA activity, and
    write the trace into ``log_dir``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], on_trace_ready=tensorboard_trace_handler(log_dir)
    ) as prof:
        yield prof
