"""``torch.profiler`` capture helpers (``verkle_kzg_tpu/utils/profiling.py``;
the reference's analogue is the criterion + pprof flamegraph wiring at
``benches/ipa.rs:161-169``).

Usage::

    from verkle_kzg_tpu_torch.utils.profiling import annotate, device_trace
    with device_trace("vkzg-trace") as prof:
        with annotate("commit"):
            IPA.commit(crs, data)
        torch.cuda.synchronize()
    print(prof.key_averages().table())

The directory gets a Chrome trace (TensorBoard's profile plugin and
Perfetto open it) with the host's calls and each CUDA kernel on the
card's timeline. Device busy time read from it is a lower bound: on the
H100 the profiler has dropped the records of long kernels (3 of the 9
stages of one G1 NTT), so time a kernel with CUDA events where it matters.
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


@contextlib.contextmanager
def annotate(name: str):
    """A named span inside a ``device_trace`` capture."""
    from torch.profiler import record_function

    with record_function(name):
        yield
