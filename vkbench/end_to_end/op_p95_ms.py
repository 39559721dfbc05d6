"""The 95th percentile (nearest rank) of every op's latency in the window:
from the call to the returned host objects, by the host clock."""

from vkbench.harness import percentile


def read(run):
    return 1e3 * percentile(run.latencies_s, 95) if run.latencies_s else None
