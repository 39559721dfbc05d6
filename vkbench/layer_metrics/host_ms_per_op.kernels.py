"""Host milliseconds an op on the kernels' host side (``ops/cuda_*.py``,
from a wrapper's entry through its checks, planning and launch; a site a
launch key): the self time of the program's ``span.kernels.*`` spans,
which leaves out the spans opened inside them and the host's waits for the
card, over every op of the traced run's window (``vkbench/spans.py``)."""

from vkbench.spans import layer_self_ms


def read(run):
    return layer_self_ms(run, "kernels")
