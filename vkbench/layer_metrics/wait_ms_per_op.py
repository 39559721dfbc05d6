"""Milliseconds an op the host waits for the card: the self time of the
program's ``span.wait.*`` spans, each around exactly one blocking call (a
device -> host read, an upload from pageable memory, ``int`` of a device
tensor), over every op of the traced run's window (``vkbench/spans.py``)."""

from vkbench.spans import layer_self_ms


def read(run):
    return layer_self_ms(run, "wait")
