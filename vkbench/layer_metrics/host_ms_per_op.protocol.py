"""Host milliseconds an op in the protocol layer (``schemes/``,
``fiatshamir/``, ``poly/``, ``hostmath/``): the self time of the program's
``span.protocol.*`` spans, which leaves out the spans opened inside them
and the host's waits for the card, over every op of the traced run's
window (``vkbench/spans.py``)."""

from vkbench.spans import layer_self_ms


def read(run):
    return layer_self_ms(run, "protocol")
