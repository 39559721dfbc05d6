"""Lightweight host-side observability: counters and spans.

The reference has no metrics at all (SURVEY.md §5: one println in a bench).
Here the protocol layers record the work they dispatch — MSM sizes, batch
shapes, the queries of a multiproof — so production deployments can
account for device work without profiling overhead. Counters are
process-local and explicitly reset; recording costs a dict update.

Spans time the host at every layer boundary (:func:`span`). A span names
its layer and its site; each call adds, in the same registry,

* ``span.<layer>.<site>.calls``: one;
* ``span.<layer>.<site>.s``: its wall seconds, the spans inside it included;
* ``span.<layer>.<site>.self_s``: those seconds less the spans opened
  inside it,

so the ``self_s`` of every span sum to the wall time of the outermost
ones. The layers are the port's: ``protocol`` (``schemes/``,
``fiatshamir/``, ``poly/``, ``hostmath/``), ``orchestration`` (``ops/msm.py``,
``ops/ntt.py``, ``ops/field.py``, ``ops/curve.py``, ``convert.py``),
``kernels`` (the host side of ``ops/cuda_*.py``, a site a launch key of
``cuda_lib.launches``) and ``wait``: the calls that block the host until
the card is done (a device -> host read, an upload from pageable memory),
each through :func:`wait_for`, so that the time the host waits for the card
leaves the self time of the layer it waits in. While ``torch.profiler``
runs, a span also opens ``record_function("vk.<layer>.<site>")``, which
puts it on the profiler's timeline beside the kernels; otherwise it opens
none. No span sits inside a loop over queries, elements or points.
"""

from __future__ import annotations

import collections
import functools
from time import perf_counter_ns

from torch.autograd import _profiler_enabled

_COUNTERS: dict = collections.defaultdict(float)

#: The open spans of this process, innermost last: [span, start ns,
#: nanoseconds of the spans closed inside it, its record_function or None].
_STACK: list = []
_SPANS: dict = {}


def record(name: str, value: float = 1.0) -> None:
    """Accumulate ``value`` into counter ``name``."""
    _COUNTERS[name] += value


def counters() -> dict:
    """Snapshot of all counters."""
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()


class _Span:
    __slots__ = ("name", "_calls", "_s", "_self_s")

    def __init__(self, layer: str, site: str):
        key = f"span.{layer}.{site}"
        self.name = f"vk.{layer}.{site}"
        self._calls, self._s, self._self_s = key + ".calls", key + ".s", key + ".self_s"

    def __enter__(self):
        rf = None
        if _profiler_enabled():
            from torch.profiler import record_function

            rf = record_function(self.name)
            rf.__enter__()
        _STACK.append([self, perf_counter_ns(), 0, rf])
        return self

    def __exit__(self, *exc):
        end = perf_counter_ns()
        _, start, inner, rf = _STACK.pop()
        total = end - start
        if _STACK:
            _STACK[-1][2] += total
        _COUNTERS[self._calls] += 1
        _COUNTERS[self._s] += total * 1e-9
        _COUNTERS[self._self_s] += (total - inner) * 1e-9
        if rf is not None:
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return wrapper


def span(layer: str, site: str) -> _Span:
    """The span of ``site`` in ``layer``: a context manager, or a decorator
    that runs the function inside it. One object a (layer, site), kept;
    it holds no state of a call, so it nests and recurses."""
    s = _SPANS.get((layer, site))
    if s is None:
        s = _SPANS[(layer, site)] = _Span(layer, site)
    return s


def wait_for(site: str, call, *args):
    """``call(*args)``, a call that blocks the host until the card is done
    (``t.cpu``, ``t.to`` from host memory, ``int`` of a device tensor),
    inside ``span("wait", site)``. The same span on the CPU, where it
    waits for nothing."""
    with span("wait", site):
        return call(*args)


def innermost() -> str | None:
    """The name (``vk.<layer>.<site>``) of the innermost open span, or None."""
    return _STACK[-1][0].name if _STACK else None
