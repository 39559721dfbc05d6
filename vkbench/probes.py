"""Probes: wrappers that the traced run puts around the names where the
program's callers look them up, so that the benchmark's own files, not the
program, place the spans and the CUDA events.

A probe is a dict: ``module`` (an importable name), ``attr`` (a name in
it, or ``Class.name``, or ``alias.name`` where ``alias`` is a module the
first one imported: that one alias is then proxied, so the name changes
for that module's callers alone), ``tag`` (the span is ``vk.<tag>``),
and optionally ``events`` (record CUDA events around each call) and
``keep`` (a function of the call's arguments whose value is kept with the
call, for the readers).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import types

from torch.profiler import record_function


@dataclasses.dataclass
class Call:
    tag: str
    start: object = None  # torch.cuda.Event
    end: object = None
    kept: object = None
    ms: float | None = None


class _Proxy(types.ModuleType):
    """A module seen through one replaced attribute."""

    def __init__(self, inner, name, value):
        super().__init__(inner.__name__)
        self._inner = inner
        setattr(self, name, value)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class Probes:
    """Installs probes for the duration of a ``with`` block; ``calls``
    collects one :class:`Call` per call of an ``events`` probe."""

    def __init__(self, specs: list, cuda: bool):
        self.specs = list(specs)
        self.cuda = cuda
        self.calls: list = []
        self._undo: list = []
        self._depth: dict = {}

    def _wrap(self, fn, spec):
        tag = spec["tag"]
        timed = spec.get("events") and self.cuda
        keep = spec.get("keep")

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            outer = self._depth.get(tag, 0) == 0
            self._depth[tag] = self._depth.get(tag, 0) + 1
            try:
                with record_function(f"vk.{tag}"):
                    if not (outer and spec.get("events")):
                        return fn(*args, **kwargs)
                    call = Call(tag)
                    if timed:
                        import torch

                        call.start = torch.cuda.Event(enable_timing=True)
                        call.end = torch.cuda.Event(enable_timing=True)
                        call.start.record()
                    out = fn(*args, **kwargs)
                    if timed:
                        call.end.record()
                    if keep is not None:
                        call.kept = keep(*args, **kwargs)
                    self.calls.append(call)
                    return out
            finally:
                self._depth[tag] -= 1

        return wrapper

    def __enter__(self):
        for spec in self.specs:
            mod = importlib.import_module(spec["module"])
            head, _, name = spec["attr"].rpartition(".")
            if not head:
                original = getattr(mod, name)
                setattr(mod, name, self._wrap(original, spec))
                self._undo.append((mod, name, original))
                continue
            owner = getattr(mod, head)
            if isinstance(owner, types.ModuleType):
                proxy = _Proxy(owner, name, self._wrap(getattr(owner, name), spec))
                self._undo.append((mod, head, owner))
                setattr(mod, head, proxy)
            else:
                raw = owner.__dict__[name]
                fn = raw.__func__ if isinstance(raw, staticmethod) else raw
                wrapped = self._wrap(fn, spec)
                setattr(owner, name, staticmethod(wrapped) if isinstance(raw, staticmethod) else wrapped)
                self._undo.append((owner, name, raw))
        return self

    def __exit__(self, *exc):
        for obj, name, original in reversed(self._undo):
            setattr(obj, name, original)
        self._undo.clear()
        return False

    def settle(self) -> None:
        """Read every recorded pair of events (after a synchronize)."""
        for call in self.calls:
            if call.start is not None and call.ms is None:
                call.ms = call.start.elapsed_time(call.end)

    def by_tag(self, tag: str) -> list:
        return [c for c in self.calls if c.tag == tag]
