"""Spans at the layer boundaries of the port's hot paths.

`traced(name, counts)` makes every call of a function a span named `name`.
A span is in one of three states:

- off, the default: the call goes straight through after one test of two
  flags. Nothing is allocated, and nothing reaches the profiler or the card;
- a ``torch.profiler`` session is running and no recorder is on: the call
  runs inside a fast record-function range of the span's name. The range is
  a host operation of the profiler's trace, on its clock and around the
  CUDA runtime calls the span makes. Unlike ``torch.profiler.record_function``
  it is not a user annotation, so Kineto derives no device-side
  ``gpu_user_annotation`` event from it and the trace's device time holds
  device work alone;
- a `Recorder` is on (``with recording() as rec:``): the call appends a
  `Span` to ``rec.spans`` and opens no range. Times are taken with
  ``time.perf_counter_ns`` and moved to the epoch nanoseconds of Kineto's
  ``start_ns`` by one anchor taken when the recorder starts, so recorded
  spans can be laid over a trace of the device alone.

`counts(result, *args, **kwargs)` returns the span's count attributes
(whole numbers the call's shapes give); it runs only under a recorder.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as autograd_profiler

NAMES: set[str] = set()          # every span name the program declares

# The recorder that is on, if any. The spans sit deep in the program's call
# tree, where no caller could pass one, so they find it here.
_recorder: Recorder | None = None


@dataclasses.dataclass
class Span:
    """One recorded call: epoch ns on Kineto's clock, the index of the
    enclosing span in the recorder's list (-1 for an outermost one), the
    index of the outermost span it lies under (its unit: one request, one
    block, one sweep call) and its count attributes."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    unit: int
    counts: dict


class Recorder:
    """Spans of the thread that started it, in the order they opened."""

    def __init__(self):
        self.spans: list[Span] = []
        self.units = 0
        self.thread = threading.get_ident()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self._open: list[int] = []

    def run(self, name, counts, fn, args, kwargs):
        parent = self._open[-1] if self._open else -1
        if parent < 0:
            unit, self.units = self.units, self.units + 1
        else:
            unit = self.spans[parent].unit
        span = Span(name, 0, 0, parent, unit, {})
        self._open.append(len(self.spans))
        self.spans.append(span)
        span.start_ns = time.perf_counter_ns() + self.offset_ns
        try:
            out = fn(*args, **kwargs)
        finally:
            span.end_ns = time.perf_counter_ns() + self.offset_ns
            self._open.pop()
        if counts is not None:
            span.counts = counts(out, *args, **kwargs)
        return out


@contextlib.contextmanager
def recording():
    """Turn a new `Recorder` on for the block and yield it."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a span recorder is already on")
    _recorder = Recorder()
    try:
        yield _recorder
    finally:
        _recorder = None


def traced(name: str, counts=None):
    """Decorator: each call of the function is a span named `name`."""
    NAMES.add(name)

    def wrap(fn):
        @functools.wraps(fn)
        def span(*args, **kwargs):
            if _recorder is None and not autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            rec = _recorder
            if rec is None or rec.thread != threading.get_ident():
                with _RecordFunctionFast(name):
                    return fn(*args, **kwargs)
            return rec.run(name, counts, fn, args, kwargs)

        return span

    return wrap
