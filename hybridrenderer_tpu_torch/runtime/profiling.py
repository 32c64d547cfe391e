"""The renderer's tracer: spans on the host and on the device (the
reference engine's declared GPU timestamp queries, RenderGraph.h:319-343,
made real inside the captured frame).

A renderer made with ``trace=True`` holds a ``Tracer``; otherwise it
holds ``OFF``, whose spans are one shared no-op context, so that an
untraced renderer records nothing and captures the graphs it always
did. Tracing is fixed for the renderer's life: it changes what the
captured graphs hold.

* Host spans (``host(name)``): while a profiler runs, a
  ``torch.profiler.record_function`` named ``hr.<name>``, on its
  timeline beside the device operations; and always its host ms,
  summed by name.
* Device spans (``device(name)``): a pair of CUDA events on the current
  stream. Under a capture they are external events, so they become
  event-record nodes of the graph and time the span on the device clock
  at every replay; the renderer reads a frame graph's pairs while the
  host waits for the frame, and the commit graph's before its next
  replay (``replayed``, ``flush``). Each pass is one (``run_pass``, the render
  graph's hook), the frame body another (``frame``), the scene update
  and refit and the commit graph's copies others. On the CPU the same
  spans are timed with the host clock and ``totals()["clock"]`` says
  so.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function

NULL = contextlib.nullcontext()
_NO_SPANS = contextlib.nullcontext(())
PREFIX = "hr."


class _Off:
    """The tracer of an untraced renderer: every span is ``NULL``."""

    run_pass = None

    def host(self, name):
        return NULL

    def device(self, name):
        return NULL

    def collecting(self):
        return _NO_SPANS

    def replayed(self, spans):
        pass

    def flush(self):
        pass

    def totals(self) -> dict:
        return {}

    def reset(self):
        pass


OFF = _Off()


def _add(sums, name, ms):
    s = sums.setdefault(name, [0.0, 0])
    s[0] += ms
    s[1] += 1


class Tracer:
    """Spans of one renderer on ``device`` (see the module)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.host_ms = {}            # name → [ms, count]
        self.device_ms = {}
        self._pending = []           # (name, start, end) events to read
        self._collect = None         # a capture's event pairs

    @contextlib.contextmanager
    def host(self, name):
        t0 = time.perf_counter()
        try:
            # a record_function costs ~10 us; only a profiler reads it
            with record_function(PREFIX + name) \
                    if torch.autograd._profiler_enabled() else NULL:
                yield
        finally:
            _add(self.host_ms, name, 1e3 * (time.perf_counter() - t0))

    @contextlib.contextmanager
    def device(self, name):
        if not self.cuda:
            t0 = time.perf_counter()
            yield
            _add(self.device_ms, name, 1e3 * (time.perf_counter() - t0))
            return
        start, end = (torch.cuda.Event(enable_timing=True, external=True)
                      for _ in range(2))
        start.record()
        yield
        end.record()
        (self._pending if self._collect is None
         else self._collect).append((name, start, end))

    def run_pass(self, p, registry, ctx):
        """The render graph's ``run_pass`` hook: each pass a device
        span under its name."""
        with self.device(p.name):
            return p.fn(registry, ctx)

    @contextlib.contextmanager
    def collecting(self):
        """Device spans opened inside go to the list it yields (a
        capture's, read at each replay through ``replayed``)."""
        outer, self._collect = self._collect, []
        try:
            yield self._collect
        finally:
            self._collect = outer

    def replayed(self, spans):
        """A graph holding ``spans`` (from ``collecting``) was launched:
        its events are read at the next ``flush``."""
        self._pending.extend(spans)

    def flush(self):
        """Reads every launched pair, each as soon as its end event has
        run: while a frame runs, its first spans are read as its later
        ones run."""
        pending, self._pending = self._pending, []
        for name, start, end in pending:
            end.synchronize()
            _add(self.device_ms, name, start.elapsed_time(end))

    def totals(self) -> dict:
        """{clock: "device" or "host" (the device spans' clock), device:
        {span: (ms, count)}, host: {span: (ms, count)}}; waits for the
        spans launched."""
        self.flush()
        return {"clock": "device" if self.cuda else "host",
                "device": {k: tuple(v) for k, v in self.device_ms.items()},
                "host": {k: tuple(v) for k, v in self.host_ms.items()}}

    def reset(self):
        """Clears the sums (spans launched and not read are dropped)."""
        self._pending.clear()
        self.host_ms.clear()
        self.device_ms.clear()

