"""The captured frame: the rule by which ``Renderer`` and
``parallel.sharded.ShardedRenderer`` run a frame function through CUDA
graphs, one set for each key, as the reference keeps one jitted program
for each.

A key's first use runs eagerly, as the frame it is, so that every lazy
set-up (kernel loads, cached constants, the refit's level walk, the
exact tile lists that size the binning capacity) happens outside a
capture; the graph is captured right after it, and every later use
replays. A frame that cannot be captured raises, with the renderer as it
was; on the card nothing falls back to eager execution unless the
renderer is made with ``capture=False``.

Each key holds two graphs: the frame, which reads the renderer's buffers
and writes only memory of its own graph pool, and the commit, which
copies the frame's results into the buffers; no replay reads a buffer
that it writes (the reference donates its state instead). Between the
two the host reads the tile entries the frame's rasters needed. A frame
that needed more than the binning capacity is not committed: its key is
captured again at a capacity sized from what it needed, and the frame
replayed (or, with ``bin_capacity`` fixed, it raises, and the history is
left as it was; ``recaptures`` counts these).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from .. import native
from . import profiling
from .log import core as _log

# a captured frame bins into this many times the tile entries its key's
# first (eager) frame, or an overflowed replay, needed, plus the slack;
# CapturedRenderer.bin_capacity fixes it instead
BIN_HEADROOM = 2
BIN_SLACK = 1 << 16


@dataclasses.dataclass
class Result:
    """What a frame function returns: the image, the frame stats, the
    most tile entries a raster needed, one for each binning (a shard's;
    None without a frame), and (renderer buffer, new value) trees to
    commit."""
    out: Any
    stats: Any
    needed: Any
    commits: list


@dataclasses.dataclass
class Graph:
    """A key's captured frame: ``replay()`` replays its frame graphs,
    ``commit()`` its copy-back graphs."""
    replay: Any
    commit: Any
    result: Result       # the frame graphs' outputs, in their pools
    capacity: Any        # the tile entries each binning may use (a tuple)
    launches: dict = dataclasses.field(default_factory=dict)  # one replay's
    keep: tuple = ()     # inputs the graph reads that the key names by id
    spans: tuple = ((), ())  # the device spans of replay() and commit()


class CapturedRenderer:
    """What both renderers share: the captured-frame rule (``run_key``)
    and the state it keeps. ``capture``: replay CUDA graphs (the default
    where every one of ``devices`` is a CUDA device); False runs every
    frame eagerly. ``trace``: time the renderer's work in spans
    (runtime/profiling), for the renderer's life. A subclass renders a
    frame with ``render``."""

    def __init__(self, devices, capture=None, trace=False):
        cuda = all(d.type == "cuda" for d in devices)
        self.capture = cuda if capture is None else bool(capture)
        if self.capture and not cuda:
            raise ValueError("CUDA graphs need every device of the frame "
                             "to be a CUDA device")
        self.tracing = profiling.Tracer(devices[0]) if trace \
            else profiling.OFF
        # tile entries each captured raster may use, fixed (an overflow
        # raises); None: sized per binning and key, grown on an overflow
        self.bin_capacity = None
        self.graphs = {}         # key → Graph
        self.capture_ms = {}     # each key's capture time, host clock
        self.recaptures = 0      # keys captured again on a bin overflow
        self.frame_count = 0

    def render_np(self, cam_state, **kw) -> np.ndarray:
        return self.render(cam_state, **kw).cpu().numpy()

    def reset_history(self):
        """Drop all carried history: the next frame is a first frame. The
        graphs are kept, as the reference keeps its jitted programs: the
        first frame's graph reads no history."""
        self.frame_count = 0

    def run_key(self, key, eager, capture, keep=()):
        """At the key's first use ``eager(undo)`` → (Result, (destination,
        source) pairs) runs the frame, filling ``undo``; with ``capture``
        on, the key is then captured by ``capture(capacity)`` → Graph, a
        capacity for each binning (the result's ``needed``: one for each
        shard); on a failure ``undo`` is taken back and the error raised.
        Only then are the pairs copied. Later uses replay the graph (see
        _replay_key). → (the result, whether it is the graph's). The
        spans the tracer launched before are read first."""
        self.tracing.flush()
        graph = self.graphs.get(key)
        fixed = self.bin_capacity
        if graph is not None and graph.capacity is not None \
                and fixed is not None \
                and any(c != fixed for c in graph.capacity):
            del self.graphs[key]              # bin_capacity was changed
            graph = None
        if graph is not None:
            return self._replay_key(key, graph, capture), True
        undo = []
        res, pairs = eager(undo)
        if self.capture:
            capacity = None if res.needed is None else tuple(
                _capacity_for(int(n)) if fixed is None else fixed
                for n in res.needed)
            try:
                self._capture_key(key, capture, capacity, keep)
            except BaseException:
                # nothing committed: the renderer is left as it was
                for fn in reversed(undo):
                    fn()
                raise
        with self.tracing.device("commit"):
            for dst, src in pairs:
                dst.copy_(src)
        return res, False

    def _capture_key(self, key, capture, capacity, keep):
        """``capture(capacity)`` into ``graphs[key]``; the capture's
        launch counts are taken back, and each replay adds them again."""
        t0 = time.perf_counter()
        before = native.counts()
        try:
            graph = capture(capacity)
        except Exception as e:
            raise RuntimeError(f"{_key_name(key)}: the frame cannot be "
                               f"captured into a CUDA graph: {e}") from e
        finally:
            after = native.counts()
            native.set_counts(before)
        graph.launches = {n: (after[n][0] - before[n][0],
                              after[n][1] - before[n][1]) for n in after}
        graph.keep = keep
        self.graphs[key] = graph
        self.capture_ms[_key_name(key)] = ms = \
            1e3 * (time.perf_counter() - t0)
        _log().info("frame graph captured", key=_key_name(key),
                    ms=round(ms, 1), bin_capacity=capacity)
        return graph

    def _replay_key(self, key, graph, capture):
        """Replays the key's frame; a frame whose tile lists overflowed a
        capacity is captured again, every binning at a capacity sized
        from what it needed where it overflowed, and replayed (with
        bin_capacity fixed, it raises), and only then committed."""
        tracing = self.tracing
        needed = self._replay_frame(graph)
        if needed is not None and _overflowed(needed, graph.capacity):
            if self.bin_capacity is not None:
                raise RuntimeError(
                    f"{_key_name(key)}: the frame's tile lists need "
                    f"{needed} entries, above the fixed binning capacity "
                    f"{self.bin_capacity}; nothing was committed. Set "
                    f"{type(self).__name__}.bin_capacity higher, or to "
                    f"None, and render again.")
            _log().warn("binning capacity overflowed; recapturing",
                        key=_key_name(key), needed=needed,
                        capacity=graph.capacity)
            self.recaptures += 1
            keep, capacity = graph.keep, tuple(
                _capacity_for(n) if n > c else c
                for n, c in zip(needed, graph.capacity))
            with tracing.host("recapture"):
                del self.graphs[key], graph   # frees its pools
                graph = self._capture_key(key, capture, capacity, keep)
                needed = self._replay_frame(graph)
            if _overflowed(needed, graph.capacity):
                raise RuntimeError(f"{_key_name(key)}: the recaptured "
                                   f"frame overflowed again ({needed} "
                                   f"entries)")
        with tracing.host("commit"):
            graph.commit()
        tracing.replayed(graph.spans[1])      # read at the next run_key
        return graph.result

    def _replay_frame(self, graph):
        """Replays a key's frame graphs → the most tile entries each
        binning needed (None for a key without a frame); waits for the
        frame, reading its device spans as they end."""
        tracing = self.tracing
        with tracing.host("replay"):
            graph.replay()
        native.add_counts(graph.launches)
        tracing.replayed(graph.spans[0])
        needed = graph.result.needed
        if needed is None:
            return None
        with tracing.host("tile_read"):
            tracing.flush()
            return tuple(int(n) for n in needed)


def _key_name(key) -> str:
    return "/".join(str(k) for k in key[:4])


def _capacity_for(needed: int) -> int:
    return BIN_HEADROOM * needed + BIN_SLACK


def _overflowed(needed, capacity) -> bool:
    return any(n > c for n, c in zip(needed, capacity))


def commit_pairs(commits, undo=None) -> list:
    """(buffer, new value) trees → (destination, source) tensor pairs to
    copy. Given ``undo`` (a list; an eager frame), a history name without
    a buffer of its shape gets one (a copy of the value) and a changed
    non-tensor field (the refit's level order, on a first refit) is set,
    and ``undo`` collects how to take each back; without it (under a
    capture) either raises. A source that shares memory with any
    destination is copied first, so the commit reads no buffer it
    writes."""
    pairs = []
    for static, new in commits:
        if isinstance(static, dict):
            for name, v in new.items():
                cur = static.get(name)
                if cur is not None and cur.shape == v.shape \
                        and cur.dtype == v.dtype:
                    if v is not cur:
                        pairs.append((cur, v))
                elif undo is not None:
                    undo.append(_restore_item(static, name))
                    static[name] = v.clone()
                else:
                    raise RuntimeError(f"history '{name}' has no buffer")
        else:
            _tree_pairs(static, new, pairs, undo)
    dsts = {d.untyped_storage().data_ptr() for d, _ in pairs}
    if len(dsts) != len(pairs):
        raise RuntimeError("two committed buffers share memory")
    return [(d, s.clone() if s.untyped_storage().data_ptr() in dsts else s)
            for d, s in pairs]


def _restore_item(d, name):
    if name in d:
        old = d[name]
        return lambda: d.__setitem__(name, old)
    return lambda: d.pop(name)


def _tree_pairs(static, new, pairs, undo):
    for f in dataclasses.fields(static):
        a, b = getattr(static, f.name), getattr(new, f.name)
        if a is b or (isinstance(a, (bool, int, float, str)) and a == b):
            continue
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise RuntimeError(f"{f.name}: {tuple(b.shape)} {b.dtype} "
                                   f"into {tuple(a.shape)} {a.dtype}")
            pairs.append((a, b))
        elif dataclasses.is_dataclass(a) and type(a) is type(b):
            _tree_pairs(a, b, pairs, undo)
        elif undo is not None:
            undo.append(lambda o=static, n=f.name, v=a: setattr(o, n, v))
            setattr(static, f.name, b)
        else:
            raise RuntimeError(f"{type(static).__name__}.{f.name} changed "
                               f"under a capture")
