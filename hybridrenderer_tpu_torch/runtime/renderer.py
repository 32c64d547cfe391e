"""Renderer driver (hybridrenderer_tpu/runtime/renderer.py).

A frame is one call of ``_frame``: the path's pass stack over the scene,
the tracer, the carried history and the frame's row on the device
(``graph/params.pack_row``: the camera, exposure, the SVGF phis and the
frame index, one host-to-device copy a frame). Its results are committed
to the renderer's own buffers, which stay the same tensors from frame to
frame: the history (``state``), and after a dynamic update the scene's
and the tracer's tensors, written in place.

On a CUDA scene each frame function is captured into CUDA graphs, one
set for each key, as the reference keeps one jitted program for each:
("frame", history_valid) for ``render`` (and ``render_burst``, which
replays them once a frame), ("dynamic", history_valid, use_subset,
update_lights, dirty set) for ``render_dynamic`` and ("commit", ...)
for ``update_dynamic``. A key's first use runs eagerly, as the frame it
is, so that every lazy set-up (kernel loads, cached constants, the
refit's level walk, the exact tile lists that size the binning
capacity) happens outside a capture; the graph is captured right after
it, and every later use copies the row and replays. A frame that cannot
be captured raises, with the renderer as it was; on the card nothing
falls back to eager execution unless the renderer is made with
``capture=False``.

Each key holds two graphs: the frame, which reads the renderer's buffers
and writes only memory of its own graph pool, and the commit, which
copies the frame's results into the buffers; no replay reads a buffer
that it writes (the reference donates its state instead). Between the
two the host reads the tile entries the frame's rasters needed. A frame
that needed more than the binning capacity is not committed: its key is
captured again at a capacity sized from what it needed, and the frame
replayed (or, with ``Renderer.bin_capacity`` fixed, it raises, and the
history is left as it was; ``Renderer.recaptures`` counts these). CPU
scenes run the same functions eagerly, with exact tile lists.

A renderer made with ``trace=True`` times its work (runtime/profiling):
host spans around the row upload, the frame graph's launch, the read of
the tile entries, the commit graph's launch, the image's clone and a
recapture; device spans around each pass, the frame body, the scene
update, the refit and the commit, held in the captured graphs as event
nodes and read after each replay. ``trace_totals()`` sums them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from .. import native
from ..core.camera import CameraState
from ..core.types import RenderFlags, RenderPathType
from ..graph.params import ROW_SIZE, FrameParams, FrameState, pack_row
from ..graph.passes import FrameContext
from ..ops import trace
from ..ops.raster_cuda import Binning
from ..paths.factory import create_render_path
from ..scene import dynamic
from . import profiling
from .log import core as _log

DEFAULT_PHI = (4.0, 128.0, 0.02, 0.0)
# a captured frame bins into this many times the tile entries its key's
# first (eager) frame, or an overflowed replay, needed, plus the slack;
# Renderer.bin_capacity fixes it instead
BIN_HEADROOM = 2
BIN_SLACK = 1 << 16


@dataclasses.dataclass
class _Result:
    """What a frame function returns: the image, the frame stats, the
    most tile entries a raster needed, one for each binning (a shard's;
    None without a frame), and (renderer buffer, new value) trees to
    commit."""
    out: Any
    stats: Any
    needed: Any
    commits: list


@dataclasses.dataclass
class _Graph:
    """A key's captured frame: ``replay()`` replays its frame graphs,
    ``commit()`` its copy-back graphs."""
    replay: Any
    commit: Any
    result: _Result      # the frame graphs' outputs, in their pools
    capacity: Any        # the tile entries each binning may use (a tuple)
    launches: dict = dataclasses.field(default_factory=dict)  # one replay's
    keep: tuple = ()     # inputs the graph reads that the key names by id
    spans: tuple = ((), ())  # the device spans of replay() and commit()


class Renderer:
    def __init__(self, settings, scene_data, tracer=None, capture=None,
                 trace=False):
        """``capture``: replay CUDA graphs (the default on a CUDA scene);
        False runs every frame eagerly. ``trace``: time the renderer's
        work in spans (runtime/profiling), for the renderer's life."""
        self.settings = settings
        self.scene = scene_data
        self.device = scene_data.device
        self.capture = self.device.type == "cuda" if capture is None \
            else bool(capture)
        if self.capture and self.device.type != "cuda":
            raise ValueError("CUDA graphs need a scene on a CUDA device")
        self.tracing = profiling.Tracer(self.device) if trace \
            else profiling.OFF
        self.path = create_render_path(settings)
        self.tracer = tracer
        self.frame_count = 0
        # tile entries a captured raster may use, fixed (an overflow
        # raises); None: sized per key and grown on an overflow
        self.bin_capacity = None
        self._history = {}
        self._graphs = {}
        self._rows = {}          # K → the (K, ROW_SIZE) row buffer
        self._transforms = None  # the dynamic updates' (N, 4, 4) buffer
        self._stats = None
        self.capture_ms = {}     # each key's capture time, host clock
        self.recaptures = 0      # keys captured again on a bin overflow

    @classmethod
    def for_scene(cls, settings, scene_data, capture=None, trace=False):
        """Renderer with the ray tracer attached when the path or the
        flags ask for ray-traced passes."""
        tracer = _build_tracer(scene_data, settings) \
            if _needs_tracer(settings) else None
        return cls(settings, scene_data, tracer=tracer, capture=capture,
                   trace=trace)

    # --- frame functions -------------------------------------------------
    def _context(self, row, scene, tracer, history, history_valid,
                 binning=None):
        """The FrameContext of a frame over a (ROW_SIZE,) row → (ctx,
        the carried FrameState)."""
        state = FrameState(history=history)
        ctx = FrameContext(
            scene=scene, cam=CameraState.unpack(row),
            params=FrameParams.from_row(scene, row), settings=self.settings,
            state=state, history_valid=history_valid, binning=binning,
            **trace_hooks(scene, tracer))
        return ctx, state

    def _frame(self, row, scene, tracer, history, history_valid, binning):
        """One frame's math over a (ROW_SIZE,) row → (out (H, W, 3), new
        history dict, stats (3,) i64)."""
        with self.tracing.device("frame"):
            ctx, state = self._context(row, scene, tracer, history,
                                       history_valid, binning)
            # each pass a device span; an untraced frame calls run as
            # it always did
            hook = self.tracing.run_pass
            out, new_state, registry = (
                self.path.run(ctx, state) if hook is None
                else self.path.run(ctx, state, run_pass=hook))
            stats = registry.get("_FrameStats")
            if stats is None:
                stats = torch.zeros(3, dtype=torch.int64, device=row.device)
        return out, new_state.history, stats

    def _history_for(self, history_valid):
        return self._history if history_valid else {}

    def _updated(self, maps, transforms, vert_idx, tri_idx, use_subset,
                 update_lights):
        """The scene after a dynamic update and the tracer refit on it
        (new tensors; the renderer's are read, not written)."""
        with self.tracing.device("scene.update"):
            if use_subset:
                scene = dynamic.update_transforms_subset(
                    self.scene, maps, transforms, vert_idx, tri_idx,
                    update_lights=update_lights)
            else:
                scene = dynamic.update_transforms(self.scene, maps,
                                                  transforms)
        if self.tracer is None:
            return scene, None
        with self.tracing.device("scene.refit"):
            return scene, self.tracer.refit(scene)

    def _row_buffer(self, k):
        buf = self._rows.get(k)
        if buf is None:
            buf = self._rows[k] = torch.empty((k, ROW_SIZE),
                                              dtype=torch.float32,
                                              device=self.device)
        return buf

    def _upload_rows(self, rows):
        """(K, ROW_SIZE) host rows → the K-row buffer on the device: one
        copy. The source is pageable, so the copy stages it before it
        returns, and the copy is ordered after the last replay on the
        stream."""
        buf = self._row_buffer(rows.shape[0])
        buf.copy_(torch.from_numpy(rows), non_blocking=True)
        return buf

    def _upload_transforms(self, transforms):
        t = torch.as_tensor(transforms)
        if self._transforms is None:
            self._transforms = torch.empty(t.shape, dtype=torch.float32,
                                           device=self.device)
        self._transforms.copy_(t, non_blocking=True)
        return self._transforms

    # --- graphs ----------------------------------------------------------
    def _run(self, key, body, keep=()):
        """``body(binning)`` → _Result through key's graphs (run_key).
        Returns the result's image (a new tensor)."""
        def eager(undo):
            res = body(Binning())
            return res, _pairs(res.commits, undo)

        res, replayed = run_key(self, key, eager,
                                lambda capacity: self._capture(body,
                                                               capacity),
                                keep)
        if res.stats is not None:
            self._stats = res.stats
        if not replayed or res.out is None:
            return res.out
        with self.tracing.host("out_clone"):
            return res.out.clone()

    def _capture(self, body, capacity):
        """The frame graph of ``body`` and the graph that commits its
        results; with tracing on, each holds its device spans' events."""
        frame = torch.cuda.CUDAGraph()
        with self.tracing.collecting() as frame_spans, \
                torch.cuda.graph(frame):
            res = body(Binning(None if capacity is None else capacity[0]))
            pairs = _pairs(res.commits)
        commit = torch.cuda.CUDAGraph()
        with self.tracing.collecting() as commit_spans, \
                torch.cuda.graph(commit), self.tracing.device("commit"):
            for dst, src in pairs:
                dst.copy_(src)
        return _Graph(frame.replay, commit.replay, res, capacity,
                      spans=(frame_spans, commit_spans))

    # --- public API --------------------------------------------------------
    @property
    def state(self) -> FrameState:
        """The carried history: the renderer's history buffers, or empty
        before the first frame after a reset."""
        return FrameState(history=dict(self._history)) \
            if self.frame_count else FrameState.empty()

    def set_history(self, history: dict, frame_count: int):
        """Resume from ``history`` (name → array or tensor) after
        ``frame_count`` frames: written into the history buffers, which
        the captured frames read; a name, shape or dtype that the buffers
        do not have replaces them and drops the graphs."""
        new = {k: torch.as_tensor(v) for k, v in history.items()}
        same = new.keys() == self._history.keys() and all(
            self._history[k].shape == v.shape
            and self._history[k].dtype == v.dtype for k, v in new.items())
        if same:
            for k, v in new.items():
                self._history[k].copy_(v)
        else:
            self._history = {k: v.to(self.device).clone()
                             for k, v in new.items()}
            self._graphs = {}
        self.frame_count = int(frame_count)

    @torch.no_grad()
    def render(self, cam_state, exposure: float = 1.0, svgf_phi=DEFAULT_PHI):
        """Render one frame → (H, W, 3) float32 tensor on the device."""
        with self.tracing.host("upload"):
            self._upload_rows(pack_row(cam_state, exposure, svgf_phi,
                                       self.frame_count)[None])
        return self._render_row()

    def _render_row(self):
        """The frame of the row in the one-row buffer."""
        buf = self._row_buffer(1)
        hv = self.frame_count > 0

        def body(binning):
            out, history, stats = self._frame(
                buf[0], self.scene, self.tracer, self._history_for(hv), hv,
                binning)
            return _Result(out, stats, (binning.max_needed(self.device),),
                           [(self._history, history)])

        out = self._run(("frame", hv), body)
        self.frame_count += 1
        return out

    def render_np(self, cam_state, **kw) -> np.ndarray:
        return self.render(cam_state, **kw).cpu().numpy()

    @torch.no_grad()
    def update_dynamic(self, maps, transforms, vert_idx, tri_idx,
                       use_subset: bool, update_lights: bool):
        """A dynamic update of ``self.scene`` (scene/dynamic.py; only the
        dirty rows ``vert_idx`` / ``tri_idx`` when ``use_subset``), then
        the tracer's refit, both written into the scene's and the
        tracer's tensors: ``DynamicScene.commit``'s work."""
        with self.tracing.host("upload"):
            tf = self._upload_transforms(transforms)

        def body(binning):
            scene, tracer = self._updated(maps, tf, vert_idx, tri_idx,
                                          use_subset, update_lights)
            return _Result(None, None, None, _scene_commits(self, scene,
                                                            tracer))

        self._run(("commit", use_subset, update_lights, id(maps),
                   id(vert_idx), id(tri_idx)), body,
                  keep=(maps, vert_idx, tri_idx))

    @torch.no_grad()
    def render_dynamic(self, cam_state, maps, transforms, vert_idx, tri_idx,
                       use_subset: bool, update_lights: bool,
                       exposure: float = 1.0, svgf_phi=DEFAULT_PHI):
        """A dynamic frame in one call: ``update_dynamic``'s update and
        refit, then the frame over the updated scene, in one graph (the
        reference's one-dispatch dynamic frame); the scene and the tracer
        are left updated, exactly as ``update_dynamic`` leaves them."""
        with self.tracing.host("upload"):
            buf = self._upload_rows(pack_row(cam_state, exposure, svgf_phi,
                                             self.frame_count)[None])
            tf = self._upload_transforms(transforms)
        hv = self.frame_count > 0

        def body(binning):
            scene, tracer = self._updated(maps, tf, vert_idx, tri_idx,
                                          use_subset, update_lights)
            out, history, stats = self._frame(
                buf[0], scene, tracer, self._history_for(hv), hv, binning)
            return _Result(out, stats, (binning.max_needed(self.device),),
                           [(self._history, history)]
                           + _scene_commits(self, scene, tracer))

        out = self._run(("dynamic", hv, use_subset, update_lights, id(maps),
                         id(vert_idx), id(tri_idx)), body,
                        keep=(maps, vert_idx, tri_idx))
        self.frame_count += 1
        return out

    @torch.no_grad()
    def render_burst(self, cam_states, exposure: float = 1.0,
                     svgf_phi=DEFAULT_PHI):
        """Render one frame per camera state in order → (K, H, W, 3): all
        K rows in one copy, then K frames through ``render``'s graphs,
        each row copied on the device into the frame's row buffer; the
        frames and the history are exactly those of K ``render``
        calls."""
        with self.tracing.host("upload"):
            rows = self._upload_rows(np.stack([
                pack_row(cs, exposure, svgf_phi, self.frame_count + i)
                for i, cs in enumerate(cam_states)]))
        one, outs = self._row_buffer(1), []
        for i in range(rows.shape[0]):
            if rows is not one:
                one[0].copy_(rows[i])
            outs.append(self._render_row())
        return torch.stack(outs)

    def switch_path(self, path_type):
        """Live render-path switch: new pass stack, history and graphs
        dropped; the scene is kept, and the tracer too unless the new
        path needs one that is missing."""
        _log().info("switching render path", to=str(path_type))
        self._apply(path=path_type)

    def apply_settings(self, **changes):
        """Live settings change (flags, display mode, resolution, path,
        trace_backend): rebuild the pass stack, keep the scene, drop the
        history and the graphs. The tracer is kept while it still serves
        (the reference keeps it whatever changes), built when one is
        needed and missing, and rebuilt when the traversal kernel, the BVH
        builder, or (on a scene large enough) the triangles "pallas-wide"
        traces would change, so that the setting takes effect."""
        _log().info("applying settings",
                    **{k: str(v) for k, v in changes.items()})
        self._apply(**changes)

    def _apply(self, **changes):
        settings = self.settings.replace(**changes)
        path = create_render_path(settings)
        if _needs_tracer(settings) and (
                self.tracer is None
                or self.tracer.request != trace.request_of(
                    settings, self.scene.num_triangles)):
            self.tracer = _build_tracer(self.scene, settings)
        self.settings, self.path = settings, path
        self._history, self._graphs = {}, {}
        self.reset_history()

    def reset_history(self):
        """Drop all carried history: the next frame is a first frame. The
        graphs are kept, as the reference keeps its jitted programs: the
        first frame's graph reads no history."""
        self.frame_count = 0

    def frame_stats(self) -> dict:
        """Last frame's instance drawn/culled counts and covered pixels
        (the active-ray count). Waits for the device."""
        s = np.zeros(3, np.int64) if self._stats is None \
            else self._stats.cpu().numpy()
        return {"instances_drawn": int(s[0]), "instances_culled": int(s[1]),
                "covered_pixels": int(s[2])}

    def trace_totals(self) -> dict:
        """The tracer's sums (``profiling.Tracer.totals``; empty without
        ``trace=True``) and ``recaptures``; waits for the device."""
        return {**self.tracing.totals(), "recaptures": self.recaptures}

    def reset_trace(self):
        """Clears the tracer's sums (not ``recaptures``)."""
        self.tracing.reset()


def _key_name(key) -> str:
    return "/".join(str(k) for k in key[:4])


def _capacity_for(needed: int) -> int:
    return BIN_HEADROOM * needed + BIN_SLACK


def run_key(owner, key, eager, capture, keep=()):
    """The captured-frame rule of ``Renderer`` and
    ``parallel.sharded.ShardedRenderer`` (``owner``: its ``capture``,
    ``bin_capacity``, ``_graphs`` and ``capture_ms``). At the key's first
    use ``eager(undo)`` → (_Result, (destination, source) pairs) runs the
    frame, filling ``undo``; with ``owner.capture`` the key is then
    captured by ``capture(capacity)`` → _Graph, a capacity for each
    binning (the result's ``needed``: one for each shard); on a failure
    ``undo`` is taken back and the error raised. Only then are the pairs
    copied. Later uses replay the graph (see _replay_key). → (the
    result, whether it is the graph's). The spans the owner's tracer
    launched before are read first."""
    owner.tracing.flush()
    graph = owner._graphs.get(key)
    fixed = owner.bin_capacity
    if graph is not None and graph.capacity is not None \
            and fixed is not None and any(c != fixed for c in graph.capacity):
        del owner._graphs[key]                # bin_capacity was changed
        graph = None
    if graph is not None:
        return _replay_key(owner, key, graph, capture), True
    undo = []
    res, pairs = eager(undo)
    if owner.capture:
        capacity = None if res.needed is None else tuple(
            _capacity_for(int(n)) if fixed is None else fixed
            for n in res.needed)
        try:
            _capture_key(owner, key, capture, capacity, keep)
        except BaseException:
            # nothing committed: the owner is left as it was
            for fn in reversed(undo):
                fn()
            raise
    with owner.tracing.device("commit"):
        for dst, src in pairs:
            dst.copy_(src)
    return res, False


def _capture_key(owner, key, capture, capacity, keep):
    """``capture(capacity)`` into ``owner._graphs[key]``; the capture's
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
    owner._graphs[key] = graph
    owner.capture_ms[_key_name(key)] = ms = 1e3 * (time.perf_counter() - t0)
    _log().info("frame graph captured", key=_key_name(key), ms=round(ms, 1),
                bin_capacity=capacity)
    return graph


def _replay_key(owner, key, graph, capture):
    """Replays the key's frame; a frame whose tile lists overflowed a
    capacity is captured again, every binning at a capacity sized from
    what it needed where it overflowed, and replayed (with bin_capacity
    fixed, it raises), and only then committed."""
    tracing = owner.tracing
    needed = _replay_frame(owner, graph)
    if needed is not None and _overflowed(needed, graph.capacity):
        if owner.bin_capacity is not None:
            raise RuntimeError(
                f"{_key_name(key)}: the frame's tile lists need {needed} "
                f"entries, above the fixed binning capacity "
                f"{owner.bin_capacity}; nothing was committed. Set "
                f"{type(owner).__name__}.bin_capacity higher, or to None, "
                f"and render again.")
        _log().warn("binning capacity overflowed; recapturing",
                    key=_key_name(key), needed=needed,
                    capacity=graph.capacity)
        owner.recaptures += 1
        keep, capacity = graph.keep, tuple(
            _capacity_for(n) if n > c else c
            for n, c in zip(needed, graph.capacity))
        with tracing.host("recapture"):
            del owner._graphs[key], graph     # frees its pools
            graph = _capture_key(owner, key, capture, capacity, keep)
            needed = _replay_frame(owner, graph)
        if _overflowed(needed, graph.capacity):
            raise RuntimeError(f"{_key_name(key)}: the recaptured frame "
                               f"overflowed again ({needed} entries)")
    with tracing.host("commit"):
        graph.commit()
    tracing.replayed(graph.spans[1])          # read at the next run_key
    return graph.result


def _overflowed(needed, capacity) -> bool:
    return any(n > c for n, c in zip(needed, capacity))


def _replay_frame(owner, graph):
    """Replays a key's frame graphs → the most tile entries each binning
    needed (None for a key without a frame); waits for the frame,
    reading its device spans as they end."""
    tracing = owner.tracing
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


def _scene_commits(renderer, scene, tracer):
    commits = [(renderer.scene, scene)]
    if tracer is not None:
        commits.append((renderer.tracer, tracer))
    return commits


def _pairs(commits, undo=None) -> list:
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


def trace_hooks(scene, tracer) -> dict:
    """The FrameContext's ray-query hooks over ``tracer`` (none without
    one): shadow_query, shadow_query_pair and trace_radiance."""
    if tracer is None:
        return {}

    def trace_radiance(o, d, ctx, depth, active=None, row0=0):
        # row0 only where it is not the default, so that a wrapper of the
        # tracer's method with the reference's signature still serves
        kw = {"row0": row0} if row0 else {}
        return tracer.trace_radiance(scene, o, d, ctx, depth, active=active,
                                     **kw)

    return dict(shadow_query=tracer.shadow_query,
                shadow_query_pair=tracer.shadow_query_pair,
                trace_radiance=trace_radiance)


def _build_tracer(scene_data, settings):
    t0 = time.perf_counter()
    tracer = trace.SceneTracer.build(scene_data, settings)
    _log().info("ray tracer attached", backend=tracer.backend,
                wide_kernel=tracer.wide_kernel, bf16=tracer.quantized,
                tris=int(scene_data.num_triangles),
                build_ms=round(1e3 * (time.perf_counter() - t0), 1))
    if tracer.demotion is not None:
        _log().info("wide kernel demoted, as the reference demotes it",
                    asked=settings.wide_kernel, reason=tracer.demotion)
    return tracer


def _needs_tracer(settings) -> bool:
    """Whether the settings run ray-traced passes."""
    return settings.path == RenderPathType.RAYTRACED or bool(
        settings.flags & (RenderFlags.SHADOW | RenderFlags.AO
                          | RenderFlags.REFLECTION | RenderFlags.GI))
