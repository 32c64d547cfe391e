"""Renderer driver (hybridrenderer_tpu/runtime/renderer.py).

A frame is one call of ``_frame``: the path's pass stack over the scene,
the tracer, the carried history and the frame's row on the device
(``graph/params.pack_row``: the camera, exposure, the SVGF phis and the
frame index, one host-to-device copy a frame). Its results are committed
to the renderer's own buffers, which stay the same tensors from frame to
frame: the history (``state``), and after a dynamic update the scene's
and the tracer's tensors, written in place.

On a CUDA scene each frame function is captured into CUDA graphs by the
rule of runtime/capture.py, one set for each key: ("frame",
history_valid) for ``render`` (and ``render_burst``, which replays them
once a frame), ("dynamic", history_valid, use_subset, update_lights,
dirty set) for ``render_dynamic`` and ("commit", ...) for
``update_dynamic``. Every later use of a key copies the row and replays.
CPU scenes run the same functions eagerly, with exact tile lists.

A renderer made with ``trace=True`` times its work (runtime/profiling):
host spans around the row upload, the frame graph's launch, the read of
the tile entries, the commit graph's launch, the image's clone and a
recapture; device spans around each pass, the frame body, the scene
update, the refit and the commit, held in the captured graphs as event
nodes and read after each replay. ``trace_totals()`` sums them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.camera import CameraState
from ..core.types import RenderFlags, RenderPathType
from ..graph.params import ROW_SIZE, FrameParams, FrameState, pack_row
from ..graph.passes import FrameContext
from ..ops import trace
from ..ops.raster_cuda import Binning
from ..paths.factory import create_render_path
from ..scene import dynamic
from .capture import CapturedRenderer, Graph, Result, commit_pairs
from .log import core as _log

DEFAULT_PHI = (4.0, 128.0, 0.02, 0.0)


class Renderer(CapturedRenderer):
    def __init__(self, settings, scene_data, tracer=None, capture=None,
                 trace=False):
        """``capture``: replay CUDA graphs (the default on a CUDA scene);
        False runs every frame eagerly. ``trace``: time the renderer's
        work in spans (runtime/profiling), for the renderer's life."""
        self.settings = settings
        self.scene = scene_data
        self.device = scene_data.device
        super().__init__((self.device,), capture, trace)
        self.path = create_render_path(settings)
        self.tracer = tracer
        self._history = {}
        self._rows = {}          # K → the (K, ROW_SIZE) row buffer
        self._transforms = None  # the dynamic updates' (N, 4, 4) buffer
        self._stats = None

    @classmethod
    def for_scene(cls, settings, scene_data, capture=None, trace=False):
        """Renderer with the ray tracer attached when the path or the
        flags ask for ray-traced passes."""
        tracer = tracer_for(settings, scene_data)
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
        """``body(binning)`` → Result through key's graphs (run_key).
        Returns the result's image (a new tensor)."""
        def eager(undo):
            res = body(Binning())
            return res, commit_pairs(res.commits, undo)

        res, replayed = self.run_key(
            key, eager, lambda capacity: self._capture(body, capacity), keep)
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
            pairs = commit_pairs(res.commits)
        commit = torch.cuda.CUDAGraph()
        with self.tracing.collecting() as commit_spans, \
                torch.cuda.graph(commit), self.tracing.device("commit"):
            for dst, src in pairs:
                dst.copy_(src)
        return Graph(frame.replay, commit.replay, res, capacity,
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
            self.graphs = {}
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
            return Result(out, stats, (binning.max_needed(self.device),),
                           [(self._history, history)])

        out = self._run(("frame", hv), body)
        self.frame_count += 1
        return out

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
            return Result(None, None, None, _scene_commits(self, scene,
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
            return Result(out, stats, (binning.max_needed(self.device),),
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
        if self.tracer is None or self.tracer.request != trace.request_of(
                settings, self.scene.num_triangles):
            new = tracer_for(settings, self.scene)
            if new is not None:  # else kept: the new settings trace no rays
                self.tracer = new
        self.settings, self.path = settings, path
        self._history, self.graphs = {}, {}
        self.reset_history()

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


def _scene_commits(renderer, scene, tracer):
    commits = [(renderer.scene, scene)]
    if tracer is not None:
        commits.append((renderer.tracer, tracer))
    return commits


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


def tracer_for(settings, scene_data):
    """The ray tracer over ``scene_data`` that ``settings`` ask for, built
    now; None where the path and the flags trace no rays."""
    if not (settings.path == RenderPathType.RAYTRACED or settings.flags & (
            RenderFlags.SHADOW | RenderFlags.AO | RenderFlags.REFLECTION
            | RenderFlags.GI)):
        return None
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

