"""The row-sharded frame (hybridrenderer_tpu/parallel/sharded.py).

The reference shards one jitted frame over a device mesh with GSPMD:
image rows over the mesh, the scene, BVH and tracer replicated, the ray
passes pinned to each chip's own rows (shard_map), and halo exchanges
inserted for the stencils. The output equals the single-device frame.

Here the same design is written out. Each shard runs the path's passes
over its own window of rows (``FrameContext.row0`` of an image
``full_height`` rows tall, ``settings.height`` rows) on its own device,
with the scene and tracer replicated there (one copy per distinct
device). Everything that locates a pixel takes the window: the raster
(K1 / K1v bin and resolve the window's 16-row bands, pixel centres
``row0 + y + 0.5``), pixel uv and view directions, seeds and sampling
patterns, the NEE seeds of traced rays. The ray passes trace only the
shard's rows. Where a pass reads other rows it asks the shard's
``RowExchange``: the SVGF and TAA stencils run on their rows padded with
their radius of halo rows (filter_moments 3, à-trous 2, 4, 8, TAA and
the depth gradients 1, the half-res upsample one half-res row), and the
reprojections (K3, K5) read the previous frame's whole image, gathered
from the shards. A halo or a gather is a slice of another shard's rows
and a ``.to(device)``.

The shards run in one process as threads that take turns in rank order:
a thread runs until it reaches an exchange, posts its rows and hands the
turn on; once every shard has posted, each takes the rows it needs in
its next turn. Only one shard runs at a time, so a frame's launches are
issued in a fixed order and the kernels' launch counts stay exact; the
kernels of shards on one card run on its stream in that order, and on
several cards asynchronously.

``shard_rays=False`` traces each ray query once over the whole image on
the first device (the reference's GSPMD placement without shard_map),
and gives the same pixels. Like the reference, the sharded frame renders
static scenes, eagerly (no CUDA graph, no dynamic update).
"""
from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from ..core.camera import CameraState
from ..graph.params import FrameParams, FrameState, pack_row
from ..graph.passes import FrameContext
from ..paths.factory import create_render_path
from ..runtime.renderer import (DEFAULT_PHI, _build_tracer, _needs_tracer,
                                trace_hooks)
from .mesh import replicated, row_sharding

_MISSING = object()


class _Aborted(Exception):
    """Another shard failed: this one stops at its next turn."""


class _Lockstep:
    """One thread per shard, one running at a time, in rank order. A
    thread's turn ends at an exchange (or when it returns); an exchange
    hands back what every shard posted to it."""

    def __init__(self, n: int):
        self.n = n
        self.cv = threading.Condition()
        self.turn = 0
        self.done = [False] * n
        self.posts = {}      # phase → [values, shards that read them]
        self.error = None

    def _wait(self, rank):
        while self.turn != rank and self.error is None:
            self.cv.wait()
        if self.error is not None:
            raise _Aborted()

    def _pass(self, rank):
        for k in range(1, self.n + 1):
            j = (rank + k) % self.n
            if not self.done[j]:
                self.turn = j
                break
        self.cv.notify_all()

    def exchange(self, rank: int, phase: int, value) -> list:
        with self.cv:
            entry = self.posts.setdefault(phase, [[_MISSING] * self.n, 0])
            entry[0][rank] = value
            self._pass(rank)
            self._wait(rank)
            values = entry[0]
            entry[1] += 1
            if entry[1] == self.n:
                del self.posts[phase]
        if any(v is _MISSING for v in values):
            raise RuntimeError(f"shard {rank}: the shards' passes diverged "
                               f"(exchange {phase} missed by some shard)")
        return values

    def run(self, fns, devices) -> list:
        """``fns[i]()`` on shard i's thread, with ``devices[i]`` current
        and autograd off → their results; the first failure raises."""
        results = [None] * self.n

        def body(rank):
            dev = devices[rank]
            try:
                with self.cv:
                    self._wait(rank)
                with torch.no_grad(), (torch.cuda.device(dev)
                                       if dev.type == "cuda"
                                       else contextlib.nullcontext()):
                    results[rank] = fns[rank]()
            except _Aborted:
                return
            except Exception as e:         # re-raised by run, below
                with self.cv:
                    if self.error is None:
                        self.error = e
                    self.cv.notify_all()
                return
            with self.cv:
                self.done[rank] = True
                self._pass(rank)

        threads = [threading.Thread(target=body, args=(r,),
                                    name=f"shard-{r}", daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.error is not None:
            raise self.error
        return results


class RowExchange:
    """Shard ``rank``'s side of its frame's row exchange
    (``FrameContext.exchange``). Every shard calls the same exchanges in
    the same order. Each shard's images hold consecutive rows of the
    whole image, in rank order; their row counts may differ (the
    half-res grid's)."""

    def __init__(self, step: _Lockstep, rank: int, device):
        self.step = step
        self.rank = rank
        self.device = device
        self.phase = 0

    def _all(self, value) -> list:
        self.phase += 1
        return self.step.exchange(self.rank, self.phase, value)

    def _blocks(self, images):
        blocks = self._all(tuple(images))
        sizes = [b[0].shape[0] if b else 0 for b in blocks]
        starts = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        return blocks, starts

    def halo(self, r: int, *images):
        """See FrameContext.halo."""
        blocks, starts = self._blocks(images)
        a, b = starts[self.rank], starts[self.rank + 1]
        lo, hi = max(0, a - r), min(starts[-1], b + r)
        out = []
        for k in range(len(images)):
            parts = []
            for j, blk in enumerate(blocks):
                s, e = max(lo, starts[j]), min(hi, starts[j + 1])
                if s < e:
                    parts.append(blk[k][s - starts[j]:e - starts[j]]
                                 .to(self.device))
            out.append(parts[0] if len(parts) == 1 else torch.cat(parts))
        return out, a - lo

    def gather(self, *images):
        """See FrameContext.gather."""
        blocks, _ = self._blocks(images)
        return [torch.cat([blk[k].to(self.device) for blk in blocks])
                for k in range(len(images))]

    def once(self, fn, *images):
        """``fn`` over the whole images, once, on the first shard's
        device → this shard's rows of its result (a tensor or a tuple of
        them, whose leading dimension is the images')."""
        blocks, starts = self._blocks(images)
        result = None
        if self.rank == 0:
            whole = [torch.cat([blk[k].to(self.device) for blk in blocks])
                     for k in range(len(images))]
            result = fn(*whole)
        result = self._all(result)[0]
        a, b = starts[self.rank], starts[self.rank + 1]
        if isinstance(result, tuple):
            return tuple(x[a:b].to(self.device) for x in result)
        return result[a:b].to(self.device)


class ShardedRenderer:
    """The frame of ``runtime.renderer.Renderer``, its image rows sharded
    over ``mesh`` (parallel/mesh.py). ``render`` returns the whole
    (H, W, 3) image on the mesh's first device; each shard's SVGF and TAA
    history stays on its device and carries to the next frame."""

    def __init__(self, settings, scene_data, mesh, axis: str = "y",
                 tracer=None, shard_rays: bool = True):
        self.settings = settings
        self.scene = scene_data
        self.mesh = mesh
        self.axis = axis
        self.rows = row_sharding(mesh, settings.height)
        # every shard runs the path over a window of its height
        self.shard_settings = settings.replace(height=self.rows[0][1])
        self.path = create_render_path(self.shard_settings)
        self.tracer = tracer
        self.shard_rays = shard_rays and tracer is not None
        self.scenes = replicated(mesh, scene_data)
        self.tracers = replicated(mesh, tracer) if tracer is not None \
            else (None,) * len(mesh)
        self.frame_count = 0
        self.histories = [{} for _ in mesh.devices]
        self._stats = None

    @classmethod
    def for_scene(cls, settings, scene_data, mesh, **kw):
        """With the ray tracer attached when the path or the flags ask for
        ray-traced passes (``Renderer.for_scene``'s rule); it is built
        once and replicated on each distinct device."""
        tracer = _build_tracer(scene_data, settings) \
            if _needs_tracer(settings) else None
        return cls(settings, scene_data, mesh, tracer=tracer, **kw)

    def _hooks(self, rank, exchange):
        """The shard's ray-query hooks: its own tracer over its rows, or
        with ``shard_rays`` off the first shard's over the whole image."""
        if self.shard_rays or self.tracers[rank] is None:
            return trace_hooks(self.scenes[rank], self.tracers[rank])
        scene, tracer = self.scenes[0], self.tracers[0]

        def ones(p):
            return torch.ones(p.shape[:2], dtype=torch.bool, device=p.device)

        def shadow_query(p, n, d, tmax, active=None):
            return exchange.once(
                lambda *x: tracer.shadow_query(*x[:3], tmax, active=x[3]),
                p, n, d.expand_as(p), ones(p) if active is None else active)

        def shadow_query_pair(p, n, da, ta, db, tb, active=None):
            return exchange.once(
                lambda *x: tracer.shadow_query_pair(
                    x[0], x[1], x[2], ta, x[3], tb, active=x[4]),
                p, n, da.expand_as(p), db.expand_as(p),
                ones(p) if active is None else active)

        def trace_radiance(o, d, ctx, depth, active=None, row0=0):
            # the first shard's rays start the image: its ctx and row0
            return exchange.once(
                lambda *x: tracer.trace_radiance(scene, x[0], x[1], ctx,
                                                 depth, active=x[2],
                                                 row0=row0),
                o, d, ones(o) if active is None else active)

        return dict(shadow_query=shadow_query,
                    shadow_query_pair=shadow_query_pair,
                    trace_radiance=trace_radiance)

    def _shard_frame(self, step, rank, row, history_valid):
        dev = self.mesh.devices[rank]
        exchange = RowExchange(step, rank, dev)
        scene = self.scenes[rank]
        row = row.to(dev)
        state = FrameState(history=self.histories[rank]
                           if history_valid else {})
        ctx = FrameContext(
            scene=scene, cam=CameraState.unpack(row),
            params=FrameParams.from_row(scene, row),
            settings=self.shard_settings, state=state,
            history_valid=history_valid, row0=self.rows[rank][0],
            full_height=self.settings.height, exchange=exchange,
            **self._hooks(rank, exchange))
        out, new_state, registry = self.path.run(ctx, state)
        return out, new_state.history, registry.get("_FrameStats")

    @torch.no_grad()
    def render(self, cam_state, exposure: float = 1.0,
               svgf_phi=DEFAULT_PHI):
        """Render one frame → (H, W, 3) float32 tensor on the mesh's first
        device."""
        row = torch.from_numpy(pack_row(cam_state, exposure, svgf_phi,
                                        self.frame_count))
        step = _Lockstep(len(self.mesh))
        results = step.run(
            [functools.partial(self._shard_frame, step, r, row,
                               self.frame_count > 0)
             for r in range(len(self.mesh))], self.mesh.devices)
        first = self.mesh.devices[0]
        self.histories = [history for _, history, _ in results]
        stats = [s for _, _, s in results]
        if stats[0] is not None:
            # every shard culls the same instances; covered pixels add up
            covered = sum(s[2].to(first) for s in stats)
            self._stats = torch.cat([stats[0][:2].to(first), covered[None]])
        self.frame_count += 1
        return torch.cat([out.to(first) for out, _, _ in results])

    def render_np(self, cam_state, **kw) -> np.ndarray:
        return self.render(cam_state, **kw).cpu().numpy()

    def reset_history(self):
        """The next frame is a first frame."""
        self.frame_count = 0

    def frame_stats(self) -> dict:
        """As ``Renderer.frame_stats``, over the whole image."""
        s = np.zeros(3, np.int64) if self._stats is None \
            else self._stats.cpu().numpy()
        return {"instances_drawn": int(s[0]), "instances_culled": int(s[1]),
                "covered_pixels": int(s[2])}
