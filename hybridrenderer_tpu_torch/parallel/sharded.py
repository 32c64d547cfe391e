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
made in a fixed order and the kernels' launch counts stay exact.

On a mesh of CUDA devices the frame is captured, as ``Renderer``'s is
(runtime/capture.py ``CapturedRenderer.run_key``): one set of graphs
for each ``history_valid``, as the reference keeps one jitted program
for each. A key's first use runs eagerly with exact tile lists, and the
key is then captured; every later use copies the frame's row to each
device and replays. The exchanges cut each shard's frame into segments, and
each segment is captured into a CUDA graph of its own (``_Segments``),
on its device's capture stream and into its device's graph pool; a
capture closes before its shard hands the turn on, so no two captures
are ever open. Rows a shard reads from a shard on its own device are
read in place inside the reading segment; rows from another device
come from a static buffer on the reading device, which a copy fills
between the two segments. A replay launches segment k of every shard, then
exchange k's copies (each ordered after its source's segment and before
its destination's next one by events on the two devices' streams),
then segment k + 1: no host sync between segments, and shards on
separate cards run at the same time. The host then reads each shard's
tile entries (a binning overflow captures the key again), and a commit
graph for each device copies the shards' results into their history
buffers, so no replay reads a buffer that it writes. A frame that
cannot be captured raises, with the renderer as it was;
``capture=False`` runs every frame eagerly. CPU meshes run eagerly.

Like the reference, the sharded frame renders static scenes only, and
one frame a call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import warnings
from typing import Any

import numpy as np
import torch

from ..core.camera import CameraState
from ..graph.params import ROW_SIZE, FrameParams, FrameState, pack_row
from ..graph.passes import FrameContext
from ..ops.raster_cuda import Binning
from ..paths.factory import create_render_path
from ..runtime.capture import CapturedRenderer, Graph, Result, commit_pairs
from ..runtime.renderer import DEFAULT_PHI, trace_hooks, tracer_for
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


class _Segments:
    """A shard's frame captured as CUDA graphs, one for each
    segment between two of its exchanges, on its device's capture
    ``stream`` into its device's graph ``pool``. ``graphs[k]`` is segment
    k (None where it launched nothing); ``copies[k]`` the (static buffer,
    source rows) copies that fill this shard's buffers after segment k of
    every shard, before its segment k + 1."""

    def __init__(self, device, pool, stream):
        self.device, self.pool, self.stream = device, pool, stream
        self.graphs, self.copies = [], []
        self._graph = self._prev = None

    def local(self, rank, src) -> bool:
        """Whether shard ``rank``'s rows ``src`` are read in place."""
        return src.device == self.device

    def fetch(self, src):
        """A static buffer on this device that ``src``'s copy fills
        before the next segment replays (allocated between captures)."""
        buf = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        self.copies[-1].append((buf, src))
        return buf

    def begin(self):
        self._prev = torch.cuda.current_stream(self.device)
        torch.cuda.set_stream(self.stream)
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool)

    def end(self):
        graph, self._graph = self._graph, None
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                graph.capture_end()
        finally:
            torch.cuda.set_stream(self._prev)
        empty = any("empty" in str(w.message) for w in caught)
        self.graphs.append(None if empty else graph)
        self.copies.append([])

    def abort(self):
        """Closes a capture that a failure left open."""
        graph, self._graph = self._graph, None
        if graph is None:
            return
        try:
            graph.capture_end()
        except RuntimeError:
            pass                        # the failure invalidated it
        finally:
            torch.cuda.set_stream(self._prev)


def halo_parts(starts, rank: int, r: int, n_images: int):
    """Shard ``rank``'s halo of radius ``r`` over blocks that start at
    image rows ``starts`` (and end at ``starts[-1]``) → (for each image,
    its parts (shard, image, first row, end row) in row order, the rows
    above the shard's own)."""
    a, b = starts[rank], starts[rank + 1]
    lo, hi = max(0, a - r), min(starts[-1], b + r)
    parts = [(j, max(lo, s) - s, min(hi, e) - s)
             for j, (s, e) in enumerate(zip(starts, starts[1:]))
             if max(lo, s) < min(hi, e)]
    return [[(j, k, s, e) for j, s, e in parts]
            for k in range(n_images)], a - lo


def gather_parts(starts, n_images: int):
    """The whole images' parts, every shard's block in rank order."""
    return [[(j, k, 0, e - s) for j, (s, e) in enumerate(zip(starts,
                                                             starts[1:]))]
            for k in range(n_images)]


class RowExchange:
    """Shard ``rank``'s side of its frame's row exchange
    (``FrameContext.exchange``). Every shard calls the same exchanges in
    the same order. Each shard's images hold consecutive rows of the
    whole image, in rank order; their row counts may differ (the
    half-res grid's). ``segments`` (a captured frame): where each
    exchange ends a segment and the next begins. ``log`` records the
    exchanges: (kind, radius, each posted image's dtype and shape)."""

    def __init__(self, step: _Lockstep, rank: int, device, segments=None):
        self.step = step
        self.rank = rank
        self.device = device
        self.segments = segments
        self.phase = 0
        self.log = []

    def _all(self, value) -> list:
        self.phase += 1
        if self.segments is not None:
            self.segments.end()
        return self.step.exchange(self.rank, self.phase, value)

    def _blocks(self, kind, r, images):
        self.log.append((kind, r, tuple((x.dtype, tuple(x.shape))
                                        for x in images)))
        blocks = self._all(tuple(images))
        sizes = [b[0].shape[0] if b else 0 for b in blocks]
        return blocks, np.concatenate([[0], np.cumsum(sizes)]).tolist()

    def _take(self, blocks, wanted) -> list:
        """For each output its parts (shard j, image k, first row, end
        row) of ``blocks[j][k]`` → the outputs on this shard's device,
        each part's rows in order; begins the next segment. A part on
        another device is copied: eagerly with ``.to``, in a captured
        frame into a static buffer (``_Segments.fetch``)."""
        seg = self.segments
        parts = []
        for want in wanted:
            parts.append([])
            for j, k, s, e in want:
                src = blocks[j][k][s:e]
                parts[-1].append(src.to(self.device) if seg is None
                                 else src if seg.local(j, src)
                                 else seg.fetch(src))
        if seg is not None:
            seg.begin()
        return [p[0] if len(p) == 1 else torch.cat(p) for p in parts]

    def halo(self, r: int, *images):
        """See FrameContext.halo."""
        blocks, starts = self._blocks("halo", r, images)
        wanted, top = halo_parts(starts, self.rank, r, len(images))
        return self._take(blocks, wanted), top

    def gather(self, *images):
        """See FrameContext.gather."""
        blocks, starts = self._blocks("gather", 0, images)
        return self._take(blocks, gather_parts(starts, len(images)))


@dataclasses.dataclass
class _Shard:
    """One shard's frame: its rows of the image, its new history, its
    frame stats (None without a G-buffer), the most tile entries its
    binning needed, and its exchanges (``RowExchange.log``)."""
    out: Any
    history: dict
    stats: Any
    needed: Any
    exchanges: list


class ShardedRenderer(CapturedRenderer):
    """The frame of ``runtime.renderer.Renderer``, its image rows sharded
    over ``mesh`` (parallel/mesh.py). ``render`` returns the whole
    (H, W, 3) image on the mesh's first device; each shard's SVGF and TAA
    history stays in buffers on its device and carries to the next
    frame. ``capture``: replay CUDA graphs (the default on a mesh of
    CUDA devices); False runs every frame eagerly."""

    def __init__(self, settings, scene_data, mesh, tracer=None,
                 capture=None):
        super().__init__(mesh.devices, capture)
        self.settings = settings
        self.mesh = mesh
        self.rows = row_sharding(mesh, settings.height)
        # every shard runs the path over a window of its height
        self.shard_settings = settings.replace(height=self.rows[0][1])
        self.path = create_render_path(self.shard_settings)
        self.scenes = replicated(mesh, scene_data)
        self.tracers = replicated(mesh, tracer) if tracer is not None \
            else (None,) * len(mesh)
        self.histories = [{} for _ in mesh.devices]
        # each key's exchanges, one list a shard, from its eager frame
        self.exchanges = {}
        self._rows = {d: torch.empty(ROW_SIZE, dtype=torch.float32,
                                     device=d) for d in mesh.distinct}
        self._stats = None

    @classmethod
    def for_scene(cls, settings, scene_data, mesh, **kw):
        """With the ray tracer attached when the path or the flags ask for
        ray-traced passes (``Renderer.for_scene``'s rule); it is built
        once and replicated on each distinct device."""
        return cls(settings, scene_data, mesh,
                   tracer=tracer_for(settings, scene_data), **kw)

    def _shard_frame(self, step, rank, history_valid, binning,
                     segments=None) -> _Shard:
        dev = self.mesh.devices[rank]
        exchange = RowExchange(step, rank, dev, segments)
        scene = self.scenes[rank]
        row = self._rows[dev]
        state = FrameState(history=self.histories[rank]
                           if history_valid else {})
        ctx = FrameContext(
            scene=scene, cam=CameraState.unpack(row),
            params=FrameParams.from_row(scene, row),
            settings=self.shard_settings, state=state,
            history_valid=history_valid, binning=binning,
            row0=self.rows[rank][0], full_height=self.settings.height,
            exchange=exchange, **trace_hooks(scene, self.tracers[rank]))
        out, new_state, registry = self.path.run(ctx, state)
        return _Shard(out, new_state.history, registry.get("_FrameStats"),
                      binning.max_needed(dev), exchange.log)

    def _result(self, shards) -> Result:
        return Result([s.out for s in shards], [s.stats for s in shards],
                      tuple(s.needed for s in shards), [])

    def _eager(self, key, undo):
        """The key's frame run eagerly, with exact tile lists → (result,
        history pairs to commit)."""
        step = _Lockstep(len(self.mesh))
        shards = step.run(
            [functools.partial(self._shard_frame, step, r, key[1],
                               Binning()) for r in range(len(self.mesh))],
            self.mesh.devices)
        self.exchanges[key] = [s.exchanges for s in shards]
        return self._result(shards), commit_pairs(
            [(h, s.history) for h, s in zip(self.histories, shards)], undo)

    def _capture(self, key, capacity) -> Graph:
        """The key's frame captured shard by shard, segment by segment,
        each shard binning into its ``capacity``, and a commit graph for
        each device."""
        devices, distinct = self.mesh.devices, self.mesh.distinct
        streams = {d: torch.cuda.Stream(d) for d in distinct}
        pools = {d: torch.cuda.graph_pool_handle() for d in distinct}
        segs = [_Segments(d, pools[d], streams[d]) for d in devices]
        for d in distinct:
            torch.cuda.synchronize(d)
        step = _Lockstep(len(self.mesh))

        def shard(rank):
            seg = segs[rank]
            try:
                seg.begin()
                s = self._shard_frame(step, rank, key[1],
                                      Binning(capacity[rank]), seg)
                pairs = commit_pairs([(self.histories[rank], s.history)])
                seg.end()
            except BaseException:
                seg.abort()
                raise
            return s, pairs

        done = step.run([functools.partial(shard, r)
                         for r in range(len(self.mesh))], devices)
        shards = [s for s, _ in done]
        if [s.exchanges for s in shards] != self.exchanges[key]:
            raise RuntimeError("the captured frame's exchanges differ from "
                               "its eager frame's")
        commits = []
        for d in distinct:
            pairs = [p for (_, ps), dev in zip(done, devices) if dev == d
                     for p in ps]
            if pairs:
                with torch.cuda.device(d):
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, stream=streams[d]):
                        for dst, src in pairs:
                            dst.copy_(src)
                commits.append(graph)
        order = []
        for k in range(len(segs[0].graphs)):
            order += [s.graphs[k].replay for s in segs
                      if s.graphs[k] is not None]
            order += [functools.partial(dst.copy_, src, non_blocking=True)
                      for s in segs for dst, src in s.copies[k]]

        def replay():
            for fn in order:
                fn()

        def commit():
            for graph in commits:
                graph.replay()

        return Graph(replay, commit, self._result(shards), capacity)

    @torch.no_grad()
    def render(self, cam_state, exposure: float = 1.0,
               svgf_phi=DEFAULT_PHI):
        """Render one frame → (H, W, 3) float32 tensor on the mesh's first
        device."""
        row = torch.from_numpy(pack_row(cam_state, exposure, svgf_phi,
                                        self.frame_count))
        for buf in self._rows.values():
            buf.copy_(row, non_blocking=True)
        key = ("frame", self.frame_count > 0)
        res, _ = self.run_key(key, functools.partial(self._eager, key),
                              functools.partial(self._capture, key))
        self._stats = res.stats
        self.frame_count += 1
        first = self.mesh.devices[0]
        return torch.cat([out.to(first) for out in res.out])

    def frame_stats(self) -> dict:
        """As ``Renderer.frame_stats``, over the whole image: every shard
        culls the same instances; covered pixels add up."""
        s = [np.zeros(3, np.int64) if x is None else x.cpu().numpy()
             for x in self._stats or [None]]
        return {"instances_drawn": int(s[0][0]),
                "instances_culled": int(s[0][1]),
                "covered_pixels": int(sum(x[2] for x in s))}
