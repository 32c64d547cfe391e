"""The captured sharded frame's machinery that runs without a card
(hybridrenderer_tpu_torch/parallel/sharded.py, runtime/capture.py
``CapturedRenderer``): the exchange plan each shard records, the static
buffers and copies that carry rows between devices in a captured frame,
and the capture / replay / overflow rule both renderers follow. The
captured frames themselves run on the card (tests/test_torch_cuda.py)."""
import pytest
import torch

from hybridrenderer_tpu_torch import native
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
from hybridrenderer_tpu_torch.parallel.mesh import make_mesh
from hybridrenderer_tpu_torch.parallel.sharded import (RowExchange,
                                                       ShardedRenderer,
                                                       _Lockstep, _Segments)
from hybridrenderer_tpu_torch.runtime import capture as capture_mod
from hybridrenderer_tpu_torch.runtime import profiling
from hybridrenderer_tpu_torch.runtime.capture import (CapturedRenderer,
                                                      Graph, Result)
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene import scene as scenes

from .test_torch_slice import CUBE_CAM
from .torch_parity import one_torch_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def test_exchange_plan_same_on_every_shard_and_frame():
    """Hybrid frames (SVGF, shadow and AO rays) on 4 CPU shards of 8 rows:
    every shard records the same exchanges in the same order (kind,
    radius, images; only their row counts may differ), and each key's
    plan is the same on every frame."""
    s = RenderSettings(width=32, height=32, path=RenderPathType.HYBRID,
                       flags=RenderFlags.default_hybrid())
    r = ShardedRenderer.for_scene(s, scenes.cube_scene().build("cpu"),
                                  make_mesh(devices=["cpu"] * 4))
    assert not r.capture
    cam = OrbitCamera(width=32, height=32, **CUBE_CAM)
    plans = []
    for _ in range(3):
        r.render(cam.step(True))
        plans.append({k: [list(p) for p in v] for k, v in
                      r.exchanges.items()})
    first, later = ("frame", False), ("frame", True)
    assert plans[1][later] == plans[2][later]
    assert plans[2][first] == plans[0][first]
    for key in (first, later):
        shards = plans[2][key]

        def rowless(plan):
            return [(kind, rad, [(dt, shape[1:]) for dt, shape in imgs])
                    for kind, rad, imgs in plan]

        assert all(rowless(p) == rowless(shards[0]) for p in shards[1:])
        kinds = {kind for kind, _, _ in shards[0]}
        # the history is gathered only when it is valid
        assert kinds == ({"halo", "gather"} if key == later else {"halo"})


class _CopySegments(_Segments):
    """_Segments without a card: nothing is captured, every other shard's
    rows count as another device's (so each comes through a static buffer
    and a copy), and the copies run where a replay runs them, between
    the segments."""

    def __init__(self, rank):
        super().__init__(torch.device("cpu"), None, None)
        self.rank = rank

    def local(self, rank, src):
        return rank == self.rank

    def begin(self):
        for dst, src in self.copies[-1] if self.copies else ():
            dst.copy_(src)

    def end(self):
        self.graphs.append(None)
        self.copies.append([])


def test_static_buffers_and_copy_plan_match_exchange():
    """Two images (float (H, W, 3), int (H, W)) in blocks of 5, 3, 4 and 4
    rows (unequal, as half-res grids are) on 4 shards: halos of radius 1,
    2 and 8 (beyond the next shard) and a gather through static
    buffers and their copy plan give exactly what RowExchange gives
    eagerly, and the whole image's rows; every copy reads another shard's
    rows, in place, so a replay after the sources change fills the
    buffers with the new rows."""
    gen = torch.Generator().manual_seed(0)
    rows = [5, 3, 4, 4]
    whole = (torch.rand(sum(rows), 6, 3, generator=gen),
             torch.randint(0, 99, (sum(rows), 6), generator=gen))
    starts = [0, 5, 8, 12, 16]
    blocks = [tuple(x[a:b].clone() for x in whole)
              for a, b in zip(starts, starts[1:])]

    def shard(rank, step, segments):
        ex = RowExchange(step, rank, torch.device("cpu"), segments)
        if segments is not None:
            segments.begin()
        out = [ex.halo(r, *blocks[rank]) for r in (1, 2, 8)]
        out.append(ex.gather(*blocks[rank]))
        if segments is not None:
            segments.end()
        return out

    results = {}
    for planned in (False, True):
        step = _Lockstep(4)
        segs = [_CopySegments(r) if planned else None for r in range(4)]
        results[planned] = step.run(
            [lambda r=r: shard(r, step, segs[r]) for r in range(4)],
            [torch.device("cpu")] * 4), segs
    (eager, _), (planned, segs) = results[False], results[True]
    for rank in range(4):
        a, b = starts[rank], starts[rank + 1]
        for i, r in enumerate((1, 2, 8)):
            (e_out, e_top), (p_out, p_top) = eager[rank][i], planned[rank][i]
            lo, hi = max(0, a - r), min(16, b + r)
            assert e_top == p_top == a - lo
            for e, p, w in zip(e_out, p_out, whole):
                assert torch.equal(e, p) and torch.equal(p, w[lo:hi])
        for e, p, w in zip(eager[rank][3], planned[rank][3], whole):
            assert torch.equal(e, p) and torch.equal(p, w)
    # every copy reads another shard's block in place, and only the rows
    # the outputs need from other shards are copied: the radius-1 halo of
    # shard 1 copies one row above and one below of each image
    ptrs = {x.untyped_storage().data_ptr(): j
            for j, blk in enumerate(blocks) for x in blk}
    for rank, seg in enumerate(segs):
        for dst, src in (c for cs in seg.copies for c in cs):
            j = ptrs.get(src.untyped_storage().data_ptr())
            assert j != rank
    assert [tuple(d.shape[0] for d, _ in cs) for cs in segs[1].copies[:1]] \
        == [(1, 1, 1, 1)]
    for blk in blocks:
        for x in blk:
            x += 1
    for seg in segs:
        for dst, src in (c for cs in seg.copies for c in cs):
            dst.copy_(src)
            assert torch.equal(dst, src)


def _owner(capture=None):
    """The captured-frame rule's owner, of fake frames on a CUDA device
    that it never touches: captured by default."""
    return CapturedRenderer((torch.device("cuda"),), capture)


def _frames(owner, script, fail=()):
    """owner.run_key over a fake two-shard frame: ``script`` gives each
    replay's needed tile entries; capture number i in ``fail`` raises.
    → (calls: eager runs, captures (capacity), commits), a buffer the
    eager frame commits into, render()."""
    calls = dict(eager=0, captures=[], commits=0)
    buf = torch.zeros(2)
    kernel = next(iter(native.KERNELS))

    def eager(undo):
        calls["eager"] += 1
        undo.append(lambda: calls.__setitem__("undone", True))
        res = Result("eager", None, (torch.tensor(10), torch.tensor(20)),
                     [])
        return res, [(buf, torch.ones(2))]

    def capture(capacity):
        calls["captures"].append(capacity)
        native.add_counts({kernel: (3, 0)})     # the capture's launches
        if len(calls["captures"]) in fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        res = Result("graph", None, None, [])

        def replay():
            res.needed = tuple(torch.tensor(n) for n in script.pop(0))

        def commit():
            calls["commits"] += 1

        return Graph(replay, commit, res, capacity)

    def render():
        return owner.run_key(("frame", True), eager, capture)

    return calls, buf, render, kernel


def test_run_key_capture_replay_and_overflow(monkeypatch):
    """The first use runs eagerly, is captured at a capacity for each
    shard from what it needed, and is committed; replays commit and add
    the launches their capture made; a replay that overflows one shard's
    capacity is captured again (that shard's capacity grown, the other's
    kept), replayed and committed once."""
    monkeypatch.setattr(capture_mod, "BIN_SLACK", 0)
    native.reset_counts()
    owner = _owner()
    calls, buf, render, kernel = _frames(owner, [(10, 40), (11, 39),
                                                 (12, 45), (12, 45)])
    res, replayed = render()
    assert (res.out, replayed, calls["eager"]) == ("eager", False, 1)
    assert calls["captures"] == [(20, 40)] and torch.equal(buf,
                                                           torch.ones(2))
    assert native.KERNELS[kernel].launches == 0      # taken back
    for n in range(2):
        res, replayed = render()
        assert (res.out, replayed) == ("graph", True)
        assert native.KERNELS[kernel].launches == 3 * (n + 1)
    # the third replay needed 45 entries on shard 1, above its 40 → 90;
    # the overflowed replay and the new graph's both count
    res, replayed = render()
    assert (res.out, replayed) == ("graph", True)
    assert calls["captures"] == [(20, 40), (20, 90)]
    assert calls["commits"] == 3 and calls["eager"] == 1
    assert native.KERNELS[kernel].launches == 12
    assert owner.graphs[("frame", True)].capacity == (20, 90)
    assert owner.recaptures == 1


def test_run_key_host_spans_nest(monkeypatch):
    """With a tracer, run_key's host spans: each replay's frame launch,
    tile read and commit launch, and a recapture holding its launch and
    tile read, nested on the profiler's timeline; the eager frame's
    commit is a device span (host clock on the CPU)."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(capture_mod, "BIN_SLACK", 0)
    owner = _owner()
    owner.tracing = profiling.Tracer("cpu")     # the host clock
    _, _, render, _ = _frames(owner, [(10, 20), (30, 20), (30, 20)])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            render()
    tot = owner.tracing.totals()
    assert {k: n for k, (_, n) in tot["host"].items()} == {
        "replay": 3, "tile_read": 3, "commit": 2, "recapture": 1}
    assert {k: n for k, (_, n) in tot["device"].items()} == {"commit": 1}
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.name.startswith(profiling.PREFIX)),
                   key=lambda sp: sp[1])
    assert [n for n, _, _ in spans].count("hr.replay") == 3
    (_, r0, r1), = [s for s in spans if s[0] == "hr.recapture"]
    inside = [n for n, s, e in spans if r0 <= s and e <= r1 and
              n != "hr.recapture"]
    assert inside == ["hr.replay", "hr.tile_read"]
    assert owner.recaptures == 1


def test_run_key_fixed_capacity_and_capture_failure():
    """With bin_capacity fixed, a replay that overflows raises before its
    commit; a frame that cannot be captured raises with the eager frame's
    commits taken back and nothing committed, on the card nothing falls
    back to eager; without capture every use runs eagerly."""
    owner = _owner()
    owner.bin_capacity = 15
    calls, buf, render, _ = _frames(owner, [(16, 3)])
    render()
    assert calls["captures"] == [(15, 15)]
    with pytest.raises(RuntimeError, match="fixed binning capacity"):
        render()
    assert calls["commits"] == 0
    owner = _owner()
    calls, buf, render, _ = _frames(owner, [], fail=(1,))
    with pytest.raises(RuntimeError, match="cannot be captured"):
        render()
    assert calls.get("undone") and not owner.graphs
    assert torch.equal(buf, torch.zeros(2))
    owner = _owner(capture=False)
    calls, buf, render, _ = _frames(owner, [])
    for _ in range(2):
        assert render()[1] is False
    assert calls["eager"] == 2 and not calls["captures"]


def _single(s, data, **kw):
    return Renderer.for_scene(s, data, **kw)


def _sharded(s, data, **kw):
    return ShardedRenderer.for_scene(s, data,
                                     make_mesh(devices=["cpu"] * 2), **kw)


@pytest.mark.parametrize("make", [_single, _sharded],
                         ids=["Renderer", "ShardedRenderer"])
def test_cpu_renderer_state_and_refusal(make):
    """Both renderers on CPU inputs: asked for CUDA graphs they raise;
    by default two frames run eagerly and capture no graph, with the
    captured frame's state as it starts: no capture time, no recapture
    and a capacity sized per key."""
    s = RenderSettings(width=16, height=16, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT | RenderFlags.IBL)
    data = scenes.cube_scene().build("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        make(s, data, capture=True)
    r = make(s, data)
    assert not r.capture
    assert (r.capture_ms, r.recaptures, r.bin_capacity) == ({}, 0, None)
    cam = OrbitCamera(width=16, height=16, **CUBE_CAM)
    for _ in range(2):
        assert r.render_np(cam.step()).shape == (16, 16, 3)
    assert r.frame_count == 2 and r.graphs == {}
    assert (r.capture_ms, r.recaptures, r.bin_capacity) == ({}, 0, None)
