"""The check against faults: each cell's run, driven on the CPU at a
small size past the harness's look for a card, comes out correct, and
comes out not correct with the timed path broken underneath, once for
each fault the cell can have: a step that returns its state unchanged
(the history, and in the dynamic cell the scene too), half of the image
left out, an answer altered where it is produced: one 40 x 40 block
of the image brightened by 0.5 (a single pixel is below what the image's
mean difference can see, compare.py), and in a sharded cell (four shards
on the CPU) the exchange between shards left out. The forward cell has
two of its own: the forward pass's shadow query answering "lit"
everywhere, and TAA's history fetch returning the current colour in
place of the reprojected history. The cell's own limits judge."""
import time

import pytest
import torch

from framebench import harness, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _small(name):
    w = spec.cell(BENCH, name)
    cfg = spec.config(BENCH, w["config"])
    cfg["scene"].update(num_objects=24, spheres=10, tex_size=16)
    if cfg.get("shards", 1) > 1:
        # the seams between shards have to cross shadows and objects, as
        # they do among the cell's 1,000: across 24 objects' floor and sky
        # a shard left without its neighbours' rows reads under the limits
        cfg["scene"].update(num_objects=200, spheres=96)
    cfg["render"].update(width=96, height=64)
    return harness.Cell(BENCH, w, cfg, spec.traffic(w["traffic"]),
                        spec.limits(name), 2 ** 31 + 11)


def _run(name, monkeypatch):
    monkeypatch.setattr(harness, "WARM_FRAMES", 3)
    res = harness.run(_small(name), torch.device("cpu"), 0.05, False,
                      time.perf_counter(), "cpu")
    return res


def _wrap_path_run(monkeypatch, change):
    from hybridrenderer_tpu_torch.paths.base import RenderPath

    orig = RenderPath.run

    def run(self, ctx, state):
        out, new_state, registry = orig(self, ctx, state)
        return change(out, state, new_state, ctx), registry

    monkeypatch.setattr(RenderPath, "run",
                        lambda self, ctx, state: _unpack(run(self, ctx, state)))


def _unpack(pair):
    (out, new_state), registry = pair
    return out, new_state, registry


def state_unchanged(monkeypatch):
    # from the second frame on the history is handed back as it came
    _wrap_path_run(monkeypatch, lambda out, state, new, ctx: (
        out, state if ctx.history_valid else new))


def half_left_out(monkeypatch):
    def change(out, state, new, ctx):
        out = out.clone()
        out[out.shape[0] // 2:] = 0.0
        return out, new
    _wrap_path_run(monkeypatch, change)


def answer_altered(monkeypatch):
    def change(out, state, new, ctx):
        out = out.clone()
        out[:40, :40] += 0.5
        return out, new
    _wrap_path_run(monkeypatch, change)


def scene_unchanged(monkeypatch):
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    monkeypatch.setattr(Renderer, "_updated",
                        lambda self, *a, **kw: (self.scene, self.tracer))


def exchange_left_out(monkeypatch):
    # the rows a shard would take from the other shards (halos, gathers)
    # arrive as zeros
    from hybridrenderer_tpu_torch.parallel.sharded import RowExchange

    orig = RowExchange._take

    def take(self, blocks, wanted):
        blocks = [b if j == self.rank else tuple(map(torch.zeros_like, b))
                  for j, b in enumerate(blocks)]
        return orig(self, blocks, wanted)

    monkeypatch.setattr(RowExchange, "_take", take)


def shadow_lit(monkeypatch):
    from hybridrenderer_tpu_torch.ops.trace import SceneTracer

    monkeypatch.setattr(
        SceneTracer, "shadow_query",
        lambda self, world_pos, *a, **kw: torch.ones(
            world_pos.shape[:2], device=world_pos.device))


def history_is_current(monkeypatch):
    from hybridrenderer_tpu_torch.ops import taa

    resolve, current = taa.resolve, {}

    def keep(cur, *a, **kw):
        current["colour"] = cur
        return resolve(cur, *a, **kw)

    monkeypatch.setattr(taa, "resolve", keep)
    monkeypatch.setattr(taa, "window_sample",
                        lambda image, uv: current["colour"])


FAULTS = [(c, f) for c in CELLS
          for f in (state_unchanged, half_left_out, answer_altered)]
FAULTS += [("stress.dynamic", scene_unchanged)]
FAULTS += [("forward.orbit", shadow_lit), ("forward.orbit",
                                           history_is_current)]
FAULTS += [(w["name"], exchange_left_out) for w in BENCH["workloads"]
           if spec.config(BENCH, w["config"]).get("shards", 1) > 1]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, monkeypatch):
    res = _run(name, monkeypatch)
    assert res["correct"], res["checks"]
    # the cell's end-to-end metrics, frame_ms.sharded read as frame_ms
    assert set(res["metrics"]) == {m["name"] for m in
                                   spec.end_to_end(BENCH, name)}
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(name, monkeypatch)
    assert not res["correct"], res["checks"]
