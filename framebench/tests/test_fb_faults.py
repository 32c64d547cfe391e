"""The check against faults: each cell's run, driven on the CPU at a
small size past the harness's look for a card, comes out correct, and
comes out not correct with the timed path broken underneath, once for
each fault the cell can have: a step that returns its state unchanged
(the history, and in the dynamic cell the scene too), half of the image
left out, and an answer altered where it is produced: one 40 x 40 block
of the image brightened by 0.5 (a single pixel is below what the image's
mean difference can see, compare.py). The cell's own limits judge."""
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


FAULTS = [(c, f) for c in CELLS
          for f in (state_unchanged, half_left_out, answer_altered)]
FAULTS += [("stress.dynamic", scene_unchanged)]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, monkeypatch):
    res = _run(name, monkeypatch)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(name, monkeypatch)
    assert not res["correct"], res["checks"]
