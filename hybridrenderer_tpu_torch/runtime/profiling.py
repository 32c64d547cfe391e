"""Per-pass timing (hybridrenderer_tpu/runtime/profiling.py) — the
reference engine's declared GPU timestamp queries (RenderGraph.h:319-343)
made real.

A captured frame is one CUDA graph, so per-pass times do not exist in
it; ``profile_frame`` runs one frame of the renderer's path eagerly, one
pass at a time, after the renderer's current history (which it leaves
as it was), and times each pass: with CUDA events on the card, with the
host clock on the CPU. Use it for guidance; the eager passes launch
what the graph launches, plus the host's dispatch gaps between them.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from ..graph.params import pack_row
from .renderer import DEFAULT_PHI


def _time_ms(fn, iters: int, device) -> tuple:
    """(ms a call of ``fn`` over ``iters`` calls after one untimed call,
    its last result)."""
    out = fn()
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return 1e3 * (time.perf_counter() - t0) / iters, out


@torch.no_grad()
def profile_frame(renderer, cam_state, iters: int = 5) -> Dict[str, float]:
    """Returns {pass_name: ms} for one frame of ``renderer``'s path."""
    row = torch.from_numpy(pack_row(cam_state, 1.0, DEFAULT_PHI,
                                    renderer.frame_count)).to(renderer.device)
    hv = renderer.frame_count > 0
    ctx, state = renderer._context(row, renderer.scene, renderer.tracer,
                                   renderer._history_for(hv), hv)
    timings: Dict[str, float] = {}

    def run_pass(p, registry, ctx):
        timings[p.name], out = _time_ms(lambda: p.fn(registry, ctx), iters,
                                        renderer.device)
        return out

    renderer.path.graph.execute({}, ctx, state, run_pass=run_pass)
    return timings


def print_profile(timings: Dict[str, float]):
    total = sum(timings.values())
    width = max(len(k) for k in timings)
    for name, ms in timings.items():
        bar = "#" * int(40 * ms / max(total, 1e-9))
        print(f"{name:<{width}}  {ms:8.2f} ms  {bar}")
    print(f"{'TOTAL (unfused)':<{width}}  {total:8.2f} ms")
