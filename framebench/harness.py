"""One run of one cell: set-up, the measured (or traced) window, the
check against the reference, and the result line.

Set-up (``setup_s``, from the process's start to the first timed
frame): the port's import and its built libraries, the scene from the
seed, the renderer, the first two frames (eager, each capturing its
key's graphs) and WARM_FRAMES - 2 replayed frames. The window renders
frame after frame for ``--seconds``, each timed on the host clock from
the call until ``torch.cuda.synchronize()`` returns; the image stays on
the device. With ``--trace 1`` the window is TRACE_FRAMES frames under
``torch.profiler`` instead, and the per-layer metrics are read from it.
Then the check: the program's history is reset and CHECK_FRAMES more
frames of the traffic go through the same entry and captured graphs;
the program is freed; the reference renders the same frames from the
same arrays; compare.py judges them.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import compare, imports, scenegen, spec, stats
from . import profile as trace_read
from .frame_shape import FrameShape
from .traffic import Traffic

WARM_FRAMES = 5
TRACE_FRAMES = 40
CHECK_FRAMES = 2


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _err(*a):
    print(*a, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return "; ".join(out.stdout.strip().splitlines()) or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _sync(devices):
    with record_function("synchronize"):
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


class Cell:
    """A cell: its BENCHMARK.json entries, configuration, traffic
    parameters, limits and seed."""

    def __init__(self, bench, workload, config, traffic_params, limits,
                 seed):
        self.bench, self.workload, self.name = bench, workload, \
            workload["name"]
        self.config, self.traffic_params = config, traffic_params
        self.limits = limits
        self.seed = seed & (2 ** 64 - 1)
        self.shape = FrameShape.of(config["render"])

    @classmethod
    def named(cls, name: str, seed: int, root=spec.ROOT) -> "Cell":
        bench = spec.benchmark(root)
        w = spec.cell(bench, name)
        return cls(bench, w, spec.config(bench, w["config"], root),
                   spec.traffic(w["traffic"]), spec.limits(name), seed)

    def inputs(self):
        """(scene arrays, traffic) from the seed."""
        desc = scenegen.generate(self.config["scene"], self.seed)
        r = self.config["render"]
        return desc, Traffic(self.traffic_params, self.seed, r["width"],
                             r["height"], desc.kinds, desc.transforms)


def setup(cell: Cell, device, t0: float):
    """The program, built and warmed up → (program, traffic, scene
    arrays, frames rendered, setup seconds)."""
    from .program import Program

    desc, traffic = cell.inputs()
    prog = Program(cell.config, desc, traffic, device)
    for k in range(1, WARM_FRAMES + 1):
        prog.frame(k)
        _sync(prog.devices)
    return prog, traffic, desc, WARM_FRAMES, time.perf_counter() - t0


def window(prog, k0: int, seconds: float):
    """Closed loop for ``seconds`` → (frame ms each, window s)."""
    times = []
    start = time.perf_counter()
    k = k0
    while True:
        t = time.perf_counter()
        prog.frame(k)
        _sync(prog.devices)
        end = time.perf_counter()
        times.append(1e3 * (end - t))
        k += 1
        if end - start >= seconds:
            return times, end - start


def traced(prog, k0: int, cell: Cell):
    """TRACE_FRAMES frames under the profiler, each in a host span
    "frame" → Trace."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(k0, k0 + TRACE_FRAMES):
            with record_function("frame"):
                prog.frame(k)
                _sync(prog.devices)
    ops, spans = trace_read.events(prof)
    frames = [s for s in spans if s[0] == "frame"]
    first, last = min(s[1] for s in frames), max(s[2] for s in frames)
    return trace_read.Trace(
        ops=ops, spans=spans, start=first, end=last, frames=TRACE_FRAMES,
        kernel_names=trace_read.port_kernel_names(spec.ROOT),
        shape=cell.shape, counters={"capture_ms": prog.capture_ms()},
        rooflines=spec.rooflines(), peaks=spec.peaks(),
        devices=len(prog.devices))


def check(cell: Cell, prog, desc, traffic, k0: int, device):
    """The check after the window: CHECK_FRAMES frames k0.. through the
    program from a reset history; the program freed; the same frames
    through the reference → readings of the limits' numbers."""
    frames = program_frames(prog, k0)
    return compare.readings(frames, reference_frames(cell, desc, traffic,
                                                     k0, device, frames),
                            list(cell.limits))


def program_frames(prog, k0: int) -> list:
    """CHECK_FRAMES frames k0.. of the program from a reset history, on
    the host (compare.py's planes); then the program is freed."""
    prog.reset_history()
    frames = []
    for k in range(k0, k0 + CHECK_FRAMES):
        out = prog.frame(k)
        _sync(prog.devices)
        frames.append({"image": out.to("cpu", copy=True), **prog.planes()})
    prog.close()
    return frames


def reference_frames(cell, desc, traffic, k0, device, program,
                     tf32=False) -> list:
    """The reference's CHECK_FRAMES frames k0.. on ``device``, on the
    host, its SVGF filters guided by the ``program`` frames' planes.
    ``tf32`` computes its matrix products in TF32: the control, the
    precision below the configuration's."""
    from .reference.render import Reference

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        ref = Reference(cell.config, desc, traffic, device)
        ref.move_to(k0 - 1)
        return [{n: v.cpu() for n, v in ref.frame(k, guide).items()}
                for k, guide in zip(range(k0, k0 + CHECK_FRAMES), program)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def memory_peak(devices) -> int:
    return max(torch.cuda.max_memory_allocated(d) for d in devices)


def run(cell: Cell, device, seconds: float, trace: bool, t0: float,
        kind: str) -> dict:
    """Set-up, window (or traced window) and check of one run on
    ``device`` → the result (without the import check)."""
    cuda = device.type == "cuda"
    prog, traffic, desc, k, setup_s = setup(cell, device, t0)
    if trace:
        t = traced(prog, k + 1, cell)
        k += TRACE_FRAMES
        attempted = TRACE_FRAMES
        metrics = {}
        for m in spec.per_layer(cell.bench, cell.name):
            v = spec.metric(m["name"])(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": trace_read.busy_s_per_device(t),
                 "window_s": t.window_s}
        breakdown = {"device_ops": trace_read.top_ops(t),
                     "idle_gaps": trace_read.idle_gaps(t)}
    else:
        times, window_s = window(prog, k + 1, seconds)
        k += len(times)
        attempted = len(times)
        e2e = {"setup_s": setup_s,
               "frame_ms": stats.rate_ms(window_s, len(times)),
               "frame_ms_p95": stats.percentile(times, 95.0)}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(cell.bench, cell.name)}
        extra, breakdown = {}, None
    devices = list(prog.devices)
    peak = memory_peak(devices) if cuda else 0
    read = check(cell, prog, desc, traffic, k + 1, device)
    correct, checks = compare.judge(read, cell.limits)
    result = {"correct": correct, "attempted": attempted + CHECK_FRAMES,
              "failed": 0 if correct else CHECK_FRAMES, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": kind, "count": len(devices),
                         "memory_peak_bytes": int(peak), **extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv, t0: float) -> int:
    a = _args(argv)
    cell = Cell.named(a.workload, a.seed)
    chips = int(cell.workload["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        _err(f"{a.workload} needs {chips} CUDA device(s), found {have}: "
             f"no result")
        return 2
    kind = torch.cuda.get_device_name(0)
    print(f"# device {kind} x {have}; nvidia-smi name, power.limit: "
          f"{_power_limit()}", flush=True)
    result = run(cell, torch.device("cuda", 0), a.seconds, bool(a.trace),
                 t0, kind)
    found = imports.loaded_forbidden()
    if found:
        _err(f"modules of {found} were loaded in this run: no result")
        return 3
    for name, c in result["checks"].items():
        _err(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
