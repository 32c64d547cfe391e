"""Reading a ``torch.profiler`` trace of the traced frames: device
operations with their times on the trace's own timeline, the host spans
the harness wraps around its calls, and what a per-layer metric reads
of them (``Trace``)."""
from __future__ import annotations

import dataclasses
import glob
import os
import re

from torch.autograd import DeviceType

# the harness's own host spans (record_function), innermost first when
# two cover one instant; the profiler also puts each on the device's
# timeline as an annotation, which is no device operation
HOST_SPANS = ("camera", "set_entity_transform", "synchronize",
              "commit_and_render", "render", "frame")


@dataclasses.dataclass
class Trace:
    """What the traced frames left: ``ops``, device operations as (name,
    start us, end us, device index); ``spans``, host spans as (name,
    start us, end us); the traced window's [start, end] in us; the
    number of frames; the port's kernel names; the cell's frame shape;
    the program's counters; the kernel counts."""
    ops: list
    spans: list
    start: float
    end: float
    frames: int
    kernel_names: frozenset
    shape: object
    counters: dict
    rooflines: dict
    peaks: dict
    devices: int

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def per_frame_ms(self, ops) -> float:
        return sum(e - s for _, s, e, _ in ops) / 1e3 / self.frames

    def is_port_kernel(self, name: str) -> bool:
        return _kernel_of(name, self.kernel_names) is not None

    def matching(self, names) -> list:
        names = frozenset(names)
        return [o for o in self.ops if _kernel_of(o[0], names) is not None]

    @property
    def complete(self) -> bool:
        """Whether the profiler recorded device operations on every
        device the run uses."""
        return len({o[3] for o in self.ops}) >= self.devices


_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def _kernel_of(name: str, names):
    for tok in _IDENT.findall(name):
        if tok in names:
            return tok
    return None


def port_kernel_names(root) -> frozenset:
    """The ``__global__`` functions of the port's CUDA sources."""
    names = set()
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?([A-Za-z_]\w*)\s*\(")
    for path in glob.glob(os.path.join(root, "hybridrenderer_tpu_torch",
                                       "csrc", "*.cu")):
        with open(path) as f:
            names.update(pat.findall(f.read()))
    return frozenset(names)


def events(prof):
    """→ (device ops, host spans) of a finished profile."""
    ops, spans = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA and e.name not in HOST_SPANS:
            ops.append((e.name, float(tr.start), float(tr.end),
                        int(e.device_index)))
        elif e.device_type == DeviceType.CPU and e.name in HOST_SPANS:
            spans.append((e.name, float(tr.start), float(tr.end)))
    return ops, spans


def union(intervals, lo: float, hi: float) -> list:
    """The merged intervals of ``intervals`` ((start, end)) inside
    [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(t: Trace, device=None) -> float:
    ivs = [(s, e) for _, s, e, d in t.ops if device is None or d == device]
    return sum(e - s for s, e in union(ivs, t.start, t.end))


def busy_s_per_device(t: Trace) -> float:
    """Seconds in which an operation ran on the device, averaged over
    the devices the run uses."""
    return sum(busy_us(t, d) for d in range(t.devices)) / t.devices / 1e6


def short_name(name: str) -> str:
    """A device operation's name without the namespaces that every
    PyTorch or port kernel carries, cut to 160 characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(noise, "")
    return name[:160]


def top_ops(t: Trace, n: int = 10) -> list:
    """[name, device seconds a frame] of the operations that took most
    time, by name, summed over devices."""
    tot = {}
    for name, s, e, _ in t.ops:
        tot[name] = tot.get(name, 0.0) + (e - s)
    return [[short_name(name), us / 1e6 / t.frames]
            for name, us in sorted(tot.items(), key=lambda x: -x[1])[:n]]


def idle_gaps(t: Trace, n: int = 10, device: int = 0) -> list:
    """[what the host was doing, seconds] of the ``n`` longest spans of
    the traced window in which ``device`` ran nothing, labelled by the
    innermost host span that covers the gap's middle."""
    busy = union([(s, e) for _, s, e, d in t.ops if d == device],
                 t.start, t.end)
    edges = [t.start] + [x for iv in busy for x in iv] + [t.end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = 0.5 * (s + e)
        covering = [sp for sp in t.spans if sp[1] <= mid <= sp[2]]
        label = min(covering, key=lambda sp: HOST_SPANS.index(sp[0]))[0] \
            if covering else "outside the harness's spans"
        out.append([label, (e - s) / 1e6])
    return out
