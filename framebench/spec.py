"""Discovery by name: BENCHMARK.json at the checkout's root names the
cells and metrics; each configuration, traffic mix, per-layer metric,
kernel count and set of limits is a file of its own under framebench/,
found by its name:

* ``configs/<config>.json`` (the cell's ``config``; the file BENCHMARK.json
  gives),
* ``traffic/<traffic>.json``,
* ``metrics/<metric>.py`` with ``read(trace) -> number or None``,
* ``roofline/<kernel>.py`` with ``NAMES`` (the kernel's function names in
  the port's csrc/) and ``count(shape) -> (bytes, flop)`` a frame,
* ``limits/<cell>.json``: each compared number's limit.
"""
from __future__ import annotations

import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root=ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(cell_name: str) -> dict:
    return _json(os.path.join(HERE, "limits", f"{cell_name}.json"))


def _module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"framebench.{kind}.{name.replace('.', '_')}", path)
    if spec is None or not os.path.exists(path):
        raise KeyError(f"no {kind} file {name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str):
    """The reader of per-layer metric ``name``."""
    return _module("metrics", name).read


def rooflines() -> dict:
    """Kernel → its count module, every file under roofline/."""
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "roofline", "*.py"))):
        name = os.path.basename(path)[:-3]
        out[name] = _module("roofline", name)
    return out


def peaks() -> dict:
    return _json(os.path.join(HERE, "roofline", "peaks.json"))


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics the cell reports: those that list it, and
    those without a ``workloads`` key."""
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])]


def end_to_end(bench: dict, cell_name: str) -> list:
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]
