"""BENCHMARK.json against the benchmark's files: every configuration,
traffic mix, per-layer metric, cell and render path's reference is
found by its name, and the file keeps to the limits a benchmark is held
to."""
import importlib
import json
import os
import re

import pytest

from framebench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FRAME = {m["name"] for m in BENCH["end_to_end"]
         if m["name"].split(".")[0] == "frame_ms"}


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["framebench"]
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(c):
    assert NAME.match(c["name"])
    assert c["file"] == f"framebench/configs/{c['name']}.json"
    cfg = spec.config(BENCH, c["name"])
    assert cfg["reduced"] == c["reduced"]
    assert cfg["source"] == c["source"]
    assert {"scene", "render"} <= set(cfg)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    assert NAME.match(w["name"]) and len(w["why"]) <= 200
    assert w["chips"] in (1, 4)
    assert spec.config(BENCH, w["config"])
    assert "camera" in spec.traffic(w["traffic"])
    limits = spec.limits(w["name"])
    assert limits and all(v >= 0 for v in limits.values())
    e2e = {m["name"] for m in spec.end_to_end(BENCH, w["name"])}
    # set-up and a frame time: frame_ms, or frame_ms.<kind> bounded apart
    assert "setup_s" in e2e and len(e2e & FRAME) == 1
    assert {n.split(".")[0] for n in e2e} <= {"setup_s", "frame_ms",
                                              "frame_ms_p95"}
    assert spec.per_layer(BENCH, w["name"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert callable(spec.metric(m["name"]))
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    for name in m.get("workloads", cells):      # each reports what it moves
        assert m["moves"] in {e["name"] for e in spec.end_to_end(BENCH, name)}


def test_end_to_end_bounds():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert names[:3] == ["setup_s", "frame_ms", "frame_ms_p95"]
    assert {n.split(".")[0] for n in names[3:]} <= set(names[1:3])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_reference_found_by_the_render_path(c):
    # reference/<path lower-cased>.py: a configuration on another path
    # brings its reference as a file of its own, and the harness (which
    # asks spec.reference) needs no edit
    path = spec.config(BENCH, c["name"])["render"]["path"]
    ref = spec.reference(path)
    mod = importlib.import_module(f"framebench.reference.{path.lower()}")
    assert mod.Reference is ref
    assert callable(ref.frame) and callable(ref.move_to)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no.such.cell")
    with pytest.raises(KeyError):
        spec.metric("no_such_metric")
    for path in ("NO_SUCH_PATH", "../render", "Render.py", ""):
        with pytest.raises(KeyError):
            spec.reference(path)


def test_every_roofline_file_counts():
    peaks = spec.peaks()
    assert peaks["hbm_bytes_per_s"] > 0 and peaks["fp32_flops_per_s"] > 0
    for name, mod in spec.rooflines().items():
        assert mod.NAMES and all(n.endswith("_kernel") for n in mod.NAMES)
        assert f"{name}_roofline" in {m["name"] for m in BENCH["per_layer"]}


def test_traffic_files_are_data():
    folder = os.path.join(spec.HERE, "traffic")
    for f in os.listdir(folder):
        assert f.endswith(".json")
        with open(os.path.join(folder, f)) as fh:
            json.load(fh)
