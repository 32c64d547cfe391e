"""BENCHMARK.json against the benchmark's files: every configuration,
traffic mix, per-layer metric and cell is found by its name, and the
file keeps to the limits a benchmark is held to."""
import json
import os
import re

import pytest

from framebench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


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
    assert e2e == {"setup_s", "frame_ms", "frame_ms_p95"}
    assert spec.per_layer(BENCH, w["name"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert callable(spec.metric(m["name"]))
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


def test_end_to_end_bounds():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert names == ["setup_s", "frame_ms", "frame_ms_p95"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no.such.cell")
    with pytest.raises(KeyError):
        spec.metric("no_such_metric")


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
