"""The sharded program: on a mesh of four shards on the CPU it renders
what the one-device program renders, bit for bit, the history carried
over three frames; and the harness refuses a cell whose chips differ
from its configuration's shards, and a sharded configuration under
traffic that moves entities."""
import time

import pytest
import torch

from framebench import harness, spec
from framebench.program import Program

BENCH = spec.benchmark()
SHARDED = [w["name"] for w in BENCH["workloads"]
           if spec.config(BENCH, w["config"]).get("shards", 1) > 1]


def _small(cfg, objects=24, width=160, height=96):
    cfg["scene"].update(num_objects=objects, spheres=objects // 2,
                        tex_size=16)
    cfg["render"].update(width=width, height=height)
    return cfg


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_program_renders_the_one_device_frames(name):
    w = spec.cell(BENCH, name)
    cfg = _small(spec.config(BENCH, w["config"]))
    one = dict(cfg, shards=1)
    cell = harness.Cell(BENCH, w, cfg, spec.traffic(w["traffic"]),
                        spec.limits(name), 2 ** 31 + 21)
    desc, traffic = cell.inputs()
    cpu = torch.device("cpu")
    sharded, single = (Program(c, desc, traffic, cpu) for c in (cfg, one))
    assert len(sharded.renderer.mesh) == cfg["shards"]
    assert sharded.devices == single.devices == [cpu]
    for k in range(1, 4):
        a, b = sharded.frame(k), single.frame(k)
        assert torch.equal(a, b), k
        pa, pb = sharded.planes(), single.planes()
        assert pa.keys() == pb.keys() and {"reflection", "gi"} <= pa.keys()
        for plane in pa:
            assert torch.equal(pa[plane], pb[plane]), (k, plane)


def _bench_with(name, chips):
    bench = spec.benchmark()
    spec.cell(bench, name)["chips"] = chips
    return bench


@pytest.mark.parametrize("name,chips", [(n, 1) for n in SHARDED]
                         + [("full.orbit", 4)])
def test_main_refuses_chips_other_than_shards(name, chips, monkeypatch,
                                              capsys):
    bench = _bench_with(name, chips)
    monkeypatch.setattr(spec, "benchmark", lambda root=spec.ROOT: bench)
    rc = harness.main(["--workload", name, "--seed", "5", "--seconds", "1"],
                      time.perf_counter())
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert "shard(s): no result" in err


@pytest.mark.parametrize("name", SHARDED)
def test_setup_refuses_a_sharded_config_under_motion(name):
    w = spec.cell(BENCH, name)
    traffic = spec.traffic("dynamic")
    assert "motion" in traffic
    cell = harness.Cell(BENCH, dict(w, traffic="dynamic"),
                        _small(spec.config(BENCH, w["config"])), traffic,
                        spec.limits(name), 7)
    with pytest.raises(ValueError, match="static scenes only"):
        harness.setup(cell, torch.device("cpu"), time.perf_counter())
