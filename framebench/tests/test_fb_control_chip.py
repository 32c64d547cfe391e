"""The control on the card: for each cell, at a size a test run holds
(640 x 360, 250 objects), the program's check frames are within the
cell's limits and the control's are not. The control is the
reference computed with TF32 matrix products, the precision below the
configuration's float32 with TF32 off, guided by the program's planes
and read against the reference as the program is. Run on a card:

    python -m pytest -p no:cacheprovider -m cuda framebench/tests
"""
import time

import pytest
import torch

from framebench import compare, harness, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102,
                                  2 ** 31 + 103])
def test_control_fails_where_the_program_passes(name, seed):
    w = spec.cell(BENCH, name)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < w["chips"]:
        pytest.skip(f"needs {w['chips']} NVIDIA card(s), found {have}")
    card = torch.device("cuda", 0)
    cfg = spec.config(BENCH, w["config"])
    cfg["scene"].update(num_objects=250, spheres=110)
    cfg["render"].update(width=640, height=360)
    limits = spec.limits(name)
    cell = harness.Cell(BENCH, w, cfg, spec.traffic(w["traffic"]), limits,
                        seed)
    prog, traffic, desc, k, _ = harness.setup(cell, card,
                                              time.perf_counter())
    k += len(harness.window(prog, k + 1, 0.5)[0]) + 1
    frames = harness.program_frames(prog, k)
    ref = harness.reference_frames(cell, desc, traffic, k, card, frames)
    ctl = harness.reference_frames(cell, desc, traffic, k, card, frames,
                                   tf32=True)
    ok, checks = compare.judge(compare.readings(frames, ref, list(limits)),
                               limits)
    assert ok, checks
    bad, checks = compare.judge(compare.readings(ctl, ref, list(limits)),
                                limits)
    assert not bad, checks
