"""Readings behind a cell's limits, on the card: for each seed, a run's
set-up, a short window and the check's frames through the program, and
the reference's frames; for the control seeds also the control, the
reference computed with TF32 matrix products (the precision below the
configuration's float32 with TF32 off), read against the reference as
the program is; every number compare.py can read of the cell. Prints
one JSON line a seed:

    python3 framebench/calibrate.py --workload stress.orbit \\
        --seeds 11,12,13 --control-seeds 11,12 --seconds 2

Not part of a benchmark run."""
import argparse
import json
import os
import sys
import time


def main(argv):
    import torch

    from framebench import compare, harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    device = torch.device("cuda", 0)
    controls = {int(s) for s in a.control_seeds.split(",") if s}
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        cell = harness.Cell.named(a.workload, seed)
        prog, traffic, desc, k, setup_s = harness.setup(cell, device, t0)
        times, _ = harness.window(prog, k + 1, a.seconds)
        k += len(times) + 1
        frames = harness.program_frames(prog, k)
        names = compare.applicable(frames[0])
        t1 = time.perf_counter()
        ref = harness.reference_frames(cell, desc, traffic, k, device,
                                       frames)
        ref_s = time.perf_counter() - t1
        line = {"workload": a.workload, "seed": seed, "setup_s": setup_s,
                "reference_s": ref_s,
                "program": compare.readings(frames, ref, names)}
        if seed in controls:
            ctl = harness.reference_frames(cell, desc, traffic, k, device,
                                           frames, tf32=True)
            line["control"] = compare.readings(ctl, ref, names)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
