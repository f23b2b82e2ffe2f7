"""The low-precision control: the reference in bfloat16, put in the
program's place, read by the same comparison as a run.  Its readings have
to fail a cell's limits; they set the upper end of each limit.

    python rtbench/control.py --workload <cell> --seeds 1 2 3 [--frames N]

A frames cell's control checks the pixels a run of ``--frames`` frames
would check; a fit cell's runs the reference's first steps in bfloat16
against the same in float32, on one card (the numbers are of the whole
frame on any number of cards).  One JSON line a seed.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from rtbench import (check, core, fit, reference, scenes,  # noqa: E402
                     turntable)

LOW = torch.bfloat16


def frames_control(cell: core.Cell, seed: int, frames: int, device):
    sp = scenes.on_device(scenes.build(cell.config["scene"]), seed, device)
    lap = turntable.poses(cell.config["camera"],
                          cell.traffic["poses_per_lap"])
    start = turntable.lap_start(seed, len(lap))
    _, px, py, rows = turntable.sample(seed, frames, start, cell)
    want, _ = turntable.reference_pixels(sp, cell, lap, rows, px, py)
    got, _ = turntable.reference_pixels(sp, cell, lap, rows, px, py, LOW)
    return check.image_numbers(check.image_sums(got.float().cpu(),
                                                want.cpu()))


def fit_control(cell: core.Cell, seed: int, device):
    r, tr, conf = cell.render, cell.traffic, cell.config
    arrays = scenes.build(conf["scene"])
    true = scenes.on_device(arrays, seed, device)
    start = scenes.on_device(fit.start_arrays(arrays, tr["shift"]), seed,
                             device)
    st = reference.Settings(r["width"], r["height"], r["spp"], r["depth"],
                            r["rng_mode"])
    goal = fit.target(true, conf["camera"], st, tr["target_scale"],
                      tr["target_spp"])
    want = fit.reference_steps(start, conf["camera"], st, goal, tr)
    got = fit.reference_steps(start, conf["camera"], st, goal, tr,
                              dtype=LOW)
    return fit.compare(got, want, r["width"], 1, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=0,
                    help="frames a run's window completes (frames cells)")
    args = ap.parse_args(argv)
    cell = core.load_cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        try:
            if cell.traffic["kind"] == "turntable":
                numbers = frames_control(cell, seed, args.frames, device)
            else:
                numbers = fit_control(cell, seed, device)
        except (RuntimeError, ValueError) as e:  # a control that crashes
            numbers = {"error": repr(e)}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16", "readings": numbers,
                          "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
