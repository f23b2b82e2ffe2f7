"""The harness is driven by data: a copy of the benchmark to which a
configuration, a traffic mix, a limits file and a per-layer metric are
added as files of their own, with entries in BENCHMARK.json, runs the new
cell and reads the new metric without an edit to any file it had."""

import json
import shutil
import time

from rtbench import core

from conftest import TINY_RENDER, TINY_TRAFFIC


def test_added_files_are_picked_up(tmp_path):
    root = core.REPO
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "rtbench").rglob("*")
              if p.is_file()}
    base = tmp_path / "rtbench"
    (base / "configs" / "two_balls.json").write_text(json.dumps({
        "name": "two_balls", "source": "BASELINE.json config 1",
        "scene": {"builder": "listed", "spheres": [
            [[0.0, -100.5, -1.0], 100.0, 0, [0.5, 0.5, 0.5], 1.0],
            [[0.0, 0.0, -1.0], 0.5, 0, [0.7, 0.3, 0.3], 1.0]]},
        "bvh": None,
        "camera": {"look_from": [0.0, 0.0, 1.0], "look_at": [0.0, 0.0, -1.0],
                   "vfov": 60.0},
        "render": {"frames": TINY_RENDER["frames"] | {"rng_mode":
                                                      "sequential"}},
        "closest_hit_charge": {"spheres": "all", "boxes": 0}}))
    traffic = {"kind": "turntable", "render": "frames", "poses_per_lap": 8}
    traffic |= {k: TINY_TRAFFIC[k] for k in ("trace_calls", "check_frames",
                                             "check_pixels_per_frame")}
    (base / "traffic" / "spin8.json").write_text(json.dumps(traffic))
    (base / "limits" / "two_balls.frames.json").write_text(json.dumps(
        {"px_off_share": 0.01, "img_mae": 0.001}))
    (base / "metrics" / "calls_traced.py").write_text(
        "def read(run):\n    return run.traced or None\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "two_balls", "source": "x",
                            "file": "rtbench/configs/two_balls.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "two_balls.spin8",
                              "config": "two_balls", "traffic": "spin8",
                              "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "calls_traced", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry", "moves": "frame_ms",
                              "workloads": ["two_balls.spin8"]})
    spec["end_to_end"] = [dict(m, workloads=m["workloads"]
                               + ["two_balls.spin8"])
                          if m["name"].startswith("frame") else m
                          for m in spec["end_to_end"]]

    cell = core.load_cell("two_balls.spin8", spec, root=tmp_path)
    assert [m["name"] for m in cell.per_layer][-1] == "calls_traced"
    for trace in (False, True):
        out = core.run_cell(core.Ctx(cell=cell, seed=9, seconds=0.2,
                                     trace=trace, device="cpu",
                                     t0=time.perf_counter()))
        line = core.result(cell, out, trace, {"platform": "cpu"},
                           base=base)
        assert line["correct"]
        names = set(line["metrics"])
        assert ({"calls_traced"} <= names if trace else
                {"frame_ms", "frame_p95_ms", "setup_s"} == names)
    for p, data in before.items():
        assert p.read_bytes() == data, p
