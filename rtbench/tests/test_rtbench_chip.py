"""The command on a card (marked ``chip``: each test skips without a CUDA
card), and its refusal without one."""

import json
import subprocess
import sys

import pytest
import torch

from rtbench import core

RUN = [sys.executable, str(core.REPO / "rtbench" / "run.py")]


def test_refuses_without_the_cards_a_cell_asks_for():
    if torch.cuda.device_count() >= 4:
        pytest.skip("this machine has the cards")
    out = subprocess.run(RUN + ["--workload", "final500.fit4", "--seed", "1",
                                "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, trace):
    out = subprocess.run(RUN + ["--workload", "final500.frames", "--seed",
                                str(2**31 + 5), "--seconds", "2", "--trace",
                                str(trace)],
                         capture_output=True, text=True, timeout=1200,
                         check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
