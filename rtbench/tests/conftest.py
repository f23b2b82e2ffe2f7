"""Shared pieces of the benchmark's tests: the ``chip`` marker for tests
that need a CUDA card (each decides inside itself, through the ``card``
fixture, and skips without one) and cells cut to a size the CPU renders in
a moment."""

import dataclasses
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rtbench import core  # noqa: E402

# the sizes of the CPU tests' cells: every width and count of a cell's
# render and traffic cut down, the kind of work kept
TINY_RENDER = {"frames": dict(width=16, height=8, spp=2, depth=5),
               "fit": dict(width=32, height=16, spp=2, depth=4)}
TINY_TRAFFIC = dict(trace_calls=2, check_frames=4, check_pixels_per_frame=8,
                    steps_per_episode=3, target_scale=4)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny_cell(name: str, chips: int | None = None) -> core.Cell:
    """The cell ``name`` of BENCHMARK.json at the CPU tests' size."""
    c = core.load_cell(name)
    key = c.traffic["render"]
    conf = dict(c.config, render={key: dict(c.config["render"][key],
                                            **TINY_RENDER[key])})
    traffic = dict(c.traffic, **{k: v for k, v in TINY_TRAFFIC.items()
                                 if k in c.traffic})
    return dataclasses.replace(c, config=conf, traffic=traffic,
                               chips=chips or c.chips)


def run_tiny(cell: core.Cell, seed: int = 2**31 + 11, trace: bool = False,
             seconds: float = 0.3, prepare=None) -> core.Outcome:
    import time
    return core.run_cell(core.Ctx(cell=cell, seed=seed, seconds=seconds,
                                  trace=trace, device="cpu",
                                  t0=time.perf_counter()), prepare=prepare)
