"""Render timing (counterpart of ``raytpu/profiling.py``'s RenderStats
and ``timed``).

On a card the time comes from CUDA events around the calls, after a
``torch.cuda.synchronize()``; on the CPU from the host clock.  Every result
names the device it ran on.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from raytpu_torch.config import RenderConfig


@dataclasses.dataclass
class RenderStats:
    """Throughput accounting for one render invocation."""

    wall_s: float
    primary_rays: int
    rays_per_sec: float
    config: str
    device: str
    label: str = "fwd"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def timed(fn, cfg: RenderConfig, label: str = "fwd",
          iters: int = 1) -> tuple[object, RenderStats]:
    """Run ``fn()`` ``iters`` times after one warm-up call and time it.

    Returns (last_result, stats).  ``fn`` returns a tensor; its device picks
    the clock.  ``primary_rays`` counts width*height*spp per call (the
    BASELINE.json workload unit).
    """
    out = fn()
    if out.is_cuda:
        dev = out.device
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(dev):
            start.record()
            for _ in range(iters):
                out = fn()
            stop.record()
        stop.synchronize()
        wall = start.elapsed_time(stop) / 1e3 / iters
        device = torch.cuda.get_device_name(dev)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        wall = (time.perf_counter() - t0) / iters
        device = "cpu"
    rays = cfg.width * cfg.height * cfg.spp
    return out, RenderStats(
        wall_s=wall, primary_rays=rays, rays_per_sec=rays / wall,
        config=f"{cfg.width}x{cfg.height} spp{cfg.spp} d{cfg.depth}",
        device=device, label=label)
