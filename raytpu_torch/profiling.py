"""Render timing (counterpart of ``raytpu/profiling.py``'s RenderStats
and ``timed``) and the frame census.

On a card the time comes from CUDA events around the calls, after a
``torch.cuda.synchronize()``; on the CPU from the host clock.  Every result
names the device it ran on.  :func:`census` counts the work of a frame
(raytpu's ``count_leaves`` census, scripts/probe_roofline.py's input): the
census kernel K1' on a card, its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from raytpu_torch import golden
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


def census(scene, cam, cfg: RenderConfig, bvh=None, row0: int = 0,
           rows: int | None = None) -> dict:
    """The work of one frame -> {"leaves_entered", "bounce_steps",
    "samples", "sphere_tests", "box_tests", "device"}: samples traced,
    closest-hit steps (one per bounce taken, identical for the brute and the
    BVH sweep), the BVH leaves those steps enter, and from them the sphere
    tests the sweep runs (every sphere a step, or the outliers plus
    ``leaf_size`` a leaf entered) and the leaf-box tests (every leaf of the
    ray's octant copy a step).  CUDA tensors launch the census kernel K1'
    (:func:`raytpu_torch.kernels.megakernel.launch` with ``count=True``);
    CPU tensors run its plain version.  ``row0`` / ``rows``: the work of
    that row slab only."""
    from raytpu_torch.bvh import permute_scene
    from raytpu_torch.kernels import megakernel
    device = megakernel.check_inputs(scene, cam, cfg)
    if device.type == "cpu":
        counts = dict.fromkeys(golden.CENSUS, 0)
        golden.render_golden(scene, cam, cfg, bvh, census=counts, row0=row0,
                             rows=rows)
        name = "cpu"
    else:
        packed = megakernel.pack_scene(scene if bvh is None else
                                       permute_scene(scene, bvh.perm))
        _, cnt = megakernel.launch(megakernel.pack_camera(cam), packed, cfg,
                                   bvh, count=True, row0=row0, rows=rows)
        counts = dict(zip(golden.CENSUS, (int(c) for c in cnt.tolist())))
        name = torch.cuda.get_device_name(device)
    steps = counts["bounce_steps"]
    if bvh is None:
        counts["sphere_tests"] = steps * scene.count
        counts["box_tests"] = 0
    else:
        counts["sphere_tests"] = (counts["leaves_entered"] * bvh.leaf_size
                                  + steps * bvh.n_outliers)
        counts["box_tests"] = steps * bvh.n_leaves
    counts["device"] = name
    return counts
