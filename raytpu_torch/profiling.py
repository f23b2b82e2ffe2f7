"""Render timing, run logs and traces (counterpart of
``raytpu/profiling.py``), the frame census and the program's spans.

On a card the time comes from CUDA events around the calls, after a
``torch.cuda.synchronize()``; on the CPU from the host clock.  Every result
names the device it ran on.  :func:`log_run` appends one JSON line a run;
:func:`trace`, :func:`device_ms` and :func:`device_events` take
``torch.profiler`` where raytpu takes ``jax.profiler``.  :func:`census`
counts the work of a frame (raytpu's ``count_leaves`` census,
scripts/probe_roofline.py's input): the census kernel K1' on a card, its
plain version on the CPU.

Spans.  :func:`span` marks a phase of the program as a
``torch.profiler.record_function`` range while a profiler runs, and costs
one flag test otherwise.  The spans land in the profiler's own trace,
beside the kernels, copies and CUDA runtime calls, on its clock:

- ``raytpu.render``: the whole of :func:`raytpu_torch.render.render`;
- ``raytpu.train_step``: a train step (``shard.TrainStep.__call__``), and
  inside it, in turn, ``raytpu.refit`` (``bvh.refit``), ``raytpu.forward``
  (the taping or plain forward with its wrapper), ``raytpu.loss``,
  ``raytpu.vjp`` (the backward with its wrapper; inside it
  ``raytpu.reduce``, the host side of a sharded step's all-reduce) and
  ``raytpu.sgd``;
- in the kernel wrappers (``kernels/megakernel.py``,
  ``kernels/gradkernel.py``): ``raytpu.pack``, the host's preparation of a
  launch's operands (permuted scene, packs, stage plan, sphere rows,
  outputs and tape); ``raytpu.launch``, the call into the C entry point,
  one a kernel launch; ``raytpu.scatter``, ``render_vjp``'s cast and
  scatter of the cotangents back to input order.

To see them, trace a block with :func:`trace` (``with trace(dir):``): the
Chrome trace it writes, ``dir/trace.json``, shows each span on its host
thread's row, on the same time line as the kernels and copies it queued
(the benchmark's ``--trace 1`` runs read the same spans from their
trace).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import torch

from raytpu_torch import golden
from raytpu_torch.config import RenderConfig

# the span of every phase while no profiler runs: one shared object, so a
# span costs a flag test and no allocation
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager marking a phase of the program named ``name``
    (``raytpu.<phase>``): a ``torch.profiler.record_function`` range while
    a profiler runs, else the shared null context.  The test is needed: a
    bare ``record_function`` costs 13.4 us with no profiler on an H100's
    host, this span 0.47 us (torch 2.11)."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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


def log_run(path: str, stats: RenderStats, **extra) -> None:
    """Append one JSON line to the run log ``path``: the time, ``stats``
    (with the device it ran on) and ``extra``."""
    rec = {"ts": time.time(), **stats.as_dict(), **extra}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block, CPU and (when there is a
    card) CUDA activity, written to ``log_dir/trace.json`` (Chrome trace
    format, for chrome://tracing or Perfetto); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _traced(run_once, name: str):
    """``torch.profiler`` trace of one ``run_once()`` call on the card,
    synchronised before the trace ends; raises on the CPU.

    Take it as the first trace of a process: measured on an H100 (torch
    2.11, CUDA 12.8), a trace taken after a minute of other GPU work in a
    process that has traced before held no device event of a short call
    and lost the first of a long call's, with ``TEARDOWN_CUPTI=0`` too
    (PERF.md, "Profiler traces late in a process")."""
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name} needs a CUDA card")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_once()
        torch.cuda.synchronize()
    return prof


def device_ms(run_once) -> float:
    """The card's kernel time of one call, in ms: the device time of every
    kernel ``run_once()`` launches, summed over the device-side events of a
    ``torch.profiler`` trace (the call is synchronised before the trace
    ends).  Raises when the
    trace holds no device time: on the CPU, or where the profiler cannot
    see the card (time with CUDA events there).  See :func:`_traced` on
    traces late in a process."""
    prof = _traced(run_once, "device_ms")
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler trace holds no device time")
    return us / 1e3


def device_events(run_once) -> list:
    """Every device-side event of one traced call -> ``[(name, ms), ...]``,
    longest first (raytpu's ``device_events``, raytpu/profiling.py:78-111):
    each kernel ``run_once()`` launches, and each copy or fill the card
    runs, one entry per launch, from a ``torch.profiler`` trace (see
    :func:`_traced` on traces late in a process).  Raises as
    :func:`device_ms` does: on the CPU, or on a trace that holds no device
    event."""
    prof = _traced(run_once, "device_events")
    out = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not out:
        raise RuntimeError("the profiler trace holds no device event")
    return sorted(out, key=lambda t: -t[1])


def census(scene, cam, cfg: RenderConfig, bvh=None, row0: int = 0,
           rows: int | None = None) -> dict:
    """The work of one frame -> {"leaves_entered", "bounce_steps",
    "samples", "nodes_visited", "sphere_tests", "box_tests", "device"}:
    samples traced, closest-hit steps (one per bounce taken, identical for
    every sweep), the BVH leaves those steps enter and the nodes the walk
    visits, and from them the sphere tests the sweep runs (every sphere a
    step, or the outliers plus the leaves' spheres) and the box tests
    (the flat sweep: every leaf of the ray's octant copy a step; the walk:
    the nodes it visits).  A padded leaf holds ``leaf_size`` spheres; for an
    unpadded BVH's variable leaves the sphere tests take the mean leaf
    size, an estimate.  CUDA tensors launch the census kernel K1'
    (:func:`raytpu_torch.kernels.megakernel.launch` with ``count=True``);
    CPU tensors run its plain version.  ``row0`` / ``rows``: the work of
    that row slab only."""
    from raytpu_torch.bvh import permute_scene, sweep_of
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
    counts["device"] = name
    steps = counts["bounce_steps"]
    if bvh is None:
        counts.update(sphere_tests=steps * scene.count, box_tests=0)
        return counts
    per_leaf = bvh.leaf_size or (
        int(bvh.perm.shape[0]) / int((bvh.nodes[:, 7] > 0).sum()))
    counts["sphere_tests"] = (counts["leaves_entered"] * per_leaf
                              + steps * bvh.n_outliers)
    counts["box_tests"] = (steps * bvh.n_leaves if sweep_of(bvh) == "flat"
                           else counts["nodes_visited"])
    return counts
