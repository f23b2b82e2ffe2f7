"""Traffic kind ``turntable``: a closed loop of frames, one in flight, the
camera circling the configuration's look-at point at its camera's
distance and height, ``poses_per_lap`` poses a lap, the lap's start drawn
from the seed.  Every seed renders the same poses in another order.

A frame ends with its image in host memory.  After the window a sample of
the frames, drawn from the seed, is checked at a sample of pixels each
against the reference.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from rtbench import check, core, reference, scenes
from rtbench import measure
from rtbench.measure import Trace


def poses(camera: dict, n: int) -> list:
    """The lap's ``n`` (look_from, look_at) pairs; pose 0 is the
    configuration's camera."""
    f, at = camera["look_from"], camera["look_at"]
    dx, dz = f[0] - at[0], f[2] - at[2]
    r, a0 = math.hypot(dx, dz), math.atan2(dz, dx)
    return [((at[0] + r * math.cos(a0 + 2 * math.pi * k / n), f[1],
              at[2] + r * math.sin(a0 + 2 * math.pi * k / n)), tuple(at))
            for k in range(n)]


def lap_start(seed: int, n: int) -> int:
    return int(np.random.default_rng(seed).integers(n))


def check_pixels(seed: int, frame: int, width: int, height: int,
                 count: int):
    """The pixels (x, y) checked in frame ``frame``, drawn from the seed."""
    rg = np.random.default_rng([seed, frame])
    flat = rg.choice(width * height, size=count, replace=False)
    return flat % width, flat // width


def check_frames(seed: int, frames: int, count: int) -> np.ndarray:
    """The frames checked: all of them, or ``count`` drawn from the seed
    with the window's last frame among them."""
    if frames <= count:
        return np.arange(frames)
    rg = np.random.default_rng([seed, frames])
    pick = rg.choice(frames - 1, size=count - 1, replace=False)
    return np.sort(np.append(pick, frames - 1))


def sample(seed: int, frames: int, start: int, cell: core.Cell):
    """The checked frames of a window of ``frames`` frames and their
    pixels -> (frames, x, y, pose of each pixel)."""
    r, tr = cell.render, cell.traffic
    n = tr["check_pixels_per_frame"]
    picked = check_frames(seed, frames, tr["check_frames"])
    px, py, rows = [], [], []
    for f in picked:
        xs, ys = check_pixels(seed, int(f), r["width"], r["height"], n)
        px.append(xs)
        py.append(ys)
        rows += [(start + int(f)) % tr["poses_per_lap"]] * n
    return picked, np.concatenate(px), np.concatenate(py), rows


def reference_pixels(sp, cell: core.Cell, lap: list, rows, px, py,
                     dtype=torch.float32):
    """The reference's pixels ``(px, py)``, each of the pose ``rows``
    names, computed in ``dtype`` -> (pixels (P, 3), bounce steps)."""
    r, cam_spec = cell.render, cell.config["camera"]
    dev = sp.center.device
    cams = [reference.camera(f, at, cam_spec["vfov"],
                             r["width"] / r["height"], device=dev,
                             dtype=dtype) for f, at in lap]
    idx = torch.as_tensor(rows, device=dev)
    cam = reference.Camera(*(torch.stack([c[i] for c in cams])[idx]
                             for i in range(4)))
    st = reference.Settings(r["width"], r["height"], r["spp"], r["depth"],
                            r["rng_mode"])
    return reference.pixels(sp.to(dtype), cam, st,
                            torch.as_tensor(px, device=dev),
                            torch.as_tensor(py, device=dev))


def run(ctx: core.Ctx) -> core.Outcome:
    import raytpu_torch as rt
    cell, seed = ctx.cell, ctx.seed
    r, tr, conf = cell.render, cell.traffic, cell.config
    w, h = r["width"], r["height"]
    dev = torch.device(ctx.device)
    sp = scenes.on_device(scenes.build(conf["scene"]), seed, dev)
    scene = rt.Scene(sp.center, sp.radius, sp.mat.to(torch.int32),
                     sp.albedo, sp.param)
    bvh = (rt.build_bvh(scene, **conf["bvh"]) if conf.get("bvh")
           else None)
    cfg = rt.RenderConfig(width=w, height=h, spp=r["spp"], depth=r["depth"],
                          rng_mode=r["rng_mode"])
    lap = poses(conf["camera"], tr["poses_per_lap"])
    cams = [rt.make_camera(f, at, vfov=conf["camera"]["vfov"],
                           aspect=cfg.aspect, device=dev) for f, at in lap]
    start, n_pose = lap_start(seed, len(lap)), len(lap)
    npx = tr["check_pixels_per_frame"]
    rt.render(scene, cams[(start - 1) % n_pose], cfg, bvh=bvh).cpu()

    prof = measure.profiler(dev) if ctx.trace else None
    n_trace = tr["trace_calls"] if ctx.trace else 0
    calls, kept = [], []
    t_start = time.perf_counter()
    while True:
        k = len(calls)
        if prof is not None and k == n_trace:
            prof.stop()
        span = (torch.profiler.record_function(core.CALL_SPAN)
                if k < n_trace else contextlib.nullcontext())
        t0 = time.perf_counter()
        with span:
            img = rt.render(scene, cams[(start + k) % n_pose], cfg, bvh=bvh)
            t1 = time.perf_counter()
            host = img.cpu().numpy()
        t2 = time.perf_counter()
        calls.append((t0, t1, t2))
        xs, ys = check_pixels(seed, k, w, h, npx)
        kept.append(host[ys, xs])
        if t2 - t_start >= ctx.seconds:
            break
    if prof is not None and len(calls) <= n_trace:
        prof.stop()
    run_rec = core.Run(setup_s=t_start - ctx.t0,
                       window_s=calls[-1][2] - t_start, calls=calls,
                       traced=min(n_trace, len(calls)))
    if prof is not None:
        run_rec.traces = [Trace.from_profiler(prof, core.CALL_SPAN)]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del img, host, scene, bvh, cams, prof
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check, after the window
    frames, px, py, rows = sample(seed, len(calls), start, cell)
    got = np.concatenate([kept[f] for f in frames])
    want, steps = reference_pixels(sp, cell, lap, rows, px, py)
    numbers = check.image_numbers(check.image_sums(got, want.cpu()))
    failed = sum(int(not np.isfinite(x).all()) for x in kept)
    samples = w * h * r["spp"]
    run_rec.work = measure.work(
        samples, steps / (len(px) * r["spp"]) * samples,
        sp.radius.shape[0], conf["closest_hit_charge"], w * h * 3 * 4)
    checks = {k: (v, cell.limits[k]) for k, v in numbers.items()}
    return core.Outcome(run=run_rec, attempted=len(calls), failed=failed,
                        checks=checks, memory_peak_bytes=peak)
