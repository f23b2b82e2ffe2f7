"""Traffic kind ``fit``: inverse rendering in episodes of SGD steps.

The true scene is the configuration's; the start shifts every centre by
``shift`` in a horizontal direction drawn from ``SHIFT_SEED``, and the
target is the true scene rendered by the reference at a coarse size and
upsampled, so the program makes none of its inputs.  Set-up builds one
train step (``raytpu_torch.shard.make_train_step``) and drives it through
the first two steps from the start; the window then runs episodes of
``steps_per_episode`` steps, each from the start, back to back, so the
work of a step does not depend on how many fit into the window.  Over
several chips (one process each) the frame's rows are split over NCCL
ranks and the step all-reduces the gradients.

After the window the reference takes the same two steps and the check
compares each step's loss, and the first step's image, gradient and
change of the parameters.  (The change after later steps is not compared:
from the second step on, near-tangent hits whose gradients are clamped,
not small, make it differ by rounding alone; PERF.md has the readings.)
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from rtbench import check, core, reference, scenes
from rtbench import measure
from rtbench.measure import Trace

LEAVES = ("center", "radius", "albedo", "param", "origin", "horizontal",
          "vertical", "lower_left")
# the seed of the start's shift directions: every run starts its episodes
# from the same spheres, so the seed of a run changes their order and not
# the work
SHIFT_SEED = 0


def start_arrays(arrays: tuple, size: float) -> tuple:
    """The scene's arrays with every centre shifted by ``size`` in a
    horizontal direction drawn from ``SHIFT_SEED``."""
    n = arrays[1].shape[0]
    a = np.random.default_rng(SHIFT_SEED).random(n) * (2 * math.pi)
    shift = np.stack([np.cos(a), np.zeros(n), np.sin(a)], 1) * size
    return (arrays[0] + shift.astype(np.float32), *arrays[1:])


def target(sp, camera: dict, st: reference.Settings, scale: int, spp: int):
    """The true scene rendered by the reference at 1 / ``scale`` of the
    frame's width and height, upsampled -> (H, W, 3)."""
    w, h = st.width // scale, st.height // scale
    coarse = st._replace(width=w, height=h, spp=spp)
    dev = sp.center.device
    cam = reference.camera(camera["look_from"], camera["look_at"],
                           camera["vfov"], w / h, device=dev)
    flat = torch.arange(w * h, device=dev)
    img, _ = reference.pixels(sp, cam, coarse, flat % w, flat // w)
    img = img.reshape(h, w, 3)
    return img.repeat_interleave(scale, 0).repeat_interleave(scale, 1)


def _leaves(scene, cam) -> dict:
    """The leaves a step updates, of the program's Scene and Camera or the
    reference's Spheres and Camera."""
    return {"center": scene.center, "radius": scene.radius,
            "albedo": scene.albedo,
            "param": (scene.mat_param if hasattr(scene, "mat_param")
                      else scene.param),
            "origin": cam.origin, "horizontal": cam.horizontal,
            "vertical": cam.vertical, "lower_left": cam.lower_left}


def _moved(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


@dataclasses.dataclass
class Steps:
    """The first steps of a fit as the check reads them: each step's loss,
    the first step's gradient, image (rows ``rows`` = (first row, count) of
    the frame) and change of the leaves, and (the reference's) the first
    step's bounce steps over the frame."""

    losses: list
    grad: dict
    moved: dict
    image: torch.Tensor
    rows: tuple
    steps: float = 0.0


def reference_steps(start, cam_spec: dict, st: reference.Settings, goal,
                    tr: dict, rank: int = 0, world: int = 1,
                    dtype=torch.float32) -> Steps:
    """The reference's first two SGD steps from ``start``, computed in
    ``dtype``; over ``world`` processes each takes its band of rows and the
    sums are all-reduced.  The second step's gradient is not needed."""
    dev = start.center.device
    sp = start.to(dtype)
    cam = reference.camera(cam_spec["look_from"], cam_spec["look_at"],
                           cam_spec["vfov"], st.width / st.height,
                           device=dev, dtype=dtype)
    leaves0 = _leaves(sp, cam)
    band = -(-st.height // world)
    rows = (min(rank * band, st.height), min((rank + 1) * band, st.height))
    inv_m = 1.0 / (st.height * st.width * 3)
    lsum, grads, image, steps = reference.loss_and_grads(
        sp, cam, st, goal, rows, grad=True)
    both = _reduce(torch.cat(
        [lsum.reshape(1), torch.tensor([float(steps)], device=dev,
                                       dtype=torch.float64)]
        + [grads[k].reshape(-1) for k in LEAVES]), world)
    off = 2
    for k in LEAVES:
        m = grads[k].numel()
        grads[k] = both[off:off + m].reshape(grads[k].shape)
        off += m
    sp, cam = reference.sgd(sp, cam, grads, tr["lr"])
    lsum2, _, _, _ = reference.loss_and_grads(sp, cam, st, goal, rows,
                                              grad=False)
    loss2 = _reduce(lsum2.reshape(1).to(torch.float64), world)
    return Steps(losses=[float(both[0]) * inv_m, float(loss2[0]) * inv_m],
                 grad=grads, moved=_moved(leaves0, _leaves(sp, cam)),
                 image=image, rows=(rows[0], rows[1] - rows[0]),
                 steps=float(both[1]))


def compare(got: Steps, want: Steps, width: int, world: int, dev) -> dict:
    """The fit's compared numbers: the worst step's relative loss gap, the
    first gradient's and the first change's worst-leaf gaps of norms (the
    change over the leaves the reference moves beyond round-off), and the
    first step's image against the reference's rows."""
    sums = _image_sums(got.image, got.rows, want.image, want.rows, width)
    sums = _reduce(torch.tensor(sums, dtype=torch.float64, device=dev),
                   world).cpu().numpy()
    return {"loss_gap": max(abs(a - b) / b for a, b in
                            zip(got.losses, want.losses)),
            "grad_gap": check.worst_leaf_gap(got.grad, want.grad),
            "change_gap": check.worst_leaf_gap(
                got.moved, want.moved, keep=check.moved_leaves(want.grad)),
            **check.image_numbers(sums)}


def _reduce(t: torch.Tensor, world: int) -> torch.Tensor:
    if world > 1:
        import torch.distributed as dist
        dist.all_reduce(t)
    return t


def run(ctx: core.Ctx) -> core.Outcome:
    import raytpu_torch as rt
    from raytpu_torch import shard
    cell, seed, world, rank = ctx.cell, ctx.seed, ctx.world, ctx.rank
    r, tr, conf = cell.render, cell.traffic, cell.config
    w, h = r["width"], r["height"]
    dev = torch.device(ctx.device, rank) if ctx.device == "cuda" else \
        torch.device(ctx.device)
    group = None
    if world > 1:
        group = shard.init_distributed(device=dev,
                                       init_method=ctx.init_method,
                                       world_size=world, rank=rank)
    arrays = scenes.build(conf["scene"])
    true = scenes.on_device(arrays, seed, dev)
    start = scenes.on_device(start_arrays(arrays, tr["shift"]), seed, dev)
    st = reference.Settings(w, h, r["spp"], r["depth"], r["rng_mode"])
    goal = target(true, conf["camera"], st, tr["target_scale"],
                  tr["target_spp"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    cfg = rt.RenderConfig(width=w, height=h, spp=r["spp"], depth=r["depth"],
                          rng_mode=r["rng_mode"])
    cam_spec = conf["camera"]
    scene0 = rt.Scene(start.center, start.radius, start.mat.to(torch.int32),
                      start.albedo, start.param)
    cam0 = rt.make_camera(cam_spec["look_from"], cam_spec["look_at"],
                          vfov=cam_spec["vfov"], aspect=cfg.aspect,
                          device=dev)
    bvh = rt.build_bvh(scene0, **conf["bvh"]) if conf.get("bvh") else None
    step = shard.make_train_step(cfg, group=group, lr=tr["lr"], bvh=bvh)
    s, c, losses = scene0, cam0, []
    for i in range(2):
        s, c, loss = step(s, c, goal)
        losses.append(loss)
        if i == 0:
            img1, slab = step.last_image.clone(), (step.row0, step.rows)
            g1 = {k: v.clone() for k, v in
                  _leaves(*step.last_grads).items()}
            moved = _moved(_leaves(scene0, cam0), _leaves(s, c))
    got = Steps(losses=[float(x) for x in losses], grad=g1, moved=moved,
                image=img1, rows=slab)
    if world > 1:
        import torch.distributed as dist
        dist.barrier()

    prof = measure.profiler(dev) if ctx.trace else None
    n_trace = tr["trace_calls"] if ctx.trace else 0
    calls, out_losses = [], []
    t_start = time.perf_counter()
    while True:
        s, c = scene0, cam0
        for _ in range(tr["steps_per_episode"]):
            k = len(calls)
            if prof is not None and k == n_trace:
                _sync(dev)
                prof.stop()
            span = (torch.profiler.record_function(core.CALL_SPAN)
                    if k < n_trace else contextlib.nullcontext())
            t0 = time.perf_counter()
            with span:
                s, c, loss = step(s, c, goal)
            t1 = time.perf_counter()
            calls.append((t0, t1, t1))
            out_losses.append(loss)
        go = torch.tensor([time.perf_counter() - t_start < ctx.seconds],
                          dtype=torch.int32, device=dev)
        if world > 1:
            import torch.distributed as dist
            dist.broadcast(go, 0)
        if not bool(go.item()):
            break
    _sync(dev)
    window_s = time.perf_counter() - t_start
    if prof is not None and len(calls) <= n_trace:
        prof.stop()
    failed = int((~torch.isfinite(torch.stack(out_losses))).sum())
    run_rec = core.Run(setup_s=t_start - ctx.t0,
                       window_s=window_s, calls=calls,
                       traced=min(n_trace, len(calls)), world=world)
    trace = (Trace.from_profiler(prof, core.CALL_SPAN) if prof is not None
             else None)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del step, bvh, s, c, loss, out_losses, prof
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check, after the window
    want = reference_steps(start, cam_spec, st, goal, tr, rank, world)
    numbers = compare(got, want, w, world, dev)
    run_rec.work = measure.work(w * h * r["spp"], want.steps,
                                true.radius.shape[0],
                                conf["closest_hit_charge"], 2 * w * h * 3 * 4,
                                backward=True)
    if world > 1:
        import torch.distributed as dist
        gathered = [None] * world
        dist.all_gather_object(gathered, (
            peak, None if trace is None else
            (trace.device, trace.host, trace.lo, trace.hi, trace.calls)))
        peak = max(p for p, _ in gathered)
        if trace is not None:
            run_rec.traces = [Trace(*t) for _, t in gathered]
        dist.destroy_process_group()
    elif trace is not None:
        run_rec.traces = [trace]
    checks = {k: (v, cell.limits[k]) for k, v in numbers.items()}
    return core.Outcome(run=run_rec, attempted=len(calls), failed=failed,
                        checks=checks, memory_peak_bytes=peak)


def _image_sums(img, slab, img_ref, rows, w) -> np.ndarray:
    """:func:`check.image_sums` of an image of the rows ``slab`` = (first
    row, count) against the reference's image of the rows ``rows``; a
    reference row that ``slab`` does not hold compares as NaN, which
    fails."""
    (row0, n), (r0, rn) = slab, rows
    got = torch.full_like(img_ref, float("nan"))
    lo, hi = max(r0, row0), min(r0 + rn, row0 + n)
    if hi > lo:
        got[lo - r0:hi - r0] = img[lo - row0:hi - row0].to(got.dtype)
    return check.image_sums(got.reshape(-1, 3), img_ref.reshape(-1, 3))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
