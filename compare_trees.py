"""Parent-against-change tools for the port's kernels, beside
``chip_smoke.py``'s phases, whose helpers and tables they use.

    python3 compare_trees.py [--root DIR] COMMAND [ARGS]

Each command measures, or saves the outputs of, the ``raytpu_torch`` of the
checkout ``--root`` names (the one beside this file by default), building
its kernels there; so two checkouts are compared on one card in one
machine, one process each, in turns.  Unpack the other one (``git archive``)
into a gitignored directory of this checkout, e.g.::

    python3 compare_trees.py --root _archive/parent segment-outputs p.pt
    python3 compare_trees.py segment-outputs c.pt
    python3 compare_trees.py compare p.pt c.pt
    python3 compare_trees.py --root _archive/parent segment-times parent
    python3 compare_trees.py segment-times change

Commands, one JSON line each:

- ``segment-times LABEL``: ptxas's registers and spills of every K5 and K6
  instantiation (a fresh build; a cached library reports none), every
  K5 and K6 launch of each of phase 8b's cases (``segment_cases``) timed
  one by one (CUDA events, the mean of 3 calls after a warm-up) and summed,
  and phase 8d's frames (``wavefront_runs``: each call's time after a
  warm-up) with where a traced frame's device time goes and its idle
  share;
- ``segment-outputs PATH``, ``brute-outputs PATH``: every K5 and K6 output,
  every brute-sweep output, on fixed inputs, saved for ``compare``;
- ``compare A B``: two saved output files, output by output;
- ``k1a-split``: K1a's launch on config 2, split into the device's and the
  host's time.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

# this checkout's smoke (its helpers), imported before --root goes first on
# the path, so that ``raytpu_torch`` comes from --root
from chip_smoke import (
    LEAF, PACK_SPHERES, SEGMENT_KERNELS, VIS_W, card_line, cuda_ms, fail,
    flat_ptxas, frame_times, kernel_ms, phase, recording, segment_cases,
    segment_launches, spheres_scene, wavefront_runs, wavefront_scenes)


def tree() -> str:
    """The checkout whose ``raytpu_torch`` this process measures."""
    import raytpu_torch
    return os.path.dirname(os.path.dirname(
        os.path.abspath(raytpu_torch.__file__)))


def segment_times(label: str) -> None:
    """K5 and K6 under every policy for the ``raytpu_torch`` of ``--root``
    (see the module docstring)."""
    from raytpu_torch.kernels import _build, megakernel
    from raytpu_torch.kernels import wavefront as kwf
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load_all([megakernel.SOURCE, kwf.SOURCE])
    build_s = time.perf_counter() - t0
    ptxas = flat_ptxas(_build.build_log[kwf.SOURCE]["ptxas"], SEGMENT_KERNELS)
    scenes = wavefront_scenes(dev)
    kernels = {}
    for policy, c, mode, refill in segment_cases():
        scene, cam, bvh = scenes[policy]
        c = c.replace(spp=2, rng_mode=mode)
        _, fn, calls = segment_launches(scene, cam, c, bvh, refill)
        each = [cuda_ms(lambda: fn(*b.args), 3) for b, _ in calls]
        kernel = "K6" if refill else "K5"
        frame = (f"{c.width}x{c.height} spp2 d{c.depth} {mode}"
                 + (f" refill {refill}" if refill else ""))
        kernels[f"{kernel}/{calls[0][0].args[0].policy} {frame}"] = {
            "scene": policy, "launches": len(calls), "ms": sum(each),
            "ms_each": each}
        del calls
    frames = frame_times(scenes, wavefront_runs(), engines=("wavefront",))
    phase("segment_times", root=tree(), label=label, card=card_line(),
          build_s=build_s, ptxas=ptxas, kernels=kernels, frames=frames)


def launch_split(fn, iters: int = 50) -> dict:
    """Where the time of a launch ``fn`` goes, from CUDA events after a
    warm-up call: ``queued_ms``, the mean of ``iters`` calls made back to
    back between one pair of events (the host runs ahead, so this is the
    device's time a call: the kernels it launches and the gaps between
    them); ``alone_ms``, the mean of calls made one at a time after a
    synchronize (the host's share included: the device waits for it);
    ``host_us``, the host's time to make one call, queued."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    queued = start.elapsed_time(stop) / iters
    alone = []
    for _ in range(iters // 5):
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        alone.append(start.elapsed_time(stop))
    return {"queued_ms": queued, "alone_ms": sum(alone) / len(alone),
            "host_us": host_us}


def k1a_split() -> None:
    """K1a on config 2 (400x200, 20 spp, depth 12, 4 spheres), split:
    :func:`launch_split` of ``megakernel.launch`` and of ``render()``,
    and the kernel's own device time (:func:`kernel_ms`, the only
    profiler trace of the process), for the ``raytpu_torch`` of the
    checkout ``--root`` names.  One JSON line."""
    import raytpu_torch as rt
    from raytpu_torch.config import CONFIG2
    from raytpu_torch.kernels import megakernel

    dev = torch.device("cuda", 0)
    scene = rt.config2_world(device=dev)
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=CONFIG2.aspect, device=dev)
    cp, sp = megakernel.pack_camera(cam), megakernel.pack_scene(scene)
    k1a = launch_split(lambda: megakernel.launch(cp, sp, CONFIG2))
    render = launch_split(lambda: rt.render(scene, cam, CONFIG2))
    own = kernel_ms(lambda: megakernel.launch(cp, sp, CONFIG2),
                    "render_fwd_kernel")
    phase("k1a_split", root=tree(), card=card_line(),
          frame="400x200 spp20 d12 sequential, 4 spheres", k1a=k1a,
          render=render, kernel_ms=own)


def brute_outputs(path: str) -> None:
    """Every brute-sweep output of the ``raytpu_torch`` of ``--root`` on
    fixed inputs, saved to ``path`` (torch.save: a SHA-256 of each output's
    bytes, shape and dtype, and the tensor itself up to 2^22 elements), for
    a comparison of two checkouts (:func:`compare_outputs`): the forward's
    image, census counts, taping image and tape, K2's sums and seeds (both
    RNG modes; 50x21, slabs past and across the frame's edge, 2x2, 1003x301
    at 1 spp, config 2, REFERENCE_V2 at 4 spp, 4097 spheres (the scene
    pack), 500 spheres), and K3's image, f32 gradients and f64 sums (config
    3 with and without ``vis_w``, both PASS 2 schedules taped and not,
    REFERENCE_V2 at 2 spp in both RNG modes, 4097 spheres).
    """
    import raytpu_torch as rt
    from raytpu_torch import golden, optim
    from raytpu_torch.config import CONFIG2, CONFIG3, REFERENCE_V2, \
        RenderConfig
    from raytpu_torch.kernels import _build, gradkernel, megakernel

    dev = torch.device("cuda", 0)
    _build.load_all([megakernel.SOURCE, gradkernel.SOURCE])
    out = {}

    def spheres(n):
        return spheres_scene(n, dev)

    def cam_of(cfg, **kw):
        return rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                              aspect=cfg.aspect, device=dev, **kw)

    def forward_set(tag, scene, cam, cfg, row0=0, rows=None):
        cp, sp = megakernel.pack_camera(cam), megakernel.pack_scene(scene)
        r = rows or cfg.height
        out[f"{tag}/img"] = megakernel.launch(cp, sp, cfg, row0=row0,
                                              rows=rows)
        out[f"{tag}/census"] = megakernel.launch(cp, sp, cfg, count=True,
                                                 row0=row0, rows=rows)[1]
        tape = torch.full((cfg.spp * cfg.depth, r * cfg.width),
                          golden.TAPE_UNWRITTEN,
                          dtype=golden.tape_dtype(sp.shape[1]), device=dev)
        out[f"{tag}/tape_img"] = megakernel.launch(cp, sp, cfg, tape=tape,
                                                   row0=row0, rows=rows)
        out[f"{tag}/tape"] = tape
        gen = torch.Generator().manual_seed(3)
        acc = torch.rand((r, cfg.width, 3), generator=gen).to(dev)
        seed = torch.randint(-2**31, 2**31 - 1, (r, cfg.width), generator=gen,
                             dtype=torch.int32).to(dev)
        out[f"{tag}/k2_acc"], out[f"{tag}/k2_seed"] = \
            megakernel.launch_accumulate(cp, sp, cfg, acc, seed, 7, 3, None,
                                         row0, rows)

    def vjp_set(tag, scene, cam, cfg, vis_w=0.0, tape=False, p2=None):
        img = rt.render(scene, cam, cfg)
        gen = torch.Generator().manual_seed(11)
        ct = (2.0 * (img - torch.rand(img.shape, generator=gen).to(dev))
              / img.numel())
        kw = dict(img=img if cfg.rng_mode == "parallel" else None,
                  vis_w=vis_w, p2_refill=p2)
        if tape:
            kw["tape"] = gradkernel.render_tape_fwd(scene, cam, cfg,
                                                    cfg.spp * cfg.depth)[1]
        o = gradkernel.render_vjp(scene, cam, cfg, ct, **kw)
        out[f"{tag}/vjp_img"] = o[0]
        for k in ("center", "radius", "albedo", "mat_param"):
            out[f"{tag}/d_{k}"] = getattr(o[1], k)
        for k, v in zip(rt.Camera._fields, o[2]):
            out[f"{tag}/d_cam_{k}"] = v
        cp, sp = megakernel.pack_camera(cam), megakernel.pack_scene(scene)
        _, out[f"{tag}/f64_sphere_sums"], out[f"{tag}/f64_cam_sums"] = \
            gradkernel.launch(cp, sp, cfg, ct, kw["img"], vis_w, None,
                              kw.get("tape"), p2_refill=p2)

    tw = rt.test_world(device=dev)
    for mode in ("sequential", "parallel"):
        c = RenderConfig(width=50, height=21, spp=3, depth=6, rng_mode=mode)
        forward_set(f"{mode}/50x21", tw, cam_of(c, aperture=0.1,
                                                focus_dist=10.0), c)
        forward_set(f"{mode}/slab_past", tw, cam_of(c), c, 21, 1)
        forward_set(f"{mode}/slab_edge", tw, cam_of(c), c, 18, 5)
        c = RenderConfig(width=2, height=2, spp=3, depth=50, rng_mode=mode)
        forward_set(f"{mode}/2x2", tw, cam_of(c), c)
        c = RenderConfig(width=1003, height=301, spp=1, depth=8,
                         rng_mode=mode)
        forward_set(f"{mode}/1003x301", tw, cam_of(c), c)
        c = CONFIG2.replace(rng_mode=mode)
        forward_set(f"{mode}/config2", rt.config2_world(device=dev),
                    cam_of(c), c)
        c = REFERENCE_V2.replace(spp=4, rng_mode=mode)
        forward_set(f"{mode}/rv2_spp4", rt.random_world(device=dev),
                    rt.reference_camera_v2(c.aspect, device=dev), c)
        c = RenderConfig(width=64, height=32, spp=2, depth=4, rng_mode=mode)
        forward_set(f"{mode}/pack4097", spheres(4097), cam_of(c), c)
        c = RenderConfig(width=480, height=270, spp=4, depth=12,
                         rng_mode=mode)
        forward_set(f"{mode}/final500", rt.final_world(device=dev),
                    cam_of(c), c)
    _, s3, c3, _, _ = optim.inverse_render_problem(CONFIG3, device=dev)
    vjp_set("config3", s3, c3, CONFIG3)
    vjp_set("config3_vis_w", s3, c3, CONFIG3, vis_w=VIS_W)
    c2p = CONFIG2.replace(rng_mode="parallel")
    c2w = rt.config2_world(device=dev)
    vjp_set("config2_refill", c2w, cam_of(c2p), c2p)
    vjp_set("config2_per_sample", c2w, cam_of(c2p), c2p, p2=False)
    c = RenderConfig(width=200, height=100, spp=4, depth=8,
                     rng_mode="parallel")
    fw = rt.final_world(device=dev)
    vjp_set("final500_refill_tape", fw, cam_of(c), c, tape=True)
    vjp_set("final500_per_sample_tape", fw, cam_of(c), c, tape=True, p2=False)
    vjp_set("final500_refill_vis_w", fw, cam_of(c), c, vis_w=VIS_W)
    c = REFERENCE_V2.replace(spp=2)
    rw = rt.random_world(device=dev)
    rcam = rt.reference_camera_v2(c.aspect, device=dev)
    vjp_set("rv2_spp2_seq", rw, rcam, c)
    vjp_set("rv2_spp2_refill", rw, rcam, c.replace(rng_mode="parallel"))
    c = RenderConfig(width=64, height=32, spp=2, depth=4, rng_mode="parallel")
    vjp_set("pack4097_refill", spheres(4097), cam_of(c), c)
    vjp_set("pack4097_seq_vis_w", spheres(4097), cam_of(c),
            c.replace(rng_mode="sequential"), vis_w=VIS_W)
    torch.cuda.synchronize()
    phase("brute_outputs", root=tree(), outputs=save_outputs(out, path),
          path=path)


def save_outputs(out: dict, path: str) -> int:
    """``out``'s tensors saved to ``path`` for :func:`compare_outputs`: a
    SHA-256 of each one's bytes, shape and dtype, and the tensor itself up
    to 2^22 elements -> how many."""
    import hashlib
    saved = {}
    for k, v in out.items():
        v = v.detach().contiguous().cpu()
        saved[k] = {"sha": hashlib.sha256(v.numpy().tobytes()).hexdigest()
                    + str(tuple(v.shape)) + str(v.dtype),
                    "t": v if v.numel() <= 2**22 else None}
    torch.save(saved, path)
    return len(saved)


def compare_outputs(a: str, b: str) -> None:
    """Two :func:`brute_outputs` files compared: one JSON line with the
    outputs counted, whether both hold the same ones, and each output that
    differs with its largest |a - b| ("differs" where either was saved
    without its tensor or the shapes differ)."""
    a, b = torch.load(a), torch.load(b)
    differ = {}
    for k in a:
        if k in b and a[k]["sha"] == b[k]["sha"]:
            continue
        ta, tb = a[k]["t"], b.get(k, {}).get("t")
        differ[k] = (float((ta.double() - tb.double()).abs().max())
                     if ta is not None and tb is not None
                     and ta.shape == tb.shape else "differs")
    phase("compare_outputs", outputs=len(a), same_keys=set(a) == set(b),
          differ=differ)


def segment_outputs(path: str) -> None:
    """Every K5 and K6 output of the ``raytpu_torch`` of ``--root`` on
    fixed inputs, saved to ``path`` (:func:`save_outputs`, for
    :func:`compare_outputs`): each launch's planes and key (K5) or ride
    planes (K6, refill 2 at one and two samples in flight) of a 96x64
    wavefront frame at 2 spp, depth 8, and its image, in both RNG modes
    (K6: parallel), under every policy: config 2's 4 spheres and
    REFERENCE_V2's 327 (staged rows), PACK_SPHERES spheres (the pack),
    config 4's scene over its flat BVH, ``final_world(n=300)`` over a
    padded (leaf 4) and an unpadded (leaf 7) walk; a slab of 32 rows from
    row 48 (16 past the frame); and one launch on the frame's first
    planes tiled 64 times (more slots than a grid of one thread a slot
    or a persistent grid has lanes).
    """
    import raytpu_torch as rt
    from raytpu_torch import bvh as tbvh, wavefront as wf
    from raytpu_torch.config import RenderConfig
    from raytpu_torch.kernels import _build, megakernel
    from raytpu_torch.kernels import wavefront as kwf

    dev = torch.device("cuda", 0)
    _build.load_all([megakernel.SOURCE, kwf.SOURCE])
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=1.5, device=dev)
    s4, s300 = rt.final_world(device=dev), rt.final_world(n=300, device=dev)
    worlds = {"config2": (rt.config2_world(device=dev), None),
              "reference_v2": (rt.random_world(device=dev), None),
              "pack": (spheres_scene(PACK_SPHERES, dev), None),
              "config4_flat": (s4, rt.build_bvh(s4, leaf_size=LEAF)),
              "walk_padded": (s300, tbvh.build_bvh(s300, leaf_size=4)),
              "walk_unpadded": (s300, tbvh.build_bvh(s300, leaf_size=7,
                                                     pad_leaves=False))}
    out = {}
    for name, (scene, bvh) in worlds.items():
        for mode in ("sequential", "parallel"):
            cfg = RenderConfig(width=96, height=64, spp=2, depth=8,
                               rng_mode=mode)
            tag = f"{name}/{mode}"
            runs = [("k5", "launch_segment", {}, None)]
            if mode == "parallel":
                runs += [("k6_b1", "launch_refill_segment", {"refill": 2},
                          None),
                         ("k6_b2", "launch_refill_segment",
                          {"refill": 2, "spp_batch": 2}, None)]
            runs.append(("k5_slab", "launch_segment", {}, (48, 32)))
            if mode == "parallel":
                runs.append(("k6_slab", "launch_refill_segment",
                             {"refill": 2}, (48, 32)))
            for key, fn_name, kw, slab in runs:
                calls = []
                with recording(kwf, fn_name, calls):
                    if slab is None:
                        img = rt.render(scene, cam, cfg, backend="wavefront",
                                        bvh=bvh, **kw)
                    else:
                        img = wf._render(scene, cam, cfg, bvh, (3, 5), 1,
                                         kw.get("spp_batch", 1), 65536,
                                         kw.get("refill", 0), row0=slab[0],
                                         rows=slab[1])
                out[f"{tag}/{key}/image"] = img
                for i, (_, o) in enumerate(calls):
                    out[f"{tag}/{key}/launch{i}"] = o
                if key == "k5":
                    b = calls[0][0]
                    many = b.args[1].repeat(1, 64)
                    out[f"{tag}/k5_many"] = kwf.launch_segment(
                        b.args[0], many, *b.args[2:])
    torch.cuda.synchronize()
    phase("segment_outputs", root=tree(), outputs=save_outputs(out, path),
          path=path)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="the checkout whose raytpu_torch to run")
    sub = ap.add_subparsers(dest="command", required=True)
    sub.add_parser("segment-times").add_argument("label")
    sub.add_parser("segment-outputs").add_argument("path")
    sub.add_parser("brute-outputs").add_argument("path")
    cmp_ = sub.add_parser("compare")
    cmp_.add_argument("a")
    cmp_.add_argument("b")
    sub.add_parser("k1a-split")
    args = ap.parse_args()
    if args.command == "compare":
        compare_outputs(args.a, args.b)
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a card")
    sys.path.insert(0, os.path.abspath(args.root))
    if args.command == "segment-times":
        segment_times(args.label)
    elif args.command == "segment-outputs":
        segment_outputs(args.path)
    elif args.command == "brute-outputs":
        brute_outputs(args.path)
    else:
        k1a_split()


if __name__ == "__main__":
    main()
