"""Command-line interface (counterpart of ``raytpu/cli.py``).

    python -m raytpu_torch.cli render --scene random --width 1024 \
        --height 576 --spp 60 --depth 50 --device cuda --out frame.png
    python -m raytpu_torch.cli render --scene final --width 800 \
        --height 400 --spp 100 --bvh --device cuda --out final.png
    python -m raytpu_torch.cli render --scene final --bvh --progressive 16 \
        --checkpoint ckpt.npz --resume --device cuda --out final.png
    torchrun --nproc-per-node 4 -m raytpu_torch.cli render --devices 4 \
        --scene final --bvh --device cuda --out final.png
    python -m raytpu_torch.cli render --scene-file big.json --bvh \
        --device cuda --log runs.jsonl --out big.png
    python -m raytpu_torch.cli render --scene final --bvh --width 800 \
        --height 400 --spp 100 --rng-mode parallel --backend wavefront \
        --refill 2 --device cuda --out wavefront.png
    python -m raytpu_torch.cli gradcheck --device cuda
    python -m raytpu_torch.cli validate --scene-file big.json --bvh \
        --device cuda
    python -m raytpu_torch.cli info

Every subcommand of raytpu's is ported: ``render`` with ``--bvh`` (and
``--bvh-builder``), ``--scene-file`` (a JSON scene,
:mod:`raytpu_torch.scene_io`), ``--log`` (one JSON line a run),
``--progressive`` (with ``--checkpoint``, ``--resume`` and
``--preview-every``) and ``--devices``, and the wavefront's ``--backend wavefront`` with
``--spp-batch`` and ``--refill``; ``gradcheck``; ``validate`` (the scene
lint and the kernel against its plain version on the device,
:mod:`raytpu_torch.debug`; exit 0 iff it passes); ``info``.  Every backend
of the port's ``render`` sweeps the BVH it is given, by the flat sweep or
the skip-pointer walk as raytpu's rule picks (raytpu refuses ``--bvh`` on
its golden backend, which would ignore it; here none does).
``--devices N`` shards the rows over N processes of a ``torchrun`` launch
whose ``WORLD_SIZE`` is N, each on ``cuda:LOCAL_RANK`` (or the CPU with
``--device cpu``); process 0 writes ``--out`` and the checkpoint.  Outside
such a launch it exits with an error that says how to launch it; it never
renders on one device instead.  An option that would be ignored
(``--bvh-builder`` without ``--bvh``, ``--checkpoint`` or
``--preview-every`` without ``--progressive``, ``--resume`` without
``--checkpoint``, ``--log`` with ``--progressive``) is refused, and so are
raytpu's refusals of the wavefront's knobs: ``--refill`` and ``--spp-batch``
without ``--backend wavefront``, and the wavefront with ``--devices`` > 1
or ``--progressive``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

SCENES = ("config1", "test", "random", "final", "v1")


def _build_scene(name: str, seed: int, device, scene_file=None):
    import raytpu_torch as rt
    if scene_file:
        from raytpu_torch.scene_io import load_scene
        return load_scene(scene_file, device=device)
    if name == "config1":
        return rt.config1_world(device=device)
    if name == "test":
        return rt.test_world(device=device)
    if name == "random":
        return rt.random_world(seed=seed, device=device)
    if name == "final":
        return rt.final_world(seed=seed, device=device)
    return rt.v1_world(device=device)  # the v1 app's seven-sphere world


def _build_camera(args, aspect, device):
    import raytpu_torch as rt
    return rt.make_camera(tuple(args.look_from), tuple(args.look_at),
                          vfov=args.vfov, aspect=aspect,
                          aperture=args.aperture, focus_dist=args.focus_dist,
                          device=device)


def _distributed(args):
    """(group, rank, device) of this process in a ``torchrun`` launch of
    ``--devices`` processes; exits, saying how to launch, outside one."""
    import torch
    from raytpu_torch import shard
    n = args.devices
    env = os.environ.get("WORLD_SIZE")
    if n < 2 or env is None or int(env) != n:
        raise SystemExit(
            f"--devices {n} needs one process per device under torchrun "
            f"(WORLD_SIZE {env or 'unset'}): torchrun --nproc-per-node {n} "
            f"-m raytpu_torch.cli render --devices {n} ...; nothing was "
            "rendered")
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    group = shard.init_distributed(device=device)
    return group, shard.world(group)[0], device


def cmd_render(args) -> int:
    if args.bvh_builder is not None and not args.bvh:
        raise SystemExit("--bvh-builder needs --bvh")
    if args.devices == 1:
        return _render(args, None, 0, args.device)
    import torch.distributed as dist
    group, rank, device = _distributed(args)
    try:
        rc = _render(args, group, rank, device)
        # every rank has finished its collectives before any tears down
        # its connections: a rank that destroys the group while a peer
        # still holds it can abort that peer at exit
        dist.barrier(group)
        return rc
    finally:
        dist.destroy_process_group()


def _render(args, group, rank: int, device) -> int:
    """The render of ``cmd_render`` on this process (``rank`` of ``group``,
    or the only one when ``group`` is None)."""
    import raytpu_torch as rt
    from raytpu_torch import bvh as tbvh, io, profiling, progressive, shard
    from raytpu_torch.config import RenderConfig

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       depth=args.depth, rng_mode=args.rng_mode,
                       scatter_mode=args.scatter_mode, gamma=args.gamma)
    scene = _build_scene(args.scene, args.seed, device, args.scene_file)
    cam = _build_camera(args, cfg.aspect, device)
    bvh = (rt.build_bvh(scene, builder=args.bvh_builder or "median")
           if args.bvh else None)
    if args.progressive:
        img = None
        for state, img in progressive.render_progressive(
                scene, cam, cfg, batch=args.progressive,
                checkpoint_path=args.checkpoint, resume=args.resume,
                backend=args.backend, bvh=bvh, group=group):
            batches = state.samples // args.progressive
            if rank:
                continue
            print(f"samples {state.samples}/{cfg.spp}", file=sys.stderr)
            if args.preview_every and batches % args.preview_every == 0:
                io.save_image(args.out, img.cpu().numpy())
                print(f"preview @ {state.samples} spp -> {args.out}",
                      file=sys.stderr)
        if img is None:  # resumed from a completed checkpoint
            state, _ = progressive.load_checkpoint(args.checkpoint,
                                                   device=device)
            img = progressive.image(state, cfg)
        if not rank:
            io.save_image(args.out, img.cpu().numpy())
            print(f"wrote {args.out}")
        return 0
    if group is not None:
        def fn():
            return shard.render_sharded(scene, cam, cfg, group=group,
                                        bvh=bvh, backend=args.backend)
    else:
        def fn():
            return rt.render(scene, cam, cfg, backend=args.backend, bvh=bvh,
                             spp_batch=args.spp_batch, refill=args.refill)
    img, stats = profiling.timed(fn, cfg, label="render")
    if not rank:
        io.save_image(args.out, img.cpu().numpy())
        print(f"wrote {args.out}  ({stats.rays_per_sec / 1e6:.2f} "
              f"Mrays/s, {stats.wall_s * 1e3:.1f} ms on {stats.device}"
              + (f", {shard.world(group)[1]} processes)" if group
                 else ")"))
        if args.log:
            profiling.log_run(args.log, stats,
                              scene=args.scene_file or args.scene,
                              backend=args.backend,
                              sweep=None if bvh is None else
                              tbvh.sweep_of(bvh))
    return 0


def cmd_gradcheck(args) -> int:
    """Analytic-vs-finite-difference gradient self-check (raytpu's
    ``gradcheck`` problem): d(sum of four pixels' r+g+b) / d albedo[1, 0]
    from autograd through :func:`render` (on ``cuda``: the forward kernel
    and the VJP kernel), against a central difference with eps 1e-2."""
    import torch
    import raytpu_torch as rt
    from raytpu_torch.config import RenderConfig

    cfg = RenderConfig(width=48, height=24, spp=2, depth=4)
    scene = rt.make_scene([
        ((0.0, -100.5, -1.0), 100.0, 0, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 0.0, -1.0), 0.5, 0, (0.7, 0.3, 0.3), 0.0),
    ], args.device)
    cam = rt.make_camera((0.0, 0.3, 1.5), (0.0, 0.0, -1.0), vfov=45.0,
                         aspect=cfg.aspect, device=args.device)
    px = torch.tensor([22, 24, 26, 23], device=args.device)
    py = torch.tensor([12, 12, 13, 11], device=args.device)

    def pixels(albedo):
        img = rt.render(scene._replace(albedo=albedo), cam, cfg)
        return img[py, px].sum()

    albedo = scene.albedo.detach().requires_grad_()
    (g,) = torch.autograd.grad(pixels(albedo), albedo)
    analytic = float(g[1, 0])
    eps = 1e-2

    def at(v):
        a = scene.albedo.clone()
        a[1, 0] = v
        return float(pixels(a))

    a0 = float(scene.albedo[1, 0])
    fd = (at(a0 + eps) - at(a0 - eps)) / (2 * eps)
    err = abs(analytic - fd)
    print(json.dumps({"grad_max_err_vs_fd": err, "pass": err < 1e-3,
                      "analytic": analytic, "finite_difference": fd,
                      "device": str(albedo.device)}))
    return 0 if err < 1e-3 else 1


def cmd_validate(args) -> int:
    """Scene lint and the cross-backend check (:mod:`raytpu_torch.debug`)
    on ``--device``: exit 0 iff the plain version's image is finite and, on
    a card, the kernel (K1a, K1c or K1d) equals it bit for bit, or, on the
    CPU with ``--bvh``, the plain BVH sweep equals the plain brute sweep up
    to ties.  Scene lint findings are warnings, not failures (random_world's
    energy-amplifying metal albedo is the reference's), as in raytpu."""
    import raytpu_torch as rt
    from raytpu_torch import debug
    from raytpu_torch.config import RenderConfig

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       depth=args.depth, scatter_mode=args.scatter_mode,
                       rng_mode=args.rng_mode)
    scene = _build_scene(args.scene, args.seed, args.device, args.scene_file)
    cam = _build_camera(args, cfg.aspect, args.device)
    bvh = rt.build_bvh(scene) if args.bvh else None
    rep = {"scene_warnings": debug.validate_scene(scene)}
    rep.update(debug.validate_backends(scene, cam, cfg, bvh=bvh))
    rep["pass"] = bool(rep["plain_finite"]
                       and rep.get("kernel_bit_identical", True)
                       and rep.get("bvh_matches_brute", True))
    print(json.dumps(rep))
    return 0 if rep["pass"] else 1


def cmd_info(args) -> int:
    """The package, torch and the device this process sees, as JSON:
    ``platform`` is "gpu" when CUDA has a card, else "cpu"."""
    import torch
    import raytpu_torch as rt
    gpu = torch.cuda.is_available()
    print(json.dumps({
        "version": rt.__version__, "torch": torch.__version__,
        "cuda": torch.version.cuda, "platform": "gpu" if gpu else "cpu",
        "devices": torch.cuda.device_count() if gpu else 1,
        "device_kind": torch.cuda.get_device_name(0) if gpu else "cpu"}))
    return 0


def _view_args(p) -> None:
    """The camera options render and validate share (raytpu's)."""
    p.add_argument("--look-from", type=float, nargs=3,
                   default=[13.0, 2.0, 3.0])
    p.add_argument("--look-at", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--vfov", type=float, default=20.0)
    p.add_argument("--aperture", type=float, default=0.0)
    p.add_argument("--focus-dist", type=float, default=None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raytpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to an image file")
    r.add_argument("--scene", choices=SCENES, default="test")
    r.add_argument("--scene-file", default=None, metavar="JSON",
                   help="load the scene from a JSON file (raytpu's "
                        "scene_io schema; overrides --scene)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--width", type=int, default=400)
    r.add_argument("--height", type=int, default=200)
    r.add_argument("--spp", type=int, default=20)
    r.add_argument("--depth", type=int, default=12)
    _view_args(r)
    r.add_argument("--device", required=True,
                   help="where the scene is built and rendered: cpu, cuda, "
                        "cuda:N")
    r.add_argument("--backend", choices=("auto", "golden", "cuda",
                                         "wavefront"),
                   default="auto",
                   help="auto = the CUDA kernel on a cuda device, the plain "
                        "PyTorch version on cpu; wavefront = the sorted "
                        "wavefront (never picked by auto)")
    r.add_argument("--gamma", type=float, default=2.2,
                   help="output gamma: 2.2 = v2's pow(1/2.2), 2.0 = v1's sqrt")
    r.add_argument("--scatter-mode", choices=("v2", "v1"), default="v2",
                   help="material semantics generation")
    r.add_argument("--rng-mode",
                   choices=("sequential", "parallel", "v1_fractsin"),
                   default="sequential",
                   help="sequential = reference-parity seed chain; parallel "
                        "= per-sample streams; v1_fractsin = the v1 pixel "
                        "shader's fract-sin RNG (with --scatter-mode v1; "
                        "the plain PyTorch renderer under every backend)")
    r.add_argument("--bvh", action="store_true",
                   help="build a BVH of the scene and sweep it: the flat "
                        "leaf list up to 64 leaves a copy (K1c on a cuda "
                        "device), else the skip-pointer walk (K1d)")
    r.add_argument("--bvh-builder", choices=("median", "sah"), default=None,
                   help="BVH build heuristic (default median; sah = the "
                        "native binned surface-area heuristic)")
    r.add_argument("--spp-batch", type=int, default=1, metavar="B",
                   help="--backend wavefront + --rng-mode parallel: B "
                        "samples of a pixel in flight")
    r.add_argument("--refill", type=int, default=0, metavar="K",
                   help="--backend wavefront + --rng-mode parallel: the "
                        "persistent-refill schedule (in-kernel sample "
                        "respawn, a sort every K bounces)")
    r.add_argument("--progressive", type=int, default=0, metavar="BATCH",
                   help="render progressively in BATCH-sample steps")
    r.add_argument("--preview-every", type=int, default=0, metavar="K",
                   help="with --progressive: overwrite --out with the "
                        "current image every K batches (live preview)")
    r.add_argument("--checkpoint", default=None,
                   help="with --progressive: checkpoint after every batch "
                        "to this .npz (raytpu's layout)")
    r.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint")
    r.add_argument("--devices", type=int, default=1, metavar="N",
                   help="shard the rows over N processes of a torchrun "
                        "launch (torchrun --nproc-per-node N -m "
                        "raytpu_torch.cli render --devices N ...)")
    r.add_argument("--log", default=None, metavar="JSONL",
                   help="append the run's stats (device included) to this "
                        "JSON-lines file")
    r.add_argument("--out", default="out.png")
    r.set_defaults(fn=cmd_render)

    g = sub.add_parser("gradcheck", help="gradient vs finite-diff check")
    g.add_argument("--device", required=True,
                   help="where the check runs: cpu, cuda, cuda:N")
    g.set_defaults(fn=cmd_gradcheck)

    v = sub.add_parser("validate",
                       help="scene lint + the kernel against its plain "
                            "version")
    v.add_argument("--scene", choices=SCENES, default="test")
    v.add_argument("--scene-file", default=None, metavar="JSON")
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("--width", type=int, default=96)
    v.add_argument("--height", type=int, default=48)
    v.add_argument("--spp", type=int, default=2)
    v.add_argument("--depth", type=int, default=5)
    v.add_argument("--scatter-mode", choices=("v2", "v1"), default="v2")
    v.add_argument("--rng-mode", choices=("sequential", "parallel"),
                   default="sequential")
    v.add_argument("--bvh", action="store_true",
                   help="check the BVH's sweep (flat or walk by the rule)")
    _view_args(v)
    v.add_argument("--device", required=True,
                   help="where the check runs: cpu, cuda, cuda:N")
    v.set_defaults(fn=cmd_validate)

    i = sub.add_parser("info", help="package, torch and device info")
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    if args.cmd == "render":
        for bad, msg in (
                (args.checkpoint and not args.progressive,
                 "--checkpoint needs --progressive"),
                (args.preview_every and not args.progressive,
                 "--preview-every needs --progressive"),
                (args.resume and not args.checkpoint,
                 "--resume needs --checkpoint"),
                (args.checkpoint and not args.checkpoint.endswith(".npz"),
                 "--checkpoint must end in .npz (numpy would append it)"),
                (args.log and args.progressive,
                 "--log needs a one-shot render (not --progressive)"),
                (args.progressive < 0 or args.devices < 1,
                 "--progressive and --devices take positive counts"),
                ((args.spp_batch != 1 or args.refill)
                 and args.backend != "wavefront",
                 "--refill/--spp-batch are wavefront-only knobs; pass "
                 "--backend wavefront"),
                (args.backend == "wavefront" and args.devices > 1,
                 "--backend wavefront is not supported with --devices > 1"),
                (args.backend == "wavefront" and args.progressive,
                 "--progressive supports the auto, golden and cuda "
                 "backends")):
            if bad:
                p.error(msg)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
