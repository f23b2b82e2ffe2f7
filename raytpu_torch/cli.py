"""Command-line interface (counterpart of ``raytpu/cli.py``).

    python -m raytpu_torch.cli render --scene random --width 1024 \
        --height 576 --spp 60 --depth 50 --device cuda --out frame.png
    python -m raytpu_torch.cli render --scene final --width 800 \
        --height 400 --spp 100 --bvh --device cuda --out final.png
    python -m raytpu_torch.cli gradcheck --device cuda

The ``render`` and ``gradcheck`` subcommands are ported, ``render --bvh``
(with ``--bvh-builder``) among them: every backend of the port's
``render`` sweeps the BVH it is given (raytpu refuses ``--bvh`` on its
golden backend, which would ignore it; here none does), and
``--bvh-builder`` without ``--bvh`` is refused rather than ignored.
``--progressive``, ``--devices`` and the other subcommands belong to parts
not ported yet and exit with an error that names their ROADMAP item;
raytpu's other options are not accepted.  None is silently ignored.
"""

from __future__ import annotations

import argparse
import json
import sys

SCENES = ("config1", "test", "random", "final", "v1")

# option -> (value meaning "not asked for", ROADMAP item that ports it)
_NOT_PORTED = {
    "progressive": (0, "--progressive needs progressive rendering "
                       "(ROADMAP queue 1, M8; queue 2, K2)"),
    "devices": (1, "--devices > 1 needs sharding over torch.distributed "
                   "(ROADMAP queue 1, M9)"),
}
_SUBCOMMANDS_NOT_PORTED = {
    "validate": "debug.py's cross-backend sweep (ROADMAP queue 1, M11)",
    "info": "the tools (ROADMAP queue 1, M11)",
}


def _build_scene(name: str, seed: int, device):
    import raytpu_torch as rt
    if name == "config1":
        return rt.config1_world(device=device)
    if name == "test":
        return rt.test_world(device=device)
    if name == "random":
        return rt.random_world(seed=seed, device=device)
    if name == "final":
        return rt.final_world(seed=seed, device=device)
    return rt.v1_world(device=device)  # the v1 app's seven-sphere world


def cmd_render(args) -> int:
    for opt, (unset, msg) in _NOT_PORTED.items():
        if getattr(args, opt) != unset:
            raise SystemExit(f"not ported yet: {msg}")
    if args.bvh_builder is not None and not args.bvh:
        raise SystemExit("--bvh-builder needs --bvh")
    import raytpu_torch as rt
    from raytpu_torch import io, profiling
    from raytpu_torch.config import RenderConfig

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       depth=args.depth, rng_mode=args.rng_mode,
                       scatter_mode=args.scatter_mode, gamma=args.gamma)
    scene = _build_scene(args.scene, args.seed, args.device)
    cam = rt.make_camera(tuple(args.look_from), tuple(args.look_at),
                         vfov=args.vfov, aspect=cfg.aspect,
                         aperture=args.aperture, focus_dist=args.focus_dist,
                         device=args.device)
    bvh = (rt.build_bvh(scene, builder=args.bvh_builder or "median")
           if args.bvh else None)
    img, stats = profiling.timed(
        lambda: rt.render(scene, cam, cfg, backend=args.backend, bvh=bvh),
        cfg, label="render")
    io.save_image(args.out, img.cpu().numpy())
    print(f"wrote {args.out}  ({stats.rays_per_sec / 1e6:.2f} Mrays/s, "
          f"{stats.wall_s * 1e3:.1f} ms on {stats.device})")
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raytpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to an image file")
    r.add_argument("--scene", choices=SCENES, default="test")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--width", type=int, default=400)
    r.add_argument("--height", type=int, default=200)
    r.add_argument("--spp", type=int, default=20)
    r.add_argument("--depth", type=int, default=12)
    r.add_argument("--look-from", type=float, nargs=3,
                   default=[13.0, 2.0, 3.0])
    r.add_argument("--look-at", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    r.add_argument("--vfov", type=float, default=20.0)
    r.add_argument("--aperture", type=float, default=0.0)
    r.add_argument("--focus-dist", type=float, default=None)
    r.add_argument("--device", required=True,
                   help="where the scene is built and rendered: cpu, cuda, "
                        "cuda:N")
    r.add_argument("--backend", choices=("auto", "golden", "cuda"),
                   default="auto",
                   help="auto = the CUDA kernel on a cuda device, the plain "
                        "PyTorch version on cpu")
    r.add_argument("--gamma", type=float, default=2.2,
                   help="output gamma: 2.2 = v2's pow(1/2.2), 2.0 = v1's sqrt")
    r.add_argument("--scatter-mode", choices=("v2", "v1"), default="v2",
                   help="material semantics generation")
    r.add_argument("--rng-mode",
                   choices=("sequential", "parallel", "v1_fractsin"),
                   default="sequential",
                   help="sequential = reference-parity seed chain; parallel "
                        "= per-sample streams (v1_fractsin: not ported yet)")
    r.add_argument("--bvh", action="store_true",
                   help="build a BVH of the scene and sweep its flat leaf "
                        "list (K1c on a cuda device)")
    r.add_argument("--bvh-builder", choices=("median", "sah"), default=None,
                   help="BVH build heuristic (default median; sah = the "
                        "native binned surface-area heuristic)")
    # accepted so that these raytpu command lines parse; refused in cmd_render
    r.add_argument("--progressive", type=int, default=0, metavar="BATCH",
                   help="not ported yet (M8)")
    r.add_argument("--devices", type=int, default=1, metavar="N",
                   help="not ported yet (M9)")
    r.add_argument("--out", default="out.png")
    r.set_defaults(fn=cmd_render)

    g = sub.add_parser("gradcheck", help="gradient vs finite-diff check")
    g.add_argument("--device", required=True,
                   help="where the check runs: cpu, cuda, cuda:N")
    g.set_defaults(fn=cmd_gradcheck)

    for name, what in _SUBCOMMANDS_NOT_PORTED.items():
        sub.add_parser(name, help=f"not ported yet: needs {what}")

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _SUBCOMMANDS_NOT_PORTED:
        # refused before parsing, so raytpu's options for it need no twin
        raise SystemExit(f"not ported yet: '{argv[0]}' needs "
                         f"{_SUBCOMMANDS_NOT_PORTED[argv[0]]}")
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
