"""Forward render megakernels: wrapper of ``csrc/megakernel.cu``.

Counterpart of ``raytpu/kernels/megakernel.py::render_pallas`` (full frame,
no dense stage) and of the write side of ``raytpu/kernels/gradkernel.py::
render_tape_fwd``.  One kernel template, variants by operand: K1a (the
brute-force sphere sweep), K1c (``bvh=``: the flat leaf-list sweep over the
scene in leaf order), K1' (``count=True``: the census of leaves entered,
bounce steps and samples) and K4's write side (``tape=``: the taping
forward, the same image plus each step's winner).  The CUDA kernel is one
thread per pixel; see the note at the top of the ``.cu`` file.

:func:`render_fwd` takes the scene and camera as the package's NamedTuples.
For CPU tensors it runs the plain PyTorch version
(:func:`raytpu_torch.golden.render_golden`, with a BVH its flat sweep
:func:`raytpu_torch.golden.hit_world_bvh`); for CUDA tensors it launches
the kernel or raises — it never falls back.  :func:`launch` is the kernel
wrapper proper, on the packed operands the kernel reads.  ``launches``
counts the kernel launches made through :func:`launch`, ``variants`` the
same launches by variant.

Under autograd (any continuous leaf requires grad) :func:`render_fwd` goes
through :class:`_Render`, the counterpart of raytpu's ``custom_vjp``s
around ``_render_pallas`` and ``_render_pallas_bvh``
(raytpu/kernels/megakernel.py:1634-1739), with or without a BVH: the
forward is this kernel, the backward the fused VJP kernel K3
(``raytpu_torch/kernels/gradkernel.py``), which takes the forward image in
parallel RNG mode so as to skip its own PASS 1.  Where
:func:`raytpu_torch.kernels.gradkernel.tape_plan` applies (parallel RNG,
``vis_w == 0``, the tape within its budget) the forward is the taping one
and K3 replays its tape instead of sweeping.  The taping forward traces
through the same device function as K1a / K1c, so the image under grad is
the image without it, bit for bit (raytpu's taping forward runs another
schedule and may differ by FMA contraction; here that cannot arise).  On
CPU tensors the same Functions run the plain versions of every piece
(golden forward, golden taping forward, the adjoint's VJP and its tape
replay).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raytpu_torch import golden
from raytpu_torch.bvh import BVH, outlier_tail, permute_scene
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import _build
from raytpu_torch.scene import Scene

SOURCE = "megakernel.cu"
CAM_PACK = 19   # origin, horizontal, vertical, lower_left, u, v, lens_radius
SCENE_ROWS = 9  # cx, cy, cz, radius, mat_type, ar, ag, ab, mat_param

launches = 0    # kernel launches through launch(); a run resets and reads it
# the same launches by variant: K1a brute, K1c flat BVH, K1' census (by
# sweep), K4 taping forward (by sweep); a run resets and reads them
variants = dict.fromkeys(("K1a", "K1c", "K1'/brute", "K1'/bvh", "K4/brute",
                          "K4/bvh"), 0)

_SCENE_SPEC = {"center": (torch.float32, 2), "radius": (torch.float32, 1),
               "mat_type": (torch.int32, 1), "albedo": (torch.float32, 2),
               "mat_param": (torch.float32, 1)}


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.raytpu_render_fwd
    fn.argtypes = [ptr, ptr, i, ptr, i, i, i, i, i, ptr, i, i, ptr, ptr,
                   i, i, i, i, f, f, f, f, f, i, i, ptr]
    fn.restype = ctypes.c_int
    return lib


def check_inputs(scene: Scene, cam: Camera, cfg: RenderConfig) -> torch.device:
    """Raise on anything the kernel (or its plain version) does not take;
    return the one device every input lies on."""
    if cfg.rng_mode == "v1_fractsin":
        raise NotImplementedError(golden._FRACTSIN_TODO)
    if cfg.rng_mode not in ("sequential", "parallel"):
        raise ValueError(f"unknown rng_mode: {cfg.rng_mode!r}")
    if cfg.scatter_mode not in ("v2", "v1"):
        raise ValueError(f"unknown scatter_mode: {cfg.scatter_mode!r}")
    if cfg.width < 2 or cfg.height < 2 or cfg.spp < 1 or cfg.depth < 0:
        raise ValueError(f"unsupported frame: {cfg.width}x{cfg.height}, "
                         f"spp {cfg.spp}, depth {cfg.depth}")
    n = scene.center.shape[0] if scene.center.dim() == 2 else -1
    if n < 1:
        raise ValueError("the scene needs at least one sphere, center (N, 3)")
    tensors = []
    for name, (dtype, dim) in _SCENE_SPEC.items():
        t = getattr(scene, name)
        shape = (n, 3) if dim == 2 else (n,)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"scene.{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        tensors.append((f"scene.{name}", t))
    for name in Camera._fields:
        t = getattr(cam, name)
        shape = () if name == "lens_radius" else (3,)
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"cam.{name}: want torch.float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        tensors.append((f"cam.{name}", t))
    device = scene.center.device
    for name, t in tensors:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, scene.center on "
                             f"{device}")
    return device


def pack_camera(cam: Camera) -> torch.Tensor:
    """(19,) f32 on the camera's device, in the kernel's CamPack order."""
    return torch.cat([cam.origin, cam.horizontal, cam.vertical, cam.lower_left,
                      cam.u, cam.v, cam.lens_radius.reshape(1)]).contiguous()


def pack_scene(scene: Scene) -> torch.Tensor:
    """(9, N) f32 on the scene's device: cx, cy, cz, radius, mat_type,
    ar, ag, ab, mat_param (raytpu's ``_pack_scene`` rows)."""
    return torch.stack([
        scene.center[:, 0], scene.center[:, 1], scene.center[:, 2],
        scene.radius, scene.mat_type.to(torch.float32),
        scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
        scene.mat_param]).contiguous()


def check_packs(cam_pack: torch.Tensor, scene_pack: torch.Tensor) -> None:
    """Raise unless both packs are contiguous f32 CUDA tensors of the
    kernels' shapes on one device, carrying no autograd history: only
    :class:`_Render` may run a kernel under autograd, because only it
    supplies the backward."""
    for name, t, shape in (("cam_pack", cam_pack, (CAM_PACK,)),
                           ("scene_pack", scene_pack,
                            (SCENE_ROWS, scene_pack.shape[-1]))):
        if t.requires_grad:
            raise ValueError(f"{name} requires grad: a kernel launched "
                             "directly has no backward; go through "
                             "render_fwd (or render), whose autograd "
                             "Function runs K3 backward")
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want torch.float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cam_pack.device != scene_pack.device:
        raise ValueError("cam_pack and scene_pack lie on different devices")
    if scene_pack.shape[1] < 1:
        raise ValueError("the scene needs at least one sphere")


def check_bvh(bvh: BVH, rows: int | None, device) -> None:
    """Raise unless ``bvh`` is one the flat sweep takes for a scene of
    ``rows`` permuted rows (None: as many as ``perm`` has) on ``device``:
    padded leaves with a flat leaf list of f32 contiguous rows, ``perm``
    one entry per row."""
    if not isinstance(bvh, BVH):
        raise ValueError(f"bvh: want a raytpu_torch.bvh.BVH, got "
                         f"{type(bvh).__name__}")
    if bvh.flat is None or not bvh.leaf_size:
        raise ValueError("bvh: the flat sweep needs padded leaves and a flat "
                         "leaf list (build_bvh(pad_leaves=True))")
    flat = bvh.flat
    if rows is None:
        rows = bvh.perm.shape[0] if bvh.perm.dim() == 1 else -1
    if (flat.dtype != torch.float32 or flat.dim() != 2 or flat.shape[1] != 9
            or flat.shape[0] < 8 or flat.shape[0] % 8 or
            not flat.is_contiguous()):
        raise ValueError(f"bvh.flat: want contiguous torch.float32 (8L, 9), "
                         f"got {flat.dtype} {tuple(flat.shape)}")
    if bvh.perm.dim() != 1 or bvh.perm.shape[0] != rows:
        raise ValueError(f"bvh.perm has {tuple(bvh.perm.shape)} entries, the "
                         f"scene pack {rows} rows")
    if bvh.n_leaves * bvh.leaf_size > rows:
        raise ValueError("bvh: more leaf entries than permuted rows")
    for name, t in (("bvh.flat", flat), ("bvh.perm", bvh.perm)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the scene on {device}")


def check_tape(tape: torch.Tensor, cfg: RenderConfig, rows: int,
               device) -> None:
    """Raise unless ``tape`` is a winner-index tape of this frame: (g_cap,
    H*W) contiguous, ``g_cap <= spp * depth``, of :func:`golden.tape_dtype`
    for ``rows`` kernel-side spheres, on ``device``."""
    want = golden.tape_dtype(rows)
    if (tape.dtype != want or tape.dim() != 2
            or tape.shape[1] != cfg.height * cfg.width
            or tape.shape[0] > cfg.spp * cfg.depth
            or not tape.is_contiguous()):
        raise ValueError(
            f"tape: want contiguous {want} (g_cap <= {cfg.spp * cfg.depth}, "
            f"{cfg.height * cfg.width}) for this frame, got {tape.dtype} "
            f"{tuple(tape.shape)}")
    if tape.device != device:
        raise ValueError(f"tape is on {tape.device}, the scene on {device}")


def launch(cam_pack: torch.Tensor, scene_pack: torch.Tensor,
           cfg: RenderConfig, bvh: BVH | None = None,
           tape: torch.Tensor | None = None, count: bool = False):
    """Launch the kernel on the packed operands -> (H, W, 3) f32 image, or
    (image, census) with ``count``: ``census`` (3,) int64 on the device,
    the frame's ``golden.CENSUS`` counts.

    ``bvh``: the flat BVH sweep (K1c); ``scene_pack`` is then the scene in
    leaf order (``pack_scene(permute_scene(scene, bvh.perm))``).  ``tape``
    (g_cap, H*W): the taping forward (K4's write side) writes each pixel's
    first g_cap winners (-1 for a miss) into it; other slots keep their
    value.  Runs on the current stream of the operands' device and does not
    synchronise.  ``inv_w``, ``inv_h`` and ``inv_spp`` are computed in f64
    here and rounded to f32, as raytpu's kernel and both goldens do."""
    global launches
    check_packs(cam_pack, scene_pack)
    n = scene_pack.shape[1]
    device = scene_pack.device
    if bvh is not None:
        check_bvh(bvh, n, device)
    if tape is not None:
        check_tape(tape, cfg, n, device)
        if count:
            raise ValueError("the census does not count a taping forward")
    tail = None if bvh is None else outlier_tail(bvh.perm, bvh.flat,
                                                 bvh.leaf_size)
    out_base, out_cnt = tail if tail else (0, 0)
    lib = _lib()
    out = torch.empty((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=device)
    census = (torch.zeros(len(golden.CENSUS), dtype=torch.int64,
                          device=device)
              if count else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.raytpu_render_fwd(
            cam_pack.data_ptr(), scene_pack.data_ptr(), n,
            None if bvh is None else bvh.flat.data_ptr(),
            0 if bvh is None else bvh.n_leaves,
            0 if bvh is None else int(bvh.leaf_size), out_base, out_cnt,
            int(tape is not None),
            None if tape is None or tape.numel() == 0 else tape.data_ptr(),
            0 if tape is None else tape.shape[0],
            int(tape is not None and tape.dtype == torch.int32),
            None if census is None else census.data_ptr(), out.data_ptr(),
            cfg.width, cfg.height, cfg.spp, cfg.depth,
            float(np.float32(cfg.t_min)),
            float(np.float32(1.0 / (cfg.width - 1))),
            float(np.float32(1.0 / (cfg.height - 1))),
            float(np.float32(1.0 / cfg.spp)),
            float(np.float32(cfg.gamma)),
            int(cfg.rng_mode == "parallel"), int(cfg.scatter_mode == "v1"),
            stream)
    if err != 0:
        raise RuntimeError(f"render_fwd_kernel launch failed: CUDA error {err}")
    launches += 1
    sweep = "brute" if bvh is None else "bvh"
    if tape is not None:
        variants[f"K4/{sweep}"] += 1
    elif count:
        variants[f"K1'/{sweep}"] += 1
    else:
        variants["K1a" if bvh is None else "K1c"] += 1
    return (out, census) if count else out


def _forward(scene: Scene, cam: Camera, cfg: RenderConfig,
             bvh: BVH | None = None) -> torch.Tensor:
    device = scene.center.device
    if device.type == "cpu":
        return golden.render_golden(scene, cam, cfg, bvh)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    packed = pack_scene(scene if bvh is None else
                        permute_scene(scene, bvh.perm))
    return launch(pack_camera(cam), packed, cfg, bvh)


def _grad_forward(ctx, scene: Scene, cam: Camera, cfg: RenderConfig,
                  vis_w: float, bvh: BVH | None) -> torch.Tensor:
    """The forward under autograd: the taping forward where the tape plan
    applies (raytpu's ``_fwd`` / ``_fwd_bvh`` gate), else the plain
    forward kernel.  Keeps on ``ctx`` what the backward needs."""
    from raytpu_torch.kernels import gradkernel
    plan = gradkernel.tape_plan(cfg, scene.count, bvh, vis_w)
    if plan is None:
        img, tape = _forward(scene, cam, cfg, bvh), None
    else:
        img, tape = gradkernel.render_tape_fwd(scene, cam, cfg,
                                               plan["g_cap"], bvh)
    ctx.cfg, ctx.vis_w, ctx.bvh, ctx.plan, ctx.tape = cfg, vis_w, bvh, plan, \
        tape
    return img


def _grad_backward(ctx, ct, scene: Scene, cam: Camera, img):
    from raytpu_torch.kernels import gradkernel
    cfg, plan = ctx.cfg, ctx.plan
    # parallel RNG: the forward image elides K3's PASS 1; a tape also its
    # PASS-2 sweep for the steps it holds
    _, ds, dc = gradkernel.render_vjp(
        scene, cam, cfg, ct, img=img if cfg.rng_mode == "parallel" else None,
        vis_w=ctx.vis_w, bvh=ctx.bvh, tape=ctx.tape,
        tape_partial=plan is not None and plan["partial"])
    return ds, dc


class _Render(torch.autograd.Function):
    """The forward kernel (K1a, K1c with a BVH, or K4's taping forward)
    with K3 (its BVH variant with a BVH) as its backward: raytpu's
    ``_fwd`` / ``_bwd`` and ``_fwd_bvh`` / ``_bwd_bvh``.

    apply(cfg, vis_w, bvh, mat_type, center, radius, albedo, mat_param,
    *camera) -> image.  ``bvh`` (or None) and ``mat_type`` are derived or
    discrete data and get no gradient; ``vis_w > 0`` adds silhouette terms
    to the backward only."""

    @staticmethod
    def forward(ctx, cfg, vis_w, bvh, mat_type, center, radius, albedo,
                mat_param, *cam_leaves):
        scene = Scene(center, radius, mat_type, albedo, mat_param)
        img = _grad_forward(ctx, scene, Camera(*cam_leaves), cfg, vis_w, bvh)
        ctx.save_for_backward(mat_type, center, radius, albedo, mat_param,
                              img, *cam_leaves)
        return img

    @staticmethod
    def backward(ctx, ct):
        mat_type, center, radius, albedo, mat_param, img, *cam_leaves = \
            ctx.saved_tensors
        ds, dc = _grad_backward(
            ctx, ct, Scene(center, radius, mat_type, albedo, mat_param),
            Camera(*cam_leaves), img)
        return (None, None, None, None, ds.center, ds.radius, ds.albedo,
                ds.mat_param, *dc)


def render_fwd(scene: Scene, cam: Camera, cfg: RenderConfig,
               vis_w: float = 0.0, bvh: BVH | None = None) -> torch.Tensor:
    """Full-frame forward render -> (H, W, 3) f32 image in [0, 1] on the
    inputs' device (row 0 = bottom scanline).  CPU tensors take the plain
    PyTorch version; CUDA tensors launch the kernel (K1a, or K1c with
    ``bvh``, a :func:`raytpu_torch.bvh.build_bvh` of this scene on its
    device).  When autograd is on and a continuous leaf of the scene or
    camera requires grad, the image carries a backward: K3 on CUDA tensors,
    the adjoint on CPU tensors (``vis_w > 0`` adds silhouette gradients)."""
    device = check_inputs(scene, cam, cfg)
    if bvh is not None:
        check_bvh(bvh, None, device)
        if bvh.spheres and bvh.spheres != scene.count:
            raise ValueError(f"bvh was built for {bvh.spheres} spheres, the "
                             f"scene has {scene.count}")
    leaves = (scene.center, scene.radius, scene.albedo, scene.mat_param,
              *cam)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return _Render.apply(cfg, float(vis_w), bvh, scene.mat_type,
                             scene.center, scene.radius, scene.albedo,
                             scene.mat_param, *cam)
    return _forward(scene, cam, cfg, bvh)
