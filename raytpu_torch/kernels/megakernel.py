"""Forward render megakernel K1a: wrapper of ``csrc/megakernel.cu``.

Counterpart of ``raytpu/kernels/megakernel.py::render_pallas`` with the
brute-force sphere sweep (no BVH, no dense stage, full frame).  The CUDA
kernel is one thread per pixel; see the note at the top of the ``.cu`` file.

:func:`render_fwd` takes the scene and camera as the package's NamedTuples.
For CPU tensors it runs the plain PyTorch version
(:func:`raytpu_torch.golden.render_golden`); for CUDA tensors it launches
the kernel or raises — it never falls back.  :func:`launch` is the kernel
wrapper proper, on the packed operands the kernel reads.  ``launches``
counts the kernel launches made through :func:`launch`.

Under autograd (any continuous leaf requires grad) :func:`render_fwd` goes
through :class:`_Render`, the counterpart of raytpu's ``custom_vjp`` around
``_render_pallas`` (raytpu/kernels/megakernel.py:1634-1684): the forward is
this kernel, the backward the fused VJP kernel K3
(``raytpu_torch/kernels/gradkernel.py``), which takes the forward image in
parallel RNG mode so as to skip its own PASS 1.  On CPU tensors the same
Function runs the plain versions of both (golden forward, adjoint VJP).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raytpu_torch import golden
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import _build
from raytpu_torch.scene import Scene

SOURCE = "megakernel.cu"
CAM_PACK = 19   # origin, horizontal, vertical, lower_left, u, v, lens_radius
SCENE_ROWS = 9  # cx, cy, cz, radius, mat_type, ar, ag, ab, mat_param

launches = 0    # kernel launches through launch(); a run resets and reads it

_SCENE_SPEC = {"center": (torch.float32, 2), "radius": (torch.float32, 1),
               "mat_type": (torch.int32, 1), "albedo": (torch.float32, 2),
               "mat_param": (torch.float32, 1)}


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.raytpu_render_fwd
    fn.argtypes = [ptr, ptr, i, ptr, i, i, i, i, f, f, f, f, f, i, i, ptr]
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


def launch(cam_pack: torch.Tensor, scene_pack: torch.Tensor,
           cfg: RenderConfig) -> torch.Tensor:
    """Launch the kernel on the packed operands -> (H, W, 3) f32 image.

    Runs on the current stream of the operands' device and does not
    synchronise.  ``inv_w``, ``inv_h`` and ``inv_spp`` are computed in f64
    here and rounded to f32, as raytpu's kernel and both goldens do."""
    global launches
    check_packs(cam_pack, scene_pack)
    n = scene_pack.shape[1]
    device = scene_pack.device
    lib = _lib()
    out = torch.empty((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.raytpu_render_fwd(
            cam_pack.data_ptr(), scene_pack.data_ptr(), n, out.data_ptr(),
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
    return out


class _Render(torch.autograd.Function):
    """The forward kernel with K3 as its backward.

    apply(cfg, vis_w, mat_type, center, radius, albedo, mat_param, *camera)
    -> image.  ``mat_type`` is discrete and gets no gradient; ``vis_w > 0``
    adds silhouette terms to the backward only."""

    @staticmethod
    def forward(ctx, cfg, vis_w, mat_type, center, radius, albedo, mat_param,
                *cam_leaves):
        scene = Scene(center, radius, mat_type, albedo, mat_param)
        cam = Camera(*cam_leaves)
        img = _forward(scene, cam, cfg)
        ctx.cfg, ctx.vis_w = cfg, vis_w
        ctx.save_for_backward(mat_type, center, radius, albedo, mat_param,
                              img, *cam_leaves)
        return img

    @staticmethod
    def backward(ctx, ct):
        from raytpu_torch.kernels import gradkernel
        mat_type, center, radius, albedo, mat_param, img, *cam_leaves = \
            ctx.saved_tensors
        cfg = ctx.cfg
        # parallel RNG: the forward image elides K3's PASS 1
        _, ds, dc = gradkernel.render_vjp(
            Scene(center, radius, mat_type, albedo, mat_param),
            Camera(*cam_leaves), cfg, ct,
            img=img if cfg.rng_mode == "parallel" else None,
            vis_w=ctx.vis_w)
        return (None, None, None, ds.center, ds.radius, ds.albedo,
                ds.mat_param, *dc)


def _forward(scene: Scene, cam: Camera, cfg: RenderConfig) -> torch.Tensor:
    device = scene.center.device
    if device.type == "cpu":
        return golden.render_golden(scene, cam, cfg)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return launch(pack_camera(cam), pack_scene(scene), cfg)


def render_fwd(scene: Scene, cam: Camera, cfg: RenderConfig,
               vis_w: float = 0.0) -> torch.Tensor:
    """Full-frame forward render -> (H, W, 3) f32 image in [0, 1] on the
    inputs' device (row 0 = bottom scanline).  CPU tensors take the plain
    PyTorch version; CUDA tensors launch the kernel.  When autograd is on
    and a continuous leaf of the scene or camera requires grad, the image
    carries a backward: K3 on CUDA tensors, the adjoint on CPU tensors
    (``vis_w > 0`` adds silhouette gradients)."""
    check_inputs(scene, cam, cfg)
    leaves = (scene.center, scene.radius, scene.albedo, scene.mat_param,
              *cam)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return _Render.apply(cfg, float(vis_w), scene.mat_type,
                             scene.center, scene.radius, scene.albedo,
                             scene.mat_param, *cam)
    return _forward(scene, cam, cfg)
