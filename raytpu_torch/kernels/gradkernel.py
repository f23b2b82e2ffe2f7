"""Fused image + VJP kernel K3: wrapper of ``csrc/gradkernel.cu``.

Counterpart of ``raytpu/kernels/gradkernel.py::render_pallas_vjp`` with the
brute-force sweep and the per-sample PASS 2 (no BVH, no slab, no windowed
refill, no tape).  See the note at the top of the ``.cu`` file.

:func:`render_vjp` takes the scene and camera as the package's NamedTuples
and an image cotangent ``ct``.  For CPU tensors it runs the plain PyTorch
version (:func:`render_vjp_plain`, a VJP of
:func:`raytpu_torch.adjoint.render_golden_adjoint`, as raytpu's
``megakernel._golden_bwd``); for CUDA tensors it launches the kernel or
raises, never falling back.  :func:`launch` is the kernel wrapper proper, on
packed operands.  ``launches`` counts the kernel launches made through it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raytpu_torch import adjoint
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import _build, megakernel
from raytpu_torch.scene import Scene

SOURCE = "gradkernel.cu"
MAX_DEPTH = 64  # the kernel's per-thread residual rows (kMaxDepth)
LEAVES = 8      # sphere cotangent rows: cx cy cz rad ar ag ab mp
CAM_SUMS = 18   # raygen cotangent sums (raytpu gradkernel.py:960-969)

launches = 0    # kernel launches through launch(); a run resets and reads it


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.raytpu_render_vjp
    fn.argtypes = [ptr, ptr, i, ptr, ptr, ptr, ptr, ptr,
                   i, i, i, i, f, f, f, f, f, f, i, i, ptr]
    fn.restype = ctypes.c_int
    lib.raytpu_render_vjp_warps.argtypes = [i, i]
    lib.raytpu_render_vjp_warps.restype = ctypes.c_int
    return lib


def _scene_grads(center, radius, albedo, mat_param) -> Scene:
    """A gradient Scene: the continuous leaves, ``mat_type`` None."""
    return Scene(center=center, radius=radius, mat_type=None, albedo=albedo,
                 mat_param=mat_param)


def camera_grads(sums: torch.Tensor, cam: Camera) -> Camera:
    """The Camera cotangent from the kernel's 18 raygen sums, the host
    assembly of raytpu's gradkernel.py:1745-1766: effective origin (d_o -
    d_d), d_d, u * d_d, v * d_d, ldx * eo and ldy * eo, each summed over
    pixels and samples.  A pinhole camera never consumes its lens offset,
    so its lens cotangents are exactly zero (the ``live`` mask)."""
    sum_eo, sum_dd = sums[0:3], sums[3:6]
    sum_udd, sum_vdd = sums[6:9], sums[9:12]
    sum_ldx_eo, sum_ldy_eo = sums[12:15], sums[15:18]
    lens_r = cam.lens_radius
    live = torch.where(lens_r > 0, 1.0, 0.0)
    return Camera(
        origin=sum_eo,
        horizontal=sum_udd,
        vertical=sum_vdd,
        lower_left=sum_dd,
        u=live * lens_r * sum_ldx_eo,
        v=live * lens_r * sum_ldy_eo,
        lens_radius=live * (torch.dot(cam.u, sum_ldx_eo)
                            + torch.dot(cam.v, sum_ldy_eo)),
    )


def _check_frame(cfg: RenderConfig, ct: torch.Tensor, img, device):
    shape = (cfg.height, cfg.width, 3)
    for name, t in (("ct", ct), ("img", img)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want torch.float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the scene on {device}")


def launch(cam_pack: torch.Tensor, scene_pack: torch.Tensor,
           cfg: RenderConfig, ct: torch.Tensor, img=None, vis_w: float = 0.0):
    """Launch K3 on packed operands -> (image, (8, N) f32 sphere
    cotangents, (18,) f32 camera sums).

    ``img`` (parallel RNG only) is the forward image: it elides PASS 1.
    Sequential RNG chains each pixel's seed through its samples, so PASS 1
    must run and ``img`` is ignored there, as in raytpu.  Runs on the
    current stream of the operands' device and does not synchronise."""
    global launches
    megakernel.check_packs(cam_pack, scene_pack)
    if cfg.depth > MAX_DEPTH:
        raise ValueError(f"depth {cfg.depth}: the VJP kernel keeps at most "
                         f"{MAX_DEPTH} bounces of residuals per thread")
    device = scene_pack.device
    skip_p1 = img is not None and cfg.rng_mode == "parallel"
    img_in = img if skip_p1 else None
    _check_frame(cfg, ct, img_in, device)
    ct = ct.contiguous()
    img_in = None if img_in is None else img_in.detach().contiguous()
    n = scene_pack.shape[1]
    lib = _lib()
    out = torch.empty((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=device)
    gsc = torch.zeros((LEAVES, n), dtype=torch.float64, device=device)
    # one row of camera sums per warp, summed below in a fixed order
    n_warps = lib.raytpu_render_vjp_warps(cfg.width, cfg.height)
    gcam = torch.empty((n_warps, CAM_SUMS), dtype=torch.float64,
                       device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.raytpu_render_vjp(
            cam_pack.data_ptr(), scene_pack.data_ptr(), n, ct.data_ptr(),
            None if img_in is None else img_in.data_ptr(), out.data_ptr(),
            gsc.data_ptr(), gcam.data_ptr(),
            cfg.width, cfg.height, cfg.spp, cfg.depth,
            float(np.float32(cfg.t_min)),
            float(np.float32(1.0 / (cfg.width - 1))),
            float(np.float32(1.0 / (cfg.height - 1))),
            float(np.float32(1.0 / cfg.spp)),
            float(np.float32(cfg.gamma)), float(np.float32(vis_w)),
            int(cfg.rng_mode == "parallel"), int(cfg.scatter_mode == "v1"),
            stream)
    if err != 0:
        raise RuntimeError(f"render_vjp_kernel launch failed: CUDA error {err}")
    launches += 1
    return out, gsc.to(torch.float32), gcam.sum(dim=0).to(torch.float32)


def render_vjp_plain(scene: Scene, cam: Camera, cfg: RenderConfig, ct,
                     vis_w: float = 0.0):
    """The plain version of K3 on any device: the VJP of the adjoint
    renderer for the image cotangent ``ct`` -> (img, d_scene, d_cam)."""
    leaves = [t.detach().requires_grad_()
              for t in (scene.center, scene.radius, scene.albedo,
                        scene.mat_param, *cam)]
    with torch.enable_grad():
        img = adjoint.render_golden_adjoint(
            Scene(leaves[0], leaves[1], scene.mat_type, leaves[2],
                  leaves[3]), Camera(*leaves[4:]), cfg, vis_w)
        grads = torch.autograd.grad(img, leaves, ct, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    return img.detach(), _scene_grads(*grads[:4]), Camera(*grads[4:])


def render_vjp(scene: Scene, cam: Camera, cfg: RenderConfig, ct, img=None,
               vis_w: float = 0.0):
    """Fused image + VJP -> (img, d_scene, d_cam) for the image cotangent
    ``ct`` (H, W, 3), the counterpart of raytpu's ``render_pallas_vjp``.

    ``d_scene.mat_type`` is None (a discrete leaf).  ``img`` (parallel RNG)
    elides the kernel's PASS 1; the plain version ignores it.  ``vis_w >
    0`` adds raytpu's silhouette (boundary) gradients.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    adjoint.check_cfg(cfg)
    device = megakernel.check_inputs(scene, cam, cfg)
    ct = torch.as_tensor(ct, dtype=torch.float32, device=device)
    _check_frame(cfg, ct, img, device)
    if device.type == "cpu":
        return render_vjp_plain(scene, cam, cfg, ct, vis_w)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out, gsc, gcam = launch(megakernel.pack_camera(cam),
                            megakernel.pack_scene(scene), cfg, ct, img, vis_w)
    d_scene = _scene_grads(gsc[0:3].T.contiguous(), gsc[3],
                           gsc[4:7].T.contiguous(), gsc[7])
    return out, d_scene, camera_grads(gcam, cam)
