"""Public rendering entry point (counterpart of ``raytpu/render.py``).

Build a Scene and a Camera on a device, call :func:`render`.  Backends:

- ``"golden"`` — the plain PyTorch renderer (raytpu_torch/golden.py), on
  whatever device the tensors lie on.
- ``"cuda"``   — the hand-written CUDA megakernel
  (raytpu_torch/kernels/megakernel.py); CUDA tensors only.
- ``"auto"``   — the kernel for CUDA tensors, the plain version for CPU
  tensors.
- ``"wavefront"`` — the sorted-wavefront engine
  (raytpu_torch/wavefront.py: the segment kernels K5 / K6 on CUDA tensors,
  their plain versions on CPU tensors), with its knobs ``spp_batch`` and
  ``refill``.  raytpu demoted it on a TPU; it runs only when asked for by
  name, never under ``"auto"``.

``rng_mode="v1_fractsin"`` (the v1 fract-sin parity mode) is forward-only
and golden-only, as in raytpu: every backend renders it through the plain
version, on whatever device the tensors lie on (:func:`backend_for`).

Gradients: :func:`render` on inputs that require grad returns an image with
a backward (:mod:`raytpu_torch.autodiff`: on CUDA tensors the forward kernel
K1a and the fused VJP kernel K3; on CPU tensors the plain golden forward and
the adjoint VJP).
:func:`render_grad` is raytpu's surface: an MSE loss against a target and
the gradients of the scene's and camera's continuous leaves.

``bvh=`` (:func:`raytpu_torch.bvh.build_bvh` of the scene, on its device)
sweeps the BVH instead of every sphere, by raytpu's rule
(:func:`raytpu_torch.bvh.sweep_of`): its flat leaf list up to 64 leaves a
copy, else the skip-pointer walk.  K1c or K1d forward and K3's BVH or walk
variant backward on CUDA tensors, their plain versions on CPU tensors.  In parallel RNG with ``vis_w == 0`` (from 8 spheres) the
gradient path tapes each bounce's winner in the forward (K4) and K3 replays the tape instead of
sweeping (:func:`raytpu_torch.kernels.gradkernel.tape_plan`).

Progressive (checkpointed, batched) rendering is
:mod:`raytpu_torch.progressive`; row-slab sharding over
``torch.distributed`` is :mod:`raytpu_torch.shard`.
"""

from __future__ import annotations

import torch

from raytpu_torch import adjoint, autodiff, golden, profiling
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.scene import Scene

BACKENDS = ("auto", "golden", "cuda")
# render() and render_grad() also take the wavefront
RENDER_BACKENDS = BACKENDS + ("wavefront",)


def check_backend(backend: str, scene: Scene,
                  allowed: tuple = BACKENDS) -> None:
    """Raise on a backend not in ``allowed``, and on ``"cuda"`` for a scene
    that is not on a card (``"auto"`` takes the plain version there
    instead)."""
    if backend not in allowed:
        raise ValueError(f"unknown backend: {backend!r} (choose from "
                         f"{allowed})")
    if backend == "cuda" and not scene.center.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; the scene is on "
                         f"{scene.center.device}")


def backend_for(cfg: RenderConfig, backend: str,
                allowed: tuple = BACKENDS) -> str:
    """The backend that renders ``cfg`` when ``backend`` is asked for:
    ``"golden"`` for every name in ``allowed`` under
    ``rng_mode="v1_fractsin"``, which no kernel takes (raytpu/render.py:
    73-77), decided before any launch and on any device; else
    ``backend``."""
    if cfg.rng_mode == "v1_fractsin" and backend in allowed:
        return "golden"
    return backend


def render(scene: Scene, cam: Camera, cfg: RenderConfig,
           backend: str = "auto", device=None,
           vis_w: float = 0.0, bvh=None, spp_batch: int = 1,
           refill: int = 0) -> torch.Tensor:
    """Render -> (H, W, 3) f32 image in [0, 1] on the inputs' device.

    Row 0 is the bottom scanline (v = 0); use :func:`raytpu_torch.io.save_image`
    to write a display-oriented file.  ``device``, when given, moves the
    scene and camera there first; otherwise they stay where they are and
    the image is made on their device.  When a continuous leaf requires
    grad, the image is differentiable: ``golden`` through plain autograd,
    ``auto`` / ``cuda`` through the kernels' autograd Function, whose
    backward adds silhouette gradients for ``vis_w > 0`` (the image itself
    does not depend on ``vis_w``).  ``bvh`` (built for this scene; moved
    with it when ``device`` is given) makes every backend sweep it, by the
    flat leaf list or the skip-pointer walk: the same image up to exact
    ties of t between spheres.  ``spp_batch`` and ``refill`` are the
    wavefront's knobs (:func:`raytpu_torch.wavefront.render_wavefront`),
    refused on the other backends as raytpu refuses them.
    ``rng_mode="v1_fractsin"`` renders through the plain version whatever
    the backend (so the wavefront's knobs are refused with it).
    """
    with profiling.span("raytpu.render"):
        if device is not None:
            scene = Scene(*(t.to(device) for t in scene))
            cam = Camera(*(t.to(device) for t in cam))
            bvh = None if bvh is None else bvh.to(device)
        backend = backend_for(cfg, backend, RENDER_BACKENDS)
        check_backend(backend, scene, RENDER_BACKENDS)
        if (spp_batch > 1 or refill) and backend != "wavefront":
            raise ValueError(
                "spp_batch > 1 / refill are wavefront-only knobs; pass "
                "backend='wavefront' explicitly (the wavefront is never "
                "picked by 'auto')")
        if backend == "golden":
            return golden.render_golden(scene, cam, cfg, bvh)
        if backend == "wavefront":
            from raytpu_torch import wavefront
            return wavefront.render_wavefront(
                scene, cam, cfg, bvh=bvh, vis_w=vis_w, spp_batch=spp_batch,
                refill=refill)
        # "auto" and "cuda": the kernel on CUDA tensors, the plain version
        # on CPU tensors
        return autodiff.render_fwd(scene, cam, cfg, vis_w=vis_w, bvh=bvh)


def render_grad(scene: Scene, cam: Camera, cfg: RenderConfig, target,
                backend: str = "auto", vis_w: float = 0.0, bvh=None):
    """MSE loss against ``target`` and its gradients w.r.t. (scene, camera).

    Returns ``(loss, image, (scene_grads, camera_grads))``: a Scene whose
    ``mat_type`` is None (a discrete leaf) and a Camera.  ``vis_w > 0`` adds
    silhouette (boundary) gradients for geometry optimization; the forward
    stays the exact hard render.  ``backend="golden"`` runs the adjoint
    renderer (raytpu_torch/adjoint.py) on any device; ``"auto"`` and
    ``"cuda"`` the kernels on CUDA tensors (K1a forward, K3 backward: on
    its windowed refill in parallel RNG, where it is given the forward's
    image) and the plain versions on CPU tensors.  ``bvh`` makes ``"auto"`` and
    ``"cuda"`` sweep it, flat or by the walk (K1c / K1d forward or, in
    parallel RNG, the taping forward K4; K3's BVH variant or its tape
    replay backward);
    ``"golden"`` ignores it, as raytpu's adjoint is the brute-force oracle
    (raytpu/render.py:139).  ``"wavefront"`` takes the kernel path, as
    raytpu's does (raytpu/render.py:136-137): its gradients are K3's, on
    its windowed refill in parallel RNG.  An optimisation loop that moves
    spheres keeps the BVH's boxes around them with
    :func:`raytpu_torch.bvh.refit`.
    """
    check_backend(backend, scene, RENDER_BACKENDS)
    if backend == "wavefront":
        backend = "auto"
    adjoint.check_cfg(cfg)
    leaves = [t.detach().requires_grad_()
              for t in (scene.center, scene.radius, scene.albedo,
                        scene.mat_param, *cam)]
    s = Scene(leaves[0], leaves[1], scene.mat_type, leaves[2], leaves[3])
    c = Camera(*leaves[4:])
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=scene.center.device)
    with torch.enable_grad():
        if backend == "golden":
            img = adjoint.render_golden_adjoint(s, c, cfg, vis_w)
        else:
            img = autodiff.render_fwd(s, c, cfg, vis_w=vis_w, bvh=bvh)
        loss = torch.mean((img - target) ** 2)
        grads = torch.autograd.grad(loss, leaves)
    scene_grads = Scene(center=grads[0], radius=grads[1], mat_type=None,
                        albedo=grads[2], mat_param=grads[3])
    return loss.detach(), img.detach(), (scene_grads, Camera(*grads[4:]))
