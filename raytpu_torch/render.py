"""Public rendering entry point (counterpart of ``raytpu/render.py``).

Build a Scene and a Camera on a device, call :func:`render`.  Backends:

- ``"golden"`` — the plain PyTorch renderer (raytpu_torch/golden.py), on
  whatever device the tensors lie on.
- ``"cuda"``   — the hand-written CUDA megakernel
  (raytpu_torch/kernels/megakernel.py); CUDA tensors only.
- ``"auto"``   — the kernel for CUDA tensors, the plain version for CPU
  tensors.
"""

from __future__ import annotations

import torch

from raytpu_torch import golden
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import megakernel
from raytpu_torch.scene import Scene

BACKENDS = ("auto", "golden", "cuda")


def render(scene: Scene, cam: Camera, cfg: RenderConfig,
           backend: str = "auto", device=None) -> torch.Tensor:
    """Render -> (H, W, 3) f32 image in [0, 1] on the inputs' device.

    Row 0 is the bottom scanline (v = 0); use :func:`raytpu_torch.io.save_image`
    to write a display-oriented file.  ``device``, when given, moves the
    scene and camera there first; otherwise they stay where they are and
    the image is made on their device.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend: {backend!r} (choose from "
                         f"{BACKENDS})")
    if device is not None:
        scene = Scene(*(t.to(device) for t in scene))
        cam = Camera(*(t.to(device) for t in cam))
    if backend == "golden":
        return golden.render_golden(scene, cam, cfg)
    if backend == "cuda" and not scene.center.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; the scene is on "
                         f"{scene.center.device}")
    # "auto" and "cuda": the wrapper launches the kernel on CUDA tensors
    # and runs the plain version on CPU tensors
    return megakernel.render_fwd(scene, cam, cfg)


def render_grad(scene: Scene, cam: Camera, cfg: RenderConfig, target,
                backend: str = "auto", vis_w: float = 0.0):
    """Not ported yet: gradients need the adjoint (ROADMAP queue 1, M6), the
    kernel autograd wiring (M7) and the fused VJP kernel (queue 2, K3)."""
    raise NotImplementedError(
        "render_grad is not ported yet (ROADMAP queue 1, M6/M7; queue 2, K3)")
