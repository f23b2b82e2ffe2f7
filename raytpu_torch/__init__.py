"""raytpu_torch — the PyTorch / CUDA port of raytpu for NVIDIA Hopper.

The same scenes, cameras, presets, counter-based RNG streams and material
semantics as the JAX package ``raytpu``, with tensors in place of jax
arrays.  The forward render runs on an H100 through a hand-written CUDA
megakernel (``raytpu_torch/kernels/megakernel.py``, source in
``raytpu_torch/csrc/``) and anywhere through the plain PyTorch version
(``raytpu_torch/golden.py``).  Gradients of the image w.r.t. the scene and
camera (``render`` under autograd, ``render_grad``, ``optim.optimize``) run
backward through the fused VJP kernel (``raytpu_torch/kernels/gradkernel.py``)
on a card and through the adjoint (``raytpu_torch/adjoint.py``) anywhere.
``build_bvh(scene)`` (``raytpu_torch/bvh.py``) gives a BVH that
``render(..., bvh=)`` and ``render_grad(..., bvh=)`` sweep as a flat leaf
list, or past 64 leaves a copy (raytpu's rule) by the skip-pointer walk;
in parallel RNG the gradient path tapes each bounce's winner in the
forward and replays the tape in the backward.  ``progressive`` renders in
checkpointed sample batches (the carry-state kernel K2 on a card) and
``shard`` splits the frame into row slabs over a ``torch.distributed``
group (every kernel's slab mode).  Without a BVH the kernels sweep every
sphere over the scene's rows staged in shared memory (up to 4096
spheres); from 96 spheres that forward is counted as raytpu's dense stage
K1e.  ``wavefront`` is raytpu's sorted-wavefront engine
(``render(backend="wavefront")``: the segment kernels K5 and K6 on a
card).  ``scene_io`` reads and writes raytpu's JSON scene files, ``debug``
holds the scene lint, the checked render and the kernel-against-plain
check behind ``cli validate``.  The v1 fract-sin RNG mode
(``rng_mode="v1_fractsin"``, reference parity) is forward-only and
golden-only, as in raytpu: every backend renders it through the plain
version, on any device.  This package never imports jax.
"""

from raytpu_torch.config import RenderConfig
from raytpu_torch.camera import (
    Camera,
    make_camera,
    reference_camera_v1,
    reference_camera_v2,
)
from raytpu_torch.scene import (
    Scene,
    make_scene,
    test_world,
    random_world,
    config1_world,
    config2_world,
    final_world,
    v1_world,
)
from raytpu_torch.render import render, render_grad
from raytpu_torch.bvh import build_bvh

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Camera",
    "make_camera",
    "reference_camera_v1",
    "reference_camera_v2",
    "Scene",
    "make_scene",
    "test_world",
    "random_world",
    "config1_world",
    "config2_world",
    "final_world",
    "v1_world",
    "render",
    "render_grad",
    "build_bvh",
]
