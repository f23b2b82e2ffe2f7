"""Sharding over ``torch.distributed`` (counterpart of ``raytpu/shard.py``).

A process group takes the place of raytpu's device mesh, one process per
device, as ``torchrun`` launches them.  The frame is cut into row slabs of
:func:`slab_rows` rows, process ``r`` owning rows ``[r * slab, (r + 1) *
slab)`` (the last slab may run past the frame; its rows past the frame cost
nothing).  The scene and camera are replicated: every process builds them
from the same seed.

- :func:`render_sharded` renders each process's slab (the slab mode K1b of
  the forward kernel, or its plain version) and gathers the slabs, so every
  process holds the whole image.  The RNG keys come from absolute pixel
  coordinates, so the image is bit-identical for every world size.
- :func:`make_train_step` is raytpu's ``make_train_step_pallas``: each
  process renders its slab (the taping forward K4 where the tape plan
  applies at the slab's height), back-propagates its pixels' MSE cotangent
  through K3's slab mode and the loss and gradients are all-reduced (K3's
  f64 sums before their cast to f32), then one SGD step updates the
  continuous leaves.  On CPU tensors every piece is its plain version, which also
  stands for raytpu's golden ``make_train_step``.
- :func:`raytpu_torch.progressive.accumulate` with ``group=`` runs K2 on
  each slab through :func:`run_slabs`.
- :func:`render_wavefront_sharded` runs one wavefront a slab (K5 / K6), its
  slabs ``ceil(H / (32 * world)) * 32`` rows as raytpu's, and gathers them:
  bit-identical to the one-process wavefront for every world size.

``group=None`` means the default process group when ``torch.distributed``
is initialized, else a world of one process.  Collectives run whenever
``torch.distributed`` is initialized, a group of one process included;
without it nothing is gathered or reduced.
:func:`init_distributed` starts the default group: NCCL for a CUDA device,
gloo for the CPU, never one in place of the other.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from raytpu_torch import adjoint, autodiff, golden, profiling
from raytpu_torch import bvh as tbvh
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import megakernel
from raytpu_torch.render import BACKENDS, backend_for, check_backend
from raytpu_torch.scene import Scene


def init_distributed(*, device, init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None):
    """Start the default process group for a process that drives
    ``device`` and return it: the NCCL backend for a CUDA device (which
    becomes the current one), gloo for the CPU.  ``init_method`` (default
    ``env://``, which ``torchrun`` sets up), ``world_size`` and ``rank`` go
    to ``torch.distributed.init_process_group``; nothing is detected from a
    cluster.  A group already started with another backend is refused."""
    device = torch.device(device)
    if device.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(device)
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"torch.distributed runs {dist.get_backend()}, "
                               f"a {device.type} device needs {backend}")
        return dist.group.WORLD
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    return dist.group.WORLD


def world(group=None) -> tuple[int, int]:
    """(rank, world size) of this process in ``group`` (see the module
    docstring for ``None``)."""
    if group is None and not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def slab_rows(cfg: RenderConfig, world_size: int) -> int:
    """Rows of each process's slab: ``ceil(H / world)`` (raytpu also
    aligns them to its 8-row tiles; the port needs no alignment)."""
    return -(-cfg.height // world_size)


def slab_of(t: torch.Tensor, row0: int, rows: int) -> torch.Tensor:
    """Rows ``[row0, row0 + rows)`` of a frame-sized tensor, as a
    contiguous tensor (a view of ``t`` when the slab lies inside the
    frame); rows past the frame are 0."""
    part = t[row0:row0 + rows]
    if part.shape[0] == rows:
        return part.contiguous()
    pad = torch.zeros((rows - part.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    return torch.cat([part, pad])


def gather_rows(x: torch.Tensor, height: int, group=None) -> torch.Tensor:
    """Every process's slab ``x`` (of :func:`slab_rows` rows), stitched in
    rank order and cut to the frame's ``height`` rows, on every process."""
    if not dist.is_initialized():
        return x[:height]
    parts = [torch.empty_like(x) for _ in range(world(group)[1])]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)[:height]


def run_slabs(cfg: RenderConfig, group, fn, *frames):
    """``fn(row0, rows, *slabs)`` on this process's slab of each
    frame-sized tensor in ``frames``; each tensor ``fn`` returns is a slab,
    gathered into the whole frame on every process."""
    rank, n = world(group)
    rows = slab_rows(cfg, n)
    row0 = rank * rows
    outs = fn(row0, rows, *(slab_of(t, row0, rows) for t in frames))
    return tuple(gather_rows(o, cfg.height, group) for o in outs)


def render_sharded(scene: Scene, cam: Camera, cfg: RenderConfig, *,
                   group=None, bvh=None, backend: str = "auto"
                   ) -> torch.Tensor:
    """Full-frame render with the rows sharded over ``group`` -> (H, W, 3)
    on every process, bit-identical to :func:`raytpu_torch.render` for any
    world size.  Each process renders its slab: ``"auto"`` / ``"cuda"``
    through the forward kernel's slab mode (K1b, over ``bvh`` K1c's or K1d's sweep)
    on CUDA tensors and its plain version on CPU tensors; ``"golden"``
    through the plain version on any device, as every backend does for
    ``rng_mode="v1_fractsin"``.  No autograd."""
    backend = backend_for(cfg, backend)
    check_backend(backend, scene)
    fwd = (golden.render_golden if backend == "golden"
           else megakernel.forward)
    with torch.no_grad():
        return run_slabs(cfg, group, lambda row0, rows: (fwd(
            scene, cam, cfg, bvh=bvh, row0=row0, rows=rows),))[0]


def render_wavefront_sharded(scene: Scene, cam: Camera, cfg: RenderConfig,
                             *, group=None, bvh=None, segments=None,
                             sort_every: int = 1, spp_batch: int = 1,
                             sort_chunk: int = 65536,
                             refill: int = 0) -> torch.Tensor:
    """Sorted-wavefront render with the rows sharded over ``group``
    (raytpu's ``render_wavefront_sharded``, raytpu/shard.py:166-206) ->
    (H, W, 3) on every process.  Each process runs its own wavefront over
    the slab of ``ceil(H / (32 * world)) * 32`` rows from absolute row
    ``rank * slab`` (sorts and segment kernels stay on its device) and the
    slabs are gathered.  Seeds and sort keys come from absolute pixel
    coordinates, so the image equals the one-process wavefront's bit for
    bit.  The options as in :func:`raytpu_torch.wavefront.render_wavefront`;
    no autograd."""
    from raytpu_torch import wavefront as wf
    megakernel.check_scene_bvh(scene, cam, cfg, bvh)
    segments = wf.check_options(cfg, segments, None, sort_every, spp_batch,
                                sort_chunk, refill)
    rank, n = world(group)
    rows = -(-cfg.height // (wf.BLOCK * n)) * wf.BLOCK
    with torch.no_grad():
        img = wf._render(scene, cam, cfg, bvh, segments, sort_every,
                         spp_batch, sort_chunk, refill, row0=rank * rows,
                         rows=rows)
    return gather_rows(img, cfg.height, group)


class TrainStep:
    """One SGD step of inverse rendering over a process group (built by
    :func:`make_train_step`): ``step(scene, cam, target) -> (scene', cam',
    loss)``.  ``last_image`` keeps this process's slab of the last step's
    image, rows ``[row0, row0 + rows)``, and ``last_grads`` its all-reduced
    ``(d_scene, d_cam)``."""

    def __init__(self, cfg: RenderConfig, group, lr: float, bvh, refit: bool,
                 backend: str):
        adjoint.check_cfg(cfg)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend: {backend!r} (choose from "
                             f"{BACKENDS})")
        self.cfg, self.group, self.lr, self.bvh = cfg, group, lr, bvh
        self.refit = bool(refit and bvh is not None)
        self.backend = backend
        rank, size = world(group)
        self.rows = slab_rows(cfg, size)
        self.row0 = rank * self.rows
        self.last_image = self.last_grads = None

    def _reduce(self, loss: torch.Tensor):
        """The all-reduce of a step: the cotangent sums (the kernel's f64,
        the plain version's f32) with the loss appended in their dtype, one
        collective; ``loss`` is updated in place."""
        def reduce(sums):
            with profiling.span("raytpu.reduce"):
                both = torch.cat([sums, loss.reshape(1).to(sums.dtype)])
                dist.all_reduce(both, group=self.group)
                sums.copy_(both[:-1])
                loss.copy_(both[-1])
        return reduce if dist.is_initialized() else None

    def __call__(self, scene: Scene, cam: Camera, target):
        with profiling.span("raytpu.train_step"), torch.no_grad():
            return self._step(scene, cam, target)

    def _step(self, scene: Scene, cam: Camera, target):
        cfg, row0, rows = self.cfg, self.row0, self.rows
        check_backend(self.backend, scene)
        plain = self.backend == "golden"
        bvh = self.bvh
        if self.refit:
            with profiling.span("raytpu.refit"):
                bvh = tbvh.refit(bvh, scene)
        with profiling.span("raytpu.forward"):
            img, tape, plan = autodiff.forward(scene, cam, cfg, bvh,
                                               row0=row0, rows=rows,
                                               plain=plain)
        with profiling.span("raytpu.loss"):
            target = torch.as_tensor(target, dtype=torch.float32,
                                     device=img.device)
            # rows past the frame carry no loss
            valid = (torch.arange(rows, device=img.device) + row0
                     < cfg.height)[:, None, None]
            diff = torch.where(valid, img - slab_of(target, row0, rows), 0.0)
            inv_m = 1.0 / (cfg.height * cfg.width * 3)
            loss = torch.sum(diff.to(torch.float64) ** 2) * inv_m
            ct = 2.0 * diff * inv_m
        with profiling.span("raytpu.vjp"):
            ds, dc = autodiff.backward(scene, cam, cfg, ct, img, tape, plan,
                                       bvh=bvh, row0=row0, rows=rows,
                                       plain=plain,
                                       reduce=self._reduce(loss))
        with profiling.span("raytpu.sgd"):
            lr = self.lr
            scene = scene._replace(
                center=scene.center - lr * ds.center,
                radius=scene.radius - lr * ds.radius,
                albedo=scene.albedo - lr * ds.albedo,
                mat_param=scene.mat_param - lr * ds.mat_param)
            cam = cam._replace(
                origin=cam.origin - lr * dc.origin,
                horizontal=cam.horizontal - lr * dc.horizontal,
                vertical=cam.vertical - lr * dc.vertical,
                lower_left=cam.lower_left - lr * dc.lower_left)
        self.last_image, self.last_grads = img, (ds, dc)
        return scene, cam, loss.to(torch.float32)


def make_train_step(cfg: RenderConfig, *, group=None, lr: float = 1e-2,
                    bvh=None, refit: bool = True,
                    backend: str = "auto") -> TrainStep:
    """A train step over ``group`` (raytpu's ``make_train_step_pallas``):
    ``step(scene, cam, target) -> (scene', cam', loss)``.

    Each process renders its slab through the gradient route
    (:mod:`raytpu_torch.autodiff`: taped where the plan applies at the
    slab's height), takes the MSE cotangent of its pixels (the loss is the
    mean over the whole frame) through K3's slab mode, all-reduces the
    cotangent sums (K3's in f64) and the loss, and applies SGD with rate
    ``lr`` to the scene's continuous leaves and the camera's origin,
    horizontal, vertical and lower-left corner (raytpu's update).
    ``refit`` (with ``bvh``) recomputes the BVH's boxes from the current
    scene every step, as raytpu does, since the step moves spheres (each
    interior box the union of its leaves', where raytpu voids it).
    ``backend``: ``"auto"`` / ``"cuda"`` the kernels on CUDA tensors and
    the plain versions on CPU tensors, ``"golden"`` the plain versions."""
    return TrainStep(cfg, group, lr, bvh, refit, backend)
