"""The gradient route: how the port differentiates a render, decided here
only.

:func:`forward` runs the taping forward K4 where
:func:`raytpu_torch.kernels.gradkernel.tape_plan` applies (parallel RNG,
``vis_w == 0``, the tape within its budget), else the plain forward;
:func:`backward` runs K3 given the forward's image in parallel RNG (K3 then
skips its PASS 1) and the tape (replayed instead of swept).
``shard.TrainStep`` calls that pair inside its spans.  :class:`Render` is
the one ``torch.autograd.Function`` over it, raytpu's ``custom_vjp``s
around ``_render_pallas`` / ``_render_pallas_bvh``
(raytpu/kernels/megakernel.py:1634-1739) and the wavefront
(raytpu/wavefront.py:682-730); :func:`render_fwd` is the differentiable
render behind ``render``, ``render_grad`` and ``optim``.  The taping
forward traces through the same device function as K1a / K1c / K1d, so
the image under grad is the image without it, bit for bit.  CPU tensors
take the plain version of every piece; ``plain=True`` takes them on any
device (the train step's ``backend="golden"``).  Nothing under
``raytpu_torch/kernels`` imports this module.
"""

from __future__ import annotations

import torch

from raytpu_torch import golden
from raytpu_torch.bvh import BVH
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import gradkernel, megakernel
from raytpu_torch.scene import Scene


def forward(scene: Scene, cam: Camera, cfg: RenderConfig,
            bvh: BVH | None = None, vis_w: float = 0.0, row0: int = 0,
            rows: int | None = None, plain: bool = False):
    """-> ``(img, tape, plan)``: the taping forward, its tape and the plan
    where :func:`gradkernel.tape_plan` applies at the slab's height, else
    the plain forward's image and None, None."""
    plan = gradkernel.tape_plan(cfg, scene.count, bvh, vis_w, rows)
    if plan is None:
        fwd = golden.render_golden if plain else megakernel.forward
        return fwd(scene, cam, cfg, bvh, row0=row0, rows=rows), None, None
    taping = (golden.render_golden_tape if plain
              else gradkernel.render_tape_fwd)
    img, tape = taping(scene, cam, cfg, plan["g_cap"], bvh, row0=row0,
                       rows=rows)
    return img, tape, plan


def backward(scene: Scene, cam: Camera, cfg: RenderConfig, ct, img,
             tape=None, plan=None, vis_w: float = 0.0,
             bvh: BVH | None = None, row0: int = 0, rows: int | None = None,
             plain: bool = False, reduce=None):
    """-> ``(d_scene, d_cam)`` for the image cotangent ``ct``, given what
    :func:`forward` returned on the same inputs.  ``reduce`` sums the
    cotangents across a sharded step's processes
    (:func:`gradkernel.render_vjp`)."""
    if plain:
        _, ds, dc = gradkernel.render_vjp_plain(
            scene, cam, cfg, ct, vis_w, bvh, tape, row0, rows, reduce)
    else:
        _, ds, dc = gradkernel.render_vjp(
            scene, cam, cfg, ct,
            img=img if cfg.rng_mode == "parallel" else None, vis_w=vis_w,
            bvh=bvh, tape=tape,
            tape_partial=plan is not None and plan["partial"], row0=row0,
            rows=rows, reduce=reduce)
    return ds, dc


class Render(torch.autograd.Function):
    """apply(cfg, vis_w, bvh, (row0, rows), render, mat_type, center,
    radius, albedo, mat_param, *camera) -> image, with :func:`backward` as
    its backward.  ``render`` None runs :func:`forward`; else it is a
    whole-frame ``render(scene, cam)`` that never tapes (the wavefront's),
    whose image K3 takes as given.  Only the scene's continuous leaves and
    the camera get gradients; ``vis_w > 0`` adds silhouette terms to the
    backward only."""

    @staticmethod
    def forward(ctx, cfg, vis_w, bvh, slab_rows, render, mat_type, center,
                radius, albedo, mat_param, *cam_leaves):
        scene = Scene(center, radius, mat_type, albedo, mat_param)
        cam = Camera(*cam_leaves)
        if render is None:
            img, ctx.tape, ctx.plan = forward(scene, cam, cfg, bvh, vis_w,
                                              *slab_rows)
        else:
            img, ctx.tape, ctx.plan = render(scene, cam), None, None
        ctx.cfg, ctx.vis_w, ctx.bvh = cfg, vis_w, bvh
        ctx.slab_rows = slab_rows
        ctx.save_for_backward(mat_type, center, radius, albedo, mat_param,
                              img, *cam_leaves)
        return img

    @staticmethod
    def backward(ctx, ct):
        mat_type, center, radius, albedo, mat_param, img, *cam_leaves = \
            ctx.saved_tensors
        ds, dc = backward(
            Scene(center, radius, mat_type, albedo, mat_param),
            Camera(*cam_leaves), ctx.cfg, ct, img, ctx.tape, ctx.plan,
            ctx.vis_w, ctx.bvh, *ctx.slab_rows)
        return (None,) * 6 + (ds.center, ds.radius, ds.albedo, ds.mat_param,
                              *dc)


def needs_grad(scene: Scene, cam: Camera) -> bool:
    """Whether autograd is on and a continuous leaf of the scene or camera
    requires grad."""
    leaves = (scene.center, scene.radius, scene.albedo, scene.mat_param,
              *cam)
    return torch.is_grad_enabled() and any(t.requires_grad for t in leaves)


def differentiable(scene: Scene, cam: Camera, cfg: RenderConfig,
                   vis_w: float = 0.0, bvh: BVH | None = None,
                   row0: int = 0, rows: int | None = None,
                   render=None) -> torch.Tensor:
    """The image through :class:`Render`, on inputs the caller checked."""
    return Render.apply(cfg, float(vis_w), bvh, (row0, rows), render,
                        scene.mat_type, scene.center, scene.radius,
                        scene.albedo, scene.mat_param, *cam)


def render_fwd(scene: Scene, cam: Camera, cfg: RenderConfig,
               vis_w: float = 0.0, bvh: BVH | None = None, row0: int = 0,
               rows: int | None = None) -> torch.Tensor:
    """:func:`raytpu_torch.kernels.megakernel.forward`'s image (the frame,
    or the slab of ``rows`` from ``row0``), with a backward when
    :func:`needs_grad`: K3 on CUDA tensors, the adjoint on CPU tensors
    (``vis_w > 0`` adds silhouette gradients)."""
    if not needs_grad(scene, cam):
        return megakernel.forward(scene, cam, cfg, bvh, row0, rows)
    megakernel.check_scene_bvh(scene, cam, cfg, bvh)
    megakernel.slab(cfg, row0, rows)
    return differentiable(scene, cam, cfg, vis_w, bvh, row0, rows)
