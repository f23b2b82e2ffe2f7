"""Inverse-rendering optimization with checkpoint / resume (counterpart of
``raytpu/optim.py``).

Parameters are a dict of tensors.  :class:`Adam` is written out in
``optax.adam``'s op order, in f32 (``torch.optim.Adam`` rounds in another
order, so it is not used):

    mu = (1 - b1) * g + b1 * mu;   nu = (1 - b2) * g*g + b2 * nu
    count += 1;   mu_hat = mu / (1 - b1**count);   nu_hat = nu / (1 - b2**count)
    update = -lr * (mu_hat / (sqrt(nu_hat) + eps))

A checkpoint is one npz in raytpu's layout: ``step``, ``n_params``, the
param leaves ``p{i}`` and the optimizer-state leaves ``s{i}`` (``count`` as
a 0-dim int32, then the ``mu`` leaves, then the ``nu`` leaves), leaves in
sorted key order as ``jax.tree.leaves`` orders a dict.  So a checkpoint
written by ``raytpu.optim`` for ``optax.adam`` loads here, and the reverse.
A resumed run continues bit-identically to an uninterrupted one.
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple

import numpy as np
import torch


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32, steps taken
    mu: dict             # first moments, like params
    nu: dict             # second moments, like params


class Adam:
    """Adam in optax's op order with ``optax.adam``'s default b1, b2 and
    eps; ``init`` and ``update`` as optax's."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float = 0.05):
        self.lr = lr

    def init(self, params: dict) -> AdamState:
        return AdamState(count=torch.zeros((), dtype=torch.int32),
                         mu={k: torch.zeros_like(v) for k, v in params.items()},
                         nu={k: torch.zeros_like(v) for k, v in params.items()})

    def update(self, grads: dict, state: AdamState):
        """-> (updates, state'), the updates to add to the params."""
        count = state.count + 1
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            b1, b2, one_m_b1, one_m_b2, c, neg_lr, eps = (
                torch.tensor(x, dtype=torch.float32, device=g.device)
                for x in (self.b1, self.b2, 1 - self.b1, 1 - self.b2,
                          float(count), -self.lr, self.eps))
            mu[k] = one_m_b1 * g + b1 * state.mu[k]
            nu[k] = one_m_b2 * (g * g) + b2 * state.nu[k]
            mu_hat = mu[k] / (1 - torch.pow(b1, c))
            nu_hat = nu[k] / (1 - torch.pow(b2, c))
            updates[k] = neg_lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
        return updates, AdamState(count=count, mu=mu, nu=nu)


def _leaves(d: dict) -> list:
    return [d[k] for k in sorted(d)]


def save_opt_checkpoint(path: str, params: dict, opt_state: AdamState,
                        step: int) -> None:
    """Write (params, Adam state, step) to one npz in raytpu's layout;
    written to a temporary file, then renamed."""
    p_leaves = _leaves(params)
    s_leaves = ([opt_state.count] + _leaves(opt_state.mu)
                + _leaves(opt_state.nu))
    payload = {"step": np.asarray(step, np.int64),
               "n_params": np.asarray(len(p_leaves), np.int64)}
    for i, leaf in enumerate(p_leaves):
        payload[f"p{i}"] = leaf.detach().cpu().numpy()
    for i, leaf in enumerate(s_leaves):
        payload[f"s{i}"] = leaf.detach().cpu().numpy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_opt_checkpoint(path: str, params_template: dict):
    """-> (params, Adam state, step), bit-exact as saved, on the template's
    devices.  ``params_template`` gives the keys, shapes and dtypes; a
    leaf that does not match raises, since positional loading would
    mis-assign it."""
    keys = sorted(params_template)
    with np.load(path) as z:
        n_p = int(z["n_params"])
        step = int(z["step"])
        if n_p != len(keys):
            raise ValueError(
                f"checkpoint {path!r} holds {n_p} param leaves but the "
                f"template has {len(keys)}: wrong template")
        n_saved = sum(1 for k in z.files if re.fullmatch(r"s\d+", k))
        if n_saved != 1 + 2 * len(keys):
            raise ValueError(
                f"checkpoint {path!r} holds {n_saved} optimizer-state "
                f"leaves but Adam over {len(keys)} params has "
                f"{1 + 2 * len(keys)}: wrong optimizer")

        def leaf(name, like):
            a = z[name]
            want = like.detach().cpu().numpy()
            if a.shape != want.shape or a.dtype != want.dtype:
                raise ValueError(
                    f"checkpoint {path!r} leaf {name}: saved "
                    f"{a.dtype}{a.shape} vs expected {want.dtype}"
                    f"{want.shape}")
            return torch.from_numpy(np.array(a)).to(like.device)

        params = {k: leaf(f"p{i}", params_template[k])
                  for i, k in enumerate(keys)}
        tmpl = Adam().init(params)
        count = leaf("s0", tmpl.count)
        mu = {k: leaf(f"s{1 + i}", tmpl.mu[k]) for i, k in enumerate(keys)}
        nu = {k: leaf(f"s{1 + len(keys) + i}", tmpl.nu[k])
              for i, k in enumerate(keys)}
    return params, AdamState(count=count, mu=mu, nu=nu), step


def inverse_render_problem(cfg, *, device, shift=(0.12, 0.0, 0.08),
                           vis_w: float = 0.005):
    """The config-3 inverse-rendering problem (``make_problem`` of
    examples/inverse_render.py): a ground and a hero sphere seen through a
    thin-lens camera from (0, 0.3, 1.5) (vfov 45, aperture 0.25, focus
    2.5); the target is the true scene's render, and the hero starts
    shifted by ``shift``.

    Returns (scene_true, scene0, cam, target, loss_fn): ``loss_fn(params)``
    is the MSE of :func:`raytpu_torch.render` against the target with the
    hero's centre set to ``params["center"]`` (3,), differentiable through
    autograd (on CUDA tensors: K1a forward, K3 backward) with silhouette
    gradients of weight ``vis_w``; pass it to :func:`optimize` with
    ``{"center": scene0.center[1]}``.
    """
    from raytpu_torch.camera import make_camera
    from raytpu_torch.render import render
    from raytpu_torch.scene import make_scene

    scene_true = make_scene([
        ((0.0, -100.5, -1.0), 100.0, 0, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 0.0, -1.0), 0.5, 0, (0.7, 0.3, 0.3), 0.0),
    ], device)
    cam = make_camera((0.0, 0.3, 1.5), (0.0, 0.0, -1.0), vfov=45.0,
                      aspect=cfg.aspect, aperture=0.25, focus_dist=2.5,
                      device=device)
    target = render(scene_true, cam, cfg)
    center0 = scene_true.center.clone()
    center0[1] += torch.tensor(shift, dtype=torch.float32, device=device)
    scene0 = scene_true._replace(center=center0)

    def loss_fn(params):
        center = torch.cat([scene0.center[:1], params["center"][None],
                            scene0.center[2:]])
        img = render(scene0._replace(center=center), cam, cfg, vis_w=vis_w)
        return torch.mean((img - target) ** 2)

    return scene_true, scene0, cam, target, loss_fn


def optimize(loss_fn, params: dict, steps: int, lr: float = 0.05,
             checkpoint_path: str | None = None,
             checkpoint_every: int = 0, resume: bool = False,
             callback=None):
    """Adam-optimize ``params`` (a dict of tensors) against the scalar
    ``loss_fn(params)``, differentiated by autograd.

    Returns (params, losses).  With ``checkpoint_path`` and
    ``checkpoint_every`` it saves params, moments and step every so many
    steps; ``resume=True`` continues from the file (the remaining steps
    run, and the trajectory matches an uninterrupted run bit for bit).
    ``callback(step, loss)`` is called after each step if given.
    """
    optimizer = Adam(lr)
    start = 0
    params = {k: v.detach() for k, v in params.items()}
    opt_state = optimizer.init(params)
    if resume and checkpoint_path:
        params, opt_state, start = load_opt_checkpoint(checkpoint_path,
                                                       params)
    losses = []
    for i in range(start, steps):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss = loss_fn(live)
            grads = torch.autograd.grad(loss, list(live.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(live.items(), grads)}
        updates, opt_state = optimizer.update(grads, opt_state)
        params = {k: params[k] + updates[k] for k in params}
        losses.append(float(loss.detach()))
        if callback is not None:
            callback(i, losses[-1])
        if (checkpoint_path and checkpoint_every
                and (i + 1) % checkpoint_every == 0):
            save_opt_checkpoint(checkpoint_path, params, opt_state, i + 1)
    return params, losses
