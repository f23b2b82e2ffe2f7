"""Progressive rendering with checkpoint / resume (counterpart of
``raytpu/progressive.py``).

The carried state is a linear accumulation buffer plus each pixel's RNG
stream state, so

- rendering in K sample batches is **bit-identical** to one big render;
- a render can be checkpointed to disk mid-flight and resumed, on the same
  host or another, with no repeated work;
- the display image can be inspected at any intermediate sample count.

Each batch is one launch of the carry-state kernel K2
(:func:`raytpu_torch.kernels.megakernel.accumulate`) on CUDA tensors and
its plain version on CPU tensors.  Checkpoints use raytpu's ``.npz``
layout exactly (``acc`` f32, ``seed`` uint32, ``samples``, ``config`` int64
x7, ``config_f`` f64), so a checkpoint written by either package resumes in
the other.  With ``group`` (a ``torch.distributed`` process group, see
:mod:`raytpu_torch.shard`) each process runs its row slab and every process
ends the batch holding the whole state; slabs and the RNG use absolute
pixel coordinates, so the state is the same for every world size and a
checkpoint migrates between them, a world of one included.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytpu_torch import golden, rng, shard
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import megakernel
from raytpu_torch.render import backend_for, check_backend
from raytpu_torch.scene import Scene

# checkpoint enum encodings, raytpu's order
_RNG_MODES = ("sequential", "parallel", "v1_fractsin")
_SCATTER_MODES = ("v2", "v1")


class ProgressiveState(NamedTuple):
    """Carried render state: linear colour sums and per-pixel RNG streams."""

    acc: torch.Tensor   # (H, W, 3) f32 linear (pre-gamma) sample sums
    seed: torch.Tensor  # (H, W) int64 holding u32 per-pixel stream states
    samples: int        # samples accumulated so far


def init_state(cfg: RenderConfig, *, device) -> ProgressiveState:
    """No samples yet: zero sums, each pixel's seed its base hash."""
    h, w = cfg.height, cfg.width
    py, px = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return ProgressiveState(
        acc=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
        seed=rng.pixel_seed(px, py), samples=0)


def accumulate(scene: Scene, cam: Camera, cfg: RenderConfig,
               state: ProgressiveState, spp: int, backend: str = "auto",
               bvh=None, group=None) -> ProgressiveState:
    """Add ``spp`` samples per pixel to the carried state.

    The first sample's index (the parallel RNG mode's stream offset) is
    ``state.samples``.  ``backend="golden"`` runs the plain version on any
    device; ``"auto"`` launches K2 on CUDA tensors and the plain version on
    CPU tensors; ``"cuda"`` needs CUDA tensors.  ``bvh`` sweeps the BVH,
    flat or by the walk (K2's walk variant past 64 leaves a copy).  ``group``: each process of the group adds the samples of
    its row slab (:func:`raytpu_torch.shard.slab_rows`) and the slabs are
    gathered, so every process returns the whole state, bit-identical to
    the unsharded one.  ``rng_mode="v1_fractsin"`` runs the plain version
    under every backend, as :func:`raytpu_torch.render` does."""
    backend = backend_for(cfg, backend)
    check_backend(backend, scene)
    if spp < 1:
        raise ValueError(f"a batch needs spp >= 1, got {spp}")
    fn = golden.accumulate_golden if backend == "golden" else \
        megakernel.accumulate
    s0 = int(state.samples)
    if group is None:
        acc, seed = fn(scene, cam, cfg, state.acc, state.seed, s0, spp, bvh)
    else:
        acc, seed = shard.run_slabs(
            cfg, group, lambda row0, rows, acc_s, seed_s: fn(
                scene, cam, cfg, acc_s, seed_s, s0, spp, bvh, row0, rows),
            state.acc, state.seed)
    return ProgressiveState(acc=acc, seed=seed, samples=s0 + spp)


def image(state: ProgressiveState, cfg: RenderConfig) -> torch.Tensor:
    """Display image (gamma-corrected mean) at the current sample count."""
    inv = rng.f32_like(state.acc, 1.0 / max(int(state.samples), 1))
    return golden._to_gamma(state.acc * inv, cfg.gamma)


# -- checkpoint / resume -----------------------------------------------------

def save_checkpoint(path: str, state: ProgressiveState,
                    cfg: RenderConfig) -> None:
    """Write the state and config to an ``.npz`` in raytpu's layout
    (``np.savez_compressed``: a path without ``.npz`` gains it)."""
    np.savez_compressed(
        path,
        acc=state.acc.detach().cpu().numpy().astype(np.float32),
        seed=state.seed.detach().cpu().numpy().astype(np.uint32),
        samples=np.asarray(np.int32(state.samples)),
        config=np.array([cfg.width, cfg.height, cfg.spp, cfg.depth,
                         cfg.chunk_pixels,
                         _RNG_MODES.index(cfg.rng_mode),
                         _SCATTER_MODES.index(cfg.scatter_mode)], np.int64),
        config_f=np.array([cfg.t_min, cfg.gamma], np.float64),
    )


def load_checkpoint(path: str, *,
                    device) -> tuple[ProgressiveState, RenderConfig]:
    """-> (state on ``device``, config) from a checkpoint of either package;
    older 5-int configs load with raytpu's defaults for the modes."""
    with np.load(path) as z:
        cvals = [int(v) for v in z["config"]]
        t_min, gamma = (float(v) for v in z["config_f"])
        acc, seed, samples = z["acc"], z["seed"], int(z["samples"])
    w, h, spp, depth, chunk = cvals[:5]
    cfg = RenderConfig(
        width=w, height=h, spp=spp, depth=depth, t_min=t_min, gamma=gamma,
        chunk_pixels=chunk,
        rng_mode=_RNG_MODES[cvals[5]] if len(cvals) > 5 else "sequential",
        scatter_mode=_SCATTER_MODES[cvals[6]] if len(cvals) > 6 else "v2")
    state = ProgressiveState(
        acc=torch.from_numpy(np.asarray(acc, np.float32)).to(device),
        seed=torch.from_numpy(np.asarray(seed, np.uint32).astype(
            np.int64)).to(device),
        samples=samples)
    return state, cfg


def render_progressive(scene: Scene, cam: Camera, cfg: RenderConfig,
                       batch: int = 8, checkpoint_path: str | None = None,
                       resume: bool = False, backend: str = "auto",
                       bvh=None, group=None):
    """Render ``cfg.spp`` samples in ``batch``-sized increments.

    Yields ``(state, image)`` after each batch; with ``checkpoint_path``
    checkpoints after every batch (process 0 of ``group`` only) and, with
    ``resume``, starts from that checkpoint, refusing one whose config
    differs from ``cfg`` in anything but ``spp``.  A checkpoint that already
    holds ``cfg.spp`` samples yields nothing.  ``backend``, ``bvh`` and
    ``group`` as in :func:`accumulate`."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    device = scene.center.device
    if resume and checkpoint_path:
        state, saved_cfg = load_checkpoint(checkpoint_path, device=device)
        if saved_cfg.replace(spp=cfg.spp) != cfg:
            raise ValueError(
                f"checkpoint config {saved_cfg} does not match render "
                f"config {cfg}; resuming would mix rendering semantics")
    else:
        state = init_state(cfg, device=device)
    writer = group is None or shard.world(group)[0] == 0
    while state.samples < cfg.spp:
        step = min(batch, cfg.spp - state.samples)
        state = accumulate(scene, cam, cfg, state, step, backend=backend,
                           bvh=bvh, group=group)
        if checkpoint_path and writer:
            save_checkpoint(checkpoint_path, state, cfg)
        yield state, image(state, cfg)
