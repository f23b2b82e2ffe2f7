"""The CUDA megakernel against its plain PyTorch version, on the card.

These tests need a CUDA card and nvcc; without a card they skip (the
condition is a string, so pytest evaluates it at setup, not at import).
Run them on a card with

    python -m pytest --noconftest tests/test_torch_cuda_kernel.py -q

(``--noconftest``: tests/conftest.py configures jax, which the card's
environment need not have; these tests never import it.)

Tolerance: both sides run the same op order with every f32 operation
rounded on its own (the kernel is built with -fmad=false), so most pixels
are bit-equal; sin/cos/exp/log and rsqrt may round differently between the
kernel and torch's CUDA builds, and a 1-ulp change can flip a Schlick coin or
a near-tie closest hit.  So: |d| <= 3e-4 (the repo's cross-context image
budget) on all but 0.1% of pixels; depth 1 (no scatter) to 1e-6 everywhere.
"""

import pytest
import torch

import raytpu_torch as rt
from raytpu_torch import golden
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import megakernel

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")


def _cam(cfg, **kw):
    return rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                          aspect=cfg.aspect, device="cuda", **kw)


def _agree(got, want, share=1e-3):
    d = (got - want).abs().amax(dim=-1)
    assert float((d > 3e-4).float().mean()) <= share, float(d.max())


@needs_card
@pytest.mark.parametrize("cfg", [
    RenderConfig(width=128, height=64, spp=4, depth=12),
    RenderConfig(width=128, height=64, spp=4, depth=12, rng_mode="parallel"),
    RenderConfig(width=128, height=64, spp=4, depth=12, scatter_mode="v1"),
    RenderConfig(width=50, height=21, spp=3, depth=6),
], ids=["sequential", "parallel", "v1", "unaligned"])
def test_kernel_matches_plain(cfg):
    scene = rt.test_world(device="cuda")
    cam = _cam(cfg)
    megakernel.launches = 0
    got = rt.render(scene, cam, cfg, backend="auto")
    assert megakernel.launches == 1
    want = golden.render_golden(scene, cam, cfg)
    _agree(got, want)


@needs_card
def test_kernel_matches_plain_random_world_defocus():
    cfg = RenderConfig(width=96, height=54, spp=2, depth=8)
    scene = rt.random_world(seed=3, half_extent=4, device="cuda")
    cam = _cam(cfg, aperture=0.3, focus_dist=10.0)
    _agree(rt.render(scene, cam, cfg, backend="cuda"),
           golden.render_golden(scene, cam, cfg))


@needs_card
def test_depth1_exact():
    cfg = RenderConfig(width=160, height=90, spp=1, depth=1)
    scene = rt.random_world(device="cuda")
    cam = _cam(cfg, aperture=0.2, focus_dist=12.0)
    got = rt.render(scene, cam, cfg, backend="cuda")
    want = golden.render_golden(scene, cam, cfg)
    assert float((got - want).abs().max()) <= 1e-6


@needs_card
def test_kernel_deterministic_and_rejects_bad_packs():
    cfg = RenderConfig(width=64, height=32, spp=2, depth=4)
    scene = rt.test_world(device="cuda")
    cam = _cam(cfg)
    cp, sp = megakernel.pack_camera(cam), megakernel.pack_scene(scene)
    a = megakernel.launch(cp, sp, cfg)
    b = megakernel.launch(cp, sp, cfg)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        megakernel.launch(cp.double(), sp, cfg)
    with pytest.raises(ValueError):
        megakernel.launch(cp, sp.t().contiguous(), cfg)
    with pytest.raises(ValueError):
        megakernel.launch(cp, sp[:, ::2], cfg)
    with pytest.raises(ValueError):
        megakernel.launch(cp.cpu(), sp, cfg)
