"""The port's render path on the CPU against raytpu's Pallas megakernel.

``raytpu_torch.render(backend="auto")`` on CPU tensors goes through the
kernel wrapper, which runs the plain PyTorch version there; it is held
against ``raytpu.kernels.megakernel.render_pallas(..., interpret=True)``,
the way tests/test_pallas.py runs the Pallas kernel on the CPU.  Tolerance:
|d| <= 3e-4 on at least 99% of pixels (the cross-context budget; see
tests/test_torch_golden.py for what moves pixels between XLA and torch).

The CUDA kernel itself runs only on a card: tests/test_torch_cuda_kernel.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import raytpu
from raytpu.config import RenderConfig
from raytpu.kernels import megakernel as jmk
import raytpu_torch as rt
from raytpu_torch import convert, golden
from raytpu_torch.render import render_grad
from raytpu_torch.kernels import megakernel as tmk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _inputs(name):
    if name == "test_world":
        cfg = RenderConfig(width=64, height=36, spp=2, depth=4)
        scene, look = raytpu.test_world(), ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0))
        kw = {"vfov": 20.0}
    elif name == "unaligned":
        cfg = RenderConfig(width=50, height=21, spp=2, depth=3)
        scene, look = raytpu.config1_world(), ((0.0, 0.2, 1.0),
                                               (0.0, 0.0, -1.0))
        kw = {"vfov": 60.0}
    elif name == "defocus":
        cfg = RenderConfig(width=64, height=24, spp=2, depth=3)
        scene, look = raytpu.config1_world(), ((0.0, 0.5, 2.0),
                                               (0.0, 0.0, -1.0))
        kw = {"vfov": 40.0, "aperture": 0.4, "focus_dist": 3.0}
    elif name == "many_spheres_parallel":
        cfg = RenderConfig(width=32, height=16, spp=2, depth=3,
                           rng_mode="parallel")
        scene, look = raytpu.random_world(seed=3, half_extent=4), (
            (13.0, 2.0, 3.0), (0.0, 0.0, 0.0))
        kw = {"vfov": 20.0}
    else:  # v1 materials on the v1 world through the thin-lens v1 camera
        cfg = RenderConfig(width=40, height=30, spp=1, depth=6, gamma=2.0,
                           scatter_mode="v1")
        scene, look = raytpu.v1_world(), ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0))
        kw = {"vfov": 20.0, "aperture": 0.1, "focus_dist": 10.0}
    cam = raytpu.make_camera(*look, aspect=cfg.aspect, **kw)
    return scene, cam, cfg


@pytest.mark.parametrize("name", ["test_world", "unaligned", "defocus",
                                  "many_spheres_parallel", "v1"])
def test_render_auto_matches_pallas_interpret(name):
    scene, cam, cfg = _inputs(name)
    want = np.asarray(jmk.render_pallas(scene, cam, cfg, interpret=True))
    s = convert.scene_from_numpy(_np(scene), "cpu")
    c = convert.camera_from_numpy(_np(cam), "cpu")
    before = sum(tmk.variants.values())
    got = rt.render(s, c, cfg, backend="auto")
    # CPU tensors never reach the kernel
    assert sum(tmk.variants.values()) == before
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    d = np.abs(got.numpy() - want).max(axis=-1)
    assert float((d > 3e-4).mean()) <= 0.01, float(d.max())
    assert torch.equal(got, rt.render(s, c, cfg, backend="golden"))


def _small():
    cfg = RenderConfig(width=16, height=8, spp=1, depth=2)
    scene = rt.test_world(device="cpu")
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=cfg.aspect, device="cpu")
    return scene, cam, cfg


@pytest.mark.parametrize("bad", [
    ("center", lambda t: t.double()),
    ("center", lambda t: t[:, :2]),
    ("radius", lambda t: t[:-1]),
    ("mat_type", lambda t: t.float()),
    ("albedo", lambda t: t.reshape(-1)),
    ("mat_param", lambda t: t.half()),
], ids=["center_f64", "center_n2", "radius_short", "mat_type_f32",
        "albedo_flat", "mat_param_f16"])
def test_wrapper_rejects_bad_scene(bad):
    scene, cam, cfg = _small()
    field, f = bad
    scene = scene._replace(**{field: f(getattr(scene, field))})
    with pytest.raises(ValueError, match=field):
        rt.render(scene, cam, cfg)


def test_wrapper_rejects_bad_camera_and_config():
    scene, cam, cfg = _small()
    with pytest.raises(ValueError, match="origin"):
        rt.render(scene, cam._replace(origin=cam.origin.double()), cfg)
    with pytest.raises(ValueError, match="lens_radius"):
        rt.render(scene, cam._replace(lens_radius=cam.lens_radius[None]), cfg)
    with pytest.raises(ValueError, match="frame"):
        rt.render(scene, cam, cfg.replace(width=1))
    with pytest.raises(ValueError, match="scatter_mode"):
        rt.render(scene, cam, cfg.replace(scatter_mode="v3"))
    # the v1 fract-sin mode is golden-only, as in raytpu: render() takes
    # it through the plain version under every backend, the kernel
    # wrapper's check still refuses it
    fs = cfg.replace(rng_mode="v1_fractsin", scatter_mode="v1")
    before = sum(tmk.variants.values())
    assert torch.equal(rt.render(scene, cam, fs),
                       golden.render_golden(scene, cam, fs))
    assert sum(tmk.variants.values()) == before
    with pytest.raises(ValueError, match="golden-only"):
        tmk.check_inputs(scene, cam, fs)


def test_wrapper_rejects_requires_grad():
    """render() on leaves that require grad returns a differentiable image
    (the wrapper's autograd Function); launch() itself still refuses packed
    operands that carry autograd history, since it has no backward."""
    scene, cam, cfg = _small()
    center = scene.center.clone().requires_grad_()
    origin = cam.origin.clone().requires_grad_()
    img = rt.render(scene._replace(center=center),
                    cam._replace(origin=origin), cfg)
    assert img.requires_grad
    assert torch.equal(img.detach(), rt.render(scene, cam, cfg))
    g_center, g_origin = torch.autograd.grad(img.sum(), (center, origin))
    assert bool(torch.isfinite(g_center).all()) and g_center.abs().sum() > 0
    assert bool(torch.isfinite(g_origin).all()) and g_origin.abs().sum() > 0
    with pytest.raises(ValueError, match="requires grad"):
        tmk.launch(tmk.pack_camera(cam._replace(origin=origin)),
                   tmk.pack_scene(scene), cfg)


def test_kernel_launch_needs_cuda_tensors():
    scene, cam, cfg = _small()
    cp, sp = tmk.pack_camera(cam), tmk.pack_scene(scene)
    assert cp.shape == (tmk.CAM_PACK,) and cp.is_contiguous()
    assert sp.shape == (tmk.SCENE_ROWS, 4) and sp.is_contiguous()
    np.testing.assert_array_equal(sp[4].numpy(), [0, 0, 1, 2])
    with pytest.raises(ValueError, match="CUDA"):
        tmk.launch(cp, sp, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        rt.render(scene, cam, cfg, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        rt.render(scene, cam, cfg, backend="pallas")


# an H100's opt-in shared memory a block (the device attribute
# cudaDevAttrMaxSharedMemoryPerBlockOptin)
H100_SMEM_OPTIN = 232448


@pytest.mark.parametrize("n,leaf,sweep,want", [
    (500, 64, None, (8, 128, 10_384)),       # config 4: all of it
    (120, 16, None, (8, 128, 4_240)),
    (4000, 64, None, (63, 1008, 81_664)),    # 63 leaves of 64: all of it
    # raytpu's rule (63 leaves) past the limit: 52 leaves staged, 11 read
    # from the scene pack
    (16000, 256, None, (52, 1008, 229_968)),
    # 2000 leaves forced flat: the boxes (500 KB) read from bvh.flat
    (8000, 4, "flat", (2000, 0, 160_016)),
])
def test_flat_stage_bytes(n, leaf, sweep, want):
    """The flat sweep's shared memory (csrc stage_flat) within a block's
    opt-in limit: two 16-byte rows a box of each of the 8 octant copies if
    they fit, the outliers' rows, then leaf_size rows and one unused row a
    leaf for as many leaves as fit.  warp_census counts the card's
    kernels only, the walk's too."""
    from raytpu_torch import bvh as tbvh
    scene = rt.final_world(n=n, device="cpu")
    bvh = tbvh.build_bvh(scene, leaf_size=leaf)
    if sweep is not None:
        bvh = tbvh.with_sweep(bvh, sweep)
    assert tbvh.sweep_of(bvh) == "flat" and bvh.n_outliers == 1
    st = tmk.flat_stage(bvh, H100_SMEM_OPTIN)
    assert (st["leaves"], st["boxes"], st["bytes"]) == want
    assert st["outliers"] == 1 and st["bytes"] <= H100_SMEM_OPTIN
    assert st["bytes"] == 16 * (st["leaves"] * (leaf + 1) + st["outliers"]
                                + st["boxes"])
    cfg = rt.RenderConfig(width=8, height=4, spp=1, depth=2)
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=cfg.aspect, device="cpu")
    sp = tmk.pack_scene(tbvh.permute_scene(scene, bvh.perm))
    with pytest.raises(ValueError, match="CUDA"):
        tmk.warp_census(tmk.pack_camera(cam), sp, cfg, bvh)
    with pytest.raises(ValueError, match="CUDA"):
        tmk.warp_census(tmk.pack_camera(cam), sp, cfg,
                        tbvh.with_sweep(bvh, "walk"))


def test_render_grad_not_ported():
    """render_grad is ported: an MSE loss, the image and finite gradients
    of every continuous leaf (mat_type's is None)."""
    scene, cam, cfg = _small()
    target = torch.full((cfg.height, cfg.width, 3), 0.5)
    loss, img, (sg, cg) = render_grad(scene, cam, cfg, target)
    assert torch.equal(img, rt.render(scene, cam, cfg))
    assert float(loss) == pytest.approx(float(((img - target) ** 2).mean()))
    assert sg.mat_type is None
    for name in ("center", "radius", "albedo", "mat_param"):
        g, x = getattr(sg, name), getattr(scene, name)
        assert g.shape == x.shape and bool(torch.isfinite(g).all()), name
    for g, x in zip(cg, cam):
        assert g.shape == x.shape and bool(torch.isfinite(g).all())
    assert sg.albedo.abs().sum() > 0 and cg.origin.abs().sum() > 0


def test_render_device_argument_moves_inputs():
    scene, cam, cfg = _small()
    a = rt.render(scene, cam, cfg, device="cpu")
    b = golden.render_golden(scene, cam, cfg)
    assert torch.equal(a, b)


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import raytpu_torch, raytpu_torch.cli, raytpu_torch.convert, "
        "raytpu_torch.io, raytpu_torch.profiling, raytpu_torch.adjoint, "
        "raytpu_torch.optim, raytpu_torch.kernels.megakernel, "
        "raytpu_torch.kernels.gradkernel, raytpu_torch.bvh, "
        "raytpu_torch.native\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'raytpu'))\n"
        "print(bad, 'jax' in before, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    bad, before, after = out.rsplit(" ", 2)
    assert bad == "[]"
    assert after.strip() == before  # jax stays out unless preloaded


def test_sources_never_import_jax_or_raytpu():
    pkg = os.path.join(ROOT, "raytpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert "import jax" not in text, f
                assert "from raytpu " not in text and "from raytpu." not in \
                    text, f
                assert "import raytpu\n" not in text, f
