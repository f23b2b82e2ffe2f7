"""raytpu_torch.golden (the plain PyTorch renderer) against raytpu.golden.

Both packages get identical inputs: the scene and camera are built by
raytpu and carried across with ``raytpu_torch.convert``.

Tolerances:
- ``hit_world``: winner indices, hit flags and front-face flags bit-exact;
  normals to rtol 1e-6, atol 1e-6; t to rtol 1e-6, atol 1e-4.  The t budget
  is the r=1000 ground sphere's: its discriminant ``half_b^2 - a*c`` is a
  catastrophic cancellation, and XLA's CPU fusion may contract it into a
  multiply-add where torch rounds twice.  Measured: 0.4% of the rays differ
  in t, all on the ground, by at most 6.1e-5.
- against the scalar float64 oracle tests/hlsl_ref.py: atol 5e-3 per pixel
  with one outlier allowed on test_world (an f32-vs-f64 Schlick branch), as
  tests/test_golden.py holds raytpu's golden.
- images: |d| <= 3e-4 on at least 99% of pixels.  XLA's CPU exp/log/sin/cos
  and rsqrt round differently from torch's by ~1 ulp; that moves most
  pixels by at most a few 1e-5, and now and then flips a Schlick coin or a
  near-tie bounce, which changes that pixel's path entirely.  Measured on
  the CPU (max |d|, share of pixels above 3e-4): test_world 5.3e-5, 0;
  unaligned 50x21 3.9e-7, 0; defocus 6.0e-7, 0; v1 scatter 2.2e-5, 0;
  v1_world 2.3e-5, 0; parallel 5.9e-5, 0; random_world(3, 4) 3.6e-4,
  0.08% (one pixel).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import hlsl_ref
import raytpu
from raytpu import golden as jg
from raytpu.config import RenderConfig
from raytpu_torch import convert, golden as tg, rng


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _rays(scene_np, n, seed):
    """Camera-like rays plus rays leaving sphere surfaces (bounce origins,
    where the t_min test decides), unnormalized directions."""
    rs = np.random.default_rng(seed)
    o = np.tile(np.float32([13.0, 2.0, 3.0]), (n, 1))
    o += rs.normal(0, 0.5, (n, 3)).astype(np.float32)
    d = (-o + rs.normal(0, 1.5, (n, 3))).astype(np.float32)
    k = rs.integers(0, len(scene_np["radius"]), n // 2)
    u = rs.normal(size=(n // 2, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o[n // 2:] = (scene_np["center"][k] + scene_np["radius"][k, None] * u)
    d[n // 2:] = rs.normal(size=(n // 2, 3)) * rs.uniform(0.5, 2, (n // 2, 1))
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("scene_fn", [raytpu.test_world,
                                      lambda: raytpu.random_world(
                                          seed=3, half_extent=4)],
                         ids=["test_world", "random_world"])
def test_hit_world_winners_bit_exact(scene_fn):
    js = scene_fn()
    sn = _np(js)
    ts = convert.scene_from_numpy(sn, "cpu")
    o, d = _rays(sn, 2048, 7)
    want = jg.hit_world(js, tuple(jnp.asarray(o[:, i]) for i in range(3)),
                        tuple(jnp.asarray(d[:, i]) for i in range(3)), 1e-3)
    got = tg.hit_world(ts, tuple(torch.from_numpy(o[:, i]) for i in range(3)),
                       tuple(torch.from_numpy(d[:, i]) for i in range(3)),
                       1e-3)
    hit = np.asarray(want[0])
    assert 0.2 < hit.mean() < 1.0  # both hits and misses are exercised
    np.testing.assert_array_equal(got[0].numpy(), hit)
    np.testing.assert_array_equal(got[2].numpy()[hit], np.asarray(want[2])[hit])
    np.testing.assert_array_equal(got[4].numpy()[hit], np.asarray(want[4])[hit])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-4)
    for a, b in zip(want[3], got[3]):
        np.testing.assert_allclose(b.numpy()[hit], np.asarray(a)[hit],
                                   rtol=1e-6, atol=1e-6)


def _cam(cfg, look_from=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0), **kw):
    kw.setdefault("vfov", 20.0)
    return raytpu.make_camera(look_from, look_at, aspect=cfg.aspect, **kw)


def _case(name):
    if name == "test_world":
        cfg = RenderConfig(width=64, height=36, spp=2, depth=4)
        return raytpu.test_world(), _cam(cfg), cfg
    if name == "unaligned":
        cfg = RenderConfig(width=50, height=21, spp=2, depth=3)
        return raytpu.config1_world(), _cam(cfg, (0.0, 0.2, 1.0),
                                            (0.0, 0.0, -1.0), vfov=60.0), cfg
    if name == "defocus":
        cfg = RenderConfig(width=64, height=24, spp=2, depth=3)
        return raytpu.config1_world(), _cam(
            cfg, (0.0, 0.5, 2.0), (0.0, 0.0, -1.0), vfov=40.0, aperture=0.4,
            focus_dist=3.0), cfg
    if name == "v1_scatter":
        cfg = RenderConfig(width=64, height=36, spp=2, depth=6,
                           scatter_mode="v1")
        return raytpu.test_world(), _cam(cfg), cfg
    if name == "v1_world":
        cfg = RenderConfig(width=48, height=36, spp=2, depth=6, gamma=2.0,
                           scatter_mode="v1")
        return raytpu.v1_world(), raytpu.reference_camera_v1(), cfg
    if name == "parallel":
        cfg = RenderConfig(width=64, height=36, spp=3, depth=4,
                           rng_mode="parallel")
        return raytpu.test_world(), _cam(cfg), cfg
    cfg = RenderConfig(width=48, height=27, spp=2, depth=5)
    return raytpu.random_world(seed=3, half_extent=4), _cam(cfg), cfg


def compare_to_raytpu(scene, cam, cfg, render):
    """(max |d|, share of pixels with |d| > 3e-4) of ``render`` against
    raytpu.golden.render_golden on the same inputs."""
    want = np.asarray(jg.render_golden(scene, cam, cfg))
    got = render(convert.scene_from_numpy(_np(scene), "cpu"),
                 convert.camera_from_numpy(_np(cam), "cpu"), cfg)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    d = np.abs(got.numpy() - want).max(axis=-1)
    return float(d.max()), float((d > 3e-4).mean())


CASES = ["test_world", "unaligned", "defocus", "v1_scatter", "v1_world",
         "parallel", "random_world"]


@pytest.mark.parametrize("name", CASES)
def test_render_golden_matches_raytpu(name):
    worst, share = compare_to_raytpu(*_case(name), tg.render_golden)
    assert share <= 0.01, (worst, share)


def test_chunking_does_not_change_pixels():
    scene, cam, cfg = _case("unaligned")
    s = convert.scene_from_numpy(_np(scene), "cpu")
    c = convert.camera_from_numpy(_np(cam), "cpu")
    a = tg.render_golden(s, c, cfg)
    b = tg.render_golden(s, c, cfg.replace(chunk_pixels=97))
    assert torch.equal(a, b)


def test_accumulate_in_batches_is_bit_exact():
    """Two 2-sample batches threading seed and sums == one 4-sample run."""
    scene, cam, cfg = _case("test_world")
    s = convert.scene_from_numpy(_np(scene), "cpu")
    c = convert.camera_from_numpy(_np(cam), "cpu")
    px = torch.arange(cfg.width).repeat(4)
    py = torch.arange(4).repeat_interleave(cfg.width) * 9
    for mode in ("sequential", "parallel"):
        cf = cfg.replace(rng_mode=mode)
        seed = rng.pixel_seed(px, py)
        once, sd1 = tg.accumulate_pixels(s, c, cf, px, py, seed, 4)
        half, sd = tg.accumulate_pixels(s, c, cf, px, py, seed, 2)
        two, sd2 = tg.accumulate_pixels(s, c, cf, px, py, sd, 2, init=half,
                                        s0=2)
        for a, b in zip(once, two):
            assert torch.equal(a, b)
        assert torch.equal(sd1, sd2)


def test_fractsin_mode_not_ported():
    """The v1 fract-sin mode, once refused, renders through golden: on
    test_world at 16x8 the image is raytpu's golden run op by op (under
    jax.disable_jit, the one op order raytpu reproduces; see
    tests/test_torch_fractsin.py) within the image budget, chunking
    changes no pixel, and the v2 materials are refused as raytpu refuses
    them."""
    scene, cam, cfg = _case("test_world")
    cfg = cfg.replace(width=16, height=8, scatter_mode="v1",
                      rng_mode="v1_fractsin")
    cam = _cam(cfg)
    with jax.disable_jit():
        want = np.asarray(jg.render_golden(scene, cam, cfg))
    s = convert.scene_from_numpy(_np(scene), "cpu")
    c = convert.camera_from_numpy(_np(cam), "cpu")
    got = tg.render_golden(s, c, cfg)
    d = np.abs(got.numpy() - want).max(axis=-1)
    assert float((d > 3e-4).mean()) <= 0.01, float(d.max())
    assert torch.equal(tg.render_golden(s, c, cfg.replace(chunk_pixels=37)),
                       got)
    with pytest.raises(ValueError, match="scatter_mode='v1'"):
        tg.render_golden(s, c, cfg.replace(scatter_mode="v2"))


def test_tangent_ray_gradient_is_finite():
    """A ray that grazes a sphere (disc == 0 exactly): the root's sqrt
    takes its gradient from the 1e-20-clamped branch, so d t / d center is
    finite and equals jax.grad through raytpu's golden, [1, 0, 0]."""
    sphere = [((0.0, 0.0, 0.0), 1.0, 0, (0.5, 0.5, 0.5), 0.0)]
    js = raytpu.make_scene(sphere)
    o, d = (-5.0, 1.0, 0.0), (1.0, 0.0, 0.0)

    def t_jax(center):
        ro = tuple(jnp.asarray([v], jnp.float32) for v in o)
        rd = tuple(jnp.asarray([v], jnp.float32) for v in d)
        return jg.hit_world(js._replace(center=center), ro, rd, 1e-3)[1][0]

    want = np.asarray(jax.grad(t_jax)(js.center))
    ts = convert.scene_from_numpy(_np(js), "cpu")
    center = ts.center.clone().requires_grad_()
    hit, t, _, _, _ = tg.hit_world(
        ts._replace(center=center),
        tuple(torch.tensor([v]) for v in o),
        tuple(torch.tensor([v]) for v in d), 1e-3)
    assert bool(hit[0]) and float(t[0].detach()) == 5.0
    (got,) = torch.autograd.grad(t[0], center)
    np.testing.assert_array_equal(want, [[1.0, 0.0, 0.0]])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,aperture", [("sequential", 0.0),
                                           ("parallel", 0.3)],
                         ids=["sequential_pinhole", "parallel_defocus"])
def test_render_golden_autograd_matches_jax_grad(mode, aperture):
    """torch autograd through render_golden against jax.grad through
    raytpu's render_golden, loss mean(img^2), on test_world at 32x16, 2 spp,
    depth 3.  Budget 5e-3 of max|b| per leaf (floor 1e-8 scene, 1e-6
    camera), tests/test_torch_adjoint.py's: the t of the ground sphere
    moves by up to ~6e-5 between XLA and torch (see hit_world above), and
    the geometry cotangents carry it.  Measured: 2.1e-3 (radius) in the
    parallel defocus case, 4.0e-4 (radius) in the sequential pinhole
    case."""
    cfg = RenderConfig(width=32, height=16, spp=2, depth=3, rng_mode=mode)
    scene = raytpu.test_world()
    cam = _cam(cfg, aperture=aperture, focus_dist=12.0)

    def loss_j(s, c):
        return jnp.mean(jg.render_golden(s, c, cfg) ** 2)

    gs_j, gc_j = jax.grad(loss_j, argnums=(0, 1), allow_int=True)(scene, cam)
    s = convert.scene_from_numpy(_np(scene), "cpu")
    c = convert.camera_from_numpy(_np(cam), "cpu")
    leaves = [t.clone().requires_grad_()
              for t in (s.center, s.radius, s.albedo, s.mat_param, *c)]
    img = tg.render_golden(
        s._replace(center=leaves[0], radius=leaves[1], albedo=leaves[2],
                   mat_param=leaves[3]), type(c)(*leaves[4:]), cfg)
    g = torch.autograd.grad(torch.mean(img ** 2), leaves)
    names = ["center", "radius", "albedo", "mat_param", *c._fields]
    want = [getattr(gs_j, k) for k in names[:4]] + list(gc_j)
    for k, a, b in zip(names, g, want):
        b = np.asarray(b)
        floor = 1e-8 if k in names[:4] else 1e-6
        err = np.abs(a.numpy() - b).max() / max(np.abs(b).max(), floor)
        assert np.isfinite(a.numpy()).all() and err <= 5e-3, (k, err)


@pytest.mark.parametrize("name,outliers", [("unaligned", 0),
                                           ("test_world", 1)])
def test_render_golden_matches_scalar_oracle(name, outliers):
    scene, cam, cfg = _case(name)
    img = tg.render_golden(convert.scene_from_numpy(_np(scene), "cpu"),
                           convert.camera_from_numpy(_np(cam), "cpu"),
                           cfg).numpy()
    sd = {k: np.asarray(v, np.float64) if k != "mat_type" else np.asarray(v)
          for k, v in _np(scene).items()}
    cd = {k: np.asarray(v, np.float64) for k, v in _np(cam).items()}
    cd["lens_radius"] = float(cd["lens_radius"])
    rs = np.random.default_rng(0)
    bad = 0
    for x, y in zip(rs.integers(0, cfg.width, 24),
                    rs.integers(0, cfg.height, 24)):
        want = hlsl_ref.render_pixel(sd, cd, int(x), int(y), cfg.width,
                                     cfg.height, cfg.spp, cfg.depth)
        bad += not np.allclose(img[int(y), int(x)], want, atol=5e-3)
    assert bad <= outliers
