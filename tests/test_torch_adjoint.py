"""raytpu_torch.adjoint (the plain version of the VJP kernel K3) against
raytpu.adjoint.

Both packages get the same scene and camera (built by raytpu, carried
across with ``raytpu_torch.convert``) and the same image cotangent, made
from a numpy seed: ``ct = 2 (img - target) / img.size`` for a uniform
target, the MSE loss's.  The port's VJP is ``torch.autograd.grad`` through
``render_golden_adjoint``; raytpu's is ``jax.vjp`` of its own.

Tolerances:
- the forward image: |d| <= 3e-4 on at least 99% of pixels, the
  cross-context budget of tests/test_torch_golden.py;
- gradients, per leaf: max|a - b| / max(max|b|, floor) <= 5e-3, with the
  floor 1e-8 for scene leaves and 1e-6 for camera leaves (the metric of
  tests/test_gradkernel.py).  XLA's CPU exp/log/sin/cos/rsqrt round
  differently from torch's by about an ulp, and XLA may contract the
  ground sphere's discriminant into a multiply-add; the hit distance t
  then moves by up to ~6e-5, and d t / d center carries it into the
  geometry cotangents.  Measured on the CPU (worst leaf of each case):
  sequential pinhole 3.4e-4 (radius), sequential defocus 1.8e-4 (u),
  parallel pinhole 5.0e-4 (radius), parallel defocus 3.3e-3 (v, the lens
  basis), v1 scatter 1.5e-4
  (lens_radius), vis_w 2.4e-4 (u).  Images: at most 6.9e-5 apart.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import raytpu
from raytpu import adjoint as jadj
from raytpu.config import RenderConfig
from raytpu_torch import adjoint as tadj, convert, golden, rng
from raytpu_torch.camera import Camera
from raytpu_torch.scene import Scene

GRAD_BUDGET = 5e-3
SCENE_LEAVES = ("center", "radius", "albedo", "mat_param")


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def three_spheres():
    """Ground, diffuse hero and a fuzzy metal (tests/test_gradkernel.py's
    silhouette scene)."""
    return raytpu.make_scene([
        ((0.0, -100.5, -1.0), 100.0, 0, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 0.0, -1.0), 0.5, 0, (0.7, 0.3, 0.3), 0.0),
        ((0.7, 0.1, -1.2), 0.4, 1, (0.8, 0.6, 0.2), 0.1),
    ])


def case(name):
    """-> (raytpu scene, raytpu camera, cfg, vis_w)."""
    look = ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0))
    cfg = RenderConfig(width=32, height=16, spp=2, depth=3)
    if name == "sequential_pinhole":
        return raytpu.test_world(), raytpu.make_camera(
            *look, vfov=20.0, aspect=cfg.aspect), cfg, 0.0
    if name == "sequential_defocus":
        return raytpu.test_world(), raytpu.make_camera(
            *look, vfov=20.0, aspect=cfg.aspect, aperture=0.3,
            focus_dist=12.0), cfg, 0.0
    if name == "parallel_pinhole":
        cfg = cfg.replace(rng_mode="parallel")
        return raytpu.test_world(), raytpu.make_camera(
            *look, vfov=20.0, aspect=cfg.aspect), cfg, 0.0
    if name == "parallel_defocus":
        cfg = cfg.replace(spp=3, depth=4, rng_mode="parallel")
        return raytpu.test_world(), raytpu.make_camera(
            *look, vfov=20.0, aspect=cfg.aspect, aperture=0.2,
            focus_dist=10.0), cfg, 0.0
    if name == "v1_scatter":
        cfg = cfg.replace(depth=4, gamma=2.0, scatter_mode="v1")
        return raytpu.v1_world(), raytpu.make_camera(
            *look, vfov=20.0, aspect=cfg.aspect, aperture=0.1,
            focus_dist=10.0), cfg, 0.0
    assert name == "vis_w"
    cfg = RenderConfig(width=64, height=32, spp=2, depth=3)
    return three_spheres(), raytpu.make_camera(
        (0.0, 0.3, 1.5), (0.0, 0.0, -1.0), vfov=45.0, aspect=cfg.aspect,
        aperture=0.25, focus_dist=2.5), cfg, 0.005


def cotangent(img, seed=0):
    """The MSE loss's image cotangent for a uniform target from ``seed``."""
    img = np.asarray(img)
    target = np.random.default_rng(seed).uniform(0, 1, img.shape)
    return (2.0 * (img - target.astype(np.float32)) / img.size).astype(
        np.float32)


def leaf_errors(got_scene, got_cam, want_scene, want_cam) -> dict:
    """Relative max error per leaf, max|a - b| / max(max|b|, floor)."""
    out = {}
    for grads, want, names, floor in (
            (got_scene, want_scene, SCENE_LEAVES, 1e-8),
            (got_cam, want_cam, Camera._fields, 1e-6)):
        a_all = convert.grads_to_numpy(grads)
        b_all = convert.grads_to_numpy(want)
        for k in names:
            a, b = a_all[k], b_all[k]
            assert a.shape == b.shape, k
            assert np.isfinite(a).all(), k
            out[k] = float(np.abs(a - b).max()
                           / max(float(np.abs(b).max()), floor))
    return out


def port_vjp(scene, cam, cfg, ct, vis_w):
    """autograd through the port's adjoint renderer on the CPU."""
    s = convert.scene_from_numpy(_np(scene), "cpu")
    c = convert.camera_from_numpy(_np(cam), "cpu")
    leaves = [t.clone().requires_grad_()
              for t in (s.center, s.radius, s.albedo, s.mat_param, *c)]
    img = tadj.render_golden_adjoint(
        Scene(leaves[0], leaves[1], s.mat_type, leaves[2], leaves[3]),
        Camera(*leaves[4:]), cfg, vis_w)
    g = torch.autograd.grad(img, leaves, torch.from_numpy(ct))
    return (img.detach().numpy(),
            Scene(g[0], g[1], None, g[2], g[3]), Camera(*g[4:]))


CASES = ["sequential_pinhole", "sequential_defocus", "parallel_pinhole",
         "parallel_defocus", "v1_scatter", "vis_w"]


@pytest.mark.parametrize("name", CASES)
def test_adjoint_matches_raytpu(name):
    scene, cam, cfg, vis_w = case(name)
    img_j, vjp = jax.vjp(
        lambda s, c: jadj.render_golden_adjoint(s, c, cfg, vis_w), scene, cam)
    ct = cotangent(img_j)
    ds, dc = vjp(jnp.asarray(ct))
    img, gs, gc = port_vjp(scene, cam, cfg, ct, vis_w)
    d = np.abs(img - np.asarray(img_j)).max(axis=-1)
    assert float((d > 3e-4).mean()) <= 0.01, float(d.max())
    errs = leaf_errors(gs, gc, ds, dc)
    assert max(errs.values()) <= GRAD_BUDGET, errs
    if not float(cam.lens_radius) > 0:  # a pinhole consumes no lens draw
        for k in ("u", "v", "lens_radius"):
            assert not getattr(gc, k).any(), k


def _trace_inputs(n=512, seed=5):
    """A test_world scene and camera rays with their RNG states."""
    scene = convert.scene_from_numpy(_np(raytpu.test_world()), "cpu")
    rs = np.random.default_rng(seed)
    o = np.float32([13.0, 2.0, 3.0]) + rs.normal(0, 0.3, (n, 3))
    d = -o + rs.normal(0, 1.0, (n, 3))
    ro = tuple(torch.tensor(o[:, i], dtype=torch.float32) for i in range(3))
    rd = tuple(torch.tensor(d[:, i], dtype=torch.float32) for i in range(3))
    sd = rng.pixel_seed(torch.arange(n) % 37, torch.arange(n) // 37)
    return scene, ro, rd, sd


@pytest.mark.parametrize("scatter_mode", ["v2", "v1"])
def test_trace_adjoint_matches_autograd_of_golden_trace(scatter_mode):
    """The hand-structured backward equals generic autograd through the
    port's own golden.trace (same package, same op order, same detach
    policy): the radiance and seeds bit-equal; the cotangents, summed in
    another order, to max|a - b| / max|b| <= 1e-4 per leaf (measured
    1.3e-5 at worst, the ray origin's)."""
    scene, ro, rd, sd = _trace_inputs()
    depth = 4

    def run(fn):
        leaves = [t.clone().requires_grad_()
                  for t in (scene.center, scene.radius, scene.albedo,
                            scene.mat_param, *ro, *rd)]
        s = Scene(leaves[0], leaves[1], scene.mat_type, leaves[2], leaves[3])
        (r, g, b), seed = fn(s, tuple(leaves[4:7]), tuple(leaves[7:10]))
        w = torch.linspace(0.5, 1.5, r.numel())
        loss = (w * r).sum() + (w * g * 0.7).sum() + (b * b).sum()
        return (r, g, b), seed, torch.autograd.grad(loss, leaves,
                                                    allow_unused=True)

    want_v, want_sd, want_g = run(lambda s, o, d: golden.trace(
        s, o, d, sd, depth, 1e-3, scatter_mode))
    got_v, got_sd, got_g = run(lambda s, o, d: tadj.trace_adjoint(
        s, o, d, sd, depth, 1e-3, 0.0, scatter_mode))
    for a, b in zip(got_v, want_v):
        assert torch.equal(a, b)
    assert torch.equal(got_sd, want_sd)
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        assert b is not None and bool(torch.isfinite(a).all()), i
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-8)
        assert err <= 1e-4, (i, err)


def test_vis_w_changes_only_the_geometry_gradients():
    """Silhouette terms add to center and radius only; the image and the
    other leaves' cotangents are those of vis_w = 0."""
    scene, cam, cfg, _ = case("vis_w")
    ct = cotangent(np.zeros((cfg.height, cfg.width, 3), np.float32) + 0.5)
    img0, gs0, gc0 = port_vjp(scene, cam, cfg, ct, 0.0)
    img1, gs1, gc1 = port_vjp(scene, cam, cfg, ct, 0.005)
    np.testing.assert_array_equal(img0, img1)
    assert not torch.equal(gs0.center, gs1.center)
    assert not torch.equal(gs0.radius, gs1.radius)
    assert torch.equal(gs0.albedo, gs1.albedo)
    assert torch.equal(gs0.mat_param, gs1.mat_param)
    for a, b in zip(gc0, gc1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("order", ["a_first", "b_first"])
def test_near_miss_tie_takes_the_lower_index(order):
    """The silhouette terms' near-miss sphere: argmax of the negative
    discriminant over forward-facing misses, the first maximum on ties (the
    rule K3's warp-wide sweep keeps: the largest discriminant, among equal
    ones the lowest index), never a NaN padding row.  Two spheres mirrored
    about the ray have bit-equal discriminants; both packages take the
    lower index of the two.  A third, farther sphere has a smaller
    discriminant; a ray pointing away from all of them has no near miss."""
    nan = float("nan")
    a, b = ((1.5, 0.0, 5.0), 1.0), ((-1.5, 0.0, 5.0), 1.0)
    pair = (a, b) if order == "a_first" else (b, a)
    rows = [((nan, nan, nan), nan), *pair, ((0.0, 2.5, 9.0), 1.0)]
    center = np.array([c for c, _ in rows], np.float32)
    radius = np.array([r for _, r in rows], np.float32)
    ro = [np.zeros(2, np.float32) for _ in range(3)]
    rd = [np.zeros(2, np.float32), np.zeros(2, np.float32),
          np.array([1.0, -1.0], np.float32)]
    j_idx, j_has = jadj._near_miss_sweep(
        raytpu.Scene(center=jnp.asarray(center), radius=jnp.asarray(radius),
                     mat_type=None, albedo=None, mat_param=None),
        tuple(map(jnp.asarray, ro)), tuple(map(jnp.asarray, rd)))
    t_idx, t_has = tadj._near_miss_sweep(
        Scene(center=torch.from_numpy(center),
              radius=torch.from_numpy(radius), mat_type=None, albedo=None,
              mat_param=None),
        tuple(map(torch.from_numpy, ro)), tuple(map(torch.from_numpy, rd)))
    assert np.asarray(j_has).tolist() == t_has.tolist() == [True, False]
    assert int(j_idx[0]) == int(t_idx[0]) == 1


def test_rejects_fractsin_rng():
    scene, cam, cfg, _ = case("sequential_pinhole")
    s = convert.scene_from_numpy(_np(scene), "cpu")
    c = convert.camera_from_numpy(_np(cam), "cpu")
    with pytest.raises(ValueError, match="v1_fractsin"):
        tadj.render_golden_adjoint(s, c, cfg.replace(rng_mode="v1_fractsin",
                                                     scatter_mode="v1"))
