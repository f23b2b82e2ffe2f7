"""The benchmark's reference against the port's plain versions at a tiny
size on the CPU: its scenes equal the port's builders, its images equal
the port's golden renderer's bit for bit, and its loss and gradients
agree with the port's plain train step."""

import numpy as np
import pytest
import torch

import raytpu_torch as rt
from raytpu_torch import golden, shard
from rtbench import reference as R
from rtbench import scenes


def _spheres(sc):
    return R.Spheres(sc.center, sc.radius, sc.mat_type.long(), sc.albedo,
                     sc.mat_param)


def test_scenes_equal_the_ports_builders():
    for mine, port in [
            (scenes.random_world(3, 9), rt.random_world(3, device="cpu")),
            (scenes.final_world(0, 500), rt.final_world(0, 500,
                                                        device="cpu"))]:
        for a, b in zip(mine, port):
            np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("mode", ["sequential", "parallel"])
def test_image_equals_the_ports_golden(mode):
    sc = rt.random_world(0, device="cpu")
    cfg = rt.RenderConfig(width=24, height=12, spp=3, depth=6,
                          rng_mode=mode)
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=cfg.aspect, device="cpu")
    want = golden.render_golden(sc, cam, cfg).reshape(-1, 3)
    rc = R.camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), 20.0, cfg.aspect,
                  device="cpu")
    for a, b in zip(rc, (cam.origin, cam.horizontal, cam.vertical,
                         cam.lower_left)):
        assert torch.equal(a, b)
    flat = torch.arange(24 * 12)
    got, steps = R.pixels(_spheres(sc), rc, R.Settings(24, 12, 3, 6, mode),
                          flat % 24, flat // 24)
    assert torch.equal(got, want)
    assert steps > 24 * 12 * 3


def test_loss_and_gradients_agree_with_the_ports_train_step():
    sc = rt.final_world(0, n=60, device="cpu")
    cfg = rt.RenderConfig(width=24, height=12, spp=3, depth=6,
                          rng_mode="parallel")
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=cfg.aspect, device="cpu")
    target = torch.rand(12, 24, 3, generator=torch.Generator().manual_seed(1))
    step = shard.make_train_step(cfg, lr=1e-2,
                                 bvh=rt.build_bvh(sc, leaf_size=8))
    _, _, loss = step(sc, cam, target)
    ds, dc = step.last_grads
    rc = R.camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), 20.0, cfg.aspect,
                  device="cpu")
    lsum, g, img, _ = R.loss_and_grads(_spheres(sc), rc,
                                       R.Settings(24, 12, 3, 6, "parallel"),
                                       target)
    assert torch.equal(img, step.last_image)
    assert float(lsum) / (12 * 24 * 3) == pytest.approx(float(loss),
                                                        rel=1e-6)
    port = {"center": ds.center, "radius": ds.radius, "albedo": ds.albedo,
            "param": ds.mat_param, "origin": dc.origin,
            "horizontal": dc.horizontal, "vertical": dc.vertical,
            "lower_left": dc.lower_left}
    for k, v in port.items():
        err = (v.double() - g[k]).norm() / g[k].norm()
        assert err < 1e-5, k


def test_bfloat16_reference_differs():
    sc = rt.random_world(0, device="cpu")
    rc = R.camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), 20.0, 2.0,
                  device="cpu")
    st = R.Settings(16, 8, 2, 5)
    flat = torch.arange(16 * 8)
    f32, _ = R.pixels(_spheres(sc), rc, st, flat % 16, flat // 16)
    low, _ = R.pixels(_spheres(sc).to(torch.bfloat16),
                      R.Camera(*(x.to(torch.bfloat16) for x in rc)), st,
                      flat % 16, flat // 16)
    assert (f32 - low.float()).abs().mean() > 1e-2
