"""The traffic generators and scenes repeat exactly for a seed."""

import numpy as np
import torch

from rtbench import fit, scenes, turntable


CAM = {"look_from": [13.0, 2.0, 3.0], "look_at": [0.0, 0.0, 0.0],
       "vfov": 20.0}


def test_turntable_repeats_for_a_seed():
    seed = 2**31 + 7
    a = [turntable.lap_start(seed, 72)] + [
        turntable.check_pixels(seed, k, 1024, 576, 64) for k in range(5)]
    b = [turntable.lap_start(seed, 72)] + [
        turntable.check_pixels(seed, k, 1024, 576, 64) for k in range(5)]
    assert a[0] == b[0]
    for (x1, y1), (x2, y2) in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(y1, y2)
    np.testing.assert_array_equal(turntable.check_frames(seed, 300, 48),
                                  turntable.check_frames(seed, 300, 48))


def test_turntable_lap():
    lap = turntable.poses(CAM, 72)
    assert len(lap) == 72
    np.testing.assert_allclose(lap[0][0], (13.0, 2.0, 3.0), atol=1e-12)
    r = [np.hypot(f[0], f[2]) for f, _ in lap]
    np.testing.assert_allclose(r, np.hypot(13.0, 3.0))
    assert all(f[1] == 2.0 for f, _ in lap)
    # every seed's window renders the same poses, in another order
    assert {turntable.lap_start(s, 72) for s in range(2000)} == set(range(72))


def test_check_sample_bounds():
    px, py = turntable.check_pixels(3, 9, 800, 400, 64)
    assert len(set(zip(px.tolist(), py.tolist()))) == 64
    assert px.max() < 800 and py.max() < 400
    f = turntable.check_frames(3, 500, 48)
    assert len(f) == 48 and f[-1] == 499 and len(set(f.tolist())) == 48
    np.testing.assert_array_equal(turntable.check_frames(3, 10, 48),
                                  np.arange(10))


def test_episode_start_is_one_set_for_every_seed():
    arrays = scenes.build({"builder": "final_world", "seed": 0, "n": 500})
    a = fit.start_arrays(arrays, 0.1442)
    b = fit.start_arrays(arrays, 0.1442)
    np.testing.assert_array_equal(a[0], b[0])
    d = a[0] - arrays[0]
    assert np.all(d[:, 1] == 0)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 0.1442, rtol=1e-5)
    # the directions are drawn from the harness's one shift seed
    rng = np.random.default_rng(fit.SHIFT_SEED)
    ang = rng.random(len(d)) * (2 * np.pi)
    np.testing.assert_allclose(d[:, 0], 0.1442 * np.cos(ang), atol=1e-6)
    # two run seeds: the same shifted spheres in another order
    s1 = scenes.on_device(a, 11, "cpu")
    s2 = scenes.on_device(a, 2**31 + 11, "cpu")
    assert not torch.equal(s1.center, s2.center)
    assert sorted(map(tuple, s1.center.tolist())) == sorted(
        map(tuple, s2.center.tolist()))


def test_scene_order_repeats_and_keeps_the_set():
    arrays = scenes.build({"builder": "final_world", "seed": 0, "n": 500})
    a = scenes.on_device(arrays, 123456789012, "cpu")
    b = scenes.on_device(arrays, 123456789012, "cpu")
    c = scenes.on_device(arrays, 5, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.center, c.center)
    key = lambda s: sorted(map(tuple, torch.cat(  # noqa: E731
        [s.center, s.radius[:, None]], 1).tolist()))
    assert key(a) == key(c)
