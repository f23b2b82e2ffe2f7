"""raytpu_torch scenes, cameras and the numpy converters against raytpu.

Scene builders draw the same numpy RNG sequence, so their arrays must be
equal, dtypes included.  ``make_camera`` is f32 vector math whose norm
XLA may sum in another order, so cameras are compared with rtol 1e-6 and
atol 1e-6.  ``get_ray`` is fed one camera (carried across by
``raytpu_torch.convert``) and must agree to rtol 1e-6 (sin/cos of the lens
sample differ by ~1 ulp between XLA and torch on the CPU); its seeds are
integer state and must be bit-exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytpu
from raytpu import camera as jcam
import raytpu_torch as rt
from raytpu_torch import camera as tcam, convert

BUILDERS = [
    ("test_world", {}), ("v1_world", {}), ("config1_world", {}),
    ("config2_world", {}), ("random_world", {}),
    ("random_world", {"seed": 3, "half_extent": 4}),
    ("final_world", {}), ("final_world", {"seed": 2, "n": 137}),
]


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.mark.parametrize("name,kw", BUILDERS,
                         ids=[f"{n}{kw}" for n, kw in BUILDERS])
def test_builders_array_equal(name, kw):
    want = getattr(raytpu, name)(**kw)
    got = getattr(rt, name)(**kw, device="cpu")
    assert got._fields == want._fields
    assert got.count == want.count
    for a, b in zip(want, got):
        assert b.device.type == "cpu"
        assert b.numpy().dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_builders_need_a_device():
    with pytest.raises(TypeError):
        rt.test_world()
    with pytest.raises(TypeError):
        rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0))


CAMERAS = [
    dict(look_from=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0), vfov=20.0,
         aspect=2.0),
    dict(look_from=(0.0, 0.5, 2.0), look_at=(0.0, 0.0, -1.0), vfov=40.0,
         aspect=64 / 24, aperture=0.4, focus_dist=3.0),
    dict(look_from=(-2.0, 2.0, 1.0), look_at=(0.0, 0.0, -1.0),
         vup=(0.1, 1.0, 0.0), vfov=90.0, aspect=1.5, aperture=0.2),
]


@pytest.mark.parametrize("kw", CAMERAS, ids=["pinhole", "defocus", "vup"])
def test_make_camera_allclose(kw):
    want = _np(raytpu.make_camera(**kw))
    got = convert.camera_to_numpy(rt.make_camera(**kw, device="cpu"))
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_reference_cameras_allclose():
    pairs = [(raytpu.reference_camera_v2(), rt.reference_camera_v2(
                 device="cpu")),
             (raytpu.reference_camera_v2(aspect=4 / 3),
              rt.reference_camera_v2(aspect=4 / 3, device="cpu")),
             (raytpu.reference_camera_v1(), rt.reference_camera_v1(
                 device="cpu"))]
    for a, b in pairs:
        for x, y in zip(a, b):
            np.testing.assert_allclose(y.numpy(), np.asarray(x),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", CAMERAS, ids=["pinhole", "defocus", "vup"])
def test_get_ray_allclose(kw):
    jc = raytpu.make_camera(**kw)
    tc = convert.camera_from_numpy(_np(jc), "cpu")
    rs = np.random.default_rng(5)
    s = rs.random(512, dtype=np.float32)
    t = rs.random(512, dtype=np.float32)
    seed = rs.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32)
    (jo, jd, js) = jcam.get_ray(jc, jnp.asarray(s), jnp.asarray(t),
                                jnp.asarray(seed))
    (to, td, ts) = tcam.get_ray(tc, torch.from_numpy(s), torch.from_numpy(t),
                                torch.from_numpy(seed.astype(np.int64)))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                  np.asarray(js))
    for a, b in zip(jo + jd, to + td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   rtol=1e-6, atol=1e-6)
    if kw.get("aperture", 0.0) == 0.0:
        # a pinhole camera consumes no draw
        np.testing.assert_array_equal(np.asarray(js), seed)


def test_convert_round_trip_exact():
    scene = _np(raytpu.random_world(seed=3, half_extent=4))
    cam = _np(raytpu.reference_camera_v1())
    s = convert.scene_from_numpy(scene, "cpu")
    c = convert.camera_from_numpy(cam, "cpu")
    assert isinstance(s, rt.Scene) and isinstance(c, rt.Camera)
    assert s.mat_type.dtype == torch.int32
    for d, back in ((scene, convert.scene_to_numpy(s)),
                    (cam, convert.camera_to_numpy(c))):
        assert set(back) == set(d)
        for k in d:
            assert back[k].dtype == d[k].dtype
            np.testing.assert_array_equal(back[k], d[k])
    # a raytpu NamedTuple is taken as it is
    s2 = convert.scene_from_numpy(raytpu.test_world(), "cpu")
    np.testing.assert_array_equal(s2.center.numpy(),
                                  np.asarray(raytpu.test_world().center))
