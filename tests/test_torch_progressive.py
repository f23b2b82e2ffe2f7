"""Progressive rendering (raytpu_torch.progressive, the plain version of K2)
on the CPU against raytpu.progressive.

Inputs: raytpu's ``test_world()`` carried across with
``raytpu_torch.convert`` (and ``final_world(n=48)``, leaf 16, for the BVH
case), 40x24, 6 spp, depth 3, ``chunk_pixels=128``: tests/test_progressive.py's
frame.  Tolerances:
- batching: the port's batches (2, 3, 1) equal its one 6-sample batch, acc
  and seed bit for bit, and its image is the port's ``render()``'s bit for
  bit (the same torch operations);
- against raytpu: ``acc / samples`` within 3e-4 on at least 99% of pixels
  (the cross-context image budget of tests/test_torch_megakernel.py) and
  ``seed`` equal on at least 99.9% (a path flip between XLA's and torch's
  rounding changes the number of draws);
- checkpoints: a raytpu checkpoint resumes in the port to the port's
  one-shot image within the same budget (its first samples are raytpu's),
  and a port checkpoint loads in raytpu with the same config and equal
  arrays.  The files have the same keys and types.
"""

import numpy as np
import pytest
import torch

import raytpu
from raytpu import progressive as jprog
from raytpu.config import RenderConfig as JConfig
import raytpu_torch as rt
from raytpu_torch import bvh as tbvh, convert, progressive
from raytpu_torch.config import RenderConfig

CFG = RenderConfig(width=40, height=24, spp=6, depth=3, chunk_pixels=128)
JCFG = JConfig(width=40, height=24, spp=6, depth=3, chunk_pixels=128)
LOOK = ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0))


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _world(cfg=CFG, final=False):
    """(raytpu scene, raytpu camera, port scene, port camera)."""
    scene = raytpu.final_world(n=48) if final else raytpu.test_world()
    cam = raytpu.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect)
    return (scene, cam, convert.scene_from_numpy(_np(scene), "cpu"),
            convert.camera_from_numpy(_np(cam), "cpu"))


def _agree(got, want, share=0.99):
    d = np.abs(np.asarray(got) - np.asarray(want)).max(axis=-1)
    assert float((d <= 3e-4).mean()) >= share, float(d.max())


@pytest.mark.parametrize("case", ["sequential", "parallel", "bvh"])
def test_batches_equal_one_shot(case):
    cfg = CFG.replace(rng_mode="parallel" if case == "parallel"
                      else "sequential")
    *_, scene, cam = _world(cfg, final=case == "bvh")
    bvh = tbvh.build_bvh(scene, leaf_size=16) if case == "bvh" else None
    init = progressive.init_state(cfg, device="cpu")
    one = progressive.accumulate(scene, cam, cfg, init, 6, bvh=bvh)
    state = init
    for k in (2, 3, 1):
        state = progressive.accumulate(scene, cam, cfg, state, k, bvh=bvh)
    assert state.samples == 6 and init.samples == 0
    assert torch.equal(state.acc, one.acc)
    assert torch.equal(state.seed, one.seed)
    assert state.seed.dtype == torch.int64
    assert torch.equal(progressive.image(state, cfg),
                       rt.render(scene, cam, cfg, bvh=bvh))
    golden = progressive.accumulate(scene, cam, cfg, init, 6,
                                    backend="golden", bvh=bvh)
    assert torch.equal(golden.acc, one.acc)


@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_accumulate_matches_raytpu(rng_mode):
    cfg, jcfg = CFG.replace(rng_mode=rng_mode), JCFG.replace(rng_mode=rng_mode)
    jscene, jcam, scene, cam = _world(cfg)
    jstate = jprog.init_state(jcfg)
    state = progressive.init_state(cfg, device="cpu")
    np.testing.assert_array_equal(state.seed.numpy(), np.asarray(jstate.seed))
    for k in (2, 4):
        jstate = jprog.accumulate(jscene, jcam, jcfg, jstate, k)
        state = progressive.accumulate(scene, cam, cfg, state, k)
    assert state.samples == int(jstate.samples) == 6
    _agree(state.acc.numpy() / 6, np.asarray(jstate.acc) / 6)
    same = state.seed.numpy() == np.asarray(jstate.seed).astype(np.int64)
    assert float(same.mean()) >= 0.999
    _agree(progressive.image(state, cfg).numpy(), jprog.image(jstate, jcfg))


def test_checkpoint_interop(tmp_path):
    """raytpu -> port: a raytpu checkpoint after 2 samples resumes in the
    port to the port's one-shot image.  port -> raytpu: a port checkpoint
    loads in raytpu with cfg2 == CFG and equal arrays, and resumes there."""
    jscene, jcam, scene, cam = _world()
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jstate = jprog.accumulate(jscene, jcam, JCFG, jprog.init_state(JCFG), 2)
    jprog.save_checkpoint(jpath, jstate, JCFG)
    state, cfg = progressive.load_checkpoint(jpath, device="cpu")
    assert cfg == CFG and state.samples == 2
    np.testing.assert_array_equal(state.acc.numpy(), np.asarray(jstate.acc))
    np.testing.assert_array_equal(state.seed.numpy(), np.asarray(jstate.seed))
    state = progressive.accumulate(scene, cam, cfg, state, 4)
    one = progressive.accumulate(
        scene, cam, CFG, progressive.init_state(CFG, device="cpu"), 6)
    _agree(progressive.image(state, CFG), progressive.image(one, CFG))

    part = progressive.accumulate(
        scene, cam, CFG, progressive.init_state(CFG, device="cpu"), 2)
    progressive.save_checkpoint(tpath, part, CFG)
    jloaded, cfg2 = jprog.load_checkpoint(tpath)
    assert cfg2 == JCFG and int(jloaded.samples) == 2
    np.testing.assert_array_equal(np.asarray(jloaded.acc), part.acc.numpy())
    np.testing.assert_array_equal(np.asarray(jloaded.seed), part.seed.numpy())
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
        np.testing.assert_array_equal(a["config"], b["config"])
        np.testing.assert_array_equal(a["config_f"], b["config_f"])
    jdone = jprog.accumulate(jscene, jcam, JCFG, jloaded, 4)
    _agree(jprog.image(jdone, JCFG), progressive.image(one, CFG))


def test_render_progressive_generator(tmp_path):
    """One (state, image) per batch, the last image the one-shot render;
    the checkpoint of the last batch resumes to nothing; a checkpoint of
    another config is refused."""
    *_, scene, cam = _world()
    path = str(tmp_path / "ck.npz")
    out = list(progressive.render_progressive(scene, cam, CFG, batch=4,
                                              checkpoint_path=path))
    assert [s.samples for s, _ in out] == [4, 6]
    assert torch.equal(out[-1][1], rt.render(scene, cam, CFG))
    assert list(progressive.render_progressive(
        scene, cam, CFG, batch=4, checkpoint_path=path, resume=True)) == []
    # an interrupted run resumes to the same image
    gen = progressive.render_progressive(scene, cam, CFG, batch=2,
                                         checkpoint_path=path)
    next(gen)
    gen.close()
    rest = list(progressive.render_progressive(
        scene, cam, CFG, batch=2, checkpoint_path=path, resume=True))
    assert [s.samples for s, _ in rest] == [4, 6]
    assert torch.equal(rest[-1][1], out[-1][1])
    with pytest.raises(ValueError, match="does not match"):
        next(progressive.render_progressive(
            scene, cam, CFG.replace(depth=4), checkpoint_path=path,
            resume=True))
    with pytest.raises(ValueError, match="batch"):
        next(progressive.render_progressive(scene, cam, CFG, batch=0))


def test_fractsin_refuses_with_its_roadmap_item():
    """The v1 fract-sin mode, once refused, accumulates: 2 + 2 samples
    under every backend name equal the one-shot 4-sample render bit for
    bit (the float2 state is fast-forwarded by the samples already
    taken), the carried u32 seeds stay each pixel's base hash, and
    render_progressive's last image is the same."""
    *_, scene, cam = _world()
    cfg = CFG.replace(spp=4, rng_mode="v1_fractsin", scatter_mode="v1",
                      gamma=2.0)
    one = rt.render(scene, cam, cfg)
    for backend in ("auto", "golden"):
        st = progressive.init_state(cfg, device="cpu")
        for _ in range(2):
            st = progressive.accumulate(scene, cam, cfg, st, 2,
                                        backend=backend)
        assert st.samples == 4
        assert torch.equal(progressive.image(st, cfg), one)
        assert torch.equal(st.seed,
                           progressive.init_state(cfg, device="cpu").seed)
    *_, (_, last) = progressive.render_progressive(scene, cam, cfg, batch=2)
    assert torch.equal(last, one)
