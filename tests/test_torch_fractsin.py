"""The v1 fract-sin RNG mode (``rng_mode="v1_fractsin"``) of raytpu_torch
against raytpu, on the CPU.

raytpu's fract-sin chain (``fract(sin(dot(state, (12.9898, 78.233))) *
43758.5453)``) turns one rounding into a different draw, so its values
depend on the op order.  raytpu's source spells out plain f32 mul/add, and
raytpu produces that order only when each op runs on its own: under
``jax.jit`` XLA contracts mul+add pairs into FMAs, and its jitted draws
equal its op-by-op draws on only ~85% of states (measured on an
x86-64 CPU).  The port pins the source order (one torch op per f32
operation), so the tests hold it

- bit for bit against raytpu run under ``jax.disable_jit()``: ``fs_sin``
  on 4000 arguments in [0, 92] and ``fs_rand2d`` on 3000 states, value and
  state, and the chained draws the two mappings consume;
- the mappings' values (``acos``, ``pow``, ``sin``, ``cos`` lie outside
  the chain, and torch's and XLA's differ by an ulp or two) within 4 ulp
  of 1.0, 4.8e-7 absolute (measured: 2.4e-7);
- images against raytpu's golden under ``jax.disable_jit()``: |d| <= 3e-4
  on at least 99% of pixels, the rest (path flips, e.g. on the r=1000
  ground's f32 cancellation) within 1e-2 and counted in the message
  (measured at 16x8, spp 2, depth 4: max 2.2e-6 on v1_world, 6e-8 on the
  small-sphere scene, no pixel above 3e-4);
- against jitted raytpu and the scalar oracle tests/hlsl_ref.py only at
  raytpu's own calibrated bars (tests/test_v1_rng.py): >= 80% of draws
  exact against ``hlsl_ref.fs_rand2d`` (measured 92%); the flow against
  ``hlsl_ref.render_pixel_v1_fractsin`` with the port's draws injected, and
  the image against jitted raytpu, at (depth 1, 1e-3, 60%), (depth 1,
  1e-2, 90%), (depth 3, 1e-2, 65%) on the small-sphere scene and (depth
  6, 1e-2, 60%) on v1_world (measured: the oracle 100% in each; jitted
  raytpu 73%, 97%, 78%, 75%).

Batches, slabs and resumed renders of the port equal its one-shot render
bit for bit: the float2 state comes from absolute pixel coordinates and is
fast-forwarded by the samples already taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hlsl_ref
import raytpu
from raytpu import progressive as jprog, rng as jrng
from raytpu.config import RenderConfig as JConfig
import raytpu_torch as rt
from raytpu_torch import convert, golden, progressive, rng
from raytpu_torch.config import REFERENCE_V1_FAITHFUL, RenderConfig
from raytpu_torch.kernels import megakernel

MAP_ATOL = 4 * 2.0 ** -23   # 4 ulp of 1.0
BAND = 3e-4                 # the repo's cross-context image budget
OUTLIER = 1e-2              # raytpu's ground-scene calibration


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _cfgs(**kw):
    """(raytpu config, port config) of tests/test_v1_rng.py's frame."""
    base = dict(width=24, height=12, spp=2, depth=6, gamma=2.0,
                scatter_mode="v1", rng_mode="v1_fractsin")
    base.update(kw)
    return JConfig(**base), RenderConfig(**base)


def _small_spheres(cfg):
    """tests/test_v1_rng.py:76-84's scene and thin-lens camera (raytpu)."""
    scene = raytpu.make_scene([
        ((0.0, -20.5, -1.0), 20.0, 0, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 0.0, -1.0), 0.5, 0, (0.7, 0.3, 0.3), 0.0),
        ((1.0, 0.0, -1.0), 0.5, 1, (0.8, 0.8, 0.2), 0.1),
        ((-1.0, 0.0, -1.0), 0.5, 2, (1.0, 1.0, 1.0), 1.5),
    ])
    cam = raytpu.make_camera((0.0, 0.6, 2.0), (0.0, 0.0, -1.0), vfov=45.0,
                             aspect=cfg.aspect, aperture=0.1,
                             focus_dist=3.0)
    return scene, cam


def _world(name, cfg):
    if name == "v1_world":
        return raytpu.v1_world(), raytpu.reference_camera_v1()
    return _small_spheres(cfg)


def _port(scene, cam):
    return (convert.scene_from_numpy(_np(scene), "cpu"),
            convert.camera_from_numpy(_np(cam), "cpu"))


def _states(n, seed):
    st = np.random.RandomState(seed).uniform(0.01, 0.99, (n, 2))
    return st.astype(np.float32)


def test_fs_sin_bit_exact_vs_raytpu_op_by_op():
    x = np.random.RandomState(0).uniform(0.0, 92.0, 4000).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jrng.fs_sin(jnp.asarray(x)))
    np.testing.assert_array_equal(rng.fs_sin(torch.from_numpy(x)).numpy(),
                                  want)


def test_draws_bit_exact_vs_raytpu_op_by_op():
    """fs_rand2d's value and state, three chained draws (what
    fs_unit_sphere consumes; fs_unit_disk takes the first two) bit for bit;
    the mapped disk and sphere values within MAP_ATOL; by value: the
    mappings return no state."""
    st = _states(3000, 1)
    jx, jy = jnp.asarray(st[:, 0]), jnp.asarray(st[:, 1])
    tx, ty = torch.from_numpy(st[:, 0]), torch.from_numpy(st[:, 1])
    with jax.disable_jit():
        want, s = [], (jx, jy)
        for _ in range(3):
            v, s = jrng.fs_rand2d(*s)
            want.append((v, *s))
        disk = jrng.fs_unit_disk(jx, jy)
        sphere = jrng.fs_unit_sphere(jx, jy)
    s = (tx, ty)
    for w in want:
        v, s = rng.fs_rand2d(*s)
        for a, b in zip((v, *s), w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got_disk = rng.fs_unit_disk(tx, ty)
    got_sphere = rng.fs_unit_sphere(tx, ty)
    assert len(got_disk) == 2 and len(got_sphere) == 3
    for a, b in zip((*got_disk, *got_sphere), (*disk, *sphere)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=MAP_ATOL)


def test_draws_meet_the_scalar_oracle_bar():
    """tests/test_v1_rng.py:47-62's bar: >= 80% of single draws exact
    against the numpy transcription (whose sine takes FMAs)."""
    st = _states(256, 7)
    got, _ = rng.fs_rand2d(torch.from_numpy(st[:, 0]),
                           torch.from_numpy(st[:, 1]))
    match = sum(float(hlsl_ref.fs_rand2d((a, b))[0]) == float(g)
                for (a, b), g in zip(st, got))
    assert match >= 0.8 * len(st), match


def _rand2d_port(st):
    """Scalar adapter over the port's fs_rand2d, injected into the oracle
    so the flow check shares the draws (as tests/test_v1_rng.py does)."""
    v, (x, y) = rng.fs_rand2d(torch.tensor(np.float32(st[0])),
                              torch.tensor(np.float32(st[1])))
    return np.float32(v), (np.float32(x), np.float32(y))


BARS = [("small_spheres", dict(depth=1), 1e-3, 0.60),
        ("small_spheres", dict(depth=1), 1e-2, 0.90),
        ("small_spheres", dict(depth=3), 1e-2, 0.65),
        ("v1_world", dict(width=32, height=24, spp=1, depth=6), 1e-2, 0.60)]
BAR_IDS = ["small_d1_1e-3", "small_d1_1e-2", "small_d3_1e-2", "v1_world"]


@pytest.mark.parametrize("name, kw, tol, frac", BARS, ids=BAR_IDS)
def test_flow_matches_scalar_oracle(name, kw, tol, frac):
    """The port's image against hlsl_ref's PS_Main transcription with the
    port's draws injected, at tests/test_v1_rng.py:104-105 and :175's
    bars, on the same sampled pixels."""
    jcfg, cfg = _cfgs(**kw)
    scene, cam = _world(name, cfg)
    img = rt.render(*_port(scene, cam), cfg).numpy()
    cam_d = {k: np.asarray(getattr(cam, k)) for k in
             ("origin", "horizontal", "vertical", "lower_left", "u", "v")}
    cam_d["lens_radius"] = float(cam.lens_radius)
    pts = [(px, py) for py in range(0, cfg.height, 2)
           for px in range(0, cfg.width, 3)]
    ok = sum(np.allclose(img[py, px], hlsl_ref.render_pixel_v1_fractsin(
        _np(scene), cam_d, px, py, cfg.width, cfg.height, cfg.spp,
        cfg.depth, rand2d=_rand2d_port), atol=tol) for px, py in pts)
    assert ok >= frac * len(pts), (ok, len(pts))


@pytest.mark.parametrize("name, kw, tol, frac", BARS, ids=BAR_IDS)
def test_image_vs_jitted_raytpu_at_its_bars(name, kw, tol, frac):
    """Jitted raytpu draws other values (its FMAs), so the images agree
    only as far as raytpu's jitted golden agrees with its own oracle."""
    jcfg, cfg = _cfgs(**kw)
    scene, cam = _world(name, cfg)
    want = np.asarray(raytpu.render(scene, cam, jcfg, backend="golden"))
    got = rt.render(*_port(scene, cam), cfg).numpy()
    share = float((np.abs(got - want).max(axis=-1) <= tol).mean())
    assert share >= frac, share


@pytest.mark.parametrize("name", ["v1_world", "small_spheres"])
def test_image_vs_raytpu_op_by_op(name):
    """16x8, spp 2, depth 4 against raytpu's golden under
    jax.disable_jit() (~7 s on v1_world): the band on 99% of pixels, the
    counted rest within OUTLIER."""
    jcfg, cfg = _cfgs(width=16, height=8, spp=2, depth=4)
    scene, cam = _world(name, cfg)
    with jax.disable_jit():
        want = np.asarray(raytpu.render(scene, cam, jcfg, backend="golden"))
    got = rt.render(*_port(scene, cam), cfg)
    assert got.shape == (8, 16, 3) and bool(torch.isfinite(got).all())
    d = np.abs(got.numpy() - want).max(axis=-1)
    outliers = int((d > BAND).sum())
    assert outliers <= 0.01 * d.size and float(d.max()) <= OUTLIER, (
        outliers, float(d.max()))


def _v1_port():
    return (rt.v1_world(device="cpu"),
            rt.reference_camera_v1(device="cpu"))


def test_every_backend_renders_the_plain_version():
    """render() takes the mode to golden.render_golden under every backend
    name, "cuda" on CPU tensors included, before any kernel check; the
    REFERENCE_V1_FAITHFUL preset's settings at a small frame."""
    cfg = REFERENCE_V1_FAITHFUL.replace(width=24, height=18, depth=6)
    scene, cam = _v1_port()
    want = golden.render_golden(scene, cam, cfg)
    for backend in ("auto", "golden", "cuda", "wavefront"):
        assert torch.equal(rt.render(scene, cam, cfg, backend=backend), want)
    assert torch.equal(rt.render(scene, cam, cfg, device="cpu"), want)


def test_batches_slabs_and_checkpoints_equal_one_shot(tmp_path):
    """spp 4 as 2 + 2 progressive batches, as two row slabs, as 1 + 3
    accumulate_golden calls, and resumed from a checkpoint after 2 samples:
    each equals the one-shot render bit for bit; the checkpoint keeps the
    mode (and raytpu reads it so); the u32 seeds are never advanced."""
    cfg = RenderConfig(width=20, height=10, spp=4, depth=5, gamma=2.0,
                       scatter_mode="v1", rng_mode="v1_fractsin")
    scene, cam = _v1_port()
    one = rt.render(scene, cam, cfg)
    st = progressive.init_state(cfg, device="cpu")
    for _ in range(2):
        st = progressive.accumulate(scene, cam, cfg, st, 2)
    assert torch.equal(progressive.image(st, cfg), one)
    top = golden.render_golden(scene, cam, cfg, row0=0, rows=6)
    rest = golden.render_golden(scene, cam, cfg, row0=6, rows=6)
    assert torch.equal(torch.cat([top, rest[:4]]), one)
    assert not bool(rest[4:].any())           # rows past the frame are 0
    acc, seed = golden.accumulate_golden(
        scene, cam, cfg, torch.zeros(10, 20, 3), st.seed, 0, 1)
    acc, seed2 = golden.accumulate_golden(scene, cam, cfg, acc, seed, 1, 3)
    assert torch.equal(acc, st.acc)
    assert torch.equal(seed2, progressive.init_state(cfg, device="cpu").seed)
    path = str(tmp_path / "ck.npz")
    gen = progressive.render_progressive(scene, cam, cfg, batch=2,
                                         checkpoint_path=path)
    next(gen)
    gen.close()
    state, saved = progressive.load_checkpoint(path, device="cpu")
    assert saved == cfg and state.samples == 2
    assert jprog.load_checkpoint(path)[1].rng_mode == "v1_fractsin"
    *_, (_, last) = progressive.render_progressive(
        scene, cam, cfg, batch=2, checkpoint_path=path, resume=True)
    assert torch.equal(last, one)


def test_trace_options_keep_working():
    """With the mode's fixed draws, trace's bvh, census and tape still
    work: a BVH render equals the brute one, the census counts every
    sample, and the tape logs a winner at every pixel's first step."""
    cfg = RenderConfig(width=16, height=8, spp=2, depth=4, gamma=2.0,
                       scatter_mode="v1", rng_mode="v1_fractsin")
    scene, cam = _v1_port()
    bvh = rt.build_bvh(scene, leaf_size=2)
    want = golden.render_golden(scene, cam, cfg)
    assert torch.equal(rt.render(scene, cam, cfg, bvh=bvh), want)
    counts = dict.fromkeys(golden.CENSUS, 0)
    golden.render_golden(scene, cam, cfg, census=counts)
    assert counts["samples"] == 16 * 8 * 2 and counts["bounce_steps"] > 0
    img, tape = golden.render_golden_tape(scene, cam, cfg, g_cap=8)
    assert torch.equal(img, want)
    assert bool((tape[0] != golden.TAPE_UNWRITTEN).all())


def test_refusals():
    """The v2 materials, gradients, the kernels' check and the wavefront's
    knobs refuse the mode with raytpu's ValueErrors."""
    cfg = RenderConfig(width=8, height=4, spp=1, depth=2, gamma=2.0,
                       scatter_mode="v1", rng_mode="v1_fractsin")
    scene, cam = _v1_port()
    with pytest.raises(ValueError, match="scatter_mode='v1'"):
        rt.render(scene, cam, cfg.replace(scatter_mode="v2"))
    with pytest.raises(ValueError, match="v1_fractsin"):
        rt.render_grad(scene, cam, cfg, torch.zeros(4, 8, 3))
    with pytest.raises(ValueError, match="golden-only"):
        megakernel.check_inputs(scene, cam, cfg)
    for knobs in (dict(refill=2), dict(spp_batch=2)):
        with pytest.raises(ValueError, match="wavefront-only"):
            rt.render(scene, cam, cfg, backend="wavefront", **knobs)
