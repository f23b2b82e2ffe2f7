"""The winner-index tape (K4) on the CPU: the plain taping forward
(golden.render_golden_tape), the plain replay (the adjoint with ``tape=``),
``tape_plan`` and the autograd path that tapes.

The contract is raytpu's (tests/test_tape.py): gradients from a taped
backward are BIT-EQUAL to the untaped ones on the same inputs, brute and
BVH, full and partial tapes, for every ``g_cap`` from 0 up; and the taping
forward's image is the untaped forward's.  In the port the image is bit-equal
too: the taping forward traces through the same code.  Sizes are those of
tests/test_tape.py (final_world(n=48), 64x32, 2 spp, depth 4); the image
cotangent comes from a numpy seed.  The CUDA kernels of the tape run on a
card only: tests/test_torch_cuda_kernel.py.
"""

import numpy as np
import pytest
import torch

import raytpu
import raytpu_torch as rt
from raytpu_torch import adjoint, bvh as tbvh, convert, golden
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import gradkernel as tgk, megakernel as tmk
from raytpu_torch.scene import Scene

CFG = RenderConfig(width=64, height=32, spp=2, depth=4, rng_mode="parallel")
SCENE_LEAVES = ("center", "radius", "albedo", "mat_param")


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def world():
    scene = convert.scene_from_numpy(_np(raytpu.final_world(n=48)), "cpu")
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=CFG.aspect, device="cpu")
    return scene, tbvh.build_bvh(scene, leaf_size=16), cam


def _ct(seed=1):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1e-3, 1e-3, (CFG.height, CFG.width, 3)).astype(np.float32))


def _adjoint_grads(scene, cam, bvh, tape):
    """The adjoint's VJP (K3's plain version), optionally replaying a tape:
    (image, center, radius, albedo, mat_param, *camera grads)."""
    leaves = [t.clone().requires_grad_()
              for t in (scene.center, scene.radius, scene.albedo,
                        scene.mat_param, *cam)]
    img = adjoint.render_golden_adjoint(
        Scene(leaves[0], leaves[1], scene.mat_type, leaves[2], leaves[3]),
        Camera(*leaves[4:]), CFG, bvh=bvh, tape=tape)
    return (img.detach(), *torch.autograd.grad(img, leaves, _ct()))


def _assert_bit_equal(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i


def test_taping_forward_gives_the_image_and_the_winners(world):
    """The plain taping forward: the untaped image bit for bit, brute and
    BVH; each pixel's log holds its live steps in order (a miss -1, every
    winner a valid row), the BVH log is the brute one through perm, and a
    shorter tape is the full one cut."""
    scene, bvh, cam = world
    full = CFG.spp * CFG.depth
    img_b, tape_b = golden.render_golden_tape(scene, cam, CFG, full)
    img_v, tape_v = golden.render_golden_tape(scene, cam, CFG, full, bvh)
    assert tape_b.dtype == torch.int16 and tuple(tape_b.shape) == (full,
                                                                   64 * 32)
    assert torch.equal(img_b, golden.render_golden(scene, cam, CFG))
    assert torch.equal(img_v, img_b)
    written = tape_b != golden.TAPE_UNWRITTEN
    assert torch.equal(written, tape_v != golden.TAPE_UNWRITTEN)
    # steps are logged front to back: no written slot after an unwritten one
    assert not bool((~written[:-1] & written[1:]).any())
    assert int(written[0].sum()) == 64 * 32  # every pixel's first step
    w = tape_v[written].long()
    assert int(w.min()) >= -1 and int(w.max()) < bvh.perm.shape[0]
    hits = w >= 0
    assert bool((bvh.perm[w[hits]] >= 0).all())  # never a dummy
    assert torch.equal(bvh.perm[w[hits]].long(), tape_b[written].long()[hits])
    assert torch.equal(tape_b[written].long()[~hits], w[~hits])
    _, part = golden.render_golden_tape(scene, cam, CFG, 3, bvh)
    assert torch.equal(part, tape_v[:3])


@pytest.mark.parametrize("g_cap", ["full", 0, 1, 2, CFG.depth + 3])
@pytest.mark.parametrize("sweep", ["brute", "bvh"])
def test_taped_adjoint_bit_equal_to_untaped(world, sweep, g_cap):
    """The plain replay: the first g_cap steps of each pixel take their
    winner from the tape, the rest sweep; image and gradients bit-equal."""
    scene, bvh, cam = world
    bvh = bvh if sweep == "bvh" else None
    g = CFG.spp * CFG.depth if g_cap == "full" else g_cap
    _, tape = golden.render_golden_tape(scene, cam, CFG, g, bvh)
    _assert_bit_equal(_adjoint_grads(scene, cam, bvh, tape),
                      _adjoint_grads(scene, cam, bvh, None))


def test_a_tape_decides_the_winners(world):
    """The replay reads the tape, not a sweep: a tape with one winner
    changed gives other gradients (so the bit-equality above is not the
    sweep answering twice)."""
    scene, bvh, cam = world
    _, tape = golden.render_golden_tape(scene, cam, CFG, CFG.depth, bvh)
    forged = tape.clone()
    row = tape[0].long()
    pix = int(torch.nonzero(row >= 0)[0])
    other = int(torch.nonzero(bvh.perm >= 0)[0])
    forged[0, pix] = other if int(row[pix]) != other else other + 1
    a = _adjoint_grads(scene, cam, bvh, tape)
    b = _adjoint_grads(scene, cam, bvh, forged)
    assert not all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))


def test_plan_gating(world, monkeypatch):
    """tests/test_tape.py:46-61's gate: parallel RNG, no silhouette terms,
    within the budget; plus the port's sizing (full = spp * depth steps of
    int16 a pixel) and its partial tape."""
    scene, bvh, _ = world
    plan = tgk.tape_plan(CFG, scene.count, bvh=bvh)
    assert plan == {"g_cap": 8, "bytes": 8 * 64 * 32 * 2, "partial": False}
    assert tgk.tape_plan(CFG, scene.count) == plan
    assert tgk.tape_plan(CFG, scene.count, bvh=bvh, vis_w=0.01) is None
    seq = CFG.replace(rng_mode="sequential")
    assert tgk.tape_plan(seq, scene.count, bvh=bvh) is None
    # too few spheres for the tape to pay (the sweep it saves is cheap)
    assert tgk.tape_plan(CFG, tgk.TAPE_MIN_SPHERES - 1) is None
    assert tgk.tape_plan(CFG, tgk.TAPE_MIN_SPHERES) == plan
    monkeypatch.setattr(tgk, "TAPE_BUDGET", 1)
    assert tgk.tape_plan(CFG, scene.count, bvh=bvh) is None
    # a budget of 3 steps a pixel: a partial tape (3/8 >= the floor)
    monkeypatch.setattr(tgk, "TAPE_BUDGET", 3 * 64 * 32 * 2 + 5)
    assert tgk.tape_plan(CFG, scene.count, bvh=bvh) == {
        "g_cap": 3, "bytes": 3 * 64 * 32 * 2, "partial": True}
    # below PARTIAL_MIN_COVERAGE of the worst case: no tape
    big = CFG.replace(spp=40)
    assert tgk.tape_plan(big, scene.count, bvh=bvh) is None
    # int32 past 32766 kernel-side rows: twice the bytes
    monkeypatch.setattr(tgk, "TAPE_BUDGET", 4 * 2**30)
    wide = tgk.tape_plan(CFG, 40000)
    assert wide["bytes"] == 2 * plan["bytes"]
    assert golden.tape_dtype(40000) == torch.int32


@pytest.mark.parametrize("sweep", ["brute", "bvh"])
def test_autograd_path_tapes_and_gives_untaped_gradients(world, monkeypatch,
                                                         sweep):
    """render_grad on CPU tensors in parallel RNG: the forward is the plain
    taping forward (tape_plan applies), the backward replays the tape, and
    the result is bit-equal to the untaped run (TAPE_BUDGET 0), full and
    partial."""
    scene, bvh, cam = world
    bvh = bvh if sweep == "bvh" else None
    target = np.random.default_rng(3).uniform(
        0, 1, (CFG.height, CFG.width, 3)).astype(np.float32)
    calls = []
    real = tgk.render_tape_fwd

    def spy(*a, **k):
        calls.append(a[3])
        return real(*a, **k)

    monkeypatch.setattr(tgk, "render_tape_fwd", spy)
    taped = rt.render_grad(scene, cam, CFG, target, bvh=bvh)
    monkeypatch.setattr(tgk, "TAPE_BUDGET", 3 * 64 * 32 * 2)
    partial = rt.render_grad(scene, cam, CFG, target, bvh=bvh)
    monkeypatch.setattr(tgk, "TAPE_BUDGET", 0)
    plain = rt.render_grad(scene, cam, CFG, target, bvh=bvh)
    assert calls == [8, 3]
    for run in (taped, partial):
        assert torch.equal(run[0], plain[0]) and torch.equal(run[1], plain[1])
        _assert_bit_equal([getattr(run[2][0], k) for k in SCENE_LEAVES],
                          [getattr(plain[2][0], k) for k in SCENE_LEAVES])
        _assert_bit_equal(run[2][1], plain[2][1])


def test_wrappers_refuse_a_tape_from_another_frame(world):
    scene, bvh, cam = world
    img, tape = tgk.render_tape_fwd(scene, cam, CFG, 8, bvh)
    ct = _ct()
    out = tgk.render_vjp(scene, cam, CFG, ct, img=img, bvh=bvh, tape=tape)
    assert torch.equal(out[0], img)
    other = CFG.replace(width=32)
    with pytest.raises(ValueError, match="tape"):  # another frame size
        tgk.render_vjp(scene, cam, other, ct[:, :32], img=img[:, :32],
                       bvh=bvh, tape=tape)
    with pytest.raises(ValueError, match="tape"):  # int32 for int16 rows
        tgk.render_vjp(scene, cam, CFG, ct, img=img, bvh=bvh,
                       tape=tape.int())
    with pytest.raises(ValueError, match="steps a pixel"):
        tgk.render_vjp(scene, cam, CFG, ct, img=img, bvh=bvh, tape=tape[:3])
    with pytest.raises(ValueError, match="parallel RNG"):
        tgk.render_vjp(scene, cam, CFG, ct, bvh=bvh, tape=tape)
    with pytest.raises(ValueError, match="parallel RNG"):
        tgk.render_vjp(scene, cam, CFG.replace(rng_mode="sequential"), ct,
                       img=img, bvh=bvh, tape=tape)
    with pytest.raises(ValueError, match="g_cap"):
        tgk.render_tape_fwd(scene, cam, CFG, 9, bvh)
    packed = tmk.pack_scene(tbvh.permute_scene(scene, bvh.perm))
    with pytest.raises(ValueError, match="CUDA"):
        tmk.launch(tmk.pack_camera(cam), packed, CFG, bvh, tape=tape)
    with pytest.raises(ValueError, match="CUDA"):
        tgk.launch(tmk.pack_camera(cam), packed, CFG, ct, img=img, bvh=bvh,
                   tape=tape)
