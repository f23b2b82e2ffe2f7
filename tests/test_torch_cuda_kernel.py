"""The CUDA kernels against their plain PyTorch versions, on the card: the
forward megakernel K1a (its brute sweep over staged rows up to 4096
spheres, over the scene pack past that), K1e (raytpu's dense stage: K1a's
kernel under raytpu's name), its BVH variants K1c (the flat
sweep) and K1d (the skip-pointer walk) and census K1', the taping forward
K4, the fused VJP kernel K3 with its BVH, walk and tape-replay variants,
the carry-state kernel K2, the slab mode of every one of them (K1b) and the
wavefront's segment kernels K5 and K6.

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
K3's image runs K1a's device code and must equal K1a's bit for bit; its
cotangents are held to 1e-3 of each leaf's largest entry (chip_smoke.py
phase 2b states why).  K1c's image equals K1a's except on exact ties of t
between spheres (none here); the taping forward's image equals the
untaped one bit for bit, and K3's taped gradients equal its untaped ones
(the same f64 sums, atomics in whatever order: bit-equal after the f32 cast
at these sizes).  K2 batched equals K2 in one batch bit for bit, and its
image the forward kernel's (within 2e-7 where the gamma epilogue's
reciprocal rounds apart); slabs stitched give the full frame bit for bit
(image, state, tape), and K3's slab sums, added in f64, its full-frame sums
within 1e-6 of each leaf's largest entry.  The walk's image equals the
flat sweep's on the same BVH bit for bit (the same leaves in the same
order), and its census counts the flat sweep's leaves and steps; on the
refill (K1d, K2, K4 and their slabs) the walk equals its plain versions
bit for bit, and so does the brute sweep's (K1a, K1b, K1', K2, K4,
over staged rows and over the pack).  K3 over a flat BVH
sweeps the rows it stages in shared memory, and its warp-wide near-miss
sweep picks the sequential loop's sphere: staged in part or not at all,
its image and f32 cotangents are bit for bit the same where the refill's
lanes are.  K5 and K6 (on their persistent slot grid, with the
forward's closest hit under every policy) equal their plain versions
(torch on the same CUDA tensors, the same op order) bit for bit, planes
and keys, launch by launch; the wavefront's image equals render()'s bit
for bit with one slot a pixel.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import raytpu_torch as rt
from raytpu_torch import autodiff, bvh as tbvh, golden, profiling
from raytpu_torch import progressive, rng, shard
from raytpu_torch import wavefront as wf
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import gradkernel, megakernel
from raytpu_torch.kernels import wavefront as kwf

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")


def _cam(cfg, **kw):
    return rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                          aspect=cfg.aspect, device="cuda", **kw)


def _launches(module) -> int:
    """The kernel launches a wrapper module has made, every variant
    summed."""
    return sum(module.variants.values())


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
    before = _launches(megakernel)
    got = rt.render(scene, cam, cfg, backend="auto")
    assert _launches(megakernel) - before == 1
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


def _rel(a, b, floor):
    return float((a - b).abs().max()) / max(float(b.abs().max()), floor)


def _vjp_errors(got, want):
    """Relative max error per leaf, max|a - b| / max(max|b|, floor), floor
    1e-8 for scene leaves and 1e-6 for camera leaves."""
    errs = {k: _rel(getattr(got[1], k), getattr(want[1], k), 1e-8)
            for k in ("center", "radius", "albedo", "mat_param")}
    errs.update({k: _rel(a, b, 1e-6) for k, a, b in
                 zip(rt.Camera._fields, got[2], want[2])})
    return errs


@needs_card
@pytest.mark.parametrize("cfg,kw,vis_w", [
    (RenderConfig(width=64, height=32, spp=2, depth=4), {}, 0.0),
    (RenderConfig(width=64, height=32, spp=2, depth=4, rng_mode="parallel"),
     dict(aperture=0.3, focus_dist=12.0), 0.0),
    (RenderConfig(width=64, height=32, spp=2, depth=6, gamma=2.0,
                  scatter_mode="v1"), dict(aperture=0.1, focus_dist=10.0),
     0.0),
    (RenderConfig(width=50, height=21, spp=3, depth=5), {}, 0.0),
    (RenderConfig(width=64, height=32, spp=2, depth=4),
     dict(aperture=0.3, focus_dist=12.0), 0.005),
], ids=["sequential", "parallel_defocus", "v1", "unaligned", "vis_w"])
def test_vjp_kernel_matches_plain(cfg, kw, vis_w):
    """K3 against its plain version (the adjoint's VJP) on the same CUDA
    tensors: K3's image bit-equal to K1a's, and every leaf's cotangent
    within 1e-3 of max|b| (the kernel sums in f64, the plain version in f32
    autograd order)."""
    scene = rt.test_world(device="cuda")
    cam = _cam(cfg, **kw)
    img = megakernel.launch(megakernel.pack_camera(cam),
                            megakernel.pack_scene(scene), cfg)
    target = torch.rand(img.shape, generator=torch.Generator().manual_seed(0))
    ct = 2.0 * (img - target.cuda()) / img.numel()
    before = _launches(gradkernel)
    got = gradkernel.render_vjp(scene, cam, cfg, ct, vis_w=vis_w)
    assert _launches(gradkernel) - before == 1
    want = gradkernel.render_vjp_plain(scene, cam, cfg, ct, vis_w)
    assert torch.equal(got[0], img)
    errs = _vjp_errors(got, want)
    assert max(errs.values()) <= 1e-3, errs


@needs_card
def test_vjp_pass1_elision_bit_equal():
    """Parallel RNG: passing the forward image skips PASS 1 and leaves the
    gradients bit-equal (tests/test_gradkernel.py demands the same of the
    TPU kernel).  p2_refill=False isolates the elision, as raytpu's test
    does: the image alone would also engage the windowed refill, whose sums
    run in another order (tested below)."""
    cfg = RenderConfig(width=64, height=16, spp=2, depth=3,
                       rng_mode="parallel")
    scene = rt.test_world(device="cuda")
    cam = _cam(cfg)
    img = rt.render(scene, cam, cfg)
    ct = 2.0 * (img - 0.25) / img.numel()
    a = gradkernel.render_vjp(scene, cam, cfg, ct)
    b = gradkernel.render_vjp(scene, cam, cfg, ct, img=img, p2_refill=False)
    assert torch.equal(a[0], b[0])
    for x, y in zip((*a[1][:2], *a[1][3:], *a[2]), (*b[1][:2], *b[1][3:],
                                                    *b[2])):
        assert torch.equal(x, y)


@needs_card
def test_autograd_runs_forward_and_vjp_kernels():
    cfg = RenderConfig(width=48, height=24, spp=2, depth=4)
    scene = rt.test_world(device="cuda")
    cam = _cam(cfg)
    center = scene.center.clone().requires_grad_()
    before = _launches(megakernel), _launches(gradkernel)
    loss, _, (sg, _) = rt.render_grad(scene, cam, cfg,
                                      torch.zeros(24, 48, 3, device="cuda"))
    img = rt.render(scene._replace(center=center), cam, cfg)
    (g,) = torch.autograd.grad(img.square().mean(), center)
    assert (_launches(megakernel) - before[0],
            _launches(gradkernel) - before[1]) == (2, 2)
    assert bool(torch.isfinite(g).all())
    torch.testing.assert_close(g, sg.center, rtol=1e-6, atol=0)


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


def _bvh_world(cfg, n=120, leaf=16):
    scene = rt.final_world(n=n, device="cuda")
    return scene, _cam(cfg), tbvh.build_bvh(scene, leaf_size=leaf)


def _reset_counts():
    for d in (megakernel.variants, gradkernel.variants):
        for k in d:
            d[k] = 0


@needs_card
@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_bvh_kernel_matches_plain_and_brute(rng_mode):
    cfg = RenderConfig(width=128, height=64, spp=4, depth=8,
                       rng_mode=rng_mode)
    scene, cam, bvh = _bvh_world(cfg)
    _reset_counts()
    got = rt.render(scene, cam, cfg, bvh=bvh)
    # the brute sweep (120 spheres: counted as the dense stage, K1e)
    brute = megakernel.launch(megakernel.pack_camera(cam),
                              megakernel.pack_scene(scene), cfg)
    assert megakernel.variants["K1c"] == 1 == megakernel.variants["K1e"]
    _agree(got, golden.render_golden(scene, cam, cfg, bvh))
    assert torch.equal(got, brute)


@needs_card
def test_census_counts_the_frame():
    """K1': the image is K1c's; samples = W*H*spp; bounce steps = the
    slots the taping forward writes; a brute census counts the same steps
    and enters no leaf."""
    cfg = RenderConfig(width=96, height=48, spp=3, depth=6,
                       rng_mode="parallel")
    scene, cam, bvh = _bvh_world(cfg)
    cp = megakernel.pack_camera(cam)
    sp = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))
    img, cen = megakernel.launch(cp, sp, cfg, bvh, count=True)
    # the taping forward writes only the slots of steps taken
    tape = torch.full((cfg.spp * cfg.depth, 96 * 48), golden.TAPE_UNWRITTEN,
                      dtype=golden.tape_dtype(sp.shape[1]), device="cuda")
    megakernel.launch(cp, sp, cfg, bvh, tape=tape)
    leaves, steps, samples, nodes = cen.tolist()
    assert torch.equal(img, megakernel.launch(cp, sp, cfg, bvh))
    assert samples == 96 * 48 * 3
    assert steps == int((tape != golden.TAPE_UNWRITTEN).sum())
    assert 0 < leaves <= steps * bvh.n_leaves and nodes == 0  # flat sweep
    _, cen_b = megakernel.launch(cp, megakernel.pack_scene(scene), cfg,
                                 count=True)
    assert cen_b.tolist() == [0, steps, samples, 0]
    # the plain version on the same CUDA tensors counts the same work (a
    # path flip between the two could move a few steps: none here)
    plain = dict.fromkeys(golden.CENSUS, 0)
    golden.render_golden(scene, cam, cfg, bvh, census=plain)
    assert [plain[k] for k in golden.CENSUS] == cen.tolist()


def _grads(out):
    return (out[0], *[getattr(out[1], k) for k in
                      ("center", "radius", "albedo", "mat_param")], *out[2])


@needs_card
@pytest.mark.parametrize("sweep", ["brute", "bvh"])
def test_tape_write_and_replay_bit_equal(sweep):
    cfg = RenderConfig(width=96, height=48, spp=2, depth=5,
                       rng_mode="parallel")
    scene, cam, bvh = _bvh_world(cfg)
    bvh = bvh if sweep == "bvh" else None
    full = cfg.spp * cfg.depth
    img, tape = gradkernel.render_tape_fwd(scene, cam, cfg, full, bvh)
    assert torch.equal(img, rt.render(scene, cam, cfg, bvh=bvh))
    _, want_tape = golden.render_golden_tape(scene, cam, cfg, full, bvh)
    written = want_tape != golden.TAPE_UNWRITTEN  # the rest is never read
    assert float((tape == want_tape)[written].float().mean()) >= 0.999
    ct = 2.0 * (img - 0.25) / img.numel()
    for p2_refill in (False, None):  # the per-sample pass, the refill
        base = _grads(gradkernel.render_vjp(scene, cam, cfg, ct, img=img,
                                            bvh=bvh, p2_refill=p2_refill))
        for g_cap in (full, 0, 1, 2, cfg.depth + 3):
            _reset_counts()
            out = gradkernel.render_vjp(scene, cam, cfg, ct, img=img, bvh=bvh,
                                        tape=tape[:g_cap].contiguous(),
                                        tape_partial=g_cap < full,
                                        p2_refill=p2_refill)
            assert gradkernel.variants[gradkernel._variant(
                "bvh" if bvh else None, p2_refill is None, True, False)] == 1
            for a, b in zip(_grads(out), base):
                assert torch.equal(a, b), (p2_refill, g_cap)


@needs_card
@pytest.mark.parametrize("rng_mode,vis_w", [("sequential", 0.0),
                                            ("parallel", 0.0),
                                            ("sequential", 0.005)])
def test_bvh_vjp_kernel_matches_plain(rng_mode, vis_w):
    cfg = RenderConfig(width=64, height=32, spp=2, depth=4,
                       rng_mode=rng_mode)
    scene, cam, bvh = _bvh_world(cfg, n=48)
    img = rt.render(scene, cam, cfg, bvh=bvh)
    ct = 2.0 * (img - 0.5) / img.numel()
    _reset_counts()
    got = gradkernel.render_vjp(scene, cam, cfg, ct, vis_w=vis_w, bvh=bvh)
    assert gradkernel.variants["K3/bvh"] == 1
    want = gradkernel.render_vjp_plain(scene, cam, cfg, ct, vis_w, bvh)
    assert torch.equal(got[0], img)
    errs = _vjp_errors(got, want)
    assert max(errs.values()) <= 1e-3, errs
    brute = gradkernel.render_vjp(scene, cam, cfg, ct, vis_w=vis_w)
    errs = _vjp_errors(got, brute)
    assert max(errs.values()) <= 1e-6, errs


@needs_card
def test_bvh_autograd_launches():
    """render_grad(bvh=): parallel RNG runs the taping forward and K3's
    tape replay on the windowed refill; sequential RNG K1c and K3's BVH
    variant, and no tape."""
    cfg = RenderConfig(width=64, height=32, spp=2, depth=4,
                       rng_mode="parallel")
    scene, cam, bvh = _bvh_world(cfg, n=48)
    target = torch.zeros(32, 64, 3, device="cuda")
    _reset_counts()
    _, _, (sg, _) = rt.render_grad(scene, cam, cfg, target, bvh=bvh)
    assert megakernel.variants["K4/bvh"] == 1
    assert gradkernel.variants["K3/bvh+refill+tape"] == 1
    assert sum(megakernel.variants.values()) == 1
    assert sum(gradkernel.variants.values()) == 1
    _reset_counts()
    _, _, (sg2, _) = rt.render_grad(scene, cam, cfg.replace(
        rng_mode="sequential"), target, bvh=bvh)
    assert megakernel.variants["K1c"] == 1 == gradkernel.variants["K3/bvh"]
    assert sum(megakernel.variants.values()) == 1
    assert sum(gradkernel.variants.values()) == 1
    assert bool(torch.isfinite(sg.center).all())
    assert bool(torch.isfinite(sg2.center).all())


@needs_card
@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
@pytest.mark.parametrize("sweep", ["brute", "bvh"])
def test_accumulate_kernel_batches_and_plain(rng_mode, sweep):
    """K2: batches 2 + 3 + 1 equal one 6-sample batch, acc and seed bit for
    bit; the state agrees with the plain version's on the same CUDA
    tensors; the image of the state is the forward kernel's."""
    cfg = RenderConfig(width=96, height=48, spp=6, depth=6,
                       rng_mode=rng_mode)
    scene, cam, bvh = _bvh_world(cfg)
    bvh = bvh if sweep == "bvh" else None
    init = progressive.init_state(cfg, device="cuda")
    _reset_counts()
    one = progressive.accumulate(scene, cam, cfg, init, 6, bvh=bvh)
    st = plain = init
    for k in (2, 3, 1):
        st = progressive.accumulate(scene, cam, cfg, st, k, bvh=bvh)
        plain = progressive.accumulate(scene, cam, cfg, plain, k,
                                       backend="golden", bvh=bvh)
    assert megakernel.variants[f"K2/{sweep}"] == 4
    assert sum(megakernel.variants.values()) == 4
    assert st.samples == 6
    assert torch.equal(st.acc, one.acc) and torch.equal(st.seed, one.seed)
    _agree(st.acc / 6, plain.acc / 6)
    assert float((st.seed == plain.seed).float().mean()) >= 0.999
    img = rt.render(scene, cam, cfg, bvh=bvh)
    assert float((progressive.image(st, cfg) - img).abs().max()) <= 2e-7


_SLABS = ((0, 13), (13, 20), (33, 7), (40, 16))  # the last runs past H


@needs_card
@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_slabs_stitch_to_the_frame(rng_mode):
    """K1b, K2, K4 and K3 on uneven slabs and one past the frame: stitched
    images, state and tapes equal the full frame's bit for bit, rows past
    the frame are 0, and K3's slab sums add up to its full-frame sums."""
    cfg = RenderConfig(width=96, height=45, spp=2, depth=5,
                       rng_mode=rng_mode)
    h = cfg.height
    scene, cam, bvh = _bvh_world(cfg)
    full = rt.render(scene, cam, cfg, bvh=bvh)
    init = progressive.init_state(cfg, device="cuda")
    st = progressive.accumulate(scene, cam, cfg, init, 2, bvh=bvh)
    _reset_counts()
    imgs, accs, seeds = [], [], []
    for row0, rows in _SLABS:
        img = megakernel.forward(scene, cam, cfg, bvh=bvh, row0=row0,
                                 rows=rows)
        acc, seed = megakernel.accumulate(
            scene, cam, cfg, shard.slab_of(init.acc, row0, rows),
            shard.slab_of(init.seed, row0, rows), 0, 2, bvh, row0, rows)
        live = max(0, min(rows, h - row0))
        for t in (img, acc):
            assert not bool(t[live:].any())
        assert not bool(seed[live:].any())
        imgs.append(img[:live])
        accs.append(acc[:live])
        seeds.append(seed[:live])
    assert megakernel.variants["K1b/bvh"] == 4 == megakernel.variants[
        "K2/bvh+slab"]
    assert torch.equal(torch.cat(imgs), full)
    assert torch.equal(torch.cat(accs), st.acc)
    assert torch.equal(torch.cat(seeds), st.seed)
    ct = 2.0 * (full - 0.5) / full.numel()
    cp = megakernel.pack_camera(cam)
    sp = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))

    def sums(out):  # K3's f64 sums, before the cast to f32, as one row
        return torch.cat([out[1].reshape(-1), out[2]])

    want, total = sums(gradkernel.launch(cp, sp, cfg, ct, None, 0.0, bvh)), 0.0
    for row0, rows in _SLABS:
        ct_s = torch.zeros((rows, cfg.width, 3), device="cuda")
        live = max(0, min(rows, h - row0))
        ct_s[:live] = ct[row0:row0 + live]
        ct_s[live:] = 1.0  # ignored: rows past the frame
        got = gradkernel.launch(cp, sp, cfg, ct_s, None, 0.0, bvh, row0=row0,
                                rows=rows)
        assert torch.equal(got[0][:live], full[row0:row0 + live])
        assert not bool(got[0][live:].any())
        total = total + sums(got)
    assert gradkernel.variants["K3/bvh+slab"] == 4
    # rows cx cy cz | rad | ar ag ab | mp of the permuted spheres, then the
    # camera sums in threes
    n = int(bvh.perm.shape[0])
    i = 0
    for size in (3 * n, n, 3 * n, n, 3, 3, 3, 3, 6):
        a, b = total[i:i + size], want[i:i + size]
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1e-12), i
        i += size
    if rng_mode != "parallel":
        return
    g = cfg.spp * cfg.depth

    def marked(rows):  # slots no step reaches keep the mark
        return torch.full((g, rows * cfg.width), golden.TAPE_UNWRITTEN,
                          dtype=golden.tape_dtype(sp.shape[1]), device="cuda")

    tape = marked(h)
    img_t = megakernel.launch(cp, sp, cfg, bvh, tape=tape)
    for row0, rows in _SLABS:
        live = max(0, min(rows, h - row0))
        tape_s = marked(rows)
        img_s = megakernel.launch(cp, sp, cfg, bvh, tape=tape_s, row0=row0,
                                  rows=rows)
        assert torch.equal(img_s[:live], img_t[row0:row0 + live])
        assert torch.equal(tape_s[:, :live * cfg.width],
                           tape[:, row0 * cfg.width:(row0 + live) * cfg.width])
        assert bool((tape_s[:, live * cfg.width:]
                     == golden.TAPE_UNWRITTEN).all())
        out = gradkernel.render_vjp(
            scene, cam, cfg, torch.zeros_like(img_s), img=img_s, bvh=bvh,
            tape=tape_s, row0=row0, rows=rows)
        assert torch.equal(out[0], img_s)
    img_w, tape_w = gradkernel.render_tape_fwd(scene, cam, cfg, g, bvh, 13,
                                               20)
    assert torch.equal(img_w, img_t[13:33]) and tape_w.shape == (g, 20 * 96)
    assert megakernel.variants["K4/bvh+slab"] == 5
    assert gradkernel.variants["K3/bvh+refill+tape+slab"] == 4


def _walk_world(cfg, padded=True):
    """final_world(n=300) at leaf 4: 75 leaves a copy, so the rule walks
    it; unpadded, the walk is the only sweep."""
    scene = rt.final_world(n=300, device="cuda")
    bvh = tbvh.build_bvh(scene, leaf_size=4, pad_leaves=padded)
    assert tbvh.sweep_of(bvh) == "walk"
    return scene, _cam(cfg), bvh


@needs_card
@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
def test_walk_kernels_match_plain(padded, rng_mode):
    """K1d, K2/walk, K3/walk and (parallel RNG) K4/walk with K3's replay
    against their plain versions on the same CUDA tensors, each launch
    counted by its variant."""
    cfg = RenderConfig(width=64, height=32, spp=2, depth=5,
                       rng_mode=rng_mode)
    scene, cam, bvh = _walk_world(cfg, padded)
    _reset_counts()
    img = rt.render(scene, cam, cfg, bvh=bvh)
    assert megakernel.variants["K1d"] == 1 == sum(megakernel.variants.values())
    _agree(img, golden.render_golden(scene, cam, cfg, bvh))
    assert torch.equal(img, rt.render(scene, cam, cfg))  # brute: no ties
    init = progressive.init_state(cfg, device="cuda")
    st = plain = init
    _reset_counts()
    for k in (1, 1):
        st = progressive.accumulate(scene, cam, cfg, st, k, bvh=bvh)
        plain = progressive.accumulate(scene, cam, cfg, plain, k,
                                       backend="golden", bvh=bvh)
    assert megakernel.variants["K2/walk"] == 2
    _agree(st.acc / 2, plain.acc / 2)
    assert float((st.seed == plain.seed).float().mean()) >= 0.999
    assert float((progressive.image(st, cfg) - img).abs().max()) <= 2e-7
    ct = 2.0 * (img - 0.5) / img.numel()
    _reset_counts()
    got = gradkernel.render_vjp(scene, cam, cfg, ct, bvh=bvh)
    assert gradkernel.variants["K3/walk"] == 1
    assert torch.equal(got[0], img)
    want = gradkernel.render_vjp_plain(scene, cam, cfg, ct, 0.0, bvh)
    errs = _vjp_errors(got, want)
    assert max(errs.values()) <= 1e-3, errs
    if rng_mode != "parallel":
        return
    full = cfg.spp * cfg.depth
    _reset_counts()
    img_t, tape = gradkernel.render_tape_fwd(scene, cam, cfg, full, bvh)
    assert megakernel.variants["K4/walk"] == 1 and torch.equal(img_t, img)
    _, want_tape = golden.render_golden_tape(scene, cam, cfg, full, bvh)
    written = want_tape != golden.TAPE_UNWRITTEN
    assert float((tape == want_tape)[written].float().mean()) >= 0.999
    base = _grads(gradkernel.render_vjp(scene, cam, cfg, ct, img=img, bvh=bvh))
    for g_cap in (full, 3):
        out = gradkernel.render_vjp(scene, cam, cfg, ct, img=img, bvh=bvh,
                                    tape=tape[:g_cap].contiguous(),
                                    tape_partial=g_cap < full)
        for a, b in zip(_grads(out), base):
            assert torch.equal(a, b), g_cap
    assert gradkernel.variants["K3/walk+refill+tape"] == 2


@needs_card
def test_walk_against_forced_flat_census_and_slabs():
    """K1d against K1c forced on the same BVH: bit-equal images, the same
    leaves entered and steps counted (K1'/walk, K1'/bvh), the nodes visited
    counted by the walk only and by its plain version alike; K3 over the
    walk against K3 over the flat sweep: the same f64 sums to 1e-9 of each
    leaf's largest; a slab over the walk equals the full frame's rows."""
    cfg = RenderConfig(width=96, height=48, spp=3, depth=6,
                       rng_mode="parallel")
    scene, cam, bvh = _walk_world(cfg)
    cp = megakernel.pack_camera(cam)
    sp = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))
    _reset_counts()
    walk = megakernel.launch(cp, sp, cfg, bvh)
    forced = tbvh.with_sweep(bvh, "flat")
    flat = megakernel.launch(cp, sp, cfg, forced)
    assert megakernel.variants["K1d"] == 1 == megakernel.variants["K1c"]
    assert torch.equal(walk, flat)
    img_w, cen_w = megakernel.launch(cp, sp, cfg, bvh, count=True)
    img_f, cen_f = megakernel.launch(cp, sp, cfg, forced, count=True)
    assert megakernel.variants["K1'/walk"] == 1 == megakernel.variants[
        "K1'/bvh"]
    assert torch.equal(img_w, walk) and torch.equal(img_f, flat)
    leaves, steps, samples, nodes = cen_w.tolist()
    assert cen_f.tolist() == [leaves, steps, samples, 0]
    assert samples == 96 * 48 * 3 and steps <= nodes <= steps * bvh.n_trav
    plain = dict.fromkeys(golden.CENSUS, 0)
    golden.render_golden(scene, cam, cfg, bvh, census=plain)
    assert [plain[k] for k in golden.CENSUS] == cen_w.tolist()
    c = profiling.census(scene, cam, cfg, bvh)
    assert c["box_tests"] == nodes and c["sphere_tests"] == (
        leaves * 4 + steps * bvh.n_outliers)
    ct = 2.0 * (walk - 0.5) / walk.numel()
    _reset_counts()
    a = gradkernel.launch(cp, sp, cfg, ct, walk, 0.0, bvh)
    b = gradkernel.launch(cp, sp, cfg, ct, walk, 0.0, forced)
    assert gradkernel.variants["K3/walk+refill"] == 1 == gradkernel.variants[
        "K3/bvh+refill"]
    assert torch.equal(a[0], b[0])
    for x, y in ((a[1], b[1]), (a[2], b[2])):
        assert float((x - y).abs().max()) <= 1e-9 * float(y.abs().max())
    part = megakernel.forward(scene, cam, cfg, bvh=bvh, row0=20, rows=40)
    assert megakernel.variants["K1b/walk"] == 1
    assert torch.equal(part[:28], walk[20:]) and not bool(part[28:].any())
    part_k3 = gradkernel.launch(cp, sp, cfg, ct[20:], walk[20:], 0.0, bvh,
                                row0=20, rows=28)
    assert gradkernel.variants["K3/walk+refill+slab"] == 1
    assert torch.equal(part_k3[0], walk[20:])


@needs_card
def test_device_ms_reads_the_kernels_time():
    """profiling.device_ms sums the kernel time of one render from a
    torch.profiler trace of the card."""
    cfg = RenderConfig(width=128, height=64, spp=4, depth=8)
    scene = rt.test_world(device="cuda")
    cam = _cam(cfg)
    rt.render(scene, cam, cfg)
    ms = profiling.device_ms(lambda: rt.render(scene, cam, cfg))
    assert 0 < ms < 1000


@needs_card
def test_device_events_lists_the_kernels():
    """profiling.device_events lists one render's device events, longest
    first, the forward kernel's launch among them; traced in a process of
    its own (a process's first trace: see profiling._traced)."""
    code = (
        "import json\n"
        "import raytpu_torch as rt\n"
        "from raytpu_torch import profiling\n"
        "from raytpu_torch.config import RenderConfig\n"
        "cfg = RenderConfig(width=128, height=64, spp=4, depth=8)\n"
        "scene = rt.test_world(device='cuda')\n"
        "cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,"
        " aspect=cfg.aspect, device='cuda')\n"
        "rt.render(scene, cam, cfg)\n"
        "print(json.dumps(profiling.device_events(\n"
        "    lambda: rt.render(scene, cam, cfg))))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    events = json.loads(proc.stdout.strip().splitlines()[-1])
    ms = [t for _, t in events]
    assert ms == sorted(ms, reverse=True) and all(t >= 0 for t in ms)
    assert any("render_fwd_kernel" in name for name, _ in events), events


@needs_card
def test_fractsin_state_bit_equal_cpu():
    """The v1 fract-sin mode on CUDA tensors (the plain version, no
    kernel): every pixel's post-jitter float2 state and its chained draws
    equal the CPU's bit for bit (one torch op per f32 operation on both),
    and the image is within the cross-context budget of the CPU's (the
    mappings' acos / pow / sin / cos, rsqrt and the gamma may round apart)."""
    cfg = RenderConfig(width=64, height=48, spp=1, depth=25, gamma=2.0,
                       scatter_mode="v1", rng_mode="v1_fractsin")
    planes = {}
    for dev in ("cpu", "cuda"):
        cam = rt.reference_camera_v1(device=dev)
        flat = torch.arange(cfg.width * cfg.height, device=dev)
        fx = (flat % cfg.width).float()
        fy = (flat // cfg.width).float()
        sx, sy = golden.fractsin_state(cfg, fx, fy)
        _, _, _, st = golden.fractsin_sample(cam, cfg, fx, fy, sx, sy)
        draws, s = [], st
        for _ in range(3):
            v, s = rng.fs_rand2d(*s)
            draws.append(v)
        img = rt.render(rt.v1_world(device=dev), cam, cfg)
        planes[dev] = [t.cpu() for t in (*st, *draws, img)]
    for a, b in zip(planes["cpu"][:-1], planes["cuda"][:-1]):
        assert torch.equal(a, b)
    _agree(planes["cuda"][-1], planes["cpu"][-1])


@needs_card
@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_dense_stage_bit_equal_k1a_and_plain(rng_mode):
    """K1e (random_world, 327 spheres, by the policy; K1a's kernel, the
    brute sweep over staged rows on the persistent sample refill) against
    the plain version, bit for bit: a frame at depth 8 and one at depth 50
    through glass and metal; on a slab ending past the frame (K1b/dense)
    the frame's rows; a ragged frame (1003 wide) at 1 spp with more pixels
    than the persistent grid holds (at most 2048 threads an SM); the
    smallest frame the entry points take (2x2; 1/(W - 1) rules out one
    pixel a row) and a 1-row slab of it; at 4096 spheres (64 KB of staged
    rows, past the 48 KB default).  The dense census kernel (warp_census,
    K1'/dense) counts the plain census's steps and samples."""
    cfg = RenderConfig(width=96, height=48, spp=2, depth=8,
                       rng_mode=rng_mode)
    scene = rt.random_world(device="cuda")
    assert {0, 1, 2} <= set(scene.mat_type.tolist())
    cam = _cam(cfg, aperture=0.1, focus_dist=10.0)
    cp, sp = megakernel.pack_camera(cam), megakernel.pack_scene(scene)
    _reset_counts()
    dense = megakernel.launch(cp, sp, cfg)
    part = megakernel.launch(cp, sp, cfg, row0=20, rows=40)
    assert {k: v for k, v in megakernel.variants.items() if v} == {
        "K1e": 1, "K1b/dense": 1}
    assert torch.equal(dense, golden.render_golden(scene, cam, cfg))
    assert torch.equal(part[:28], dense[20:]) and not bool(part[28:].any())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c, row0, rows in (
            (cfg.replace(depth=50), 0, None),
            (cfg.replace(width=1003, height=301, spp=1), 0, None),
            (cfg.replace(width=2, height=2, spp=3, depth=50), 0, None),
            (cfg.replace(width=2, height=2, spp=3, depth=50), 1, 1)):
        cam_c = _cam(c, aperture=0.1, focus_dist=10.0)
        cp_c = megakernel.pack_camera(cam_c)
        got = megakernel.launch(cp_c, sp, c, row0=row0, rows=rows)
        assert torch.equal(got, golden.render_golden(scene, cam_c, c,
                                                     row0=row0, rows=rows))
        if c.width == 1003:
            assert c.width * c.height > sms * 2048
    cn = megakernel.warp_census(cp, sp, cfg, None)
    assert megakernel.variants["K1'/dense"] == 1
    plain = dict.fromkeys(golden.CENSUS, 0)
    golden.render_golden(scene, cam, cfg, census=plain)
    assert [cn[k] for k in golden.CENSUS] == [plain[k]
                                              for k in golden.CENSUS]
    assert 0.0 < cn["loop_efficiency"] <= 1.0
    assert 0.0 < cn["sweep_efficiency"] <= 1.0
    big = _random_spheres(megakernel.DENSE_MAX)
    small = cfg.replace(width=32, height=16, spp=1, depth=4)
    got = megakernel.launch(cp, megakernel.pack_scene(big), small)
    assert torch.equal(got, golden.render_golden(big, cam, small))


def _random_spheres(n, seed=5):
    """n spheres of every material at random in a 20-unit box, from a
    seed."""
    g = torch.Generator().manual_seed(seed)
    return rt.Scene(
        (torch.rand(n, 3, generator=g) * 20 - 10).cuda(),
        (torch.rand(n, generator=g) * 0.3 + 0.05).cuda(),
        torch.randint(0, 3, (n,), generator=g, dtype=torch.int32).cuda(),
        torch.rand(n, 3, generator=g).cuda(),
        (torch.rand(n, generator=g) + 1.0).cuda())


# The brute sweep's forward cases, (frame, row0, rows, spheres; 0:
# test_world's): an unaligned frame, the smallest frame the entry points
# take, a 1-row slab wholly past the frame, a ragged frame with more pixels
# than the persistent grid holds (at most 2048 threads an SM) at 1 spp,
# and 4097 spheres, one past the stage (the sweep reads the scene pack).
_BRUTE_CASES = {
    "unaligned_50x21": (RenderConfig(width=50, height=21, spp=3, depth=6),
                        0, None, 0),
    "tiny_2x2": (RenderConfig(width=2, height=2, spp=3, depth=50), 0, None,
                 0),
    "slab_1row_past_frame": (RenderConfig(width=50, height=21, spp=3,
                                          depth=6), 21, 1, 0),
    "wide_1003x301_spp1": (RenderConfig(width=1003, height=301, spp=1,
                                        depth=8), 0, None, 0),
    "pack_4097": (RenderConfig(width=64, height=32, spp=2, depth=4), 0, None,
                  4097),
}


@needs_card
@pytest.mark.parametrize("case", list(_BRUTE_CASES))
@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_brute_refill_bit_equal_plain(rng_mode, case):
    """The brute sweep's forward on the persistent sample refill (K1a or
    K1b/brute, K2/brute, K4/brute, K1'/brute) against the plain versions on
    the same CUDA tensors, bit for bit: the image, a K2 batch from s0 = 2
    (sums and seeds), the taping forward (image and every tape slot) and
    the census's four counts, which warp_census counts too."""
    cfg, row0, rows, n = _BRUTE_CASES[case]
    cfg = cfg.replace(rng_mode=rng_mode)
    scene = _random_spheres(n) if n else rt.test_world(device="cuda")
    assert {0, 1, 2} <= set(scene.mat_type.tolist())
    cam = _cam(cfg, aperture=0.1, focus_dist=10.0)
    cp, sp = megakernel.pack_camera(cam), megakernel.pack_scene(scene)
    r, g = rows or cfg.height, cfg.spp * cfg.depth
    if case == "wide_1003x301_spp1":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert cfg.width * cfg.height > sms * 2048
    _reset_counts()
    img = megakernel.launch(cp, sp, cfg, row0=row0, rows=rows)
    assert torch.equal(img, golden.render_golden(scene, cam, cfg, row0=row0,
                                                 rows=rows))
    st = progressive.accumulate(scene, cam, cfg, progressive.init_state(
        cfg, device="cuda"), 2, backend="golden")
    acc, seed = shard.slab_of(st.acc, row0, r), shard.slab_of(st.seed, row0,
                                                                r)
    got = megakernel.accumulate(scene, cam, cfg, acc, seed, 2, 3, None, row0,
                                rows)
    want = golden.accumulate_golden(scene, cam, cfg, acc, seed, 2, 3, None,
                                    row0, rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    tape = torch.full((g, r * cfg.width), golden.TAPE_UNWRITTEN,
                      dtype=golden.tape_dtype(sp.shape[1]), device="cuda")
    timg = megakernel.launch(cp, sp, cfg, tape=tape, row0=row0, rows=rows)
    pimg, ptape = golden.render_golden_tape(scene, cam, cfg, g, None, row0,
                                            rows)
    assert torch.equal(timg, pimg) and torch.equal(tape, ptape)
    _, cen = megakernel.launch(cp, sp, cfg, count=True, row0=row0, rows=rows)
    plain = dict.fromkeys(golden.CENSUS, 0)
    golden.render_golden(scene, cam, cfg, census=plain, row0=row0, rows=rows)
    assert cen.tolist() == [plain[k] for k in golden.CENSUS]
    slab = "+slab" if rows is not None else ""
    assert {k: v for k, v in megakernel.variants.items() if v} == {
        "K1b/brute" if slab else "K1a": 1, f"K2/brute{slab}": 1,
        f"K4/brute{slab}": 1, "K1'/brute": 1}
    c = megakernel.warp_census(cp, sp, cfg, None, row0, rows)
    assert [c[k] for k in golden.CENSUS] == cen.tolist()
    if plain["samples"]:
        assert 0.0 < c["loop_efficiency"] <= 1.0
        assert 0.0 < c["sweep_efficiency"] <= 1.0


@needs_card
@pytest.mark.parametrize("n", [4096, 4097], ids=["stage_64kb", "pack_4097"])
def test_k3_brute_stage_and_pack_match_plain(n):
    """K3 under the brute sweep at the stage's largest scene (4096
    spheres: 64 KB of rows, past the 48 KB default, beside the refill's 36
    KB of camera sums) and one past it (the scene pack): the per-sample
    pass in sequential RNG and the windowed refill, each without and with
    vis_w, within 1e-3 of the plain version per leaf, the refill within
    3e-5 of the per-sample pass, every image the forward's; the refill
    replaying a full K4 tape bit for bit the untaped one."""
    cfg = RenderConfig(width=48, height=24, spp=2, depth=4,
                       rng_mode="parallel")
    seq = cfg.replace(rng_mode="sequential")
    scene = _random_spheres(n)
    cam = _cam(cfg, aperture=0.1, focus_dist=10.0)
    img = rt.render(scene, cam, seq)
    ct = 2.0 * (img - 0.5) / img.numel()
    for vis_w in (0.0, 0.005):
        _reset_counts()
        got = gradkernel.render_vjp(scene, cam, seq, ct, vis_w=vis_w)
        assert gradkernel.variants["K3"] == 1 and torch.equal(got[0], img)
        errs = _vjp_errors(got, gradkernel.render_vjp_plain(scene, cam, seq,
                                                            ct, vis_w))
        assert max(errs.values()) <= 1e-3, (vis_w, errs)
        got, ct_p = _refill_vs_per_sample(scene, cam, cfg, None, vis_w)
        errs = _vjp_errors(got, gradkernel.render_vjp_plain(scene, cam, cfg,
                                                            ct_p, vis_w))
        assert max(errs.values()) <= 1e-3, (vis_w, errs)
    full = cfg.spp * cfg.depth
    img, tape = gradkernel.render_tape_fwd(scene, cam, cfg, full)
    assert torch.equal(img, rt.render(scene, cam, cfg))
    ct = 2.0 * (img - 0.5) / img.numel()
    base = _grads(gradkernel.render_vjp(scene, cam, cfg, ct, img=img))
    _reset_counts()
    taped = _grads(gradkernel.render_vjp(scene, cam, cfg, ct, img=img,
                                         tape=tape))
    assert gradkernel.variants["K3/refill+tape"] == 1
    for a, b in zip(taped, base):
        assert torch.equal(a, b)


def _same(a, b):
    """Equal values, or equal bits where a plane holds u32 seed bits (some
    of which read as NaN)."""
    return bool(((a == b) | (a.view(torch.int32) == b.view(torch.int32)))
                .all())


def _record(monkeypatch, name):
    """kwf.<name> wrapped: each call's arguments and a copy of its
    output."""
    calls, fn = [], getattr(kwf, name)

    def rec(*args):
        out = fn(*args)
        calls.append((args, out.clone()))
        return out
    monkeypatch.setattr(kwf, name, rec)
    return calls


# The segment kernels' cases: the scene's policy, then a flat BVH staged
# only in part (a limit that leaves out most leaves: the rest read from
# the pack and the leaf list), an unpadded walk (one copy, leaves of up
# to 7 spheres) and 4097 spheres without a BVH (one past the stage: the
# brute sweep reads the pack) -> (scene, camera, bvh, SceneOps policy).
def _wavefront_world(case, cfg, monkeypatch):
    if case == "dense":
        return rt.random_world(device="cuda"), _cam(cfg), None, "dense"
    if case == "brute":
        return rt.test_world(device="cuda"), _cam(cfg), None, "brute"
    if case == "pack_4097":
        return _random_spheres(4097), _cam(cfg), None, "brute"
    if case == "walk_unpadded":
        return (*_walk_world(cfg, padded=False), "walk")
    if case == "walk":
        return (*_walk_world(cfg), "walk")
    scene, cam, bvh = _bvh_world(cfg)
    if case == "bvh_part_staged":
        whole = megakernel.flat_stage(bvh, 1 << 30)
        limit = whole["bytes"] - 16 * (bvh.n_leaves - 2) * (bvh.leaf_size + 1)
        monkeypatch.setattr(megakernel, "smem_optin", lambda dev: limit)
        st = megakernel.flat_stage(bvh, limit)
        assert st["boxes"] and st["leaves"] == 2 < bvh.n_leaves
    return scene, cam, bvh, "bvh"


def _slot_grid(ops, planes, cfg, _):
    """K5's persistent slot grid against the plain version, bit for bit, on
    planes a frame's launches do not give: R not a multiple of 256 (1000
    slots, fewer than the grid holds), every slot dead, a 38-bounce segment
    (under the dense stage, at depth 50), more slots than the grid holds
    (the frame's slots tiled 160 times, past 2048 threads an SM; not past
    the stage, where the plain version's slots x spheres broadcast would
    take tens of GB: the pack's loop is the staged rows') and, over a flat
    BVH, nothing of it staged."""
    dead = planes.clone()
    dead[12] = 0.0
    many = planes.repeat(1, 160)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert many.shape[1] > sms * 2048
    deep = cfg.replace(depth=50) if ops.policy == "dense" else cfg
    k = 38 if ops.policy == "dense" else 3
    cases = [(ops, planes[:, :1000].contiguous(), cfg, 3),
             (ops, dead, cfg, 9), (ops, planes, deep, k)]
    if ops.pack.shape[1] <= megakernel.DENSE_MAX:
        cases.append((ops, many, deep, k))
    if ops.policy == "bvh":
        cases.append((ops._replace(stage=megakernel.flat_stage(ops.bvh, 0)),
                      planes, cfg, 3))
    for o, p, c, n in cases:
        got = kwf.launch_segment(o, p, c, n)
        assert _same(got, wf.segment_plain(o, p, c, n))


def _refill_slot_grid(ops, ride, aux, cfg, _, B):
    """K6's persistent slot grid against the plain version, bit for bit:
    more slots than the grid holds (tiled 160 times; as in _slot_grid, not
    past the stage), every slot exhausted (each rides through as a copy)
    and 1000 slots."""
    done = ride.clone()
    done[0] = wf.DEAD_KEY
    cases = [(done, aux),
             (ride[:, :1000].contiguous(), aux[:, :1000].contiguous())]
    if ops.pack.shape[1] <= megakernel.DENSE_MAX:
        cases.append((ride.repeat(1, 160), aux.repeat(1, 160)))
    for r, a in cases:
        got = kwf.launch_refill_segment(ops, r, a, cfg, 2, B)
        assert _same(got, wf.refill_segment_plain(ops, r, a, cfg, 2, B))


@needs_card
@pytest.mark.parametrize("policy", ["brute", "dense", "bvh", "walk",
                                    "bvh_part_staged", "walk_unpadded",
                                    "pack_4097"])
@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_segment_kernels_match_plain(monkeypatch, policy, rng_mode):
    """Every K5 launch of a wavefront render (and, in parallel RNG, every
    K6 launch of a refill render) against its plain version on the same
    planes, bit for bit; the images equal render()'s bit for bit (one slot
    a pixel) and, two samples in flight, within an ulp.  Every policy's
    closest hit is the forward's (the flat sweep over the stage, the walk
    over its 16-byte rows, the brute sweep over staged rows or the pack),
    on a persistent slot grid: also on the planes of _slot_grid and
    _refill_slot_grid, and on a slab whose rows run past the frame."""
    cfg = RenderConfig(width=64, height=32, spp=2, depth=6,
                       rng_mode=rng_mode)
    scene, cam, bvh, tag = _wavefront_world(policy, cfg, monkeypatch)
    seg = _record(monkeypatch, "launch_segment")
    ref = rt.render(scene, cam, cfg, bvh=bvh)
    kwf.variants[f"K5/{tag}"] = 0
    img = rt.render(scene, cam, cfg, backend="wavefront", bvh=bvh)
    assert kwf.variants[f"K5/{tag}"] == len(seg) == 2 * 2
    assert torch.equal(img, ref)
    for (ops, planes, c, k), out in seg:
        assert ops.policy == tag
        assert _same(out, wf.segment_plain(ops, planes, c, k))
    _slot_grid(*seg[0][0])
    del seg[:]
    part = wf._render(scene, cam, cfg, bvh, (2, 4), 1, 1, 65536, 0, row0=16,
                      rows=32)
    assert torch.equal(part[:16], ref[16:]) and not bool(part[16:].any())
    for (ops, planes, c, k), out in seg:
        assert _same(out, wf.segment_plain(ops, planes, c, k))
    if rng_mode == "sequential":
        return
    rides = _record(monkeypatch, "launch_refill_segment")
    kwf.variants[f"K6/{tag}"] = 0
    for B in (1, 2):
        img = rt.render(scene, cam, cfg, backend="wavefront", bvh=bvh,
                        spp_batch=B, refill=2)
        if B == 1:
            assert torch.equal(img, ref)
        else:
            assert float((img - ref).abs().max()) <= 2.5e-7
    part = wf._render(scene, cam, cfg, bvh, (6,), 1, 1, 65536, 2, row0=16,
                      rows=32)
    assert torch.equal(part[:16], ref[16:]) and not bool(part[16:].any())
    assert kwf.variants[f"K6/{tag}"] == len(rides) > 2
    for (ops, ride, aux, c, k, B), out in rides:
        assert _same(out, wf.refill_segment_plain(ops, ride, aux, c, k, B))
    _refill_slot_grid(*rides[0][0])


@needs_card
def test_wavefront_backward_sequential_and_parallel_refusal():
    """A wavefront image's K3 gradients equal the kernel path's within
    f64-atomic order: in sequential RNG (K1c + K3/bvh) and, once refused,
    in parallel RNG, where the wavefront's autograd (refill=2) runs K3's
    windowed refill (K3/bvh+refill) against render_grad's taped refill
    (K4/bvh + K3/bvh+refill+tape), and render_grad(backend="wavefront") is
    render_grad's."""
    cfg = RenderConfig(width=64, height=32, spp=2, depth=6)
    scene, cam, bvh = _bvh_world(cfg)
    target = torch.full((32, 64, 3), 0.5, device="cuda")
    for rng_mode in ("sequential", "parallel"):
        c = cfg.replace(rng_mode=rng_mode)
        par = rng_mode == "parallel"
        grads = []
        for fn in (wf.render_wavefront, autodiff.render_fwd):
            leaves = [t.detach().requires_grad_() for t in
                      (scene.center, scene.radius, scene.albedo,
                       scene.mat_param, *cam)]
            s = rt.Scene(leaves[0], leaves[1], scene.mat_type, leaves[2],
                         leaves[3])
            _reset_counts()
            kw = {"refill": 2} if par and fn is wf.render_wavefront else {}
            img = fn(s, rt.Camera(*leaves[4:]), c, bvh=bvh, **kw)
            grads.append([img, *torch.autograd.grad(img, leaves,
                                                     img.detach() - target)])
            want = ("K3/bvh" if not par else "K3/bvh+refill+tape"
                    if fn is autodiff.render_fwd else "K3/bvh+refill")
            assert gradkernel.variants[want] == 1 == sum(
                gradkernel.variants.values()), want
        assert torch.equal(grads[0][0], grads[1][0])
        for a, b in zip(grads[0][1:], grads[1][1:]):
            assert float((a - b).abs().max()) <= 1e-6 * max(
                float(b.abs().max()), 1e-8)
        got = rt.render_grad(scene, cam, c, target, backend="wavefront",
                             bvh=bvh)
        want = rt.render_grad(scene, cam, c, target, bvh=bvh)
        assert torch.equal(got[1], rt.render(scene, cam, c, bvh=bvh))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for a, b in zip((*got[2][0][:2], *got[2][0][3:], *got[2][1]),
                        (*want[2][0][:2], *want[2][0][3:], *want[2][1])):
            assert float((a - b).abs().max()) <= 1e-6 * max(
                float(b.abs().max()), 1e-8)


def _refill_case(case, cfg):
    """(scene, camera, bvh, vis_w) of a refill test case."""
    if case == "bvh":
        return (*_bvh_world(cfg), 0.0)
    if case == "walk":
        return (*_walk_world(cfg), 0.0)
    scene = rt.test_world(device="cuda")
    if case == "vis_w":  # silhouette terms under a thin lens
        return scene, _cam(cfg, aperture=0.3, focus_dist=12.0), None, 0.005
    return scene, _cam(cfg), None, 0.0


def _refill_vs_per_sample(scene, cam, cfg, bvh, vis_w, tape=None):
    """K3 given the image in parallel RNG, on the refill and on the
    per-sample pass: the refill's launch counted by its variant, both
    images the given one bit for bit, every leaf within raytpu's 3e-5 of
    its largest entry (the same terms summed in another order).  Returns
    the refill's result and the image cotangent."""
    img = rt.render(scene, cam, cfg, bvh=bvh)
    ct = 2.0 * (img - 0.5) / img.numel()
    kw = dict(img=img, vis_w=vis_w, bvh=bvh, tape=tape,
              tape_partial=tape is not None
              and tape.shape[0] < cfg.spp * cfg.depth)
    _reset_counts()
    got = gradkernel.render_vjp(scene, cam, cfg, ct, **kw)
    tag = gradkernel._variant(
        None if bvh is None else megakernel.sweep_tag(bvh), True,
        tape is not None, False)
    assert gradkernel.variants[tag] == 1 == sum(gradkernel.variants.values())
    ref = gradkernel.render_vjp(scene, cam, cfg, ct, p2_refill=False, **kw)
    assert torch.equal(got[0], img) and torch.equal(ref[0], img)
    errs = _vjp_errors(got, ref)
    assert max(errs.values()) <= 3e-5, errs
    return got, ct


@needs_card
@pytest.mark.parametrize("case", ["brute", "bvh", "walk", "vis_w"])
def test_refill_matches_per_sample_and_plain(case):
    """K3's windowed refill against its per-sample pass (3e-5) and against
    the plain version (1e-3, as test_vjp_kernel_matches_plain), brute,
    over the flat sweep, over the walk and with silhouette terms."""
    cfg = RenderConfig(width=96, height=48, spp=3, depth=5,
                       rng_mode="parallel")
    scene, cam, bvh, vis_w = _refill_case(case, cfg)
    got, ct = _refill_vs_per_sample(scene, cam, cfg, bvh, vis_w)
    want = gradkernel.render_vjp_plain(scene, cam, cfg, ct, vis_w, bvh)
    errs = _vjp_errors(got, want)
    assert max(errs.values()) <= 1e-3, errs


@needs_card
@pytest.mark.parametrize("force", ["window", "hops", "both"])
def test_refill_parks_and_hops(monkeypatch, force):
    """A window of depth steps (REFILL_BUDGET 0: every lane parks after
    each sample and the next window resumes it) and lanes that hop over 9
    pixels each (a lane cap of 512): still the per-sample pass's
    cotangents, untaped and replaying a full and a partial tape."""
    cfg = RenderConfig(width=96, height=48, spp=4, depth=5,
                       rng_mode="parallel")
    scene, cam, bvh = _bvh_world(cfg)
    if force in ("window", "both"):
        monkeypatch.setattr(gradkernel, "REFILL_BUDGET", 0)
    if force in ("hops", "both"):
        monkeypatch.setattr(gradkernel, "refill_lanes",
                            lambda device, shmem=0: 512)
    plan = gradkernel.refill_plan(cfg, cfg.height,
                                  gradkernel.refill_lanes("cuda"))
    assert (plan["window"] == cfg.depth) == (force != "hops")
    assert (plan["hops"] == 9) == (force != "window")
    _refill_vs_per_sample(scene, cam, cfg, bvh, 0.0)
    full = cfg.spp * cfg.depth
    _, tape = gradkernel.render_tape_fwd(scene, cam, cfg, full, bvh)
    for g_cap in (full, cfg.depth + 3):
        _refill_vs_per_sample(scene, cam, cfg, bvh, 0.0,
                              tape[:g_cap].contiguous())


@needs_card
def test_refill_slabs_stitch_to_the_frame():
    """K3's refill on uneven slabs and one past the frame: each slab's
    image the given rows (0 past the frame) and the slab sums, added in
    f64, the full frame's within 1e-6 of each leaf's largest."""
    cfg = RenderConfig(width=96, height=45, spp=2, depth=5,
                       rng_mode="parallel")
    h = cfg.height
    scene, cam, bvh = _bvh_world(cfg)
    full = rt.render(scene, cam, cfg, bvh=bvh)
    ct = 2.0 * (full - 0.5) / full.numel()
    cp = megakernel.pack_camera(cam)
    sp = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))

    def sums(out):  # K3's f64 sums, before the cast to f32, as one row
        return torch.cat([out[1].reshape(-1), out[2]])

    _reset_counts()
    want, total = sums(gradkernel.launch(cp, sp, cfg, ct, full, 0.0, bvh)), 0.0
    assert gradkernel.variants["K3/bvh+refill"] == 1
    for row0, rows in _SLABS:
        live = max(0, min(rows, h - row0))
        ct_s = torch.ones((rows, cfg.width, 3), device="cuda")  # past: ignored
        img_s = torch.ones((rows, cfg.width, 3), device="cuda")
        ct_s[:live] = ct[row0:row0 + live]
        img_s[:live] = full[row0:row0 + live]
        got = gradkernel.launch(cp, sp, cfg, ct_s, img_s, 0.0, bvh,
                                row0=row0, rows=rows)
        assert torch.equal(got[0][:live], full[row0:row0 + live])
        assert not bool(got[0][live:].any())
        total = total + sums(got)
    assert gradkernel.variants["K3/bvh+refill+slab"] == len(_SLABS)
    n = int(bvh.perm.shape[0])
    i = 0
    for size in (3 * n, n, 3 * n, n, 3, 3, 3, 3, 6):
        a, b = total[i:i + size], want[i:i + size]
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1e-12), i
        i += size


_FLAT_CASES = ("frame", "k2_from_s0", "k4_tape", "slab_past_frame")


def _refill_vs_plain(scene, cam, cfg, bvh, case):
    """One case of the refill's forward over a BVH (the flat sweep or the
    walk) against the plain versions on the same CUDA tensors, bit for bit
    (see test_flat_refill_bit_equal_plain), with the launches by variant;
    the census kernel K1' against the plain census -> its warp census."""
    tag = megakernel.sweep_tag(bvh)
    cp = megakernel.pack_camera(cam)
    sp = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))
    row0, rows = (30, 16) if case == "slab_past_frame" else (0, None)
    g = cfg.spp * cfg.depth
    _reset_counts()
    if case in ("frame", "slab_past_frame"):
        got = megakernel.launch(cp, sp, cfg, bvh, row0=row0, rows=rows)
        assert torch.equal(got, golden.render_golden(scene, cam, cfg, bvh,
                                                     row0=row0, rows=rows))
    if case in ("k2_from_s0", "slab_past_frame"):
        st = progressive.init_state(cfg, device="cuda")
        s0 = 0
        if case == "k2_from_s0":
            s0 = 2
            st = progressive.accumulate(scene, cam, cfg, st, s0,
                                        backend="golden", bvh=bvh)
        acc, seed = (shard.slab_of(st.acc, row0, rows or cfg.height),
                     shard.slab_of(st.seed, row0, rows or cfg.height))
        got = megakernel.accumulate(scene, cam, cfg, acc, seed, s0, 3, bvh,
                                    row0, rows)
        want = golden.accumulate_golden(scene, cam, cfg, acc, seed, s0, 3,
                                        bvh, row0, rows)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case in ("k4_tape", "slab_past_frame"):
        tape = torch.full((g, (rows or cfg.height) * cfg.width),
                          golden.TAPE_UNWRITTEN,
                          dtype=golden.tape_dtype(sp.shape[1]),
                          device="cuda")
        img = megakernel.launch(cp, sp, cfg, bvh, tape=tape, row0=row0,
                                rows=rows)
        pimg, ptape = golden.render_golden_tape(scene, cam, cfg, g, bvh,
                                                row0, rows)
        assert torch.equal(img, pimg) and torch.equal(tape, ptape)
    want_launches = {
        "frame": {{"bvh": "K1c", "walk": "K1d"}[tag]: 1},
        "k2_from_s0": {f"K2/{tag}": 1}, "k4_tape": {f"K4/{tag}": 1},
        "slab_past_frame": {f"K1b/{tag}": 1, f"K2/{tag}+slab": 1,
                            f"K4/{tag}+slab": 1}}[case]
    assert {k: v for k, v in megakernel.variants.items() if v} == \
        want_launches
    c = megakernel.warp_census(cp, sp, cfg, bvh, row0, rows)
    plain = dict.fromkeys(golden.CENSUS, 0)
    golden.render_golden(scene, cam, cfg, bvh, census=plain, row0=row0,
                         rows=rows)
    assert [c[k] for k in golden.CENSUS] == [plain[k] for k in golden.CENSUS]
    assert 0.0 < c["loop_efficiency"] <= 1.0
    assert 0.0 < c["sweep_efficiency"] <= 1.0
    return c


@needs_card
@pytest.mark.parametrize("case", _FLAT_CASES)
@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_flat_refill_bit_equal_plain(rng_mode, case):
    """The flat sweep's forward (one loop of bounce steps a thread, each
    sample refilled in place; the sweep staged in shared memory, a warp's
    leaves swept together) against the plain versions on the same CUDA
    tensors, bit for bit: the frame (K1c), a K2 batch from s0 > 0 (sums and
    seeds), the taping forward (image and every tape slot) and a slab whose
    last rows lie past the frame (K1b, K2 and K4 on it).  Diffuse, metal
    and glass spheres at depth 4: lanes of a warp end their samples at
    different steps, many at the depth cap.  The census kernel K1' counts
    the plain census's leaves, steps and samples, and its warp counters no
    fewer iterations than the busiest lane's share."""
    cfg = RenderConfig(width=96, height=40, spp=3, depth=4,
                       rng_mode=rng_mode)
    scene, cam, bvh = _bvh_world(cfg)
    assert tbvh.sweep_of(bvh) == "flat" and bvh.n_outliers == 1
    assert {0, 1, 2} <= set(scene.mat_type.tolist())
    _refill_vs_plain(scene, cam, cfg, bvh, case)


@needs_card
@pytest.mark.parametrize("case", _FLAT_CASES)
@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
def test_walk_refill_bit_equal_plain(padded, rng_mode, case):
    """The walk's forward on the refill (K1d, K1b/walk, K2/walk, K4/walk:
    16-byte node and sphere rows, each lane walking to its next entered
    leaf, the warp's leaves swept together) against the plain
    versions on the same CUDA tensors, bit for bit, as the flat sweep's
    (test_flat_refill_bit_equal_plain), padded (8 copies, one outlier) and
    unpadded (one copy, leaves of up to 7 spheres, not all full); the census
    kernel K1'/walk counts the plain census's four counts, nodes visited
    included, and its node loop no fewer iterations than a lane's share."""
    cfg = RenderConfig(width=96, height=40, spp=3, depth=4,
                       rng_mode=rng_mode)
    scene = rt.final_world(n=300, device="cuda")
    bvh = tbvh.build_bvh(scene, leaf_size=4 if padded else 7,
                         pad_leaves=padded)
    assert tbvh.sweep_of(bvh) == "walk"
    c = _refill_vs_plain(scene, _cam(cfg), cfg, bvh, case)
    assert 0.0 < c["walk_efficiency"] <= 1.0
    assert c["lane_sphere_tests"] <= 32 * c["warp_sphere_tests"]


@needs_card
@pytest.mark.parametrize("n,leaf,sweep", [
    (16000, 256, None),   # raytpu's rule: 63 leaves, 11 not staged
    (8000, 4, "flat"),    # forced: 2000 leaves, their boxes not staged
], ids=["leaves_past_limit", "boxes_past_limit"])
def test_flat_partial_stage_bit_equal_plain(n, leaf, sweep):
    """A flat BVH whose sweep operands outgrow a block's shared memory:
    the kernel reads what it could not stage (leaf rows from the scene
    pack, boxes from bvh.flat) with the same arithmetic, so its image
    equals the plain version's and the walk's bit for bit, and its census
    the plain census."""
    cfg = RenderConfig(width=48, height=24, spp=2, depth=4,
                       rng_mode="parallel")
    scene = rt.final_world(n=n, device="cuda")
    cam = _cam(cfg)
    bvh = tbvh.build_bvh(scene, leaf_size=leaf)
    if sweep is not None:
        bvh = tbvh.with_sweep(bvh, sweep)
    st = megakernel.flat_stage_on(bvh, "cuda")
    assert st["bytes"] <= megakernel.flat_device("cuda")[0]
    assert st["leaves"] < bvh.n_leaves or st["boxes"] == 0
    cp = megakernel.pack_camera(cam)
    sp = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))
    _reset_counts()
    got = megakernel.launch(cp, sp, cfg, bvh)
    assert megakernel.variants["K1c"] == 1
    assert torch.equal(got, golden.render_golden(scene, cam, cfg, bvh))
    assert torch.equal(got, megakernel.launch(
        cp, sp, cfg, tbvh.with_sweep(bvh, "walk")))
    c = megakernel.warp_census(cp, sp, cfg, bvh)
    plain = dict.fromkeys(golden.CENSUS, 0)
    golden.render_golden(scene, cam, cfg, bvh, census=plain)
    assert [c[k] for k in golden.CENSUS] == [plain[k] for k in golden.CENSUS]


def _nothing_staged(monkeypatch):
    """K3's stage limit forced to 0 inside a test: every row read from the
    scene pack, where the sweep read them before K3 staged any."""
    limits = gradkernel.device_limits("cuda")
    monkeypatch.setattr(gradkernel, "device_limits",
                        lambda device: (*limits[:4], limits[0]))


@needs_card
@pytest.mark.parametrize("rng_mode,p2_refill", [
    ("sequential", None), ("parallel", False), ("parallel", None)],
    ids=["sequential", "parallel_per_sample", "parallel_refill"])
def test_k3_partial_stage_bit_equal_unstaged(monkeypatch, rng_mode,
                                             p2_refill):
    """K3 over a flat BVH that stages only part of itself
    (final_world(n=4000) at leaf 64: 63 leaves, 83 KB, past what keeps two
    blocks an SM resident beside the refill's cam_sh) against the same
    launch with nothing staged: image and f32 cotangents bit for bit (the
    refill's lanes are the same), untaped and, in parallel RNG, replaying a
    full and a partial tape; and against its plain version (1e-3)."""
    cfg = RenderConfig(width=64, height=32, spp=2, depth=4,
                       rng_mode=rng_mode)
    scene, cam, bvh = _bvh_world(cfg, n=4000, leaf=64)
    st = gradkernel.k3_stage(bvh, "cuda")
    assert tbvh.sweep_of(bvh) == "flat"
    assert 0 < st["leaves"] < bvh.n_leaves and st["boxes"] > 0
    assert gradkernel.refill_lanes("cuda", st["bytes"]) == \
        gradkernel.refill_lanes("cuda", 0)
    img = rt.render(scene, cam, cfg, bvh=bvh)
    ct = 2.0 * (img - 0.5) / img.numel()
    given = img if rng_mode == "parallel" else None
    tapes = [None]
    if rng_mode == "parallel":
        full = cfg.spp * cfg.depth
        tapes += [gradkernel.render_tape_fwd(scene, cam, cfg, g, bvh)[1]
                  for g in (full, cfg.depth + 3)]

    def runs():
        out = []
        for tape in tapes:
            _reset_counts()
            out.append(_grads(gradkernel.render_vjp(
                scene, cam, cfg, ct, img=given, bvh=bvh, tape=tape,
                tape_partial=tape is not None
                and tape.shape[0] < cfg.spp * cfg.depth,
                p2_refill=p2_refill)))
            assert gradkernel.variants[gradkernel._variant(
                "bvh", gradkernel.uses_refill(cfg, given, p2_refill),
                tape is not None, False)] == 1
        return out

    staged = runs()
    _nothing_staged(monkeypatch)
    assert gradkernel.k3_stage(bvh, "cuda")["bytes"] == 0
    for got, want in zip(staged, runs()):
        assert torch.equal(got[0], img)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    plain = gradkernel.render_vjp_plain(scene, cam, cfg, ct, 0.0, bvh)
    got = gradkernel.render_vjp(scene, cam, cfg, ct, img=given, bvh=bvh,
                                p2_refill=p2_refill)
    errs = _vjp_errors(got, plain)
    assert max(errs.values()) <= 1e-3, errs


def _near_miss_world(case):
    """(scene, camera) of a near-miss case: "all_miss", eight spheres in
    mirrored pairs around the view, every primary ray a miss with a near
    miss; "none_miss", one sphere filling the view (four more behind the
    camera), every primary ray a hit."""
    if case == "none_miss":
        scene = rt.make_scene(
            [((0.0, 0.0, -105.0), 100.0, 0, (0.5, 0.5, 0.5), 0.0)]
            + [((x, 0.0, 10.0), 0.5, 0, (0.5, 0.5, 0.5), 0.0)
               for x in (-3.0, -1.0, 1.0, 3.0)], device="cuda")
    else:
        scene = rt.make_scene(
            [((sx * x, y, -12.0), 1.0, m, (0.6, 0.4, 0.3), 0.2)
             for x, y, m in ((5.5, 0.0, 0), (5.6, 1.6, 1), (1.5, 3.4, 2),
                             (4.0, -3.4, 0)) for sx in (1.0, -1.0)],
            device="cuda")
    cam = rt.make_camera((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), vfov=20.0,
                         aspect=2.0, device="cuda")
    return scene, cam


@needs_card
@pytest.mark.parametrize("case", ["all_miss", "none_miss"])
@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_k3_near_miss_warp_all_or_no_lanes(case, rng_mode):
    """The warp-wide near-miss sweep where every lane of a warp misses at
    its first step (all 32 take their turn; the spheres lie just outside
    the view, so with vis_w 0.05 the coverage terms are well above 0) and
    where none does (depth 1, every ray a hit: the sweep takes no turn):
    brute and over a flat BVH, on the per-sample pass and the refill,
    against the plain version (1e-3), the refill against the per-sample
    pass (3e-5), images bit for bit."""
    cfg = RenderConfig(width=64, height=32, spp=2,
                       depth=1 if case == "none_miss" else 3,
                       rng_mode=rng_mode)
    scene, cam = _near_miss_world(case)
    target, vis_w = 0.3, 0.05
    for bvh in (None, tbvh.build_bvh(scene, leaf_size=4)):
        img = rt.render(scene, cam, cfg, bvh=bvh)
        c = profiling.census(scene, cam, cfg, bvh)
        assert c["bounce_steps"] == c["samples"]  # one step a sample
        if case == "all_miss":  # the sky everywhere
            assert float(img.min()) > 0.0
        else:  # every ray a hit, black at the depth cap
            assert not bool(img.any())
        ct = 2.0 * (img - target) / img.numel()
        want = gradkernel.render_vjp_plain(scene, cam, cfg, ct, vis_w, bvh)
        got = gradkernel.render_vjp(scene, cam, cfg, ct, vis_w=vis_w,
                                    bvh=bvh)
        assert torch.equal(got[0], img)
        errs = _vjp_errors(got, want)
        assert max(errs.values()) <= 1e-3, errs
        if case == "all_miss":  # the boundary terms are there
            assert float(got[1].center.abs().max()) > 1e-5
        if rng_mode == "parallel":
            _refill_vs_per_sample(scene, cam, cfg, bvh, vis_w)


@needs_card
@pytest.mark.parametrize("p2_refill", [False, None],
                         ids=["per_sample", "refill"])
def test_k3_vis_w_slabs_stitch_over_flat_bvh(p2_refill):
    """K3 with silhouette terms over a flat BVH on uneven slabs and one past
    the frame, parallel RNG: each slab's image the given rows and its f64
    sums, added, the full frame's within 1e-6 of each leaf's largest; the
    full frame against its plain version (1e-3)."""
    cfg = RenderConfig(width=96, height=45, spp=2, depth=4,
                       rng_mode="parallel")
    scene, cam, bvh = _bvh_world(cfg)
    full = rt.render(scene, cam, cfg, bvh=bvh)
    ct = 2.0 * (full - 0.5) / full.numel()
    cp = megakernel.pack_camera(cam)
    sp = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))

    def sums(out):
        return torch.cat([out[1].reshape(-1), out[2]])

    want = sums(gradkernel.launch(cp, sp, cfg, ct, full, 0.005, bvh,
                                  p2_refill=p2_refill))
    total = 0.0
    for row0, rows in _SLABS:
        live = max(0, min(rows, cfg.height - row0))
        ct_s = torch.ones((rows, cfg.width, 3), device="cuda")
        img_s = torch.ones((rows, cfg.width, 3), device="cuda")
        ct_s[:live] = ct[row0:row0 + live]
        img_s[:live] = full[row0:row0 + live]
        got = gradkernel.launch(cp, sp, cfg, ct_s, img_s, 0.005, bvh,
                                row0=row0, rows=rows, p2_refill=p2_refill)
        assert torch.equal(got[0][:live], full[row0:row0 + live])
        total = total + sums(got)
    n, i = int(bvh.perm.shape[0]), 0
    for size in (3 * n, n, 3 * n, n, 3, 3, 3, 3, 6):
        a, b = total[i:i + size], want[i:i + size]
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1e-12), i
        i += size
    got = gradkernel.render_vjp(scene, cam, cfg, ct, img=full, vis_w=0.005,
                                bvh=bvh, p2_refill=p2_refill)
    errs = _vjp_errors(got, gradkernel.render_vjp_plain(scene, cam, cfg, ct,
                                                        0.005, bvh))
    assert max(errs.values()) <= 1e-3, errs
