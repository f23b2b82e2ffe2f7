"""The dense stage K1e on the CPU: its policy against raytpu's
``_use_dense``, the wrapper's routing and naming of a launch, the brute
sweep's staged bytes, and its plain version (``golden.hit_world``'s pixels
x spheres min / argmin) against raytpu's dense MXU stage in interpret
mode.

K1e (the brute sweep's kernel) runs only on a card
(tests/test_torch_cuda_kernel.py holds it against the golden bit for
bit).  Tolerance against raytpu: the
budget tests/test_torch_golden.py holds the port's golden to (|d| <= 3e-4
on at least 99% of pixels).
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

import raytpu
from raytpu.config import RenderConfig as JConfig
from raytpu.kernels import megakernel as jmk
import raytpu_torch as rt
from raytpu_torch import convert
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import gradkernel as tgk
from raytpu_torch.kernels import megakernel
from raytpu_torch.kernels import wavefront as kwf
from test_torch_gradkernel import H100_LIMITS

LOOK = ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0))


@pytest.fixture(scope="module")
def small_bvh():
    return rt.build_bvh(rt.test_world(device="cpu"), leaf_size=2)


@pytest.mark.parametrize("n", [1, 95, 96, 327, 4096, 4097])
def test_dense_policy_matches_raytpu(n, small_bvh):
    """use_dense(n, bvh) is raytpu's compiled-kernel policy
    _use_dense(n, interpret=False, has_bvh): no BVH, 96 <= n <= 4096."""
    assert megakernel.use_dense(n, None) == jmk._use_dense(n, False, False)
    assert megakernel.use_dense(n, small_bvh) == jmk._use_dense(n, False,
                                                                 True)
    assert megakernel.use_dense(n, None) == (96 <= n <= 4096)


def _record_entries(monkeypatch, calls: list) -> None:
    """Replace the forward's and K3's C entry points by recorders: a
    forward appends (census given, its pixel counter's address), K3 ("vjp",
    its sphere count, which picks the brute sweep's form).  No card here,
    so the device and stream are stubbed too."""
    def fwd(*args):
        calls.append((args[18] is not None, args[23]))
        return 0

    def vjp(*args):
        calls.append(("vjp", args[2]))
        return 0

    monkeypatch.setattr(megakernel, "check_packs", lambda cp, sp: None)
    monkeypatch.setattr(megakernel, "check_bvh", lambda b, n, d: None)
    monkeypatch.setattr(megakernel, "flat_stage_on", lambda b, d: dict(
        leaves=0, outliers=0, boxes=0, bytes=0))
    monkeypatch.setattr(megakernel, "_lib", lambda: types.SimpleNamespace(
        raytpu_render_fwd=fwd))
    monkeypatch.setattr(tgk, "_lib", lambda: types.SimpleNamespace(
        raytpu_render_vjp=vjp, raytpu_render_vjp_warps=lambda w, r: 8))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))


def test_launch_routes_the_dense_stage(monkeypatch, small_bvh):
    """Every forward launch gets the pixel counter of its device and
    stream (its persistent grid's), one int32 kept across launches, which
    the C entry point zeroes before each.  The variant keeps raytpu's
    routing and names: a plain forward of a scene use_dense takes counts as
    K1e (K1b/dense on a slab), the other plain forwards as K1a, the census
    as K1'/brute, the taping forward as K4/brute, K2 as K2/brute;
    ``warp_census`` counts K1'/dense for a dense scene and K1'/brute for 4
    and 4097 spheres.  (Whether the brute sweep stages its rows the C entry
    point decides by the sphere count: test_brute_stage_bytes.)"""
    calls = []
    _record_entries(monkeypatch, calls)
    cfg = RenderConfig(width=8, height=4, spp=1, depth=2)
    cp = torch.zeros(megakernel.CAM_PACK)
    counter = megakernel.slot_counter(torch.device("cpu"), 0)
    assert counter.dtype == torch.int32 and counter.tolist() == [0]
    at = counter.data_ptr()

    def routed(n, launch=megakernel.launch, *args, **kw):
        for d in megakernel.variants:
            megakernel.variants[d] = 0
        out = launch(cp, torch.zeros(megakernel.SCENE_ROWS, n), cfg, *args,
                     **kw)
        (tag,) = [k for k, v in megakernel.variants.items() if v]
        return tag, calls.pop(), out

    assert routed(327)[:2] == ("K1e", (False, at))
    assert routed(327, row0=2, rows=2)[:2] == ("K1b/dense", (False, at))
    assert routed(327, count=True)[:2] == ("K1'/brute", (True, at))
    tape = torch.zeros((2, cfg.width * cfg.height), dtype=torch.int16)
    assert routed(327, tape=tape)[:2] == ("K4/brute", (False, at))
    assert routed(327, bvh=small_bvh)[:2] == ("K1c", (False, at))
    assert routed(95)[:2] == ("K1a", (False, at))
    assert routed(4096)[:2] == ("K1e", (False, at))
    assert routed(4097)[:2] == ("K1a", (False, at))
    assert routed(4097, row0=3, rows=2)[:2] == ("K1b/brute", (False, at))
    acc = torch.zeros((cfg.height, cfg.width, 3))
    seed = torch.zeros((cfg.height, cfg.width), dtype=torch.int32)
    for n in (4, 4097):
        assert routed(n, megakernel.launch_accumulate, acc, seed, 0,
                      1)[:2] == ("K2/brute", (False, at))
    for n, tag in ((4, "K1'/brute"), (327, "K1'/dense"),
                   (4097, "K1'/brute")):
        _, call, c = routed(n, megakernel.warp_census, None)
        assert (megakernel.variants[tag], call) == (1, (True, at))
        assert set(megakernel.WARP_CENSUS) <= set(c)
        assert "loop_efficiency" in c and "sweep_efficiency" in c
    assert not calls


@pytest.mark.parametrize("n", [1, 4, 327, 4096, 4097])
def test_brute_stage_bytes(monkeypatch, n):
    """The brute sweep's stage (brute_stage_bytes): the scene's rows, 16
    bytes a sphere, up to 4096 spheres (64 KB), none past it.  Both C entry
    points get the sphere count that picks the form, K3's plan counts the
    bytes for the refill's lanes (launch_plan, from the pack's spheres),
    and every stage keeps within stage_limit of an H100's limits
    (H100_LIMITS: its shared memory, K3's blocks an SM and the refill's
    camera sums): what K3 may stage a block with two blocks an SM resident
    beside their camera sums (the card's own count: chip_smoke.py phase
    4d)."""
    want = 16 * n if n <= 4096 else 0
    assert megakernel.brute_stage_bytes(n) == want
    calls = []
    _record_entries(monkeypatch, calls)
    asked = []
    monkeypatch.setattr(tgk, "refill_lanes",
                        lambda device, shmem=0: asked.append(shmem) or 512)
    monkeypatch.setattr(tgk, "device_limits", lambda device: H100_LIMITS)
    cfg = RenderConfig(width=8, height=4, spp=1, depth=2,
                       rng_mode="parallel")
    cp, sp = torch.zeros(megakernel.CAM_PACK), torch.zeros(
        megakernel.SCENE_ROWS, n)
    megakernel.launch(cp, sp, cfg)
    ct = torch.zeros((cfg.height, cfg.width, 3))
    tgk.launch(cp, sp, cfg, ct, p2_refill=False)
    assert [c[-1] if c[0] == "vjp" else c[0] for c in calls] == [False, n]
    stage, plan = tgk.launch_plan(cfg, cfg.height, sp, None, True)
    assert stage == {"leaves": 0, "outliers": 0, "boxes": 0, "bytes": want}
    assert asked == [want]
    assert plan == tgk.refill_plan(cfg, cfg.height, 512)
    assert want <= tgk.stage_limit(*tgk.device_limits("cpu"))


def test_wavefront_takes_the_same_policy(small_bvh):
    """The segment kernels' policy: the dense stage by use_dense, else the
    sweep of the BVH (raytpu's wavefront.py:395-404)."""
    cam = rt.make_camera(*LOOK, vfov=20.0, aspect=2.0, device="cpu")
    box = torch.zeros(6)
    world = rt.random_world(device="cpu")
    assert world.count == 327
    assert kwf.prepare(world, cam, None, box).policy == "dense"
    tw = rt.test_world(device="cpu")
    assert kwf.prepare(tw, cam, None, box).policy == "brute"
    assert kwf.prepare(tw, cam, small_bvh, box).policy == "bvh"
    big = rt.final_world(n=300, device="cpu")
    walk = rt.build_bvh(big, leaf_size=4)
    assert kwf.prepare(big, cam, walk, box).policy == "walk"


def test_plain_version_matches_raytpu_dense_stage(monkeypatch):
    """K1e's plain version (the golden's brute min / argmin, render on CPU
    tensors) against raytpu's dense stage forced in interpret mode on the
    500-sphere final_world."""
    monkeypatch.setattr(jmk, "_DENSE_MODE", "1")
    cfg = RenderConfig(width=32, height=16, spp=2, depth=4)
    jcfg = JConfig(width=32, height=16, spp=2, depth=4)
    js = raytpu.final_world()
    jc = raytpu.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect)
    assert jmk._use_dense(js.count, True)
    want = np.asarray(jmk.render_pallas(js, jc, jcfg, interpret=True))
    got = rt.render(
        convert.scene_from_numpy({k: np.asarray(v) for k, v in
                                  js._asdict().items()}, "cpu"),
        convert.camera_from_numpy({k: np.asarray(v) for k, v in
                                   jc._asdict().items()}, "cpu"), cfg)
    d = np.abs(got.numpy() - want).max(axis=-1)
    assert (d > 3e-4).mean() <= 0.01, float(d.max())
