"""The dense stage K1e on the CPU: its policy against raytpu's
``_use_dense``, the wrapper's routing of a launch to it, and its plain
version (``golden.hit_world``'s pixels x spheres min / argmin) against
raytpu's dense MXU stage in interpret mode.

K1e itself runs only on a card (tests/test_torch_cuda_kernel.py holds it
against K1a and the golden bit for bit).  Tolerance against raytpu: the
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
from raytpu_torch.kernels import megakernel
from raytpu_torch.kernels import wavefront as kwf

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


def test_launch_routes_the_dense_stage(monkeypatch, small_bvh):
    """A plain forward of a scene the policy takes launches K1e (K1b/dense
    on a slab); ``brute=True`` forces K1a; the census, the taping forward,
    a BVH and scenes outside 96-4096 spheres keep their sweeps.  At the C
    entry point the dense launch gets a zeroed pixel counter (its
    persistent grid's), and ``warp_census`` sends a dense scene to the
    counting dense launch (K1'/dense), which the census keeps off.  The
    launch and then the C entry point are replaced by recorders: no card
    here."""
    calls = []
    launch_c = megakernel._launch
    monkeypatch.setattr(megakernel, "check_packs", lambda cp, sp: None)
    monkeypatch.setattr(megakernel, "check_bvh", lambda b, n, d: None)
    monkeypatch.setattr(megakernel, "_launch",
                        lambda *a, **kw: calls.append(kw["dense"]))
    cfg = RenderConfig(width=8, height=4, spp=1, depth=2)
    cp = torch.zeros(megakernel.CAM_PACK)

    def routed(n, **kw):
        for d in megakernel.variants:
            megakernel.variants[d] = 0
        megakernel.launch(cp, torch.zeros(megakernel.SCENE_ROWS, n), cfg,
                          **kw)
        (tag,) = [k for k, v in megakernel.variants.items() if v]
        return tag, calls.pop()

    assert routed(327) == ("K1e", True)
    assert routed(327, brute=True) == ("K1a", False)
    assert routed(327, row0=2, rows=2) == ("K1b/dense", True)
    assert routed(327, count=True)[1] is False
    tape = torch.zeros((2, cfg.width * cfg.height), dtype=torch.int16)
    assert routed(327, tape=tape) == ("K4/brute", False)
    assert routed(327, bvh=small_bvh) == ("K1c", False)
    assert routed(95) == ("K1a", False)
    assert routed(4097) == ("K1a", False)

    def entry(*args):
        """raytpu_render_fwd's recorder: (dense, census given, the pixel
        counter's value at the launch or None)."""
        counter = args[24]
        calls.append((args[3], args[19] is not None, None if counter is None
                      else ctypes.c_int32.from_address(counter).value))
        return 0

    monkeypatch.setattr(megakernel, "_launch", launch_c)
    monkeypatch.setattr(megakernel, "_lib", lambda: types.SimpleNamespace(
        raytpu_render_fwd=entry))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    assert routed(327) == ("K1e", (1, False, 0))
    assert routed(327, row0=2, rows=2) == ("K1b/dense", (1, False, 0))
    assert routed(327, count=True) == ("K1'/brute", (0, True, None))
    assert routed(327, brute=True) == ("K1a", (0, False, None))
    for d in megakernel.variants:
        megakernel.variants[d] = 0
    c = megakernel.warp_census(cp, torch.zeros(megakernel.SCENE_ROWS, 327),
                               cfg, None)
    assert calls.pop() == (1, True, 0)
    assert {k: v for k, v in megakernel.variants.items() if v} == {
        "K1'/dense": 1}
    assert set(megakernel.WARP_CENSUS) <= set(c) and "loop_efficiency" in c
    with pytest.raises(ValueError, match="dense"):
        megakernel.warp_census(cp, torch.zeros(megakernel.SCENE_ROWS, 95),
                               cfg, None)
    assert not calls


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
