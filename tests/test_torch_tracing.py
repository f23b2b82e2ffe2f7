"""The program's spans (raytpu_torch.profiling.span) on the CPU, and on a
card where one is present.

- A ``torch.profiler`` trace of one train step (plain versions, a BVH
  scene, refit) holds ``raytpu.train_step`` once and inside it, in turn,
  ``raytpu.refit``, ``raytpu.forward``, ``raytpu.loss``, ``raytpu.vjp``
  and ``raytpu.sgd``, and ``raytpu.refit_nodes`` (the refit's interior
  pass) inside ``raytpu.refit``; a trace of ``render`` holds
  ``raytpu.render``.
- With no profiler running, ``span`` hands out one shared null context
  and a step or a render makes no ``record_function`` at all.
- Two gloo processes: each rank's ``raytpu.reduce`` lies inside its
  ``raytpu.vjp``.
- On a card, a taped step's wrappers mark ``raytpu.pack``,
  ``raytpu.launch`` (one a kernel launch) and ``raytpu.scatter``; the
  wrappers run under torch's sync debug mode "error" without raising; a
  traced train step holds no synchronising call (counted as the
  benchmark's ``host_syncs`` counts them, in a process of its own: a
  process's later traces may lose the card's events), and a step, and
  the first step over a new BVH's ``perm``, run under the mode "error".
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import raytpu_torch as rt
from raytpu_torch import bvh as tbvh, profiling, shard
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import gradkernel, megakernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RenderConfig(width=16, height=8, spp=1, depth=2, rng_mode="parallel")
STEP = ("raytpu.refit", "raytpu.forward", "raytpu.loss", "raytpu.vjp",
        "raytpu.sgd")
# the CUDA runtime's synchronising calls (rtbench/metrics/wrapper_ms.py)
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")


def _inputs(device="cpu"):
    scene = rt.final_world(n=24, device=device)
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=CFG.aspect, device=device)
    target = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (CFG.height, CFG.width, 3)).astype(np.float32)).to(device)
    return scene, cam, rt.build_bvh(scene, leaf_size=8), target


def _spans(prof) -> list:
    """(name, start us, end us) of the trace's ``raytpu.`` spans on the
    host, in order of start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith("raytpu.")
                   and e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _traced(fn, acts=(ProfilerActivity.CPU,)):
    with profile(activities=list(acts)) as prof:
        fn()
    return _spans(prof)


def test_train_step_spans_nest_in_order():
    scene, cam, bvh, target = _inputs()
    step = shard.make_train_step(CFG, bvh=bvh, refit=True)
    spans = _traced(lambda: step(scene, cam, target))
    outer = [s for s in spans if s[0] == "raytpu.train_step"]
    assert len(outer) == 1
    phases = [s for s in spans if s[0] in STEP]
    assert [s[0] for s in phases] == list(STEP)
    assert all(_inside(s, outer[0]) for s in phases)
    # one after another, none inside the one before
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))


def test_refit_nodes_inside_the_refit():
    scene, cam, bvh, target = _inputs()
    step = shard.make_train_step(CFG, bvh=bvh, refit=True)
    spans = _traced(lambda: step(scene, cam, target))
    refit, inner = ([s for s in spans if s[0] == name]
                    for name in ("raytpu.refit", "raytpu.refit_nodes"))
    assert len(refit) == 1 and len(inner) == 1
    assert _inside(inner[0], refit[0])
    fixed = shard.make_train_step(CFG, bvh=bvh, refit=False)
    spans = _traced(lambda: fixed(scene, cam, target))
    assert not [s for s in spans if s[0].startswith("raytpu.refit")]


def test_render_span():
    scene, cam, bvh, _ = _inputs()
    spans = _traced(lambda: rt.render(scene, cam, CFG, bvh=bvh))
    assert [s[0] for s in spans] == ["raytpu.render"]


def test_no_profiler_no_span(monkeypatch):
    shared = profiling.span("raytpu.render")
    assert isinstance(shared, contextlib.nullcontext)
    assert profiling.span("raytpu.sgd") is shared
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name))
    scene, cam, bvh, target = _inputs()
    shard.make_train_step(CFG, bvh=bvh)(scene, cam, target)
    rt.render(scene, cam, CFG, bvh=bvh)
    assert made == []


# One process of a gloo group: argv = rank, world, init file, output JSON,
# the repository.  It takes one train step under a CPU trace and writes
# its spans.
_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[5])
import raytpu_torch as rt
from raytpu_torch import shard
from raytpu_torch.config import RenderConfig

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
group = shard.init_distributed(device="cpu", init_method="file://" + sys.argv[3],
                               world_size=world, rank=rank)
cfg = RenderConfig(width=16, height=8, spp=1, depth=2, rng_mode="parallel")
scene = rt.final_world(n=24, device="cpu")
cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                     aspect=cfg.aspect, device="cpu")
target = torch.from_numpy(np.random.default_rng(3).uniform(
    0, 1, (8, 16, 3)).astype(np.float32))
step = shard.make_train_step(cfg, group=group,
                             bvh=rt.build_bvh(scene, leaf_size=8))
with profile(activities=[ProfilerActivity.CPU]) as prof:
    step(scene, cam, target)
spans = [(e.name, e.time_range.start, e.time_range.end)
         for e in prof.events() if e.name.startswith("raytpu.")]
with open(sys.argv[4] + f".{rank}", "w") as f:
    json.dump(spans, f)
dist.barrier()
dist.destroy_process_group()
"""


def test_gloo_reduce_inside_vjp(tmp_path):
    world = 2
    out = tmp_path / "spans.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world),
         str(tmp_path / "init"), str(out), ROOT], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=240)
        errs.append((p.returncode, err[-3000:]))
    assert all(rc == 0 for rc, _ in errs), errs
    for r in range(world):
        with open(f"{out}.{r}") as f:
            spans = [tuple(s) for s in json.load(f)]
        reduce = [s for s in spans if s[0] == "raytpu.reduce"]
        vjp = [s for s in spans if s[0] == "raytpu.vjp"]
        assert len(reduce) == 1 and len(vjp) == 1, spans
        assert _inside(reduce[0], vjp[0])


@needs_card
def test_taped_step_wrapper_spans():
    scene, cam, bvh, target = _inputs("cuda")
    assert gradkernel.tape_plan(CFG, scene.count, bvh) is not None
    step = shard.make_train_step(CFG, bvh=bvh)
    step(scene, cam, target)  # builds and loads the kernels
    torch.cuda.synchronize()
    before = sum(sum(m.variants.values()) for m in (megakernel, gradkernel))
    spans = _traced(lambda: (step(scene, cam, target),
                             torch.cuda.synchronize()),
                    (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    made = sum(sum(m.variants.values())
               for m in (megakernel, gradkernel)) - before
    assert made == 2  # K4's taping forward and K3's replay
    launch = [s for s in spans if s[0] == "raytpu.launch"]
    assert len(launch) == made
    fwd, vjp = ([s for s in spans if s[0] == name]
                for name in ("raytpu.forward", "raytpu.vjp"))
    for phase in (fwd[0], vjp[0]):
        assert sum(_inside(s, phase) for s in launch) == 1
        assert any(s[0] == "raytpu.pack" and _inside(s, phase)
                   for s in spans)
    assert [s[0] for s in spans if s[0] == "raytpu.scatter"
            and _inside(s, vjp[0])] == ["raytpu.scatter"]


@needs_card
def test_wrappers_make_no_sync():
    """The taping forward and the taped VJP on a slab over a flat BVH (its
    scatter back to input order included) and the forward render, under
    sync debug mode "error": a synchronising call would raise.  The BVH is
    new, so its perm's indices are built under the mode too."""
    scene, cam, bvh, target = _inputs("cuda")
    assert gradkernel.tape_plan(CFG, scene.count, bvh) is not None
    shard.make_train_step(CFG, bvh=bvh)(scene, cam, target)
    bvh = rt.build_bvh(scene, leaf_size=8)
    assert tbvh.sweep_of(bvh) == "flat" and bool((bvh.perm < 0).any())
    rows = CFG.height // 2
    plan = gradkernel.tape_plan(CFG, scene.count, bvh, rows=rows)
    ct = torch.ones((rows, CFG.width, 3), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, tape = gradkernel.render_tape_fwd(scene, cam, CFG,
                                               plan["g_cap"], bvh, row0=rows,
                                               rows=rows)
        _, ds, _ = gradkernel.render_vjp(
            scene, cam, CFG, ct, img=img, bvh=bvh, tape=tape,
            tape_partial=plan["partial"], row0=rows, rows=rows)
        full = megakernel.forward(scene, cam, CFG, bvh=bvh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tuple(ds.center.shape) == (scene.count, 3)
    assert bool(torch.isfinite(ds.center).all())
    assert torch.equal(img, full[rows:])


# One train step traced on a card, after one untraced, then one more and
# the first step over a new BVH under sync debug mode "error" (a
# synchronising call raises): argv = output JSON, the repository.  It
# writes the traced step's host events (name, start us, end us).
_SYNC_WORKER = r"""
import json, sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[2])
import raytpu_torch as rt
from raytpu_torch import shard
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import gradkernel

cfg = RenderConfig(width=16, height=8, spp=1, depth=2, rng_mode="parallel")
scene = rt.final_world(n=24, device="cuda")
cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                     aspect=cfg.aspect, device="cuda")
target = torch.from_numpy(np.random.default_rng(3).uniform(
    0, 1, (8, 16, 3)).astype(np.float32)).cuda()
bvh = rt.build_bvh(scene, leaf_size=8)
assert gradkernel.tape_plan(cfg, scene.count, bvh) is not None
step = shard.make_train_step(cfg, bvh=bvh)
scene, cam, _ = step(scene, cam, target)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    step(scene, cam, target)
    torch.cuda.synchronize()
host = [(e.name, e.time_range.start, e.time_range.end) for e in p.events()
        if e.device_type == torch.autograd.DeviceType.CPU]
fresh = shard.make_train_step(cfg, bvh=rt.build_bvh(scene, leaf_size=8))
torch.cuda.synchronize()
torch.cuda.set_sync_debug_mode("error")
step(scene, cam, target)
fresh(scene, cam, target)
torch.cuda.set_sync_debug_mode("default")
torch.cuda.synchronize()
with open(sys.argv[1], "w") as f:
    json.dump(host, f)
"""


@needs_card
def test_train_step_makes_no_sync(tmp_path):
    out = tmp_path / "host.json"
    run = subprocess.run([sys.executable, "-c", _SYNC_WORKER, str(out), ROOT],
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(out) as f:
        host = [tuple(h) for h in json.load(f)]
    step, refit = ([h for h in host if h[0] == name]
                   for name in ("raytpu.train_step", "raytpu.refit"))
    assert len(step) == 1 and len(refit) == 1
    calls = [h[0] for h in host if step[0][1] <= h[1] <= step[0][2]]
    assert "cudaLaunchKernel" in calls  # the trace holds the runtime's calls
    assert [c for c in calls if c in SYNCS] == []
