"""The check fails what it must: a run whose timed path is broken
underneath, and the low-precision control in the program's place, come
out not correct; a sound run comes out correct.  CPU tensors run the
program's plain versions, at the tiny sizes of conftest.py; everything of
a run but its look for a card is driven."""

import torch

import raytpu_torch
from raytpu_torch import shard
from raytpu_torch.kernels import gradkernel
from rtbench import control, core

from conftest import run_tiny, tiny_cell


def _altered_image(orig):
    def render(*a, **kw):
        img = orig(*a, **kw)
        img[..., 0] += 0.01
        return img
    return render


def _half_samples(orig):
    def render(scene, cam, cfg, *a, **kw):
        return orig(scene, cam, cfg.replace(spp=cfg.spp // 2), *a, **kw)
    return render


def test_frames_sound_run_is_correct():
    out = run_tiny(tiny_cell("ref_v2.frames"))
    assert out.correct and out.attempted > 0 and out.failed == 0
    assert out.checks["px_off_share"][0] == 0.0


def test_frames_answer_altered(monkeypatch):
    monkeypatch.setattr(raytpu_torch, "render",
                        _altered_image(raytpu_torch.render))
    assert not run_tiny(tiny_cell("ref_v2.frames")).correct


def test_frames_half_the_samples_left_out(monkeypatch):
    monkeypatch.setattr(raytpu_torch, "render",
                        _half_samples(raytpu_torch.render))
    assert not run_tiny(tiny_cell("final500.frames")).correct


def test_fit_sound_run_is_correct():
    out = run_tiny(tiny_cell("final500.fit"))
    assert out.correct and out.attempted > 0 and out.failed == 0


def test_fit_state_unchanged(monkeypatch):
    orig = shard.TrainStep.__call__

    def unchanged(self, scene, cam, target):
        _, _, loss = orig(self, scene, cam, target)
        return scene, cam, loss
    monkeypatch.setattr(shard.TrainStep, "__call__", unchanged)
    out = run_tiny(tiny_cell("final500.fit"))
    assert not out.correct
    assert out.checks["change_gap"][0] > out.checks["change_gap"][1]


def test_fit_half_the_batch_left_out(monkeypatch):
    orig = shard.make_train_step

    def half(cfg, **kw):
        # half of each slab's rows, the mean over the rest: the loss and
        # the step twice the half's
        kw["lr"] = 2 * kw["lr"]
        step = orig(cfg, **kw)
        step.rows //= 2
        call = step.__call__

        class Half:
            row0, rows = step.row0, step.rows

            def __call__(self, scene, cam, target):
                s, c, loss = call(scene, cam, target)
                self.last_image = step.last_image
                self.last_grads = tuple(type(g)(*(
                    None if x is None else 2 * x for x in g))
                    for g in step.last_grads)
                return s, c, 2 * loss
        return Half()
    monkeypatch.setattr(shard, "make_train_step", half)
    assert not run_tiny(tiny_cell("final500.fit")).correct


def test_fit_answer_altered(monkeypatch):
    orig = gradkernel.render_tape_fwd

    def altered(*a, **kw):
        img, tape = orig(*a, **kw)
        return img + 0.01, tape
    monkeypatch.setattr(gradkernel, "render_tape_fwd", altered)
    assert not run_tiny(tiny_cell("final500.fit")).correct


def _no_exchange():
    shard.TrainStep._reduce = lambda self, loss: None


def test_fit4_sound_run_is_correct():
    cell = tiny_cell("final500.fit4", chips=2)
    out = run_tiny(cell, trace=True)
    assert out.correct and out.run.world == 2 and len(out.run.traces) == 2
    line = core.result(cell, out, True, {"platform": "cpu"})
    assert {"host_ms.fit4", "mfu.fit4"} <= set(line["metrics"])


def test_fit4_exchange_left_out(monkeypatch):
    monkeypatch.setattr(shard.TrainStep, "_reduce",
                        lambda self, loss: None)
    out = run_tiny(tiny_cell("final500.fit4", chips=2),
                   prepare=_no_exchange)
    assert not out.correct
    assert out.checks["loss_gap"][0] > out.checks["loss_gap"][1]


def _fails(cell, numbers) -> bool:
    return any(not v <= cell.limits[k] for k, v in numbers.items())


def test_control_fails_frames():
    cell = tiny_cell("ref_v2.frames")
    assert _fails(cell, control.frames_control(cell, 5, 10,
                                               torch.device("cpu")))


def test_control_fails_fit():
    cell = tiny_cell("final500.fit")
    assert _fails(cell, control.fit_control(cell, 5, torch.device("cpu")))
