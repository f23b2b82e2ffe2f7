"""raytpu_torch.optim against raytpu.optim and optax.

Adam is written out in optax.adam's op order, so the port's updates equal
optax's to rtol 1e-6 (measured: bit-equal over these 5 steps; the budget
leaves room for ``b ** count``, a float pow rounded by two libraries).  Checkpoints share raytpu's
npz layout, so one written by either package loads in the other, and a
resumed port run is bit-identical to an uninterrupted one, as
tests/test_optim.py asserts for raytpu.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from raytpu import optim as jopt
from raytpu_torch import optim as topt
from raytpu_torch.config import RenderConfig


def _params():
    rs = np.random.default_rng(0)
    return {"a": rs.normal(size=(2, 3)).astype(np.float32),
            "b": np.float32(2.5),
            "center": rs.normal(size=3).astype(np.float32)}


def _grads(step):
    rs = np.random.default_rng(100 + step)
    return {"a": rs.normal(size=(2, 3)).astype(np.float32),
            "b": np.float32(rs.normal()),
            "center": (rs.normal(size=3) * 1e-3).astype(np.float32)}


def _torch(d):
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def _assert_tree_equal(port, ref, rtol=0.0):
    for k in ref:
        a, b = port[k].numpy(), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if rtol:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _optax_steps(params, steps, lr=0.01, state=None):
    opt = optax.adam(lr)
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(params) if state is None else state
    for i in range(steps):
        up, state = opt.update({k: jnp.asarray(v) for k, v in
                                _grads(i).items()}, state, params)
        params = optax.apply_updates(params, up)
    return params, state


def test_adam_matches_optax():
    want, want_state = _optax_steps(_params(), 5)
    opt = topt.Adam(0.01)
    params = _torch(_params())
    state = opt.init(params)
    for i in range(5):
        up, state = opt.update(_torch(_grads(i)), state)
        params = {k: params[k] + up[k] for k in params}
    _assert_tree_equal(params, want, rtol=1e-6)
    adam_state = want_state[0]
    assert int(state.count) == int(adam_state.count) == 5
    _assert_tree_equal(state.mu, adam_state.mu, rtol=1e-6)
    _assert_tree_equal(state.nu, adam_state.nu, rtol=1e-6)


def test_raytpu_checkpoint_loads_in_port(tmp_path):
    """A checkpoint written by raytpu.optim for optax.adam loads in the
    port bit for bit, and the next step agrees with optax's."""
    params, state = _optax_steps(_params(), 3)
    path = str(tmp_path / "raytpu.npz")
    jopt.save_opt_checkpoint(path, params, state, 3)
    p, s, step = topt.load_opt_checkpoint(path, _torch(_params()))
    assert step == 3 and s.count.dtype == torch.int32 and int(s.count) == 3
    _assert_tree_equal(p, params)
    _assert_tree_equal(s.mu, state[0].mu)
    _assert_tree_equal(s.nu, state[0].nu)
    # one more step on both sides
    opt = optax.adam(0.01)
    up_j, _ = opt.update({k: jnp.asarray(v) for k, v in _grads(3).items()},
                         state, params)
    up_t, _ = topt.Adam(0.01).update(_torch(_grads(3)), s)
    _assert_tree_equal({k: p[k] + up_t[k] for k in p},
                       optax.apply_updates(params, up_j), rtol=1e-6)


def test_port_checkpoint_loads_in_raytpu(tmp_path):
    opt = topt.Adam(0.01)
    params = _torch(_params())
    state = opt.init(params)
    up, state = opt.update(_torch(_grads(0)), state)
    params = {k: params[k] + up[k] for k in params}
    path = str(tmp_path / "port.npz")
    topt.save_opt_checkpoint(path, params, state, 1)
    p, s, step = jopt.load_opt_checkpoint(
        path, {k: jnp.asarray(v) for k, v in _params().items()},
        optax.adam(0.01))
    assert step == 1 and int(s[0].count) == 1
    _assert_tree_equal(params, p)
    _assert_tree_equal(state.mu, s[0].mu)
    _assert_tree_equal(state.nu, s[0].nu)


def test_load_rejects_mismatched_template(tmp_path):
    opt = topt.Adam(0.01)
    params = _torch(_params())
    path = str(tmp_path / "c.npz")
    topt.save_opt_checkpoint(path, params, opt.init(params), 0)
    with pytest.raises(ValueError, match="param leaves"):
        topt.load_opt_checkpoint(path, {"a": params["a"]})
    with pytest.raises(ValueError, match="leaf p0"):
        topt.load_opt_checkpoint(path, {**params, "a": params["a"][0]})


def test_resume_bit_matches_uninterrupted(tmp_path):
    """The config-3 problem at 32x16: 6 steps straight, or 3 steps with a
    checkpoint and a resume for the other 3, give the same centre and
    losses bit for bit."""
    cfg = RenderConfig(width=32, height=16, spp=2, depth=3)
    _, scene0, _, _, loss_fn = topt.inverse_render_problem(cfg,
                                                           device="cpu")
    p0 = {"center": scene0.center[1]}
    ckpt = str(tmp_path / "opt.npz")
    full, losses_full = topt.optimize(loss_fn, p0, steps=6, lr=0.02)
    topt.optimize(loss_fn, p0, steps=3, lr=0.02, checkpoint_path=ckpt,
                  checkpoint_every=3)
    resumed, losses_tail = topt.optimize(loss_fn, p0, steps=6, lr=0.02,
                                         checkpoint_path=ckpt, resume=True)
    assert torch.equal(full["center"], resumed["center"])
    assert losses_full[3:] == losses_tail
    assert not torch.equal(full["center"], p0["center"])
