"""raytpu_torch.rng against raytpu.rng on the same u32 states.

Integer streams (hashes, states, the 31- and 24-bit draws) must be
bit-exact: they are integer arithmetic plus an exact int -> f32 conversion.
The disk and sphere samples go through sqrt/sin/cos/exp/log, which XLA's
CPU backend and torch's CPU kernels implement differently (within ~1 ulp),
so those are compared with rtol 1e-6, atol 1e-7.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytpu import rng as jr
from raytpu_torch import rng as tr

_RS = np.random.default_rng(1234)
STATES = np.concatenate([
    np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint64),
    _RS.integers(0, 2**32, 4096, dtype=np.uint64)]).astype(np.uint32)
KS = _RS.integers(0, 2**32, STATES.size, dtype=np.uint64).astype(np.uint32)
KS[:2] = [0, 2**32 - 1]


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def _u32(x):
    return x.numpy().astype(np.uint32)


def test_u32_carrier_accepts_uint32_and_int32():
    want = _t(STATES)
    assert torch.equal(tr.u32(torch.from_numpy(STATES)), want)
    assert torch.equal(tr.u32(torch.from_numpy(STATES.view(np.int32))), want)


def test_base_hash_bit_exact():
    px = _RS.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    py = _RS.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    px[:2], py[:2] = [0, 2**32 - 1], [2**32 - 1, 0]
    want = np.asarray(jr.base_hash(jnp.asarray(px), jnp.asarray(py)))
    np.testing.assert_array_equal(_u32(tr.base_hash(_t(px), _t(py))), want)
    # small pixel coordinates, as the renderers pass them
    gx, gy = np.meshgrid(np.arange(64), np.arange(36))
    want = np.asarray(jr.pixel_seed(jnp.asarray(gx), jnp.asarray(gy)))
    got = tr.pixel_seed(torch.from_numpy(gx), torch.from_numpy(gy))
    np.testing.assert_array_equal(_u32(got), want)


def test_fmix32_bit_exact():
    want = np.asarray(jr.fmix32(jnp.asarray(STATES)))
    np.testing.assert_array_equal(_u32(tr.fmix32(_t(STATES))), want)


def test_fold_in_bit_exact():
    want = np.asarray(jr.fold_in(jnp.asarray(STATES), jnp.asarray(KS)))
    np.testing.assert_array_equal(_u32(tr.fold_in(_t(STATES), _t(KS))), want)
    # a Python-int sample index, as the parallel RNG mode passes it
    want = np.asarray(jr.fold_in(jnp.asarray(STATES), 7))
    np.testing.assert_array_equal(_u32(tr.fold_in(_t(STATES), 7)), want)


@pytest.mark.parametrize("name", ["hash1", "hash2", "hash3"])
def test_hash_draws_and_states_bit_exact(name):
    va, sa = getattr(jr, name)(jnp.asarray(STATES))
    vb, sb = getattr(tr, name)(_t(STATES))
    np.testing.assert_array_equal(_u32(sb), np.asarray(sa))
    va = va if isinstance(va, tuple) else (va,)
    vb = vb if isinstance(vb, tuple) else (vb,)
    assert len(va) == len(vb)
    for x, y in zip(va, vb):
        assert y.dtype == torch.float32
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


@pytest.mark.parametrize("name", ["random_in_unit_disk",
                                  "random_in_unit_sphere"])
def test_samples_allclose(name):
    va, sa = getattr(jr, name)(jnp.asarray(STATES))
    vb, sb = getattr(tr, name)(_t(STATES))
    np.testing.assert_array_equal(_u32(sb), np.asarray(sa))
    for x, y in zip(va, vb):
        np.testing.assert_allclose(y.numpy(), np.asarray(x),
                                   rtol=1e-6, atol=1e-7)
    r2 = sum(y.double() ** 2 for y in vb)
    assert float(r2.max()) <= 1.0 + 1e-6


def test_draw_chain_bit_exact():
    """Eight chained hash3 advances (a path's worth of scatters)."""
    sa, sb = jnp.asarray(STATES), _t(STATES)
    for _ in range(8):
        (a, _, _), sa = jr.hash3(sa)
        (b, _, _), sb = tr.hash3(sb)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(_u32(sb), np.asarray(sa))
