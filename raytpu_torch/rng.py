"""Counter-based u32 RNG (counterpart of ``raytpu/rng.py``).

The same streams as the JAX package, draw for draw: the state advances by
the golden-ratio Weyl increment and each draw is the murmur3 ``fmix32`` of
the new state; the initial state is the reference's ``baseHash`` of the
absolute pixel coordinates (ref: CSVersion/ShaderCompute.hlsl:23-66).

torch's ``uint32`` is incomplete on the CPU (``+`` and ``>>`` raise), so a
u32 state here is an **int64 tensor holding a value in [0, 2**32)**.  Every
operation masks back to 32 bits, and products are split into 16-bit halves
of the constant so no intermediate leaves int64's exact range: the result
is the u32 wraparound product, bit for bit.  The CUDA kernel computes the
same values in native ``uint32_t``.

Every function takes a state tensor of any shape and returns
``(value(s), new_state)``; per-component values are SoA tuples.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_K = 1103515245
_WEYL = 0x9E3779B9       # golden-ratio increment
_M1 = 0x85EBCA6B         # murmur3 fmix32 constants
_M2 = 0xC2B2AE35
_FOLD = 0xBB67AE85       # sqrt(3) frac: distinct from the Weyl step
_MASK31 = 0x7FFFFFFF
_INV_U24 = 1.0 / 16777216.0      # exact powers of two: f32-exact scalars
_INV_I31 = 1.0 / 2147483648.0
_TWO_PI = 6.28318530718          # rounds to the same f32 as raytpu's


def u32(x) -> torch.Tensor:
    """Any integer tensor -> the int64 carrier of its u32 value."""
    return x.to(torch.int64) & _MASK32


def _mul(a, k: int):
    """(a * k) mod 2**32 for an int64-carried u32 ``a`` and a u32 constant
    ``k``: the 16-bit halves keep every product below 2**48."""
    lo, hi = k & 0xFFFF, k >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _u31_to_f32(n):
    """[0, 1) from the low 31 bits (the int -> f32 conversion rounds to
    nearest, as raytpu's i32 -> f32 cast does)."""
    return (n & _MASK31).to(torch.float32) * _INV_I31


def base_hash(px, py):
    """The reference's integer pixel hash (ref: ShaderCompute.hlsl:23-28)."""
    px = u32(px)
    py = u32(py)
    hx = _mul((px >> 1) ^ py, _K)
    hy = _mul((py >> 1) ^ px, _K)
    h32 = _mul(hx ^ (hy >> 3), _K)
    return h32 ^ (h32 >> 16)


def fmix32(h):
    """murmur3 finalizer — full-avalanche 32-bit mix."""
    h = u32(h)
    h = h ^ (h >> 16)
    h = _mul(h, _M1)
    h = h ^ (h >> 13)
    h = _mul(h, _M2)
    return h ^ (h >> 16)


def pixel_seed(px, py):
    """Initial u32 stream state for a pixel (ref seed: hlsl:295)."""
    return base_hash(px, py)


def fold_in(state, k):
    """Derive an independent stream from ``state`` and integer ``k``: the
    "parallel" RNG mode's per-(pixel, sample) stream."""
    if not isinstance(k, torch.Tensor):
        k = torch.as_tensor(k, dtype=torch.int64, device=state.device)
    kk = (u32(k) + 1) & _MASK32
    return fmix32((u32(state) + _mul(kk, _FOLD)) & _MASK32)


def _draw(state):
    """One state advance: Weyl step + finalize. Returns (u32 draw, state')."""
    state = (u32(state) + _WEYL) & _MASK32
    return fmix32(state), state


def hash1(state):
    """Uniform f32 in [0,1) from the top 24 bits; one state advance."""
    n, state = _draw(state)
    return (n >> 8).to(torch.float32) * _INV_U24, state


def hash2(state):
    """Two uniform f32 lanes in [0,1); one advance (ref shape: hlsl:36-41)."""
    n, state = _draw(state)
    return (_u31_to_f32(n), _u31_to_f32(_mul(n, 48271))), state


def hash3(state):
    """Three uniform f32 lanes in [0,1); one advance (ref shape: hlsl:43-48)."""
    n, state = _draw(state)
    return (_u31_to_f32(n), _u31_to_f32(_mul(n, 16807)),
            _u31_to_f32(_mul(n, 48271))), state


def f32_like(x, value):
    """``value`` as an f32 0-dim tensor on ``x``'s device.  Dividing by it
    is a true f32 division on every device: a Python-scalar divisor may be
    turned into a multiply by its reciprocal, which rounds differently."""
    return torch.tensor(value, dtype=torch.float32, device=x.device)


def random_in_unit_disk(state):
    """Polar disk sample -> ((x, y), state') (ref: hlsl:50-57)."""
    (a, b), state = hash2(state)
    phi = b * _TWO_PI
    r = torch.sqrt(a)
    return (r * torch.sin(phi), r * torch.cos(phi)), state


def random_in_unit_sphere(state):
    """Cbrt-radius sphere sample -> ((x, y, z), state') (ref: hlsl:59-66).

    The cube root is ``exp(log(c) / 3)`` with a ``c == 0`` guard, as in
    raytpu (not a library cbrt, whose rounding differs)."""
    (a, b, c), state = hash3(state)
    h = a * 2.0 - 1.0  # cos-latitude in [-1, 1)
    phi = b * _TWO_PI
    r = torch.where(c > 0,
                    torch.exp(torch.log(torch.clamp(c, min=1e-30))
                              / f32_like(c, 3.0)),
                    0.0)
    s = torch.sqrt(torch.clamp(1.0 - h * h, min=0.0))
    return (r * s * torch.sin(phi), r * s * torch.cos(phi), r * h), state
