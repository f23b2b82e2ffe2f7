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

The v1 fract-sin RNG (``rng_mode="v1_fractsin"``, raytpu/rng.py:151-242)
is :func:`fs_sin`, :func:`fs_rand2d`, :func:`fs_unit_sphere` and
:func:`fs_unit_disk`.  Its chain multiplies a sine by 43758.5453 and keeps
the fraction, so one rounding anywhere in it moves a draw by a
quantisation step and the stream then diverges.  The op order is pinned
to the one raytpu's source spells out, plain f32 mul/add: one torch op per
f32 operation, every constant an f32 0-dim tensor on the data's device, no
fused op (``addcmul``, ``lerp``, ``fmod``, ``add(alpha=)``) that a card
could contract, ``x - floor(x)`` for the fraction.  Each torch op rounds
once on the CPU and on a card alike, so both draw the same values.
raytpu itself produces this order only op by op: measured on an
x86-64 CPU, its ``fs_sin`` eager equals a numpy f32 transcription on 100%
of 200,000 arguments in [0, 92] and under ``jax.jit`` on 90.8% (XLA
contracts mul+add pairs into FMAs); its ``fs_rand2d`` jitted equals its
eager draw on 85.3% of 3000 states.  So the port is bit-equal to raytpu
run under ``jax.disable_jit()``, and meets jitted raytpu only at raytpu's
own calibrated bars (tests/test_torch_fractsin.py).  The mappings' ``acos``,
``pow``, ``sin`` and ``cos`` lie outside the chain and may round apart
by a few ulp between libraries.
"""

from __future__ import annotations

import math

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


_consts: dict = {}


def _c(x, value):
    """``value`` as a cached f32 0-dim tensor on ``x``'s device."""
    key = (value, x.device)
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = f32_like(x, value)
    return t


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


# ---- v1 fract-sin RNG (parity mode; ref: Shader_RT.fx:106-163) ----
#
# A float2 state advanced by fract(sin(dot(state, (12.9898, 78.233))) *
# 43758.5453).  The sampling helpers take the state BY VALUE (the
# reference's defect): along a v1 path only the two jitter draws advance
# it, and every bounce reuses the draws of the post-jitter state.
_FS_A = 12.9898
_FS_B = 78.233
_FS_M = 43758.5453
# three-term pi split of the pinned argument reduction, raytpu's
_PI_A = 3.140625
_PI_B = 9.6750259399414062e-4
_PI_C = 1.2154201256553420e-10
_INV_PI = 1.0 / math.pi
_S1 = -1.6666667e-1
_S2 = 8.3333310e-3
_S3 = -1.9840874e-4
_S4 = 2.7525562e-6
_THIRD = 1.0 / 3.0


def _fract(x):
    return x - torch.floor(x)


def fs_sin(x):
    """raytpu's pinned f32 sine of the fract-sin chain (x in [0, ~92]):
    round-to-nearest pi-multiple reduction with a three-term pi split,
    then an odd minimax polynomial on [-pi/2, pi/2], one f32 op at a time
    in raytpu's source order (raytpu/rng.py:163-188)."""
    n = torch.floor(x * _c(x, _INV_PI) + _c(x, 0.5))
    r = ((x - n * _c(x, _PI_A)) - n * _c(x, _PI_B)) - n * _c(x, _PI_C)
    r2 = r * r
    p = _c(x, _S4)
    p = p * r2 + _c(x, _S3)
    p = p * r2 + _c(x, _S2)
    p = p * r2 + _c(x, _S1)
    s = r + r * (r2 * p)
    # sin(n*pi + r) = (-1)^n sin(r); n is a small exact float
    two = _c(x, 2.0)
    sign = _c(x, 1.0) - two * (n - torch.floor(n * _c(x, 0.5)) * two)
    return s * sign


def fs_rand2d(sx, sy):
    """One rand2d draw (ref: Shader_RT.fx:106-112): advances the float2
    state x then y (the second sine sees the NEW x) -> (new x, (sx', sy'))."""
    a, b, m = _c(sx, _FS_A), _c(sx, _FS_B), _c(sx, _FS_M)
    sx = _fract(fs_sin(sx * a + sy * b) * m)
    sy = _fract(fs_sin(sx * a + sy * b) * m)
    return sx, (sx, sy)


def fs_unit_sphere(sx, sy):
    """v1 random_in_unit_sphere (ref: :119-133), BY VALUE: three draws
    from (sx, sy), the caller's state is not advanced -> (x, y, z), acos
    latitude and pow-1/3 radius."""
    r1, st = fs_rand2d(sx, sy)
    r2, st = fs_rand2d(*st)
    r3, _ = fs_rand2d(*st)
    phi = _c(sx, _TWO_PI) * r1
    cos_t = _c(sx, 2.0) * r2 - _c(sx, 1.0)
    theta = torch.acos(cos_t)
    r = torch.pow(r3, _c(sx, _THIRD))
    sin_t = torch.sin(theta)
    return (r * sin_t * torch.cos(phi), r * sin_t * torch.sin(phi),
            r * cos_t)


def fs_unit_disk(sx, sy):
    """v1 random_in_unit_disk (ref: :135-144), BY VALUE.  The reference's
    quirk is the spec: x = cos(cosTheta), y = cos(sinTheta), both
    'angles' uniform in [-1, 1], so the 'disk' is the square [cos 1, 1]^2."""
    r1, st = fs_rand2d(sx, sy)
    r2, _ = fs_rand2d(*st)
    two, one = _c(sx, 2.0), _c(sx, 1.0)
    sin_t = two * r1 - one
    cos_t = two * r2 - one
    return torch.cos(cos_t), torch.cos(sin_t)
