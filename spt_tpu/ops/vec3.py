"""Component-SoA 3-vectors: the path state's vector layout.

A `(N, 3)` array puts the 3 components on the minor dimension, so every
dot/cross becomes a strided reduction over a width-3 axis.  `Vec3` stores
x/y/z as three independent `(N,)` arrays, so every vector op is a handful
of full-width elementwise ops that XLA fuses freely — the reference's
planned SoA path state (wf_types.h:4-5 "POD path state designed for CUDA
port").  Whether it beats an AoS float3 layout on a given GPU is a
measurement.

`Vec3` is a NamedTuple, hence a pytree: it threads through jit, while_loop,
shard_map, and compaction gather/scatter without special handling.
Operators are overloaded (`+`, `-`, `*`, `/`, unary `-`); `*` means
componentwise for Vec3*Vec3 and broadcast-scale for Vec3*(N,).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp
import numpy as np

Scalar = Union[float, jnp.ndarray]


class Vec3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # --- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # --- conversions --------------------------------------------------------
    @staticmethod
    def from_array(a) -> "Vec3":
        """(…, 3) array -> Vec3 of (…,) components."""
        a = jnp.asarray(a)
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def full(v, shape=(), dtype=jnp.float32) -> "Vec3":
        """Constant vector broadcast to `shape` lanes."""
        v = np.asarray(v, np.float32)
        return Vec3(
            jnp.full(shape, v[0], dtype),
            jnp.full(shape, v[1], dtype),
            jnp.full(shape, v[2], dtype),
        )

    def to_array(self) -> jnp.ndarray:
        """Vec3 -> (…, 3) (boundary use only: accumulation/image output)."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    @property
    def shape(self):
        return jnp.shape(self.x)


# --- core ops (free functions so they fuse obviously) -------------------------

def dot(a: Vec3, b: Vec3) -> jnp.ndarray:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length2(v: Vec3) -> jnp.ndarray:
    return dot(v, v)


def length(v: Vec3) -> jnp.ndarray:
    return jnp.sqrt(length2(v))


def max_component(v: Vec3) -> jnp.ndarray:
    return jnp.maximum(v.x, jnp.maximum(v.y, v.z))


def safe_normalize(v: Vec3) -> Vec3:
    """Zero vectors stay zero (wf_math.h:28-33).

    Gradient-safe: the untaken branch's primal is pinned to 1.0 so its
    (zero) cotangent never multiplies rsqrt'(1e-30) ~ 1e45, which overflows
    f32 and turns 0 * inf into NaN under jax.grad (the differentiable
    megakernel path)."""
    l2 = length2(v)
    ok = l2 > 0.0
    inv = jnp.where(ok, jax_rsqrt(jnp.where(ok, l2, 1.0)), 0.0)
    return v * inv


def normalize_or(v: Vec3, fallback: Vec3) -> Vec3:
    """Degenerate vectors fall back (device_programs.cu:441-451 pattern).
    Gradient-safe like safe_normalize."""
    l2 = length2(v)
    ok = l2 > 0.0
    inv = jax_rsqrt(jnp.where(ok, l2, 1.0))
    return where(ok, v * inv, fallback)


def jax_rsqrt(x: jnp.ndarray) -> jnp.ndarray:
    import jax.lax

    return jax.lax.rsqrt(x)


def where(mask: jnp.ndarray, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def reflect(i: Vec3, n: Vec3) -> Vec3:
    return i - n * (2.0 * dot(i, n))


def refract(i: Vec3, n: Vec3, eta: jnp.ndarray):
    """Snell refraction; returns (dir, can_refract) (wf_math.h:82-91)."""
    cosi = jnp.clip(-dot(n, i), -1.0, 1.0)
    sin2t = eta * eta * jnp.maximum(0.0, 1.0 - cosi * cosi)
    can = sin2t <= 1.0
    # gradient-safe sqrt (see math3d.safe_sqrt): TIR lanes (sin2t >= 1)
    # are masked downstream, and sqrt'(0) = inf would NaN their cotangents
    tpos = sin2t < 1.0
    cost = jnp.where(tpos, jnp.sqrt(jnp.where(tpos, 1.0 - sin2t, 1.0)), 0.0)
    t = i * eta + n * (eta * cosi - cost)
    t = safe_normalize(t)
    zero = Vec3(jnp.zeros_like(t.x), jnp.zeros_like(t.y), jnp.zeros_like(t.z))
    return where(can, t, zero), can


def make_onb(n: Vec3):
    """ONB matching make_onb (device_programs.cu:213-218): up = +Z unless
    |n.z| >= 0.999 then +X; t = normalize(up x n); b = n x t."""
    use_z = jnp.abs(n.z) < 0.999
    upx = jnp.where(use_z, 0.0, 1.0)
    # up = (upx, 0, uz) with uz = 1-upx
    uz = 1.0 - upx
    up = Vec3(upx, jnp.zeros_like(upx), uz)
    t = safe_normalize(cross(up, n))
    b = cross(n, t)
    return t, b


def from_onb(t: Vec3, b: Vec3, n: Vec3, lx, ly, lz) -> Vec3:
    """Local (lx, ly, lz) -> world via (t, b, n)."""
    return t * lx + b * ly + n * lz


def faceforward(n: Vec3, d: Vec3):
    """Flip n against d; returns (n_ff, entering)."""
    entering = dot(d, n) < 0.0
    return where(entering, n, -n), entering


def lerp(a: Vec3, b: Vec3, t: jnp.ndarray) -> Vec3:
    return a * (1.0 - t) + b * t
