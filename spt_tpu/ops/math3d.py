"""Batched 3-vector math over (..., 3) arrays.

Replaces the reference's scalar float3 helpers (device_programs.cu:55-141,
wf_math.h:9-33) with lane-parallel jnp ops: every function maps over an
arbitrary leading batch shape, so the same code shades one ray on CPU in a
test and two million rays on a GPU.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Per-lane dot product; returns (...,) given (..., 3)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(dot(v, v))


def safe_sqrt(x: jnp.ndarray) -> jnp.ndarray:
    """sqrt(max(x, 0)) with a finite gradient everywhere.

    Plain `sqrt(maximum(x, 0))` has derivative +inf at x == 0 — hit
    constantly by masked lanes (sphere discriminants, TIR, sin-from-cos), so
    jax.grad through a render turns 0-cotangent * inf into NaN.  The
    double-where pins the untaken branch's primal at 1.0 so its zero
    cotangent never meets an inf/overflowed derivative (the differentiable
    megakernel path)."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def safe_normalize(v: jnp.ndarray) -> jnp.ndarray:
    """Normalize; zero vectors map to zero (wf_math.h:28-33 safe_normalize)."""
    len2 = dot(v, v)
    ok = len2 > 0.0
    inv = jnp.where(ok, 1.0 / jnp.sqrt(jnp.where(ok, len2, 1.0)), 0.0)
    return v * inv[..., None]


def normalize_or(v: jnp.ndarray, fallback: jnp.ndarray) -> jnp.ndarray:
    """Normalize; degenerate vectors map to `fallback` (the GPU kernels'
    repeated `len2 > 0 ? v*rsqrt(len2) : n` pattern, device_programs.cu:441-451)."""
    len2 = dot(v, v)
    ok = len2 > 0.0
    inv = 1.0 / jnp.sqrt(jnp.where(ok, len2, 1.0))
    return jnp.where(ok[..., None], v * inv[..., None], fallback)


def reflect(i: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflect incident direction `i` about normal `n`
    (device_programs.cu:79-82 f3_reflect / glm::reflect)."""
    return i - 2.0 * dot(i, n)[..., None] * n


def refract(i: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray):
    """Snell refraction. Returns (refracted_dir, can_refract_mask).

    `i` points toward the surface, `n` against it, eta = etaI/etaT.
    On total internal reflection the mask is False and the direction is zero
    (wf_math.h:82-91 refract_dir; device_programs.cu:84-101 f3_refract).
    """
    cosi = jnp.clip(-dot(n, i), -1.0, 1.0)
    sin2t = eta * eta * jnp.maximum(0.0, 1.0 - cosi * cosi)
    can = sin2t <= 1.0
    cost = safe_sqrt(1.0 - sin2t)
    t = eta[..., None] * i + (eta * cosi - cost)[..., None] * n
    t = safe_normalize(t)
    return jnp.where(can[..., None], t, 0.0), can


def make_onb(n: jnp.ndarray):
    """Orthonormal basis (t, b) around unit normal `n`.

    Matches the GPU's make_onb (device_programs.cu:213-218): up = +Z unless
    |n.z| >= 0.999, then +X; t = normalize(cross(up, n)); b = cross(n, t).
    """
    nz = jnp.abs(n[..., 2]) < 0.999
    up = jnp.where(
        nz[..., None],
        jnp.array([0.0, 0.0, 1.0], dtype=n.dtype),
        jnp.array([1.0, 0.0, 0.0], dtype=n.dtype),
    )
    t = safe_normalize(cross(up, n))
    b = cross(n, t)
    return t, b


def from_onb(t, b, n, local: jnp.ndarray) -> jnp.ndarray:
    """Local (x,y,z) -> world via basis (t, b, n)."""
    return (
        t * local[..., 0:1] + b * local[..., 1:2] + n * local[..., 2:3]
    )


def smoothstep(edge0: float, edge1: float, x: jnp.ndarray) -> jnp.ndarray:
    t = jnp.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def faceforward(n: jnp.ndarray, d: jnp.ndarray):
    """Flip `n` to oppose ray direction `d`. Returns (n_ff, entering_mask)
    (wf_pt_cpu.cpp:112-115; device_programs.cu:449-452)."""
    entering = dot(d, n) < 0.0
    return jnp.where(entering[..., None], n, -n), entering


def luminance_max(c: jnp.ndarray) -> jnp.ndarray:
    """max(r,g,b) — the RR survival probability (wf_pt_cpu.cpp:234)."""
    return jnp.max(c, axis=-1)
