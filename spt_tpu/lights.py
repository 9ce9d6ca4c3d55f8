"""Analytic lights as SoA device tables.

Replaces Light/DirectionalLight/PointLight/LightManager (src/Light.cpp):

- DirectionalLight stores the direction TO the light (negated at add time,
  Light.cpp:43-46), infinite distance, no attenuation (:48-55).
- PointLight has constant/linear/quadratic attenuation (:58-79).
- Occlusion (Light.cpp:16-40) is a shadow trace with the scale-aware epsilon
  offset and tfar = dist - 1e-4; here that is a masked batched
  `ops.intersect.occluded` call issued by the integrator, so this module only
  computes radiance/direction/distance per (lane, light).

Both light kinds live in one padded table; a `kind` tag selects the formula
with masked math (no lax.switch needed for two branches).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from spt_tpu.ops import math3d as m3

KIND_NONE = 0
KIND_DIRECTIONAL = 1
KIND_POINT = 2

_BIG = 1e30  # stand-in for the infinite directional-light distance


class DeviceLights(NamedTuple):
    """(L,)-padded SoA light table."""

    kind: jnp.ndarray        # (L,) int32
    vec: jnp.ndarray         # (L, 3) direction-to-light (directional) | position (point)
    color: jnp.ndarray       # (L, 3)
    intensity: jnp.ndarray   # (L,)
    attenuation: jnp.ndarray # (L, 3) constant/linear/quadratic (point only)

    @property
    def count(self) -> int:
        return self.kind.shape[0]


class LightManager:
    """Host-side builder (Light.h:84-105 LightManager add/get/clear)."""

    def __init__(self):
        self._rows = []

    def add_directional_light(self, direction, color=(1.0, 1.0, 1.0), intensity: float = 1.0):
        d = np.asarray(direction, np.float32)
        to_light = -d / np.linalg.norm(d)  # store direction TO light (Light.cpp:44-46)
        self._rows.append((KIND_DIRECTIONAL, to_light, np.asarray(color, np.float32),
                           float(intensity), np.array([1.0, 0.0, 0.0], np.float32)))

    def add_point_light(self, position, color=(1.0, 1.0, 1.0), intensity: float = 1.0,
                        constant: float = 1.0, linear: float = 0.09, quadratic: float = 0.032):
        self._rows.append((KIND_POINT, np.asarray(position, np.float32),
                           np.asarray(color, np.float32), float(intensity),
                           np.array([constant, linear, quadratic], np.float32)))

    def clear_lights(self):
        self._rows = []

    @property
    def light_count(self) -> int:
        return len(self._rows)

    def device(self, pad_multiple: int = 1) -> DeviceLights:
        n = max(len(self._rows), 1)
        n = ((n + pad_multiple - 1) // pad_multiple) * pad_multiple
        kind = np.zeros(n, np.int32)
        vec = np.zeros((n, 3), np.float32)
        color = np.zeros((n, 3), np.float32)
        intensity = np.zeros(n, np.float32)
        atten = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
        for i, (k, v, c, it, a) in enumerate(self._rows):
            kind[i], vec[i], color[i], intensity[i], atten[i] = k, v, c, it, a
        return DeviceLights(
            kind=jnp.asarray(kind),
            vec=jnp.asarray(vec),
            color=jnp.asarray(color),
            intensity=jnp.asarray(intensity),
            attenuation=jnp.asarray(atten),
        )


def default_lights() -> DeviceLights:
    """setupLights (main.cpp:85-94): one directional light, direction
    (-0.5, -1, 0.3), warm white (1, 0.95, 0.8), intensity 2."""
    lm = LightManager()
    lm.add_directional_light([-0.5, -1.0, 0.3], [1.0, 0.95, 0.8], 2.0)
    return lm.device()


def sample_light(lights: DeviceLights, i: int, hit_point: jnp.ndarray):
    """Per-lane radiance for light `i` (a static index — integrators unroll
    the small light loop).  Returns (Li (...,3), dir_to_light (...,3),
    distance (...,), active_mask (...,)).

    Directional: Li = color * intensity, dist = inf (Light.cpp:48-55).
    Point: Li = color * intensity / (c + l*d + q*d^2) (Light.cpp:66-79).
    """
    kind = lights.kind[i]
    vec = lights.vec[i]
    color = lights.color[i] * lights.intensity[i]
    att = lights.attenuation[i]

    is_point = kind == KIND_POINT
    lv = vec - hit_point                        # point-light vector
    dist_p = m3.length(lv)
    dir_p = lv / jnp.maximum(dist_p, 1e-12)[..., None]
    atten = att[0] + att[1] * dist_p + att[2] * dist_p * dist_p

    ldir = jnp.where(is_point, dir_p, jnp.broadcast_to(vec, dir_p.shape))
    dist = jnp.where(is_point, dist_p, _BIG)
    li = jnp.where(
        is_point,
        color / jnp.maximum(atten, 1e-12)[..., None],
        jnp.broadcast_to(color, dir_p.shape),
    )
    active = kind != KIND_NONE
    return li, ldir, dist, active


# --- component-SoA (Vec3) form -----------------------------------------------

from spt_tpu.ops import vec3 as v3  # noqa: E402


def sample_light_v(lights: DeviceLights, i: int, p: "v3.Vec3"):
    """Per-lane radiance for static light index `i`, Vec3 form.
    Returns (Li: Vec3, dir_to_light: Vec3, distance, active)."""
    # Scalar reads of row i: XLA hoists them out of the lane math.
    kind = lights.kind[i]
    vx, vy, vz = lights.vec[i, 0], lights.vec[i, 1], lights.vec[i, 2]
    it = lights.intensity[i]
    cx = lights.color[i, 0] * it
    cy = lights.color[i, 1] * it
    cz = lights.color[i, 2] * it
    a0, a1, a2 = (lights.attenuation[i, 0], lights.attenuation[i, 1],
                  lights.attenuation[i, 2])

    is_point = kind == KIND_POINT
    lvx, lvy, lvz = vx - p.x, vy - p.y, vz - p.z
    dist_p = jnp.sqrt(lvx * lvx + lvy * lvy + lvz * lvz)
    inv = 1.0 / jnp.maximum(dist_p, 1e-12)
    atten = a0 + a1 * dist_p + a2 * dist_p * dist_p
    inv_at = 1.0 / jnp.maximum(atten, 1e-12)

    ldir = v3.Vec3(
        jnp.where(is_point, lvx * inv, vx),
        jnp.where(is_point, lvy * inv, vy),
        jnp.where(is_point, lvz * inv, vz),
    )
    dist = jnp.where(is_point, dist_p, _BIG)
    li = v3.Vec3(
        jnp.where(is_point, cx * inv_at, cx),
        jnp.where(is_point, cy * inv_at, cy),
        jnp.where(is_point, cz * inv_at, cz),
    )
    active = kind != KIND_NONE
    return li, ldir, dist, active
