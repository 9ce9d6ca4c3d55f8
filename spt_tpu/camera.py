"""Pinhole FPS camera.

Host-side state machine mirroring the reference Camera (src/Camera.cpp):
yaw/pitch derived from position/target (:19-27), basis rebuild with
half_width/height = tan(fov/2) * aspect (:32-50), WASD movement (:52-72),
mouse look with pitch clamp ±89° (:74-88), and threshold-based movement
detection used to reset progressive accumulation (:113-137).

The device side is a small pytree (:class:`CameraRays`) whose
``ray_directions`` matches Camera::getRayDirection semantics (:95-106):
x,y in [0,1]² -> [-1,1]² with Y flip -> normalized
(forward + x·hw·right + y·hh·up).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from spt_tpu.ops import math3d as m3

FORWARD, BACKWARD, LEFT, RIGHT = 0, 1, 2, 3


class CameraRays(NamedTuple):
    """Device camera basis — the LaunchParams camera block
    (LaunchParams.h:63-67 cam_pos/u/v/w, here kept as pos + basis + extents
    so host and device share one formula instead of the reference's
    probe-derived reconstruction, OptixBackend.cpp:1611-1626)."""

    position: jnp.ndarray    # (3,)
    forward: jnp.ndarray     # (3,)
    right: jnp.ndarray       # (3,)
    up: jnp.ndarray          # (3,)
    half_width: jnp.ndarray  # ()
    half_height: jnp.ndarray # ()

    def ray_directions(self, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
        """x, y in [0,1] (any batch shape) -> normalized world directions."""
        nx = (x - 0.5) * 2.0
        ny = -(y - 0.5) * 2.0
        d = (
            self.forward
            + nx[..., None] * (self.half_width * self.right)
            + ny[..., None] * (self.half_height * self.up)
        )
        return m3.safe_normalize(d)

    def ray_directions_v(self, x: jnp.ndarray, y: jnp.ndarray):
        """Component-SoA variant: returns a Vec3 of (N,) components
        (hot path; see spt_tpu.ops.vec3 for the layout rationale)."""
        from spt_tpu.ops import vec3 as v3

        nx = (x - 0.5) * 2.0
        ny = -(y - 0.5) * 2.0
        hw, hh = self.half_width, self.half_height
        d = v3.Vec3(
            self.forward[0] + nx * (hw * self.right[0]) + ny * (hh * self.up[0]),
            self.forward[1] + nx * (hw * self.right[1]) + ny * (hh * self.up[1]),
            self.forward[2] + nx * (hw * self.right[2]) + ny * (hh * self.up[2]),
        )
        return v3.safe_normalize(d)


class Camera:
    """Interactive host camera. All mutation happens host-side; `.rays()`
    snapshots the basis into a jit-friendly pytree."""

    def __init__(
        self,
        position=(0.0, 3.0, 8.0),
        target=(0.0, 1.0, 0.0),
        up=(0.0, 1.0, 0.0),
        fov_degrees: float = 60.0,
        aspect_ratio: float = 800.0 / 600.0,
    ):
        self.position = np.asarray(position, np.float64)
        self.world_up = np.asarray(up, np.float64)
        self.fov = float(fov_degrees)
        self.aspect_ratio = float(aspect_ratio)
        self.movement_speed = 2.5
        self.mouse_sensitivity = 0.1

        direction = np.asarray(target, np.float64) - self.position
        direction = direction / np.linalg.norm(direction)
        self.yaw = float(np.degrees(np.arctan2(direction[2], direction[0])))
        self.pitch = float(np.degrees(np.arcsin(np.clip(direction[1], -1.0, 1.0))))

        self._last_position = self.position.copy()
        self._last_yaw = self.yaw
        self._last_pitch = self.pitch
        self._first_movement_check = True
        self._update_vectors()

    def _update_vectors(self) -> None:
        cy, sy = np.cos(np.radians(self.yaw)), np.sin(np.radians(self.yaw))
        cp, sp = np.cos(np.radians(self.pitch)), np.sin(np.radians(self.pitch))
        front = np.array([cy * cp, sp, sy * cp])
        self.forward = front / np.linalg.norm(front)
        right = np.cross(self.forward, np.array([0.0, 1.0, 0.0]))
        self.right = right / np.linalg.norm(right)
        cup = np.cross(self.right, self.forward)
        self.up = cup / np.linalg.norm(cup)
        self.half_height = float(np.tan(np.radians(self.fov) * 0.5))
        self.half_width = self.half_height * self.aspect_ratio

    # --- controls (Camera.cpp:52-88) -----------------------------------------

    def process_keyboard(self, direction: int, delta_time: float) -> None:
        v = self.movement_speed * delta_time
        if direction == FORWARD:
            self.position = self.position + self.forward * v
        elif direction == BACKWARD:
            self.position = self.position - self.forward * v
        elif direction == LEFT:
            self.position = self.position - self.right * v
        elif direction == RIGHT:
            self.position = self.position + self.right * v

    def process_mouse(self, dx: float, dy: float, constrain_pitch: bool = True) -> None:
        self.yaw += dx * self.mouse_sensitivity
        self.pitch += dy * self.mouse_sensitivity
        if constrain_pitch:
            self.pitch = float(np.clip(self.pitch, -89.0, 89.0))
        self._update_vectors()

    def set_position(self, position) -> None:
        self.position = np.asarray(position, np.float64)

    def set_aspect_ratio(self, aspect: float) -> None:
        self.aspect_ratio = float(aspect)
        self._update_vectors()

    # --- accumulation-reset detection (Camera.cpp:113-137) -------------------

    def has_moved_since_last_check(
        self, position_threshold: float = 0.001, rotation_threshold: float = 0.1
    ) -> bool:
        if self._first_movement_check:
            self._first_movement_check = False
            return True
        moved = (
            np.linalg.norm(self.position - self._last_position) > position_threshold
            or abs(self.yaw - self._last_yaw) > rotation_threshold
            or abs(self.pitch - self._last_pitch) > rotation_threshold
        )
        if moved:
            self._last_position = self.position.copy()
            self._last_yaw = self.yaw
            self._last_pitch = self.pitch
        return moved

    def reset_movement_tracking(self) -> None:
        self._last_position = self.position.copy()
        self._last_yaw = self.yaw
        self._last_pitch = self.pitch
        self._first_movement_check = False

    # --- device snapshot ------------------------------------------------------

    def rays(self) -> CameraRays:
        return CameraRays(
            position=jnp.asarray(self.position, jnp.float32),
            forward=jnp.asarray(self.forward, jnp.float32),
            right=jnp.asarray(self.right, jnp.float32),
            up=jnp.asarray(self.up, jnp.float32),
            half_width=jnp.asarray(self.half_width, jnp.float32),
            half_height=jnp.asarray(self.half_height, jnp.float32),
        )

    def get_ray_direction(self, x: float, y: float) -> np.ndarray:
        """Scalar convenience matching Camera::getRayDirection (tests)."""
        nx = (x - 0.5) * 2.0
        ny = -(y - 0.5) * 2.0
        d = self.forward + nx * self.half_width * self.right + ny * self.half_height * self.up
        return (d / np.linalg.norm(d)).astype(np.float32)


def default_camera(width: int = 800, height: int = 600) -> Camera:
    """The reference's setupCamera (main.cpp:97-103): pos (0,3,8), target
    (0,1,0), fov 60°."""
    return Camera(
        position=(0.0, 3.0, 8.0),
        target=(0.0, 1.0, 0.0),
        fov_degrees=60.0,
        aspect_ratio=width / height,
    )
