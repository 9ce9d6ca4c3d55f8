"""Horizontal-cross cubemap -> equirectangular conversion.

The reference's Cubemap keeps six faces and samples them per ray on the CPU
(Cubemap.cpp:94-153), while the GPU consumes only the raw equirect image.
This build standardizes on one representation — equirect — so cross-layout
files are resampled once at load time.

Face layout and orientation follow loadCrossLayout (Cubemap.cpp:182-250):

        [+Y]
    [-X][+Z][+X][-Z]     (grid columns 0..3, row 1; +Y at (1,0), -Y at (1,2))
        [-Y]

with the per-face direction mapping of faceCoordToDirection
(Cubemap.cpp:313-345).  Note the code comment at Cubemap.cpp:189-191 draws
[+X][+Z][-X][-Z] but the offsets table places +X at column 2 and -X at
column 0 — the table is what executes, so the table is what we match.
"""

from __future__ import annotations

import numpy as np

# face -> (grid_x, grid_y) (Cubemap.cpp:207-214)
_FACE_OFFSETS = {
    "+x": (2, 1),
    "-x": (0, 1),
    "+y": (1, 0),
    "-y": (1, 2),
    "+z": (1, 1),
    "-z": (3, 1),
}


def _face_uv_from_direction(d: np.ndarray):
    """Inverse of faceCoordToDirection: direction -> (face_index, u, v) in
    [-1, 1] face coordinates.  Vectorized over (..., 3)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)

    face = np.zeros(x.shape, np.int32)
    u = np.zeros_like(x)
    v = np.zeros_like(x)

    # +X: dir = (1, -v, -u)
    m = (ax >= ay) & (ax >= az) & (x > 0)
    face[m] = 0
    u[m] = -z[m] / ax[m]
    v[m] = -y[m] / ax[m]
    # -X: dir = (-1, -v, u)
    m = (ax >= ay) & (ax >= az) & (x <= 0)
    face[m] = 1
    u[m] = z[m] / ax[m]
    v[m] = -y[m] / ax[m]
    # +Y: dir = (u, 1, v)
    m = (ay > ax) & (ay >= az) & (y > 0)
    face[m] = 2
    u[m] = x[m] / ay[m]
    v[m] = z[m] / ay[m]
    # -Y: dir = (u, -1, -v)
    m = (ay > ax) & (ay >= az) & (y <= 0)
    face[m] = 3
    u[m] = x[m] / ay[m]
    v[m] = -z[m] / ay[m]
    # +Z: dir = (u, -v, 1)
    m = (az > ax) & (az > ay) & (z > 0)
    face[m] = 4
    u[m] = x[m] / az[m]
    v[m] = -y[m] / az[m]
    # -Z: dir = (-u, -v, -1)
    m = (az > ax) & (az > ay) & (z <= 0)
    face[m] = 5
    u[m] = -x[m] / az[m]
    v[m] = -y[m] / az[m]
    return face, u, v


def extract_faces(cross: np.ndarray):
    """(3s, 4s, 3) cross image -> dict of six (s, s, 3) faces."""
    h, w, _ = cross.shape
    s = w // 4
    assert h == 3 * s, f"not a 4:3 cross: {w}x{h}"
    return {
        name: cross[gy * s : (gy + 1) * s, gx * s : (gx + 1) * s]
        for name, (gx, gy) in _FACE_OFFSETS.items()
    }


def cross_to_equirect(cross: np.ndarray, out_height: int = None) -> np.ndarray:
    """Resample a horizontal-cross cubemap into an equirect (H, 2H, 3) image."""
    faces = extract_faces(cross)
    s = faces["+x"].shape[0]
    face_stack = np.stack(
        [faces["+x"], faces["-x"], faces["+y"], faces["-y"], faces["+z"], faces["-z"]]
    )  # (6, s, s, 3)

    h = out_height or s * 2
    w = 2 * h
    vs, us = np.meshgrid(
        (np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij"
    )
    theta = us * 2.0 * np.pi - np.pi
    phi = vs * np.pi
    d = np.stack(
        [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)],
        axis=-1,
    )

    face, u, v = _face_uv_from_direction(d)
    # [-1,1] -> pixel index with the (size-1) convention of
    # faceCoordToDirection's forward mapping (Cubemap.cpp:315-317).
    px = np.clip(((u + 1.0) * 0.5 * (s - 1)).round().astype(np.int64), 0, s - 1)
    py = np.clip(((v + 1.0) * 0.5 * (s - 1)).round().astype(np.int64), 0, s - 1)
    return face_stack[face, py, px].astype(np.float32)
