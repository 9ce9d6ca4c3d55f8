"""Environment lighting: procedural sky + equirectangular HDR maps.

Replaces EnvironmentManager/Cubemap (src/EnvironmentManager.cpp,
src/Cubemap.cpp).  The reference keeps two representations — 6 resampled cube
faces for the CPU (Cubemap.cpp:271-310) and the raw equirect RGBA for the GPU
texture (Cubemap.cpp:252-269).  Only the equirect path is needed here:
a (H, W, 3) array sampled bilinearly with a gather — this is exactly the GPU
backend's model (device_programs.cu:374-397), which is also the radiometric
reference for env lookups.

Semantics preserved:
- env color = clamp(sample, max=5.0) * intensity 0.8 (EnvironmentManager.cpp:
  9-28, EnvironmentManager.h:12-13).
- procedural sky fallback (EnvironmentManager.cpp:35-61): horizon->zenith
  smoothstep gradient + pow-64 sun disk + pow-8 glow toward (0.3, 0.6, -0.8),
  all scaled by 0.8.
- equirect mapping: theta = atan2(z, x), phi = acos(y), u = (theta+pi)/2pi,
  v = phi/pi (device_programs.cu:376-387).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from spt_tpu.ops import math3d as m3

SUN_DIRECTION = np.array([0.3, 0.6, -0.8], np.float64)
SUN_DIRECTION /= np.linalg.norm(SUN_DIRECTION)


class Environment(NamedTuple):
    """Pytree environment. When `enabled` is False the (1,1,3) placeholder
    image is ignored and the procedural sky is used — both paths are computed
    and masked, keeping a single jitted program for either mode."""

    image: jnp.ndarray      # (H, W, 3) float32 linear HDR
    enabled: jnp.ndarray    # () bool
    intensity: jnp.ndarray  # () float32
    max_clamp: jnp.ndarray  # () float32
    # Neighborhood-packed copy for ONE-take bilinear: row (y*W + x) holds
    # the 2x2 texel block [c00 | c01 | c10 | c11] a bilinear fetch anchored
    # at (y, x) needs (x+1 wrapped, y+1 clamped — pre-applied at build).
    # One 12-wide take replaces four 3-wide ones; whether that is cheaper
    # on a given card is a measurement.  Off by default (SPT_ENV_PACKED=1
    # opts in).  4x the map's memory when built.
    packed: Optional[jnp.ndarray] = None   # (H*W, 12) float32
    # 2x-supersampled prefilter for ONE-take "snap" bilinear: texel
    # (Y, X) of the (2H, 2W, 3) table is the exact texel-center bilinear
    # sample of `image` at the half-texel grid point (y = Y/2, x = X/2)
    # (wrap in x, pole-clamp in y — the _derive_taps semantics baked in
    # at build).  A lookup rounds its continuous tap position to the
    # nearest half texel and fetches ONE (N, 3) row instead of four,
    # agreeing with the four-take bilinear exactly AT the grid and within
    # a quarter-texel interpolation offset between grid points.  4x the
    # map's memory.  Off by default (SPT_ENV_SNAP=1 opts in) because the
    # between-grid error is content-dependent — see _snap_on.
    snap: Optional[jnp.ndarray] = None     # (2H, 2W, 3) float32


def procedural_sky(direction: jnp.ndarray) -> jnp.ndarray:
    """getSkyColor (EnvironmentManager.cpp:35-61), batched."""
    d = direction
    t = 0.5 * (d[..., 1] + 1.0)
    t = m3.smoothstep(0.0, 1.0, t)
    horizon = jnp.array([0.7, 0.8, 0.9], d.dtype)
    zenith = jnp.array([0.2, 0.4, 0.8], d.dtype)
    sky = horizon * (1.0 - t[..., None]) + zenith * t[..., None]

    sun_dir = jnp.asarray(SUN_DIRECTION, d.dtype)
    sun_dot = jnp.maximum(m3.dot(d, sun_dir), 0.0)
    sun_intensity = sun_dot ** 64.0
    sun_glow = (sun_dot ** 8.0) * 0.3
    sun_color = jnp.array([1.0, 0.9, 0.7], d.dtype)
    sky = sky + sun_color * (sun_intensity + sun_glow)[..., None]
    return sky * 0.8


def sample_equirect(image: jnp.ndarray, direction: jnp.ndarray) -> jnp.ndarray:
    """Bilinear equirect lookup (device_programs.cu:374-387): wrap in u,
    clamp in v. `direction` must be normalized."""
    h, w = image.shape[0], image.shape[1]
    d = direction
    theta = jnp.arctan2(d[..., 2], d[..., 0])
    phi = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
    u = (theta + jnp.pi) / (2.0 * jnp.pi)
    v = phi / jnp.pi

    # Texel-center bilinear (cudaFilterModeLinear semantics).
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0i + 1, w)
    # Clamp each tap independently (cudaAddressModeClamp): at the poles both
    # taps collapse onto the edge row instead of blending inward.
    y0f = y0.astype(jnp.int32)
    y0i = jnp.clip(y0f, 0, h - 1)
    y1i = jnp.clip(y0f + 1, 0, h - 1)

    flat = image.reshape(h * w, 3)
    c00 = jnp.take(flat, y0i * w + x0i, axis=0)
    c01 = jnp.take(flat, y0i * w + x1i, axis=0)
    c10 = jnp.take(flat, y1i * w + x0i, axis=0)
    c11 = jnp.take(flat, y1i * w + x1i, axis=0)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def environment_color(env: Environment, direction: jnp.ndarray) -> jnp.ndarray:
    """getEnvironmentColor (EnvironmentManager.cpp:9-33): HDR sample clamped
    then scaled, else procedural sky."""
    d = m3.safe_normalize(direction)
    tex = sample_equirect(env.image, d)
    tex = jnp.minimum(tex, env.max_clamp) * env.intensity
    sky = procedural_sky(d)
    return jnp.where(env.enabled, tex, sky)


def make_procedural_environment(dtype=jnp.float32) -> Environment:
    return Environment(
        image=jnp.zeros((1, 1, 3), dtype),
        enabled=jnp.asarray(False),
        intensity=jnp.asarray(0.8, dtype),
        max_clamp=jnp.asarray(5.0, dtype),
    )


def pack_bilinear(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) -> (H*W, 12): the 2x2 neighborhood each bilinear fetch
    anchored at (y, x) reads, stored contiguously so the fetch is ONE
    flat take.  Column order [c00 | c01 | c10 | c11] matches
    sample_equirect's taps: c01 is (y, x+1 wrapped), c10 is (y+1 clamped,
    x) — the equirect wrap/clamp rules pre-applied at build."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[0], img.shape[1]
    x1 = np.roll(img, -1, axis=1)
    y1 = img[np.minimum(np.arange(h) + 1, h - 1)]
    y1x1 = np.roll(y1, -1, axis=1)
    return np.concatenate([img, x1, y1, y1x1], axis=-1).reshape(h * w, 12)


def _pack_enabled() -> bool:
    import os

    return os.environ.get("SPT_ENV_PACKED", "0") == "1"


def make_snap_table(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) -> (2H, 2W, 3): the texel-center bilinear sample of
    `image` at every half-texel grid point (Environment.snap).  Separable:
    even rows/cols are source texels (lerp weight 0), odd ones the mean of
    the two neighbors — x wraps (equirect seam), y clamps (poles), exactly
    _derive_taps' rules, so S[Y, X] == bilinear(image, x=X/2, y=Y/2) for
    every grid point including the seam column 2W-1 (x = W-0.5 == -0.5
    wrapped) and the pole rows."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[0], img.shape[1]
    sx = np.empty((h, 2 * w, 3), np.float32)
    sx[:, 0::2] = img
    sx[:, 1::2] = 0.5 * (img + np.roll(img, -1, axis=1))
    s = np.empty((2 * h, 2 * w, 3), np.float32)
    s[0::2] = sx
    s[1::2] = 0.5 * (sx + sx[np.minimum(np.arange(h) + 1, h - 1)])
    return s


def _snap_on(h: int) -> bool:
    """Opt-in only (SPT_ENV_SNAP=1), like `packed`.  The snap table
    displaces each lookup by at most a quarter SOURCE texel, so its
    error shrinks with the map on smooth content, but the bound is
    content-dependent, not resolution-bounded: a real HDR probe with small
    bright sources can exceed the 1 % radiometric budget at any
    resolution.  The default render therefore always uses the exact
    four-take bilinear (cudaFilterModeLinear parity,
    device_programs.cu:374-387)."""
    import os

    return os.environ.get("SPT_ENV_SNAP", "0") == "1"


def make_hdr_environment(
    image: np.ndarray, intensity: float = 0.8, max_clamp: float = 5.0
) -> Environment:
    img_np = np.asarray(image, np.float32)
    img = jnp.asarray(img_np)
    assert img.ndim == 3 and img.shape[-1] == 3, "expected (H, W, 3) HDR image"
    return Environment(
        image=img,
        enabled=jnp.asarray(True),
        intensity=jnp.asarray(intensity, jnp.float32),
        max_clamp=jnp.asarray(max_clamp, jnp.float32),
        packed=jnp.asarray(pack_bilinear(img_np)) if _pack_enabled() else None,
        snap=(jnp.asarray(make_snap_table(img_np))
              if _snap_on(img_np.shape[0]) else None),
    )


def synthetic_equirect(height: int = 64, sun_radiance: float = 40.0) -> np.ndarray:
    """Deterministic synthetic equirect HDR (H, 2H, 3): a sky gradient plus a
    bright sun disk whose radiance exceeds the 5.0 clamp — a stand-in for the
    reference's default skybox asset, which its repo does not ship
    (PathTracer.cpp:24 points at a missing assets/Cubemap/*.hdr).  Used by the
    HDR benchmark config and the oracle RMSE gate."""
    h, w = height, 2 * height
    v = (np.arange(h, dtype=np.float32) + 0.5) / h          # 0 top .. 1 bottom
    u = (np.arange(w, dtype=np.float32) + 0.5) / w
    vv, uu = np.meshgrid(v, u, indexing="ij")
    # gradient: warm horizon, blue zenith, dim ground
    zen = np.stack([0.18 + 0 * vv, 0.30 + 0 * vv, 0.65 + 0 * vv], -1)
    hor = np.stack([0.9 + 0 * vv, 0.75 + 0 * vv, 0.55 + 0 * vv], -1)
    t = np.clip(np.abs(vv - 0.5) * 2.0, 0.0, 1.0)[..., None]
    img = hor * (1 - t) + (zen * (vv < 0.5)[..., None] +
                           0.15 * hor * (vv >= 0.5)[..., None]) * t
    # sun disk at (u=0.3, v=0.25)
    du = np.minimum(np.abs(uu - 0.3), 1.0 - np.abs(uu - 0.3)) * 2.0
    dv = vv - 0.25
    r2 = du * du + dv * dv
    sun = np.exp(-r2 / 0.002)[..., None] * np.array(
        [sun_radiance, sun_radiance * 0.9, sun_radiance * 0.7], np.float32
    )
    return (img + sun).astype(np.float32)


def load_environment(path: Optional[str]) -> Environment:
    """Load a Radiance .hdr file (the `--s` CLI path, main.cpp:30-46) or fall
    back to the procedural sky, mirroring the missing-asset fallback
    (PathTracer.cpp:24-26).  Layout is auto-detected like Cubemap::loadFromFile
    (Cubemap.cpp:18-46): 2:1 equirect used directly, 4:3 horizontal cross
    resampled to equirect once at load."""
    if not path:
        return make_procedural_environment()
    from spt_tpu.io.hdr import detect_layout, read_hdr

    img = read_hdr(path)
    if detect_layout(img.shape[1], img.shape[0]) == "cross":
        from spt_tpu.io.cubemap_cross import cross_to_equirect

        img = cross_to_equirect(img)
    return make_hdr_environment(img)


# --- component-SoA (Vec3) forms ----------------------------------------------

from spt_tpu.ops import vec3 as v3  # noqa: E402


def procedural_sky_v(d: "v3.Vec3") -> "v3.Vec3":
    """getSkyColor (EnvironmentManager.cpp:35-61), Vec3 form."""
    t = 0.5 * (d.y + 1.0)
    t = m3.smoothstep(0.0, 1.0, t)
    horizon = v3.Vec3(jnp.float32(0.7), jnp.float32(0.8), jnp.float32(0.9))
    zenith = v3.Vec3(jnp.float32(0.2), jnp.float32(0.4), jnp.float32(0.8))
    sky = v3.Vec3(
        horizon.x * (1.0 - t) + zenith.x * t,
        horizon.y * (1.0 - t) + zenith.y * t,
        horizon.z * (1.0 - t) + zenith.z * t,
    )
    sun = SUN_DIRECTION
    sun_dot = jnp.maximum(
        d.x * jnp.float32(sun[0]) + d.y * jnp.float32(sun[1]) + d.z * jnp.float32(sun[2]),
        0.0,
    )
    glow = sun_dot ** 64.0 + (sun_dot ** 8.0) * 0.3
    sky = sky + v3.Vec3(glow * 1.0, glow * 0.9, glow * 0.7)
    return sky * 0.8


def _equirect_taps_raw(h: int, w: int, d: "v3.Vec3"):
    """The minimal independent tap state: (x0i wrapped, y0f UNclipped floor,
    fx, fy).  The second taps and the v clips are pure derivations
    (_derive_taps)."""
    theta = jnp.arctan2(d.z, d.x)
    phi = jnp.arccos(jnp.clip(d.y, -1.0, 1.0))
    u = (theta + jnp.pi) / (2.0 * jnp.pi)
    v = phi / jnp.pi

    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    return x0i, y0.astype(jnp.int32), fx, fy


def _derive_taps(h: int, w: int, x0i, y0f, fx, fy):
    """(x0i, y0f, fx, fy) -> (x0i, x1i, y0i, y1i, fx, fy): wrap in u,
    per-tap clamp in v.  y1 must derive from the UNCLIPPED floor — at the
    top pole row (y0f = -1) both taps clamp to row 0."""
    x1i = jnp.mod(x0i + 1, w)
    y0i = jnp.clip(y0f, 0, h - 1)
    y1i = jnp.clip(y0f + 1, 0, h - 1)
    return x0i, x1i, y0i, y1i, fx, fy


def _equirect_taps(h: int, w: int, d: "v3.Vec3"):
    """Texel-center bilinear tap setup (device_programs.cu:374-387): wrap
    in u, per-tap clamp in v.  Returns (x0i, x1i, y0i, y1i, fx, fy)."""
    x0i, y0f, fx, fy = _equirect_taps_raw(h, w, d)
    return _derive_taps(h, w, x0i, y0f, fx, fy)


def sample_equirect_packed_v(h: int, w: int, packed: jnp.ndarray,
                             d: "v3.Vec3") -> "v3.Vec3":
    """Bilinear equirect lookup through the neighborhood-packed table
    (Environment.packed): ONE flat take of 12 contiguous floats replaces
    the four per-address takes of sample_equirect_v — identical taps,
    identical interpolation arithmetic.

    The one derivation that changes: the packed row is anchored at the
    CLAMPED y0, whose stored second row is y0+1 — correct everywhere
    except the top pole (unclipped floor -1), where BOTH taps must clamp
    to row 0; forcing fy to 0 there selects exactly the row-0
    interpolation (the bottom pole needs nothing: row H-1's stored
    neighbor is itself)."""
    x0i, y0f, fx, fy = _equirect_taps_raw(h, w, d)
    fy = jnp.where(y0f < 0, jnp.float32(0.0), fy)
    y0i = jnp.clip(y0f, 0, h - 1)
    quad = jnp.take(packed, y0i * w + x0i, axis=0)     # (..., 12)
    c00, c01 = quad[..., 0:3], quad[..., 3:6]
    c10, c11 = quad[..., 6:9], quad[..., 9:12]
    fx = fx[..., None]
    fy = fy[..., None]
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return v3.Vec3.from_array(top * (1.0 - fy) + bot * fy)


def sample_equirect_snap_v(h: int, w: int, snap: jnp.ndarray,
                           d: "v3.Vec3") -> "v3.Vec3":
    """Snap-bilinear equirect lookup (Environment.snap): round the
    continuous tap position to the nearest half texel of the SOURCE map
    and fetch the prefiltered value with ONE (N, 3) flat take — the
    bilinear result displaced by at most a quarter source texel, for a
    quarter of the four-take gather cost (the whole cost of this lookup
    is takes; see sample_equirect_v).  h, w are the SOURCE dims; `snap`
    is (2h, 2w, 3).  Wrap/clamp mirror _derive_taps: x wraps (column -1
    == 2w-1 is the seam blend), y clamps (pole rows saturate)."""
    theta = jnp.arctan2(d.z, d.x)
    phi = jnp.arccos(jnp.clip(d.y, -1.0, 1.0))
    x2 = (theta + jnp.pi) * (w / jnp.pi) - 1.0    # 2 * (u*w - 0.5)
    y2 = phi * (2.0 * h / jnp.pi) - 1.0           # 2 * (v*h - 0.5)
    xs = jnp.mod(jnp.round(x2).astype(jnp.int32), 2 * w)
    ys = jnp.clip(jnp.round(y2).astype(jnp.int32), 0, 2 * h - 1)
    flat = snap.reshape(4 * h * w, 3)
    return v3.Vec3.from_array(jnp.take(flat, ys * (2 * w) + xs, axis=0))


def sample_equirect_v(image: jnp.ndarray, d: "v3.Vec3") -> "v3.Vec3":
    """Bilinear equirect lookup (device_programs.cu:374-387), Vec3 form.
    The four texel gathers are unavoidable; everything else is lane math."""
    h, w = image.shape[0], image.shape[1]
    x0i, x1i, y0i, y1i, fx, fy = _equirect_taps(h, w, d)

    # flat 1-D takes over the (H*W, 3) table
    flat = image.reshape(h * w, 3)
    c00 = jnp.take(flat, y0i * w + x0i, axis=0)
    c01 = jnp.take(flat, y0i * w + x1i, axis=0)
    c10 = jnp.take(flat, y1i * w + x0i, axis=0)
    c11 = jnp.take(flat, y1i * w + x1i, axis=0)
    top = c00 * (1.0 - fx)[..., None] + c01 * fx[..., None]
    bot = c10 * (1.0 - fx)[..., None] + c11 * fx[..., None]
    out = top * (1.0 - fy)[..., None] + bot * fy[..., None]
    return v3.Vec3.from_array(out)


def environment_color_v(env: Environment, direction: "v3.Vec3") -> "v3.Vec3":
    """getEnvironmentColor (EnvironmentManager.cpp:9-33), Vec3 form."""
    d = v3.safe_normalize(direction)
    sky = procedural_sky_v(d)
    if env.snap is not None:
        tex = sample_equirect_snap_v(env.image.shape[0],
                                     env.image.shape[1], env.snap, d)
    elif env.packed is not None:
        tex = sample_equirect_packed_v(env.image.shape[0],
                                       env.image.shape[1], env.packed, d)
    else:
        tex = sample_equirect_v(env.image, d)
    tex = v3.Vec3(
        jnp.minimum(tex.x, env.max_clamp) * env.intensity,
        jnp.minimum(tex.y, env.max_clamp) * env.intensity,
        jnp.minimum(tex.z, env.max_clamp) * env.intensity,
    )
    return v3.where(env.enabled, tex, sky)
