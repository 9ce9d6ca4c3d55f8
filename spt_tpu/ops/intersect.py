"""Ray-scene intersection: the replacement for Embree/OptiX traversal.

The reference delegates to `rtcIntersect1` (PathTracer.cpp:77-99) /
`optixTrace` (device_programs.cu:279-310) against vendor BVHs.  Here the
traversal is plain XLA, with two strategies behind one interface, chosen
by primitive count alone (`_use_unrolled`):

- **Unrolled scalar-prim streaming** (up to UNROLL_LIMIT primitives; the
  default scene has 20): a Python-unrolled loop over primitives where each
  prim's data is a traced *scalar* read; every ray-prim test is ~30
  full-width (N,) elementwise ops and the winner is carried with `where`
  selects.  No (N, C) broadcasting, no gathers, no argmin.
- **Chunked broadcast** (larger scenes, every mesh): (N, C) t-matrices with
  a running min and a final gather — brute force, every ray against every
  triangle, until a BVH traversal exists.

Everything is component-SoA (`Vec3`) — see ops/vec3.py for why.

Conventions:
- `t = INF` means miss (reference uses t = -1, device_programs.cu:748).
- Triangle normals are geometric, cross(e1, e2) — matching Embree's Ng and
  the GPU closesthit (device_programs.cu:761-820).  Integrators
  faceforward + normalize.
- `kind`: 0 miss, 1 triangle, 2 sphere (debug modes, LaunchParams.h:76-78).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from spt_tpu.ops import math3d as m3
from spt_tpu.ops.vec3 import Vec3
from spt_tpu.scene.flatten import DeviceScene

INF = np.float32(np.inf)

KIND_MISS = 0
KIND_TRIANGLE = 1
KIND_SPHERE = 2

# Möller-Trumbore determinant cutoff (parallel-ray rejection).
_MT_EPS = 1e-9

# Above this many primitives the unrolled program gets too large; larger
# scenes take the chunked broadcast path.
UNROLL_LIMIT = 192


class HitV(NamedTuple):
    """Component-SoA hit record (the HitRecord of LaunchParams.h:27-32,
    plus the interpolated TEXCOORD_0 the reference loads but never uses —
    GLTFLoader.cpp:219-331)."""

    t: jnp.ndarray        # (N,) float32, INF on miss
    normal: Vec3          # geometric normal (not normalized)
    mat_id: jnp.ndarray   # (N,) int32
    kind: jnp.ndarray     # (N,) int32
    # Interpolated texture coordinates at the hit; None when the scene is
    # untextured (intersectors only compute them when scene.tri_uv exists).
    uvx: jnp.ndarray = None   # (N,) float32
    uvy: jnp.ndarray = None   # (N,) float32

    @property
    def hit_mask(self) -> jnp.ndarray:
        return jnp.isfinite(self.t)


class Hit(NamedTuple):
    """Array-layout view of HitV (tests / external API)."""

    t: jnp.ndarray
    normal: jnp.ndarray   # (N, 3)
    mat_id: jnp.ndarray
    kind: jnp.ndarray

    @property
    def hit_mask(self) -> jnp.ndarray:
        return jnp.isfinite(self.t)


# --- unrolled scalar-prim path ------------------------------------------------

def _tri_scalar_test(scene, i, o: Vec3, d: Vec3, tmin, tmax, best_t,
                     with_uv: bool = False):
    """One triangle against all lanes; returns (ok, t, tri normal xyz[,
    barycentric (u, v)])."""
    v0x, v0y, v0z = scene.tri_v0[i, 0], scene.tri_v0[i, 1], scene.tri_v0[i, 2]
    e1x, e1y, e1z = scene.tri_e1[i, 0], scene.tri_e1[i, 1], scene.tri_e1[i, 2]
    e2x, e2y, e2z = scene.tri_e2[i, 0], scene.tri_e2[i, 1], scene.tri_e2[i, 2]
    # h = d x e2
    hx = d.y * e2z - d.z * e2y
    hy = d.z * e2x - d.x * e2z
    hz = d.x * e2y - d.y * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    inv = 1.0 / jnp.where(jnp.abs(a) > _MT_EPS, a, 1.0)
    sx, sy, sz = o.x - v0x, o.y - v0y, o.z - v0z
    u = inv * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (d.x * qx + d.y * qy + d.z * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    ok = (
        (jnp.abs(a) > _MT_EPS)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > tmin) & (t < tmax) & (t < best_t)
    )
    # geometric normal = e1 x e2 (scalar expression, hoisted by XLA)
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    if with_uv:
        return ok, t, (nx, ny, nz), (u, v)
    return ok, t, (nx, ny, nz)


def _sph_scalar_test(scene, i, o: Vec3, d: Vec3, tmin, tmax, best_t):
    cx, cy, cz = scene.sph_center[i, 0], scene.sph_center[i, 1], scene.sph_center[i, 2]
    r = scene.sph_radius[i]
    ocx, ocy, ocz = o.x - cx, o.y - cy, o.z - cz
    b = ocx * d.x + ocy * d.y + ocz * d.z
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - c
    sq = m3.safe_sqrt(disc)  # grad-safe: miss lanes are masked
    t0 = -b - sq
    t1 = -b + sq
    t = jnp.where((t0 > tmin) & (t0 < tmax), t0, t1)
    ok = (disc > 0.0) & (r > 0.0) & (t > tmin) & (t < tmax) & (t < best_t)
    return ok, t, (cx, cy, cz, r)


def _intersect_unrolled(scene, o: Vec3, d: Vec3, tmin, tmax) -> HitV:
    n = o.shape[0] if o.shape else o.x.shape[0]
    zeros = jnp.zeros(o.x.shape, jnp.float32)
    best_t = jnp.full(o.x.shape, INF)
    kind = jnp.zeros(o.x.shape, jnp.int32)
    mat = jnp.zeros(o.x.shape, jnp.int32)
    # Carry: triangle normal OR sphere center in (ax, ay, az); sphere 1/r.
    ax = ay = az = zeros
    rinv = zeros

    textured = scene.tri_uv is not None
    tri_ns = getattr(scene, "tri_ns", None)
    uvx = uvy = zeros
    for i in range(scene.num_triangles):
        ok, t, (nx, ny, nz), (bu, bv) = _tri_scalar_test(
            scene, i, o, d, tmin, tmax, best_t, with_uv=True
        )
        if tri_ns is not None:
            # interpolated shading normal (scalar row reads, hoisted by
            # XLA); zero rows fall back to geometric, as in
            # _intersect_chunked
            rn = tri_ns[i]
            snx = rn[0] + bu * rn[3] + bv * rn[6]
            sny = rn[1] + bu * rn[4] + bv * rn[7]
            snz = rn[2] + bu * rn[5] + bv * rn[8]
            ns_ok = snx * snx + sny * sny + snz * snz > 1e-12
            nx = jnp.where(ns_ok, snx, nx)
            ny = jnp.where(ns_ok, sny, ny)
            nz = jnp.where(ns_ok, snz, nz)
        best_t = jnp.where(ok, t, best_t)
        kind = jnp.where(ok, KIND_TRIANGLE, kind)
        mat = jnp.where(ok, scene.tri_mat[i], mat)
        ax = jnp.where(ok, nx, ax)
        ay = jnp.where(ok, ny, ay)
        az = jnp.where(ok, nz, az)
        if textured:
            r = scene.tri_uv[i]
            uvx = jnp.where(ok, r[0] + bu * r[2] + bv * r[4], uvx)
            uvy = jnp.where(ok, r[1] + bu * r[3] + bv * r[5], uvy)

    for i in range(scene.num_spheres):
        ok, t, (cx, cy, cz, r) = _sph_scalar_test(scene, i, o, d, tmin, tmax, best_t)
        best_t = jnp.where(ok, t, best_t)
        kind = jnp.where(ok, KIND_SPHERE, kind)
        mat = jnp.where(ok, scene.sph_mat[i], mat)
        ax = jnp.where(ok, cx, ax)
        ay = jnp.where(ok, cy, ay)
        az = jnp.where(ok, cz, az)
        rinv = jnp.where(ok, 1.0 / jnp.maximum(r, 1e-12), rinv)

    # Resolve normals: tri carried its normal; sphere -> (p - c) / r.
    t_safe = jnp.where(jnp.isfinite(best_t), best_t, 0.0)
    is_sph = kind == KIND_SPHERE
    px = o.x + t_safe * d.x
    py = o.y + t_safe * d.y
    pz = o.z + t_safe * d.z
    normal = Vec3(
        jnp.where(is_sph, (px - ax) * rinv, ax),
        jnp.where(is_sph, (py - ay) * rinv, ay),
        jnp.where(is_sph, (pz - az) * rinv, az),
    )
    if not textured:
        uvx = uvy = None
    return HitV(t=best_t, normal=normal, mat_id=mat, kind=kind,
                uvx=uvx, uvy=uvy)


def _occluded_unrolled(scene, o: Vec3, d: Vec3, tmin, tmax) -> jnp.ndarray:
    blocked = jnp.zeros(o.x.shape, bool)
    far = jnp.full(o.x.shape, INF)
    for i in range(scene.num_triangles):
        ok, _, _ = _tri_scalar_test(scene, i, o, d, tmin, tmax, far)
        blocked = blocked | ok
    for i in range(scene.num_spheres):
        ok, _, _ = _sph_scalar_test(scene, i, o, d, tmin, tmax, far)
        blocked = blocked | ok
    return blocked


# --- chunked broadcast path (large scenes) -------------------------------------

def _chunk(n: int, target: int) -> int:
    c = min(n, target)
    while n % c:
        c -= 1
    return c


def _tri_chunk_test(o, d, v0, e1, e2, tmin, tmax):
    """Möller-Trumbore for (N, C); o, d are (N, 3) arrays here."""
    dN = d[:, None, :]
    h = jnp.cross(dN, e2[None, :, :])
    a = jnp.sum(e1[None, :, :] * h, axis=-1)
    inv_a = 1.0 / jnp.where(jnp.abs(a) > _MT_EPS, a, 1.0)
    s = o[:, None, :] - v0[None, :, :]
    u = inv_a * jnp.sum(s * h, axis=-1)
    q = jnp.cross(s, e1[None, :, :])
    v = inv_a * jnp.sum(dN * q, axis=-1)
    t = inv_a * jnp.sum(e2[None, :, :] * q, axis=-1)
    valid = (
        (jnp.abs(a) > _MT_EPS)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > tmin) & (t < tmax[:, None])
    )
    return jnp.where(valid, t, INF)


def _sph_chunk_test(o, d, center, radius, tmin, tmax):
    oc = o[:, None, :] - center[None, :, :]
    b = jnp.sum(oc * d[:, None, :], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radius[None, :] * radius[None, :]
    disc = b * b - c
    ok = (disc > 0.0) & (radius[None, :] > 0.0)
    sq = m3.safe_sqrt(disc)  # grad-safe: miss lanes are masked
    t0 = -b - sq
    t1 = -b + sq
    tmaxc = tmax[:, None]
    t = jnp.where((t0 > tmin) & (t0 < tmaxc), t0, t1)
    valid = ok & (t > tmin) & (t < tmaxc)
    return jnp.where(valid, t, INF)


def _scan_chunks(test_one_chunk, n_prims: int, chunk: int, init):
    n_chunks = n_prims // chunk
    if n_chunks <= 16:
        carry = init
        for ci in range(n_chunks):
            carry = test_one_chunk(ci * chunk, carry)
        return carry
    return jax.lax.fori_loop(
        0, n_chunks, lambda ci, carry: test_one_chunk(ci * chunk, carry), init
    )


def _intersect_chunked(scene, o: Vec3, d: Vec3, tmin, tmax, chunk_size=128) -> HitV:
    oa = o.to_array()
    da = d.to_array()
    n = oa.shape[0]
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,))
    best_t = jnp.full((n,), INF)
    best_idx = jnp.zeros((n,), jnp.int32)
    best_kind = jnp.full((n,), KIND_MISS, jnp.int32)

    nt = scene.num_triangles
    if nt:
        c = _chunk(nt, chunk_size)

        def tri_chunk(start, carry):
            bt, bi, bk = carry
            v0 = jax.lax.dynamic_slice_in_dim(scene.tri_v0, start, c)
            e1 = jax.lax.dynamic_slice_in_dim(scene.tri_e1, start, c)
            e2 = jax.lax.dynamic_slice_in_dim(scene.tri_e2, start, c)
            t = _tri_chunk_test(oa, da, v0, e1, e2, tmin, tmax)
            tm = jnp.min(t, axis=1)
            am = jnp.argmin(t, axis=1).astype(jnp.int32) + start
            better = tm < bt
            return (
                jnp.where(better, tm, bt),
                jnp.where(better, am, bi),
                jnp.where(better, KIND_TRIANGLE, bk),
            )

        best_t, best_idx, best_kind = _scan_chunks(
            tri_chunk, nt, c, (best_t, best_idx, best_kind)
        )

    ns = scene.num_spheres
    if ns:
        c = _chunk(ns, chunk_size)

        def sph_chunk(start, carry):
            bt, bi, bk = carry
            ctr = jax.lax.dynamic_slice_in_dim(scene.sph_center, start, c)
            rad = jax.lax.dynamic_slice_in_dim(scene.sph_radius, start, c)
            t = _sph_chunk_test(oa, da, ctr, rad, tmin, tmax)
            tm = jnp.min(t, axis=1)
            am = jnp.argmin(t, axis=1).astype(jnp.int32) + start
            better = tm < bt
            return (
                jnp.where(better, tm, bt),
                jnp.where(better, am, bi),
                jnp.where(better, KIND_SPHERE, bk),
            )

        best_t, best_idx, best_kind = _scan_chunks(
            sph_chunk, ns, c, (best_t, best_idx, best_kind)
        )

    is_tri = best_kind == KIND_TRIANGLE
    is_sph = best_kind == KIND_SPHERE
    ti = jnp.where(is_tri, best_idx, 0)
    si = jnp.where(is_sph, best_idx, 0)

    tri_n = jnp.cross(scene.tri_e1[ti], scene.tri_e2[ti])
    t_safe = jnp.where(jnp.isfinite(best_t), best_t, 0.0)
    hit_p = oa + t_safe[:, None] * da
    sph_n = (hit_p - scene.sph_center[si]) / jnp.maximum(
        scene.sph_radius[si], 1e-12
    )[:, None]
    normal_a = jnp.where(is_tri[:, None], tri_n, jnp.where(is_sph[:, None], sph_n, 0.0))
    mat_id = jnp.where(
        is_tri, scene.tri_mat[ti], jnp.where(is_sph, scene.sph_mat[si], 0)
    ).astype(jnp.int32)

    uvx = uvy = None
    tri_ns = getattr(scene, "tri_ns", None)
    if scene.tri_uv is not None or tri_ns is not None:
        # Re-evaluate the winning triangle's barycentrics (one MT per lane —
        # cheaper than carrying (u, v) through every chunk's running min).
        wv0 = scene.tri_v0[ti]
        we1 = scene.tri_e1[ti]
        we2 = scene.tri_e2[ti]
        h = jnp.cross(da, we2)
        a = jnp.sum(we1 * h, axis=-1)
        inv_a = 1.0 / jnp.where(jnp.abs(a) > _MT_EPS, a, 1.0)
        s = oa - wv0
        bu = inv_a * jnp.sum(s * h, axis=-1)
        q = jnp.cross(s, we1)
        bv = inv_a * jnp.sum(da * q, axis=-1)
        if scene.tri_uv is not None:
            r = scene.tri_uv[ti]
            uvx = jnp.where(is_tri, r[:, 0] + bu * r[:, 2] + bv * r[:, 4],
                            0.0)
            uvy = jnp.where(is_tri, r[:, 1] + bu * r[:, 3] + bv * r[:, 5],
                            0.0)
        if tri_ns is not None:
            # interpolated shading normal; zero rows (mesh without
            # NORMALs) keep the geometric normal
            rn = tri_ns[ti]
            sn = (rn[:, 0:3] + bu[:, None] * rn[:, 3:6]
                  + bv[:, None] * rn[:, 6:9])
            use = (is_tri
                   & (jnp.sum(sn * sn, axis=-1) > 1e-12))
            normal_a = jnp.where(use[:, None], sn, normal_a)

    return HitV(
        t=best_t, normal=Vec3.from_array(normal_a), mat_id=mat_id,
        kind=best_kind, uvx=uvx, uvy=uvy
    )


def _occluded_chunked(scene, o: Vec3, d: Vec3, tmin, tmax, chunk_size=128):
    oa = o.to_array()
    da = d.to_array()
    n = oa.shape[0]
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,))
    blocked = jnp.zeros((n,), bool)

    nt = scene.num_triangles
    if nt:
        c = _chunk(nt, chunk_size)

        def tri_chunk(start, blocked):
            v0 = jax.lax.dynamic_slice_in_dim(scene.tri_v0, start, c)
            e1 = jax.lax.dynamic_slice_in_dim(scene.tri_e1, start, c)
            e2 = jax.lax.dynamic_slice_in_dim(scene.tri_e2, start, c)
            t = _tri_chunk_test(oa, da, v0, e1, e2, tmin, tmax)
            return blocked | jnp.any(jnp.isfinite(t), axis=1)

        blocked = _scan_chunks(tri_chunk, nt, c, blocked)

    ns = scene.num_spheres
    if ns:
        c = _chunk(ns, chunk_size)

        def sph_chunk(start, blocked):
            ctr = jax.lax.dynamic_slice_in_dim(scene.sph_center, start, c)
            rad = jax.lax.dynamic_slice_in_dim(scene.sph_radius, start, c)
            t = _sph_chunk_test(oa, da, ctr, rad, tmin, tmax)
            return blocked | jnp.any(jnp.isfinite(t), axis=1)

        blocked = _scan_chunks(sph_chunk, ns, c, blocked)

    return blocked


# --- public interface ---------------------------------------------------------

def _use_unrolled(scene: DeviceScene) -> bool:
    return (scene.num_triangles + scene.num_spheres) <= UNROLL_LIMIT


def intersect_v(scene: DeviceScene, o: Vec3, d: Vec3, tmin=1e-4, tmax=INF) -> HitV:
    """Closest-hit trace, Vec3-native (the hot path)."""
    if _use_unrolled(scene):
        return _intersect_unrolled(scene, o, d, tmin, tmax)
    return _intersect_chunked(scene, o, d, tmin, tmax)


def occluded_v(scene: DeviceScene, o: Vec3, d: Vec3, tmin=1e-4, tmax=INF) -> jnp.ndarray:
    """Any-hit shadow trace, Vec3-native (rtcOccluded1, Light.cpp:16-40)."""
    if _use_unrolled(scene):
        return _occluded_unrolled(scene, o, d, tmin, tmax)
    return _occluded_chunked(scene, o, d, tmin, tmax)


def intersect(scene: DeviceScene, origin, direction, tmin=1e-4, tmax=INF,
              chunk_size: int = 128) -> Hit:
    """(N, 3)-array wrapper around intersect_v."""
    hv = intersect_v(scene, Vec3.from_array(origin), Vec3.from_array(direction),
                     tmin, tmax)
    return Hit(t=hv.t, normal=hv.normal.to_array(), mat_id=hv.mat_id, kind=hv.kind)


def occluded(scene: DeviceScene, origin, direction, tmin=1e-4, tmax=INF,
             chunk_size: int = 128) -> jnp.ndarray:
    """(N, 3)-array wrapper around occluded_v."""
    return occluded_v(scene, Vec3.from_array(origin), Vec3.from_array(direction),
                      tmin, tmax)


def safe_origin_v(p: Vec3, n: Vec3, front) -> Vec3:
    """Scale-aware self-intersection offset (PathTracer.cpp:101-111)."""
    mag = jnp.maximum(jnp.abs(p.x), jnp.maximum(jnp.abs(p.y), jnp.abs(p.z)))
    eps = 1e-4 * jnp.maximum(1.0, mag)
    off = jnp.where(front, eps, -eps)
    return p + n * off


def safe_origin(hit_point, normal, front):
    """(N, 3)-array wrapper around safe_origin_v."""
    return safe_origin_v(
        Vec3.from_array(hit_point), Vec3.from_array(normal), front
    ).to_array()
