"""SceneDesc -> DeviceScene: the analog of the backend build step.

The reference's EmbreeBackend flattens instances by pre-transforming triangle
geometry into world space (positions by worldFromObject, normals by
inverse-transpose; EmbreeBackend.cpp:60-79) and registers analytic spheres as
user geometry (:139-178), maintaining a geomID->materialId map (:129-174).

Here the flattening produces dense SoA arrays with static shapes.  Padding
is OFF by default — the intersectors iterate exact prim counts, and each
padded prim would be a 100%-wasted full-width test (25% of the default
scene!).  When padding is requested (pad_multiple > 1), padded triangles
are degenerate (zero area -> Möller-Trumbore determinant 0, never hit) and
padded spheres have radius 0 (discriminant < 0 for any ray not through the
center).
Material resolution order matches EmbreeBackend.cpp:51-57: instance override,
then mesh material, then 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from spt_tpu.materials import DeviceMaterials, build_device_materials
from spt_tpu.scene.desc import NO_MATERIAL, SceneDesc

# Shading normals are stored on a 12-bit grid over [-2, 2] (n0 is unit,
# dn1/dn2 are differences of units): q = 1 + round((v + 2) / NS_STEP), in
# ~1e-3 steps, <= 0.06 deg of normal error.  Every intersector and the CPU
# oracle shade with these quantized values, so the images do not depend on
# which of them ran.
NS_STEP = np.float32(4.0 / 4094.0)


def quantize_ns(ns: np.ndarray) -> np.ndarray:
    """(T, 9) shading-normal table -> the same table on the 12-bit grid.
    All-zero rows (the flat/no-NORMAL sentinel) stay all-zero."""
    ns = np.asarray(ns, np.float32).reshape(-1, 9)
    q = (np.float32(1.0) + np.round((np.clip(ns, -2.0, 2.0) + np.float32(2.0))
                                    / NS_STEP)).astype(np.float32)
    out = (q - np.float32(1.0)) * NS_STEP - np.float32(2.0)
    out[np.abs(ns).max(axis=1) == 0.0] = 0.0
    return out


class EmitterTable(NamedTuple):
    """Emissive-triangle table for next-event estimation (area lights).

    The reference supports emissive materials but never samples them — its
    planned shadow-ray wavefront (wf_types.h:51-63 ShadowTask) only covered
    analytic lights.  Sampling emitters directly is the standard fix for
    emissive-scene variance (the Cornell-box benchmark, BASELINE.md #2).
    """

    v0: jnp.ndarray    # (E, 3)
    e1: jnp.ndarray    # (E, 3)
    e2: jnp.ndarray    # (E, 3)
    le: jnp.ndarray    # (E, 3) emitted radiance
    area: jnp.ndarray  # (E,)

    @property
    def count(self) -> int:
        return self.v0.shape[0]


class DeviceScene(NamedTuple):
    """World-space scene as SoA device arrays. A pytree — passes straight
    through jit/shard_map; replicate per chip for image-space DP
    (SURVEY.md §2 parallelism table)."""

    tri_v0: jnp.ndarray       # (T, 3) float32
    tri_e1: jnp.ndarray       # (T, 3) v1 - v0 (precomputed MT edges)
    tri_e2: jnp.ndarray       # (T, 3) v2 - v0
    tri_mat: jnp.ndarray      # (T,) int32
    sph_center: jnp.ndarray   # (S, 3) float32
    sph_radius: jnp.ndarray   # (S,) float32 (0 for padding)
    sph_mat: jnp.ndarray      # (S,) int32
    materials: DeviceMaterials
    # Emissive triangles for NEE; None when the scene has no emitters.
    emitters: Optional[EmitterTable] = None
    # Per-triangle texture coordinates [uv0 | uv1-uv0 | uv2-uv0], (T, 6)
    # float32; None when no material carries a texture (the common case —
    # keeps untextured programs free of the extra tables).
    tri_uv: Optional[jnp.ndarray] = None
    # Scene texture table (n_tex, tiles, 2, 8, 128) int32 — packed
    # baseColor and metallicRoughness images
    # (materials.build_texture_table); None when untextured.
    textures: Optional[jnp.ndarray] = None
    # Per-triangle WORLD-space shading normals [n0 | n1-n0 | n2-n0],
    # (T, 9) float32 — vertex NORMALs transformed by the instance
    # inverse-transpose (EmbreeBackend.cpp:60-79's fidelity, which the
    # reference's backends then drop by shading with Ng); interpolated at
    # the hit by every intersector.  None when no mesh carries normals;
    # meshes without normals contribute zero rows (geometric fallback).
    tri_ns: Optional[jnp.ndarray] = None

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]


def _resolve_material(instance, mesh) -> int:
    mid = instance.material_id
    if mid == NO_MATERIAL:
        mid = mesh.material_id
    if mid == NO_MATERIAL:
        mid = 0
    return int(mid)


def _pad_to(n: int, multiple: int) -> int:
    if n == 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def flatten_scene(desc: SceneDesc, pad_multiple: int = 1) -> DeviceScene:
    """Bake instance transforms and build the padded SoA arrays (the
    rtcCommitScene/optixAccelBuild step, EmbreeBackend.cpp:181 /
    OptixBackend.cpp:916-1180, minus the BVH)."""
    v0s, v1s, v2s, tri_mats, tri_uvs, tri_nss = [], [], [], [], [], []
    has_ns = False
    for inst in desc.instances:
        if inst.mesh_id >= len(desc.meshes):
            continue
        mesh = desc.meshes[inst.mesh_id]
        if not mesh.is_valid():
            continue
        mat_id = _resolve_material(inst, mesh)
        # positions -> world (EmbreeBackend.cpp:63-69)
        xf = inst.world_from_object
        pos_h = np.concatenate(
            [mesh.positions, np.ones((mesh.vertex_count, 1), np.float32)], axis=1
        )
        world = (pos_h @ xf.T)[:, :3].astype(np.float32)
        idx = mesh.indices.astype(np.int64)
        v0s.append(world[idx[:, 0]])
        v1s.append(world[idx[:, 1]])
        v2s.append(world[idx[:, 2]])
        tri_mats.append(np.full(idx.shape[0], mat_id, np.int32))
        if mesh.texcoords is not None and len(mesh.texcoords) == mesh.vertex_count:
            tc = mesh.texcoords
            uv0 = tc[idx[:, 0]]
            tri_uvs.append(np.concatenate(
                [uv0, tc[idx[:, 1]] - uv0, tc[idx[:, 2]] - uv0], axis=1
            ).astype(np.float32))
        else:
            tri_uvs.append(np.zeros((idx.shape[0], 6), np.float32))
        if mesh.normals is not None and len(mesh.normals) == mesh.vertex_count:
            # normals -> world by the inverse-transpose
            # (EmbreeBackend.cpp:70-79); row-vector form n_w = n_o @ R_ofw
            ofw = np.linalg.inv(np.asarray(xf, np.float64))[:3, :3]
            nw = (mesh.normals.astype(np.float64) @ ofw)
            nw /= np.maximum(np.linalg.norm(nw, axis=1, keepdims=True),
                             1e-20)
            nw = nw.astype(np.float32)
            n0 = nw[idx[:, 0]]
            tri_nss.append(np.concatenate(
                [n0, nw[idx[:, 1]] - n0, nw[idx[:, 2]] - n0], axis=1))
            has_ns = True
        else:
            tri_nss.append(np.zeros((idx.shape[0], 9), np.float32))

    if v0s:
        v0 = np.concatenate(v0s)
        v1 = np.concatenate(v1s)
        v2 = np.concatenate(v2s)
        tri_mat = np.concatenate(tri_mats)
        tri_uv = np.concatenate(tri_uvs)
        tri_ns = np.concatenate(tri_nss)
    else:
        v0 = np.zeros((0, 3), np.float32)
        v1 = np.zeros((0, 3), np.float32)
        v2 = np.zeros((0, 3), np.float32)
        tri_mat = np.zeros((0,), np.int32)
        tri_uv = np.zeros((0, 6), np.float32)
        tri_ns = np.zeros((0, 9), np.float32)

    if has_ns:
        # SPT_NS=0 drops shading normals entirely (flat shading, the
        # reference backends' behavior) — the quality/speed knob and the
        # A/B that prices the interpolation.
        import os

        has_ns = os.environ.get("SPT_NS", "1") != "0"
    if has_ns and v0.shape[0]:
        # Drop the table when interpolation is everywhere the geometric
        # normal anyway (flat meshes like the ground plane, whose vertex
        # normals are constant and aligned with the winding): those scenes
        # keep the exact normal-less programs — the default/cornell hot
        # paths pay nothing for this feature.
        ng = np.cross(v1 - v0, v2 - v0)
        ngl = np.linalg.norm(ng, axis=1, keepdims=True)
        real = ngl[:, 0] > 1e-20
        ngn = ng / np.maximum(ngl, 1e-20)
        varying = np.abs(tri_ns[:, 3:9]).max(axis=1) > 1e-6
        nonzero = np.abs(tri_ns[:, 0:3]).max(axis=1) > 1e-12
        off_geom = np.abs(tri_ns[:, 0:3] - ngn).max(axis=1) > 1e-3
        has_ns = bool((real & nonzero & (varying | off_geom)).any())
    if has_ns:
        tri_ns = quantize_ns(tri_ns)

    t_pad = _pad_to(v0.shape[0], pad_multiple)
    pad_n = t_pad - v0.shape[0]
    if pad_n:
        zero = np.zeros((pad_n, 3), np.float32)
        v0 = np.concatenate([v0, zero])
        v1 = np.concatenate([v1, zero])
        v2 = np.concatenate([v2, zero])
        tri_mat = np.concatenate([tri_mat, np.zeros(pad_n, np.int32)])
        tri_uv = np.concatenate([tri_uv, np.zeros((pad_n, 6), np.float32)])
        tri_ns = np.concatenate([tri_ns, np.zeros((pad_n, 9), np.float32)])

    if desc.spheres:
        centers = np.stack([s.center for s in desc.spheres]).astype(np.float32)
        radii = np.array([s.radius for s in desc.spheres], np.float32)
        sph_mat = np.array([s.material_id for s in desc.spheres], np.int32)
    else:
        centers = np.zeros((0, 3), np.float32)
        radii = np.zeros((0,), np.float32)
        sph_mat = np.zeros((0,), np.int32)

    s_pad = _pad_to(centers.shape[0], pad_multiple)
    pad_n = s_pad - centers.shape[0]
    if pad_n:
        centers = np.concatenate([centers, np.zeros((pad_n, 3), np.float32)])
        radii = np.concatenate([radii, np.zeros(pad_n, np.float32)])
        sph_mat = np.concatenate([sph_mat, np.zeros(pad_n, np.int32)])

    # Emitter table: triangles whose material emits.
    emitters = None
    if len(desc.materials) and v0.shape[0]:
        em = np.stack([m.emission for m in desc.materials]).astype(np.float32)
        emissive_mat = (em.max(axis=1) > 0.0)
        tm_clip = np.clip(tri_mat, 0, len(desc.materials) - 1)
        sel = emissive_mat[tm_clip]
        # padded tris have mat 0; exclude degenerates
        degen = (np.abs(v1 - v0).sum(1) == 0) & (np.abs(v2 - v0).sum(1) == 0)
        sel = sel & ~degen
        if sel.any():
            ev0, ee1, ee2 = v0[sel], (v1 - v0)[sel], (v2 - v0)[sel]
            area = 0.5 * np.linalg.norm(np.cross(ee1, ee2), axis=1)
            emitters = EmitterTable(
                v0=jnp.asarray(ev0),
                e1=jnp.asarray(ee1),
                e2=jnp.asarray(ee2),
                le=jnp.asarray(em[tm_clip[sel]]),
                area=jnp.asarray(area.astype(np.float32)),
            )

    from spt_tpu.materials import build_texture_table

    _, textures = build_texture_table(desc.materials)
    return DeviceScene(
        tri_v0=jnp.asarray(v0),
        tri_e1=jnp.asarray(v1 - v0),
        tri_e2=jnp.asarray(v2 - v0),
        tri_mat=jnp.asarray(tri_mat),
        sph_center=jnp.asarray(centers),
        sph_radius=jnp.asarray(radii),
        sph_mat=jnp.asarray(sph_mat),
        materials=build_device_materials(desc.materials),
        emitters=emitters,
        tri_uv=jnp.asarray(tri_uv) if textures is not None else None,
        textures=textures,
        tri_ns=jnp.asarray(tri_ns) if has_ns else None,
    )

