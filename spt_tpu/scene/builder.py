"""Canonical scenes.

- :func:`build_default_scene` — the reference's default scene
  (SceneBuilder.cpp:9-123): 9 materials, 8 analytic spheres in rows, one glass
  cube instance (scale 1.5 at (0, 1, 2)).  The material table uses the
  MaterialManager presets (MaterialManager.cpp:21-52) since those — not
  SceneBuilder's shadowed list — are what both reference backends shade with
  (SURVEY.md §5 quirk 7).
- :func:`build_test_triangle_scene` — the bring-up fixture
  (SceneBuilder.cpp:126-159): 1 triangle mesh, 2 instances (identity +
  translate/scale), 1 sphere.
- :func:`build_cornell_box_scene` — the emissive multi-bounce benchmark scene
  (BASELINE.md config #2); not in the reference, which has no emissive scene
  despite supporting emission.
- :func:`build_seeded_mesh_scene` — a few thousand smooth-shaded triangles
  made from a seed: a mesh scene that needs no asset.
"""

from __future__ import annotations

import numpy as np

from spt_tpu import materials as mats
from spt_tpu.scene.desc import (
    Material,
    MeshData,
    SceneDesc,
    create_cube_mesh,
    create_ground_plane_mesh,
    create_sphere_mesh,
    translate,
    scale,
)


def build_default_scene() -> SceneDesc:
    scene = SceneDesc()
    for m in mats.default_materials():
        scene.add_material(m)

    cube_mesh_id = scene.add_mesh(create_cube_mesh(material_id=0))

    # Metal spheres — front row (SceneBuilder.cpp:98-103)
    scene.add_sphere([-3.0, 1.0, 0.0], 1.0, 0)   # gold
    scene.add_sphere([-1.0, 1.0, 0.0], 1.0, 1)   # silver
    scene.add_sphere([1.0, 1.0, 0.0], 1.0, 2)    # copper
    scene.add_sphere([3.0, 1.0, 0.0], 1.0, 3)    # iron
    # Dielectric + mixed — back rows (SceneBuilder.cpp:104-109)
    scene.add_sphere([-2.0, 1.0, -2.0], 1.0, 5)  # plastic
    scene.add_sphere([0.0, 1.0, -2.0], 1.0, 6)   # rubber
    scene.add_sphere([2.0, 1.0, -2.0], 1.0, 7)   # wood
    scene.add_sphere([0.0, 1.0, -4.0], 1.0, 8)   # concrete

    # Glass cube: translate(0,1,2) then scale(1.5) (SceneBuilder.cpp:116-118)
    xf = scale(translate(np.eye(4, dtype=np.float32), [0.0, 1.0, 2.0]), 1.5)
    scene.add_instance(cube_mesh_id, xf, material_id=4)
    return scene


def build_hdr_glass_scene() -> SceneDesc:
    """HDR-environment showcase: ground plane, one glass and one gold sphere
    (BASELINE.md config #4 — HDR env + directional light with glass).
    Pair with env.synthetic_equirect (the reference's default skybox asset is
    absent from its repo, PathTracer.cpp:24)."""
    scene = SceneDesc()
    white = scene.add_material(Material([0.8, 0.8, 0.8], roughness=0.9, ior=1.0))
    glass = scene.add_material(mats.glass())
    gold = scene.add_material(mats.gold())
    mid = scene.add_mesh(create_ground_plane_mesh(20.0, white))
    scene.add_instance(mid)
    scene.add_sphere([-1.2, 1.0, 0.0], 1.0, glass)
    scene.add_sphere([1.2, 1.0, 0.0], 1.0, gold)
    return scene


def build_test_triangle_scene() -> SceneDesc:
    scene = SceneDesc()
    scene.add_material(Material([0.8, 0.3, 0.3]))

    tri = MeshData(
        positions=np.array(
            [[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.5, 0.0]], np.float32
        ),
        indices=np.array([[0, 1, 2]], np.uint32),
        material_id=0,
    )
    mesh_id = scene.add_mesh(tri)

    # Identity instance + translated/scaled instance (transform validation).
    scene.add_instance(mesh_id, np.eye(4, dtype=np.float32), material_id=0)
    xf = scale(translate(np.eye(4, dtype=np.float32), [2.0, 0.0, -1.0]), 0.5)
    scene.add_instance(mesh_id, xf, material_id=0)

    # One analytic sphere (sphere-path validation, SceneBuilder.cpp:154-156).
    scene.add_sphere([-2.0, 0.5, -1.0], 0.5, 0)
    return scene


def build_cornell_box_scene(light_intensity: float = 15.0) -> SceneDesc:
    """Cornell-style box: white walls, red/green side walls, emissive ceiling
    quad, one metal and one glass sphere.  Exercises emission + multi-bounce
    + RR (BASELINE.md config #2)."""
    scene = SceneDesc()
    white = scene.add_material(Material([0.73, 0.73, 0.73], roughness=0.9, ior=1.0))
    red = scene.add_material(Material([0.65, 0.05, 0.05], roughness=0.9, ior=1.0))
    green = scene.add_material(Material([0.12, 0.45, 0.15], roughness=0.9, ior=1.0))
    lamp = scene.add_material(mats.light((1.0, 0.9, 0.75), light_intensity))
    mirror = scene.add_material(mats.silver())
    glass = scene.add_material(mats.glass())

    def quad(p0, p1, p2, p3, mat):
        mesh = MeshData(
            positions=np.array([p0, p1, p2, p3], np.float32),
            indices=np.array([[0, 1, 2], [0, 2, 3]], np.uint32),
            material_id=mat,
        )
        mid = scene.add_mesh(mesh)
        scene.add_instance(mid, np.eye(4, dtype=np.float32), material_id=mat)

    s = 2.75  # half box size
    # floor / ceiling / back / left(red) / right(green)
    quad([-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s], white)
    quad([-s, 2 * s, -s], [-s, 2 * s, s], [s, 2 * s, s], [s, 2 * s, -s], white)
    quad([-s, 0, -s], [-s, 2 * s, -s], [s, 2 * s, -s], [s, 0, -s], white)
    quad([-s, 0, -s], [-s, 0, s], [-s, 2 * s, s], [-s, 2 * s, -s], red)
    quad([s, 0, -s], [s, 2 * s, -s], [s, 2 * s, s], [s, 0, s], green)
    # ceiling light (slightly below ceiling, facing down)
    l = 0.9
    quad([-l, 2 * s - 0.01, -l], [l, 2 * s - 0.01, -l],
         [l, 2 * s - 0.01, l], [-l, 2 * s - 0.01, l], lamp)
    # spheres
    scene.add_sphere([-1.1, 0.9, -0.9], 0.9, mirror)
    scene.add_sphere([1.1, 0.9, 0.6], 0.9, glass)
    return scene


def build_seeded_mesh_scene(seed: int = 0, stacks: int = 32,
                            slices: int = 48) -> SceneDesc:
    """A noise-displaced UV sphere (2 * stacks * slices triangles with
    smooth vertex normals) on a ground plane, beside a gold sphere.  Made
    from `seed` alone, and far past the unrolled intersector's primitive
    limit, so it exercises the chunked mesh route without any asset."""
    rng = np.random.default_rng(seed)
    sphere = create_sphere_mesh(stacks, slices, radius=1.0)
    unit = sphere.normals.astype(np.float64)
    k = rng.normal(size=(4, 3)) * 2.5
    phase = rng.uniform(0.0, 2.0 * np.pi, 4)
    radius = 1.0 + 0.08 * np.sin(unit @ k.T + phase).sum(axis=1)
    pos = unit * radius[:, None] + np.array([0.0, 1.1, 0.0])
    # area-weighted vertex normals of the displaced surface
    idx = sphere.indices.astype(np.int64)
    face = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]], pos[idx[:, 2]] - pos[idx[:, 0]])
    nrm = np.zeros_like(pos)
    for c in range(3):
        np.add.at(nrm, idx[:, c], face)
    length = np.linalg.norm(nrm, axis=1, keepdims=True)
    # pole vertices touch only zero-area triangles: keep their radial normal
    nrm = np.where(length > 1e-12, nrm / np.maximum(length, 1e-20), unit)

    scene = SceneDesc()
    ground = scene.add_material(mats.concrete())
    body = scene.add_material(mats.plastic())
    gold = scene.add_material(mats.gold())
    scene.add_instance(scene.add_mesh(create_ground_plane_mesh(20.0, ground)))
    scene.add_instance(scene.add_mesh(MeshData(
        positions=pos.astype(np.float32), indices=sphere.indices,
        normals=nrm.astype(np.float32), material_id=body)))
    scene.add_sphere([2.2, 0.8, -0.5], 0.8, gold)
    return scene


def build_chair_grid_scene(nx: int = 4, nz: int = 4, path: str = None):
    """An nx x nz grid of rattan chairs (~98k triangles at 4x4) — the
    big-mesh benchmark scene (BASELINE.md config #3 at reference scale; the
    reference treats large glTFs as first-class input,
    GLTFLoader.cpp:202-331, and its backends accept any size,
    EmbreeBackend.cpp:181).  Returns (desc, center, radius) for camera
    framing.  Used by bench.py --scene bigmesh.
    """
    from spt_tpu.io.gltf import bounding_box, load_gltf

    if path is None:
        path = ("/root/reference/assets/models/rattan_dining_chair/"
                "scene.gltf")
    desc = load_gltf(path)
    lo, hi = bounding_box(desc)
    dx, dz = (hi - lo)[0] * 1.3, (hi - lo)[2] * 1.3
    base = list(desc.instances)
    for gx in range(nx):
        for gz in range(nz):
            if gx == 0 and gz == 0:
                continue
            t = np.eye(4, dtype=np.float32)
            t[0, 3], t[2, 3] = gx * dx, gz * dz
            for inst in base:
                desc.add_instance(inst.mesh_id, t @ inst.world_from_object,
                                  inst.material_id)
    center = 0.5 * (lo + hi)
    center[0] += (nx - 1) * dx / 2
    center[2] += (nz - 1) * dz / 2
    radius = float(np.linalg.norm(hi - lo)) * max(nx, nz)
    return desc, center, radius


def build_unique_grid_scene(nx: int = 4, nz: int = 4, path: str = None):
    """The chair grid with every copy baked to a UNIQUE mesh (~98k unique
    triangles at 4x4): positions pre-transformed per cell, one instance per
    mesh — the reference's any-mesh promise (EmbreeBackend.cpp:181, one
    rtcCommitScene whatever the size).  BASELINE stream config; used by
    bench.py --scene stream.  Returns (desc, center, radius)."""
    from spt_tpu.io.gltf import bounding_box, load_gltf
    from spt_tpu.scene.desc import MeshData, NO_MATERIAL

    if path is None:
        path = ("/root/reference/assets/models/rattan_dining_chair/"
                "scene.gltf")
    src = load_gltf(path)
    lo, hi = bounding_box(src)
    dx, dz = (hi - lo)[0] * 1.3, (hi - lo)[2] * 1.3
    desc = SceneDesc()
    for m in src.materials:
        desc.add_material(m)
    for gx in range(nx):
        for gz in range(nz):
            t = np.eye(4, dtype=np.float32)
            t[0, 3], t[2, 3] = gx * dx, gz * dz
            for inst in src.instances:
                mesh = src.meshes[inst.mesh_id]
                xf = t @ inst.world_from_object
                pos_h = np.concatenate(
                    [mesh.positions,
                     np.ones((mesh.vertex_count, 1), np.float32)], axis=1)
                world = (pos_h @ xf.T)[:, :3].astype(np.float32)
                nrm = None
                if mesh.normals is not None:
                    ofw = np.linalg.inv(np.asarray(xf, np.float64))[:3, :3]
                    nrm = mesh.normals.astype(np.float64) @ ofw
                    nrm /= np.maximum(
                        np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
                    nrm = nrm.astype(np.float32)
                mid = desc.add_mesh(MeshData(
                    positions=world, indices=mesh.indices, normals=nrm,
                    texcoords=mesh.texcoords,
                    material_id=mesh.material_id))
                desc.add_instance(
                    mid, material_id=(inst.material_id
                                      if inst.material_id != NO_MATERIAL
                                      else NO_MATERIAL))
    center = 0.5 * (lo + hi)
    center[0] += (nx - 1) * dx / 2
    center[2] += (nz - 1) * dz / 2
    radius = float(np.linalg.norm(hi - lo)) * max(nx, nz)
    return desc, center, radius
