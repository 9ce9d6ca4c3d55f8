"""Scene fixtures for the intersection and render tests.

Each builder returns a SceneDesc; all randomness comes from fixed seeds.
Together they cover what the trace route has to get right: flat soups past
the unrolled limit, smooth vertex normals, texture coordinates, instances
with rotation / non-uniform scale / mirror / material override, emitters,
spheres mixed with triangles, and degenerate and edge-on triangles.
"""

import numpy as np

from spt_tpu.camera import Camera
from spt_tpu.scene import (SceneDesc, build_cornell_box_scene,
                           build_default_scene, build_seeded_mesh_scene)
from spt_tpu.scene.desc import Material, MeshData, create_sphere_mesh


def _rot_y(deg):
    a = np.deg2rad(deg)
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[2, 2] = np.cos(a)
    m[0, 2] = np.sin(a)
    m[2, 0] = -np.sin(a)
    return m


def _translate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (x, y, z)
    return m


def _scale(sx, sy, sz):
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    return m


def _soup_mesh(rng, nv, nt, material_id=0, spread=1.0):
    pos = rng.uniform(-spread, spread, (nv, 3)).astype(np.float32)
    idx = rng.integers(0, nv, (nt, 3)).astype(np.uint32)
    return MeshData(positions=pos, indices=idx, material_id=material_id)


def _materials(sc):
    sc.add_material(Material(base_color=[0.8, 0.3, 0.2], roughness=0.9))
    sc.add_material(Material(base_color=[0.2, 0.7, 0.3], roughness=0.6))
    sc.add_material(Material(base_color=[0.9, 0.8, 0.7], metallic=1.0,
                             roughness=0.3))


def soup():
    """300 random triangles in two meshes: a flat soup past the unrolled
    limit."""
    rng = np.random.default_rng(3)
    sc = SceneDesc()
    _materials(sc)
    sc.add_instance(sc.add_mesh(_soup_mesh(rng, 150, 200, 0, 2.0)))
    sc.add_instance(sc.add_mesh(_soup_mesh(rng, 80, 100, 1, 2.0)))
    return sc


def smooth_sphere():
    """A 16x24 UV sphere (768 triangles) with per-vertex normals."""
    sc = SceneDesc()
    sc.add_material(Material(base_color=[0.8, 0.6, 0.4]))
    sc.add_instance(sc.add_mesh(create_sphere_mesh(16, 24, radius=1.0)))
    return sc


def textured_grid(cells=(16, 8)):
    """A planar grid over [-1, 1]^2 at z = 0 (2 * 16 * 8 = 256 triangles)
    with texture coordinates u = (x + 1) / 2, v = (1 - y) / 2 and a
    checker baseColor texture."""
    nx, ny = cells
    xs = np.linspace(-1.0, 1.0, nx + 1, dtype=np.float32)
    ys = np.linspace(-1.0, 1.0, ny + 1, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    pos = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3)
    uv = np.stack([(pos[:, 0] + 1) / 2, (1 - pos[:, 1]) / 2], -1)
    idx = []
    for j in range(ny):
        for i in range(nx):
            a = j * (nx + 1) + i
            b, c, d = a + 1, a + nx + 1, a + nx + 2
            idx += [[a, b, d], [a, d, c]]
    tex = np.zeros((32, 32, 3), np.float32)
    tex[(np.arange(32)[:, None] // 8 + np.arange(32)[None, :] // 8) % 2 == 0] = 1
    sc = SceneDesc()
    sc.add_material(Material(base_color=[1, 1, 1], roughness=1.0,
                             base_color_texture=tex))
    sc.add_instance(sc.add_mesh(MeshData(
        positions=pos, indices=np.asarray(idx, np.uint32),
        normals=np.tile([[0.0, 0.0, 1.0]], (len(pos), 1)), texcoords=uv)))
    return sc


def instanced_grid():
    """Three transformed copies of one soup (rotation, non-uniform scale,
    a mirror, a material override), a second smaller mesh and a sphere,
    flattened to world space (690 triangles)."""
    rng = np.random.default_rng(11)
    sc = SceneDesc()
    _materials(sc)
    m0 = sc.add_mesh(_soup_mesh(rng, 120, 200, 0))
    m1 = sc.add_mesh(_soup_mesh(rng, 60, 90, 1))
    sc.add_instance(m0, _translate(-2.0, 0.0, 0.0))
    sc.add_instance(m0, _translate(2.0, 0.5, -1.0) @ _rot_y(35.0)
                    @ _scale(0.7, 1.3, 0.9))
    sc.add_instance(m0, _translate(0.0, -1.5, 1.0) @ _rot_y(-60.0)
                    @ _scale(-1.0, 1.0, 1.0), material_id=2)
    sc.add_instance(m1, _translate(0.0, 2.0, -2.0) @ _rot_y(10.0))
    sc.add_sphere([0.0, 0.0, -5.0], 1.0, 2)
    return sc


def cornell():
    """The emissive Cornell box (12 triangles, 2 spheres, 2 emitters)."""
    return build_cornell_box_scene()


def mixed():
    """150 triangles and 60 spheres: both chunked loops in one scene."""
    rng = np.random.default_rng(5)
    sc = SceneDesc()
    _materials(sc)
    sc.add_instance(sc.add_mesh(_soup_mesh(rng, 100, 150, 0, 2.0)))
    for i in range(60):
        c = rng.uniform(-2.5, 2.5, 3)
        sc.add_sphere(c.tolist(), float(rng.uniform(0.05, 0.3)), i % 3)
    return sc


def degenerate():
    """Zero-area, collinear and edge-on triangles beside ordinary ones:
    the first two must never be hit, the edge-on ones only from off their
    plane."""
    pos = np.array([
        [-1, 0, -3], [1, 0, -3], [0, 1.5, -3],          # ordinary
        [0.5, 0.5, -2], [0.5, 0.5, -2], [0.5, 0.5, -2],  # a point
        [-1, -1, -2.5], [0, 0, -2.5], [1, 1, -2.5],     # collinear
        [-2, -0.5, -4], [2, -0.5, -4], [0, -0.5, -1],   # horizontal plane
        [-1.5, -1, -1.5], [-1.5, 1, -1.5], [-1.5, 0, -4],  # vertical plane
    ], np.float32)
    idx = np.arange(15, dtype=np.uint32).reshape(5, 3)
    sc = SceneDesc()
    _materials(sc)
    sc.add_instance(sc.add_mesh(MeshData(positions=pos, indices=idx)))
    sc.add_sphere([1.2, 0.2, -3.5], 0.4, 1)
    return sc


def default():
    """The reference's default scene: 8 spheres and a 12-triangle cube."""
    return build_default_scene()


def seeded_mesh():
    """The seeded procedural mesh scene (3074 triangles)."""
    return build_seeded_mesh_scene(seed=0)


ALL = {f.__name__: f for f in (soup, smooth_sphere, textured_grid,
                                instanced_grid, cornell, mixed, degenerate,
                                default)}

CAMERAS = {
    "soup": dict(position=(0.0, 1.0, 6.5), target=(0.0, 0.0, 0.0)),
    "smooth_sphere": dict(position=(0.0, 0.5, 3.0), target=(0.0, 0.0, 0.0)),
    "instanced_grid": dict(position=(0.0, 1.0, 8.0), target=(0.0, 0.0, -1.0)),
    "cornell": dict(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0)),
    "mixed": dict(position=(0.0, 1.0, 7.0), target=(0.0, 0.0, 0.0)),
    "degenerate": dict(position=(0.0, 0.0, 1.0), target=(0.0, 0.0, -3.0)),
    "default": dict(position=(0.0, 3.0, 8.0), target=(0.0, 1.0, 0.0)),
    "seeded_mesh": dict(position=(0.5, 2.2, 5.0), target=(0.3, 1.0, 0.0)),
}


def camera(name, width, height):
    return Camera(fov_degrees=50.0, aspect_ratio=width / height,
                  **CAMERAS[name])


def rays(n=256, seed=0, spread=3.0):
    """(o, d) float32 arrays: origins in a box, unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)
