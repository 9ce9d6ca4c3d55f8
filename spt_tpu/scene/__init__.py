"""Backend-agnostic scene description and its device flattening.

`SceneDesc` is the contract: the reference feeds one description to both the
Embree and OptiX backends (main.cpp:139-170); here one description feeds every
integrator via :func:`flatten_scene` -> :class:`DeviceScene`.
"""

from spt_tpu.scene.desc import (
    Material,
    MeshData,
    InstanceData,
    SphereData,
    SceneDesc,
    create_cube_mesh,
    create_ground_plane_mesh,
    create_sphere_mesh,
    MATERIAL_TYPE_PBR,
    MATERIAL_TYPE_DIELECTRIC,
)
from spt_tpu.scene.builder import (
    build_default_scene,
    build_test_triangle_scene,
    build_cornell_box_scene,
    build_chair_grid_scene,
    build_hdr_glass_scene,
    build_seeded_mesh_scene,
    build_unique_grid_scene,
)
from spt_tpu.scene.flatten import DeviceScene, flatten_scene

__all__ = [
    "Material",
    "MeshData",
    "InstanceData",
    "SphereData",
    "SceneDesc",
    "create_cube_mesh",
    "create_ground_plane_mesh",
    "create_sphere_mesh",
    "MATERIAL_TYPE_PBR",
    "MATERIAL_TYPE_DIELECTRIC",
    "build_default_scene",
    "build_test_triangle_scene",
    "build_cornell_box_scene",
    "build_chair_grid_scene",
    "build_hdr_glass_scene",
    "build_seeded_mesh_scene",
    "build_unique_grid_scene",
    "DeviceScene",
    "flatten_scene",
]
