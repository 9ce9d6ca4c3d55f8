"""spt_tpu — a progressive Monte-Carlo wavefront path tracer in JAX.

A from-scratch re-design of the capabilities of `yangyonggit/simple-path-tracer`
(C++17 / Embree4 / OptiX 7.7): JAX/XLA for the compute path on the GPU,
`jax.sharding` + `shard_map` for multi-device scaling.

Architecture (vs. the reference):

- The reference's backend-agnostic ``scene::SceneDesc`` (SceneDesc.h:89-159)
  becomes :mod:`spt_tpu.scene` — a host-side description flattened into SoA
  ``jnp`` arrays (:class:`spt_tpu.scene.DeviceScene`).
- Embree/OptiX BVH traversal (EmbreeBackend.cpp, OptixBackend.cpp) becomes
  vectorized ray-primitive intersection (:mod:`spt_tpu.ops.intersect`):
  unrolled for small scenes, chunked brute force for meshes.
- The OptiX wavefront pipeline gen_primary -> [trace -> shade]*depth -> resolve
  (OptixBackend.cpp:1506-1850, device_programs.cu) becomes a single jitted
  multi-stage XLA program with an on-device depth loop — no host syncs per
  bounce (:mod:`spt_tpu.integrators.wavefront`).
- Atomic-counter index queues (device_programs.cu:268-273) become masked SoA
  lanes plus deterministic scan-based compaction (:mod:`spt_tpu.ops.compaction`).
- TBB tile parallelism (PathTracer.cpp:305-329) becomes pixel-axis sharding
  over a device mesh (:mod:`spt_tpu.parallel`).
"""

from spt_tpu.config import RenderConfig, GPU_PARITY
from spt_tpu.camera import Camera, default_camera

__version__ = "0.4.0"


def __getattr__(name):
    # Lazy re-exports: keep `import spt_tpu` light (no jax-heavy modules)
    # while offering the full user-facing API at the package root.
    lazy = {
        "SceneDesc": ("spt_tpu.scene", "SceneDesc"),
        "Material": ("spt_tpu.scene", "Material"),
        "build_default_scene": ("spt_tpu.scene", "build_default_scene"),
        "build_test_triangle_scene": ("spt_tpu.scene", "build_test_triangle_scene"),
        "build_cornell_box_scene": ("spt_tpu.scene", "build_cornell_box_scene"),
        "flatten_scene": ("spt_tpu.scene", "flatten_scene"),
        "Renderer": ("spt_tpu.engine", "Renderer"),
        "LightManager": ("spt_tpu.lights", "LightManager"),
        "load_environment": ("spt_tpu.env", "load_environment"),
        "load_gltf": ("spt_tpu.io.gltf", "load_gltf"),
        "render_wavefront": ("spt_tpu.integrators", "render_wavefront"),
        "render_megakernel": ("spt_tpu.integrators", "render_megakernel"),
    }
    if name in lazy:
        import importlib

        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'spt_tpu' has no attribute {name!r}")


__all__ = [
    "RenderConfig",
    "GPU_PARITY",
    "Camera",
    "default_camera",
    "SceneDesc",
    "Material",
    "build_default_scene",
    "build_test_triangle_scene",
    "build_cornell_box_scene",
    "flatten_scene",
    "Renderer",
    "LightManager",
    "load_environment",
    "load_gltf",
    "render_wavefront",
    "render_megakernel",
]
