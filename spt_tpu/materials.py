"""Material presets and the device-side SoA material table.

Replaces the reference's Material/MaterialManager pair (include/Material.h,
src/MaterialManager.cpp).  The preset library mirrors Materials::Gold..Light
(Material.h:99-148); the default table is MaterialManager's 9 presets
(MaterialManager.cpp:21-52) — note the Glass preset is *tagged*
MATERIAL_TYPE_DIELECTRIC there, unlike SceneBuilder's untagged glass; the
manager's list is what both reference backends actually shade with, so it is
our default too.

There is no SBT dispatch: `DeviceMaterials` is a (M, ...) SoA table and
a hit's material is a gather `table[mat_id]` (SURVEY.md §7 design stance).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

# NOTE: scene.desc is imported lazily inside functions — importing it here
# re-enters spt_tpu.scene.__init__ -> scene.flatten -> this module (a cycle
# that trips when spt_tpu.engine is imported before spt_tpu.scene).
MATERIAL_TYPE_PBR = 0
MATERIAL_TYPE_DIELECTRIC = 1


class DeviceMaterials(NamedTuple):
    """SoA material table (the `DeviceMaterial[]` of LaunchParams.h:34-43 —
    plus the emission/transparency fields the GPU left unused, SURVEY.md §5
    quirks 2 and 7, which we wire in)."""

    base_color: jnp.ndarray    # (M, 3) raw albedo; diffuse derived at shade
    metallic: jnp.ndarray      # (M,)
    roughness: jnp.ndarray     # (M,)
    ior: jnp.ndarray           # (M,)
    mat_type: jnp.ndarray      # (M,) int32: 0 PBR, 1 DIELECTRIC
    emission: jnp.ndarray      # (M, 3)
    transparency: jnp.ndarray  # (M,) derived via Material::getTransparency()
    tex_id: jnp.ndarray        # (M,) int32 index into the scene texture
                               # table, -1 when the material is untextured

    @property
    def count(self) -> int:
        return self.base_color.shape[0]


# Default device texture resolution: 128x128 = 16384 texels, stored as 16
# (8, 128) blocks of 1024 texels per plane.  The ACTUAL resolution of a
# scene's packed table is chosen per scene by choose_tex_res (byte-budgeted:
# few textures get 256^2, many get 64^2) and recovered from the table shape
# by tex_res_of — samplers must use that, never this constant.
TEX_RES = 128

# Bytes the packed table may spend (both int32 planes of every texture).
# 2 MiB = 4 textures at 256^2, 16 at 128^2, 64 at 64^2: a many-texture glTF
# keeps every texture (the reference behavior of "textures always work",
# GLTFLoader.cpp:219-331) at reduced resolution.  Whether a larger budget
# pays on a given GPU is a measurement.
_DEFAULT_TEX_BUDGET = 2 << 20


def tex_budget_bytes() -> int:
    """The packed-table byte budget (SPT_TEX_BUDGET overrides, bytes)."""
    import os

    try:
        return int(os.environ.get("SPT_TEX_BUDGET", _DEFAULT_TEX_BUDGET))
    except ValueError:
        return _DEFAULT_TEX_BUDGET


def choose_tex_res(n_tex: int) -> int:
    """Largest square resolution in {256, 128, 64} whose packed table
    (2 int32 planes per texture) fits tex_budget_bytes().  64 is the floor:
    below it bilinear filtering visibly posterizes, so past-the-floor scenes
    go over the budget."""
    budget = tex_budget_bytes()
    for res in (256, 128):
        if n_tex * 2 * res * res * 4 <= budget:
            return res
    return 64


def tex_res_of(textures) -> int:
    """Per-scene texture resolution from the packed table's static shape
    ((n_tex, tiles, 2, 8, 128) -> sqrt(tiles * 1024))."""
    return int(np.sqrt(textures.shape[1] * 1024))


def _resample_texture(img: np.ndarray, res: int = TEX_RES) -> np.ndarray:
    """(H, W, C) -> (res, res, C): area-average when downsampling (the
    chair's 2048^2 baseColor keeps its mean color per cell instead of one
    arbitrary texel), point sample where a cell gets no source texel."""
    img = np.asarray(img, np.float32)
    h, w, ch = img.shape
    yi = np.minimum((np.arange(res) + 0.5) / res * h, h - 1).astype(np.int64)
    xi = np.minimum((np.arange(res) + 0.5) / res * w, w - 1).astype(np.int64)
    point = img[yi][:, xi]
    if h <= res and w <= res:
        return point.astype(np.float32)
    if h % res == 0 and w % res == 0:
        # exact blocked mean (the common case: power-of-two source like the
        # chair's 2048^2); ~100x faster than the scatter-add path
        return img.reshape(res, h // res, res, w // res, ch).mean(
            (1, 3)).astype(np.float32)
    by = np.minimum(np.arange(h) * res // h, res - 1)
    bx = np.minimum(np.arange(w) * res // w, res - 1)
    acc = np.zeros((res, res, ch), np.float64)
    cnt = np.zeros((res, res, 1), np.float64)
    np.add.at(acc, (by[:, None], bx[None, :]), img)
    np.add.at(cnt, (by[:, None], bx[None, :]), 1.0)
    return np.where(cnt > 0, acc / np.maximum(cnt, 1.0),
                    point).astype(np.float32)


def _pack_color(rgb: np.ndarray) -> np.ndarray:
    """(.., 3) [0,1] floats -> packed int32, 10 bits/channel, sqrt-encoded
    (decode x^2: gamma-2-ish allocation keeps dark-texel precision).  One
    packed word = ONE gather per tap instead of three."""
    q = np.round(np.sqrt(np.clip(rgb, 0.0, 1.0)) * 1023.0).astype(np.uint32)
    return (q[..., 0] << 20) | (q[..., 1] << 10) | q[..., 2]


def _pack_mr(mr: np.ndarray) -> np.ndarray:
    """(.., 2) [0,1] (roughness, metallic) multipliers -> packed uint32,
    16 bits each.  The no-MR-texture neutral fill is (1, 1) = 0xFFFFFFFF."""
    q = np.round(np.clip(mr, 0.0, 1.0) * 65535.0).astype(np.uint32)
    return (q[..., 0] << 16) | q[..., 1]


def _tile(plane: np.ndarray) -> np.ndarray:
    """(res, res) uint32 -> (res^2/1024, 8, 128): texel (ty, tx) at
    flat = ty * res + tx -> (flat >> 10, (flat >> 7) & 7, flat & 127).
    Tiles are flat-index blocks of 1024 texels, so the split works for any
    res with res^2 % 1024 == 0 (every power of two >= 32)."""
    return plane.reshape(-1).reshape(-1, 8, 128)


def build_texture_table(materials: Sequence["Material"], res: int = None):
    """(tex_id (M,) int32, textures (n_tex, res^2/1024, 2, 8, 128) int32 |
    None).

    `res` defaults to choose_tex_res(n_textured) — the byte-budgeted
    per-scene resolution; recover it from the table with tex_res_of.
    Plane 0 of each tile pair is the packed baseColor (_pack_color); plane 1
    packs the (roughness, metallic) multipliers from the glTF
    metallicRoughness texture (G = roughness, B = metallic per spec), or the
    neutral (1, 1) when the material has none.  The sampler
    (transport.sample_texture_v) decodes with unpack_color / unpack_mr."""
    tex_id = np.full(max(len(materials), 1), -1, np.int32)
    textured = [
        (i, m) for i, m in enumerate(materials)
        if getattr(m, "base_color_texture", None) is not None
        or getattr(m, "metallic_roughness_texture", None) is not None
    ]
    if res is None:
        res = choose_tex_res(len(textured))
    imgs = []
    for i, m in textured:
        img = getattr(m, "base_color_texture", None)
        mr = getattr(m, "metallic_roughness_texture", None)
        tex_id[i] = len(imgs)
        if img is not None:
            color = _pack_color(_resample_texture(img, res))
        else:
            color = np.full((res, res), _pack_color(
                np.ones(3, np.float32)), np.uint32)
        if mr is not None:
            # glTF metallicRoughness: G = roughness, B = metallic
            mr_rs = _resample_texture(mr, res)
            packed_mr = _pack_mr(mr_rs[..., [1, 2]])
        else:
            packed_mr = np.full((res, res), np.uint32(0xFFFFFFFF))
        imgs.append(np.stack([_tile(color), _tile(packed_mr)], 1))
    if not imgs:
        return jnp.asarray(tex_id), None
    packed = np.stack(imgs).view(np.int32)
    return jnp.asarray(tex_id), jnp.asarray(packed)


def unpack_color(p):
    """Packed int32 plane -> (r, g, b) float arrays (inverse _pack_color).
    Works on jnp or np values (bit ops only)."""
    r = ((p >> 20) & 1023).astype(jnp.float32) * (1.0 / 1023.0)
    g = ((p >> 10) & 1023).astype(jnp.float32) * (1.0 / 1023.0)
    b = (p & 1023).astype(jnp.float32) * (1.0 / 1023.0)
    return r * r, g * g, b * b


def unpack_mr(p):
    """Packed int32 plane -> (roughness_mult, metallic_mult) floats."""
    rough = ((p >> 16) & 0xFFFF).astype(jnp.float32) * (1.0 / 65535.0)
    metal = (p & 0xFFFF).astype(jnp.float32) * (1.0 / 65535.0)
    return rough, metal


def build_device_materials(materials: Sequence["Material"]) -> DeviceMaterials:
    """Material list -> SoA table (MaterialManager::buildDeviceMaterials,
    MaterialManager.cpp:13-19, with derived transparency baked in)."""
    if len(materials) == 0:
        materials = [Material()]
    tex_id, _ = build_texture_table(materials)
    return DeviceMaterials(
        base_color=jnp.asarray(np.stack([m.base_color for m in materials]), jnp.float32),
        metallic=jnp.asarray(np.array([m.metallic for m in materials], np.float32)),
        roughness=jnp.asarray(np.array([m.roughness for m in materials], np.float32)),
        ior=jnp.asarray(np.array([m.ior for m in materials], np.float32)),
        mat_type=jnp.asarray(np.array([m.mat_type for m in materials], np.int32)),
        emission=jnp.asarray(np.stack([m.emission for m in materials]), jnp.float32),
        transparency=jnp.asarray(
            np.array([m.get_transparency() for m in materials], np.float32)
        ),
        tex_id=tex_id,
    )


def gather(table: DeviceMaterials, mat_id: jnp.ndarray) -> DeviceMaterials:
    """Per-lane material fetch with clamped ids (the GPU's defensive clamp,
    device_programs.cu:341-345)."""
    mid = jnp.clip(mat_id, 0, table.count - 1)
    return DeviceMaterials(
        base_color=table.base_color[mid],
        metallic=table.metallic[mid],
        roughness=table.roughness[mid],
        ior=table.ior[mid],
        mat_type=table.mat_type[mid],
        emission=table.emission[mid],
        transparency=table.transparency[mid],
        tex_id=table.tex_id[mid],
    )


# --- Preset library (Material.h:99-148) ---------------------------------------

def _material_cls():
    from spt_tpu.scene.desc import Material

    return Material


def gold() -> "Material":
    return _material_cls()([1.0, 0.71, 0.29], metallic=1.0, roughness=0.05)


def silver() -> "Material":
    return _material_cls()([0.95, 0.93, 0.88], metallic=1.0, roughness=0.02)


def copper() -> "Material":
    return _material_cls()([0.95, 0.64, 0.54], metallic=1.0, roughness=0.08)


def iron() -> "Material":
    return _material_cls()([0.56, 0.57, 0.58], metallic=1.0, roughness=0.3)


def plastic() -> "Material":
    return _material_cls()([0.8, 0.2, 0.2], metallic=0.0, roughness=0.4, ior=1.2)


def rubber() -> "Material":
    return _material_cls()([0.3, 0.3, 0.3], metallic=0.0, roughness=0.8, ior=1.1)


def glass() -> "Material":
    return _material_cls()([1.0, 1.0, 1.0], metallic=0.0, roughness=0.0, ior=1.5,
                           mat_type=MATERIAL_TYPE_DIELECTRIC)


def clear_glass() -> "Material":
    return _material_cls()([0.95, 0.98, 1.0], metallic=0.0, roughness=0.02,
                           ior=1.5, mat_type=MATERIAL_TYPE_DIELECTRIC)


def wood() -> "Material":
    return _material_cls()([0.4, 0.25, 0.1], metallic=0.0, roughness=0.7, ior=1.0)


def concrete() -> "Material":
    return _material_cls()([0.6, 0.6, 0.6], metallic=0.0, roughness=0.9, ior=1.0)


def light(color=(1.0, 1.0, 1.0), intensity: float = 5.0) -> "Material":
    return _material_cls()([0.0, 0.0, 0.0], metallic=0.0, roughness=1.0,
                           emission=np.asarray(color, np.float32) * intensity)


def default_materials() -> List["Material"]:
    """The 9-entry default table (MaterialManager.cpp:21-52):
    gold, silver, copper, iron, glass(DIELECTRIC), plastic, rubber, wood,
    concrete."""
    return [gold(), silver(), copper(), iron(), glass(),
            plastic(), rubber(), wood(), concrete()]


# --- component-SoA gather -----------------------------------------------------

from spt_tpu.ops.vec3 import Vec3  # noqa: E402
from typing import NamedTuple as _NT  # noqa: E402


class LaneMaterials(_NT):
    """Per-lane material parameters in Vec3/lane layout."""

    base_color: Vec3
    metallic: "jnp.ndarray"
    roughness: "jnp.ndarray"
    ior: "jnp.ndarray"
    mat_type: "jnp.ndarray"
    emission: Vec3
    transparency: "jnp.ndarray"
    tex_id: "jnp.ndarray"


def gather_v(table: DeviceMaterials, mat_id) -> LaneMaterials:
    """Per-lane material fetch, Vec3 layout (clamped ids,
    device_programs.cu:341-345)."""
    mid = jnp.clip(mat_id, 0, table.count - 1)
    bc = table.base_color[mid]
    em = table.emission[mid]
    return LaneMaterials(
        base_color=Vec3(bc[..., 0], bc[..., 1], bc[..., 2]),
        metallic=table.metallic[mid],
        roughness=table.roughness[mid],
        ior=table.ior[mid],
        mat_type=table.mat_type[mid],
        emission=Vec3(em[..., 0], em[..., 1], em[..., 2]),
        transparency=table.transparency[mid],
        tex_id=table.tex_id[mid],
    )
