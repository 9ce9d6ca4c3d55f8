"""glTF 2.0 loader (.gltf / .glb) -> SceneDesc.

The reference ships a tinygltf-based loader (GLTFLoader.cpp) that main never
wires into SceneDesc — `--i model.gltf` prints "not yet implemented"
(main.cpp:147-151).  This loader completes that integration (SURVEY.md §7
step 6): recursive node walk with TRS/matrix transforms
(GLTFLoader.cpp:202-217, 334-382), per-primitive POSITION/NORMAL/TEXCOORD_0 +
u8/u16/u32 index extraction (:219-331), computed-normal fallback (:176-200),
and pbrMetallicRoughness -> Material mapping.

Pure stdlib + numpy (no pygltflib in the image); PIL decodes texture
images.  baseColor textures ARE loaded and sampled — beyond the reference,
whose GLTFLoader reads TEXCOORD_0 and texture uris but whose backends never
sample a texture (GLTFLoader.cpp:219-331).  KHR extensions are ignored
except KHR_materials_emissive_strength / _transmission / _ior.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional

import numpy as np

from spt_tpu.scene.desc import (
    Material,
    MeshData,
    MATERIAL_TYPE_DIELECTRIC,
    SceneDesc,
)

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class _Gltf:
    def __init__(self, doc: dict, buffers: List[bytes]):
        self.doc = doc
        self.buffers = buffers

    def accessor(self, index: int) -> np.ndarray:
        acc = self.doc["accessors"][index]
        n_comp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        count = acc["count"]
        if "bufferView" not in acc:
            out = np.zeros((count, n_comp), dtype)
        else:
            bv = self.doc["bufferViews"][acc["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", 0)
            elem_size = np.dtype(dtype).itemsize * n_comp
            if stride in (0, elem_size):
                out = np.frombuffer(
                    buf, dtype, count=count * n_comp, offset=offset
                ).reshape(count, n_comp)
            else:
                raw = np.frombuffer(
                    buf, np.uint8, count=(count - 1) * stride + elem_size, offset=offset
                )
                idx = (np.arange(count)[:, None] * stride
                       + np.arange(elem_size)[None, :])
                out = raw[idx].view(dtype).reshape(count, n_comp)
        return out.copy()


def _load_buffers(doc: dict, base_dir: str, glb_bin: Optional[bytes]) -> List[bytes]:
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_bin or b"")
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _parse(path: str) -> _Gltf:
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head == b"glTF":  # binary container
            magic, version, _length = struct.unpack("<III", f.read(12))
            assert magic == 0x46546C67 and version == 2, "bad GLB header"
            doc = None
            glb_bin = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                clen, ctype = struct.unpack("<II", hdr)
                payload = f.read(clen)
                if ctype == 0x4E4F534A:      # JSON
                    doc = json.loads(payload)
                elif ctype == 0x004E4942:    # BIN
                    glb_bin = payload
            assert doc is not None, "GLB missing JSON chunk"
        else:
            doc = json.load(open(path))
            glb_bin = None
    return _Gltf(doc, _load_buffers(doc, base_dir, glb_bin))


def _node_matrix(node: dict) -> np.ndarray:
    """TRS / matrix -> 4x4 (GLTFLoader.cpp:334-382). glTF matrices are
    column-major flat lists."""
    if "matrix" in node:
        return np.array(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "translation" in node:
        m[:3, 3] = node["translation"]
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ],
            np.float32,
        )
        m[:3, :3] = m[:3, :3] @ r
    if "scale" in node:
        m[:3, :3] = m[:3, :3] * np.array(node["scale"], np.float32)[None, :]
    return m


def _computed_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (the fallback, GLTFLoader.cpp:176-200)."""
    n = np.zeros_like(positions)
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    fn = np.cross(positions[i1] - positions[i0], positions[i2] - positions[i0])
    np.add.at(n, i0, fn)
    np.add.at(n, i1, fn)
    np.add.at(n, i2, fn)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(lens, 1e-12)).astype(np.float32)


def _load_image(g: _Gltf, base_dir: str, image_index: int,
                srgb: bool = True):
    """Decode a glTF image (uri file, data uri, or bufferView) -> (H, W, 3)
    float32 LINEAR color.  baseColor images are sRGB-encoded per spec
    (srgb=True decodes them); metallicRoughness images are linear data
    (srgb=False returns raw channel values)."""
    import io as _io

    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            "this glTF has textures; decoding them needs Pillow "
            "(pip install pillow)") from exc
    img = g.doc["images"][image_index]
    try:
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
                pil = Image.open(_io.BytesIO(data))
            else:
                from urllib.parse import unquote

                pil = Image.open(os.path.join(base_dir, unquote(uri)))
        else:
            bv = g.doc["bufferViews"][img["bufferView"]]
            buf = g.buffers[bv["buffer"]]
            off = bv.get("byteOffset", 0)
            pil = Image.open(_io.BytesIO(buf[off:off + bv["byteLength"]]))
        arr = np.asarray(pil.convert("RGB"), np.float32) / 255.0
    except Exception as exc:
        import warnings

        warnings.warn(f"glTF image {image_index} "
                      f"({img.get('uri', '<bufferView>')!r}) failed to load "
                      f"({exc}); material renders untextured")
        return None
    if not srgb:
        return arr
    # sRGB -> linear (the exact EOTF; shading is linear throughout)
    return np.where(arr <= 0.04045, arr / 12.92,
                    ((arr + 0.055) / 1.055) ** 2.4).astype(np.float32)


def _material_texture(g: _Gltf, base_dir: str, gmat: dict, slot: str,
                      srgb: bool):
    """Resolve a pbrMetallicRoughness texture slot ('baseColorTexture' or
    'metallicRoughnessTexture', GLTFLoader.cpp:219-331 reads the same uris
    but never samples them) to a decoded image, or None."""
    pbr = gmat.get("pbrMetallicRoughness", {})
    tex = pbr.get(slot)
    if tex is None:
        return None
    textures = g.doc.get("textures", [])
    if tex.get("index", -1) >= len(textures):
        return None
    source = textures[tex["index"]].get("source")
    if source is None:
        return None
    return _load_image(g, base_dir, source, srgb=srgb)


def _base_color_texture(g: _Gltf, base_dir: str, gmat: dict):
    return _material_texture(g, base_dir, gmat, "baseColorTexture", True)


def _metallic_roughness_texture(g: _Gltf, base_dir: str, gmat: dict):
    return _material_texture(g, base_dir, gmat, "metallicRoughnessTexture",
                             False)


def _convert_material(gmat: dict, texture: np.ndarray = None,
                      mr_texture: np.ndarray = None) -> Material:
    pbr = gmat.get("pbrMetallicRoughness", {})
    base = np.array(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)[:3]
    metallic = float(pbr.get("metallicFactor", 1.0))
    roughness = float(pbr.get("roughnessFactor", 1.0))
    emissive = np.array(gmat.get("emissiveFactor", [0, 0, 0]), np.float32)
    strength = (
        gmat.get("extensions", {})
        .get("KHR_materials_emissive_strength", {})
        .get("emissiveStrength", 1.0)
    )
    transmission = (
        gmat.get("extensions", {})
        .get("KHR_materials_transmission", {})
        .get("transmissionFactor", 0.0)
    )
    ior = (
        gmat.get("extensions", {})
        .get("KHR_materials_ior", {})
        .get("ior", 1.5)
    )
    mat_type = MATERIAL_TYPE_DIELECTRIC if transmission > 0.5 else 0
    return Material(
        base_color=base,
        emission=emissive * strength,
        metallic=metallic,
        roughness=roughness,
        ior=float(ior),
        transparency=float(transmission),
        mat_type=mat_type,
        base_color_texture=texture,
        metallic_roughness_texture=mr_texture,
    )


def load_gltf(path: str, scene_desc: Optional[SceneDesc] = None) -> SceneDesc:
    """Load a glTF file into a SceneDesc (appending if one is given)."""
    g = _parse(path)
    doc = g.doc
    sd = scene_desc if scene_desc is not None else SceneDesc()

    # materials (offset if appending to an existing desc)
    base_dir = os.path.dirname(os.path.abspath(path))
    mat_base = len(sd.materials)
    gmats = doc.get("materials", [])
    for gm in gmats:
        sd.add_material(_convert_material(
            gm, _base_color_texture(g, base_dir, gm),
            _metallic_roughness_texture(g, base_dir, gm)))
    if not gmats:
        sd.add_material(Material())

    # meshes: one MeshData per primitive
    prim_mesh_ids: Dict[int, List[int]] = {}
    for mi, gmesh in enumerate(doc.get("meshes", [])):
        ids = []
        for prim in gmesh.get("primitives", []):
            if prim.get("mode", 4) != 4:  # TRIANGLES only
                continue
            attrs = prim["attributes"]
            positions = g.accessor(attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                indices = g.accessor(prim["indices"]).astype(np.uint32).reshape(-1, 3)
            else:
                indices = np.arange(len(positions), dtype=np.uint32).reshape(-1, 3)
            normals = (
                g.accessor(attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs
                else _computed_normals(positions, indices)
            )
            texcoords = (
                g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs
                else None
            )
            mat_id = mat_base + prim.get("material", 0)
            ids.append(
                sd.add_mesh(
                    MeshData(
                        positions=positions,
                        indices=indices,
                        normals=normals,
                        texcoords=texcoords,
                        material_id=mat_id,
                    )
                )
            )
        prim_mesh_ids[mi] = ids

    # node walk (GLTFLoader.cpp:202-217)
    def walk(node_index: int, parent: np.ndarray):
        node = doc["nodes"][node_index]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            for mesh_id in prim_mesh_ids.get(node["mesh"], []):
                sd.add_instance(mesh_id, world.astype(np.float32))
        for child in node.get("children", []):
            walk(child, world)

    scene_index = doc.get("scene", 0)
    scenes = doc.get("scenes", [])
    roots = scenes[scene_index].get("nodes", []) if scenes else range(len(doc.get("nodes", [])))
    for root in roots:
        walk(root, np.eye(4, dtype=np.float32))

    return sd


def bounding_box(sd: SceneDesc):
    """World-space AABB over all instanced geometry + spheres (the
    GLTFLoader bounding-box utility, GLTFLoader.h:71-108) — used by the CLI
    to frame the camera."""
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for inst in sd.instances:
        mesh = sd.meshes[inst.mesh_id]
        ph = np.concatenate([mesh.positions, np.ones((len(mesh.positions), 1), np.float32)], 1)
        world = (ph @ inst.world_from_object.T)[:, :3]
        lo = np.minimum(lo, world.min(0))
        hi = np.maximum(hi, world.max(0))
    for sph in sd.spheres:
        lo = np.minimum(lo, sph.center - sph.radius)
        hi = np.maximum(hi, sph.center + sph.radius)
    if not np.isfinite(lo).all():
        lo, hi = np.zeros(3), np.zeros(3)
    return lo.astype(np.float32), hi.astype(np.float32)
