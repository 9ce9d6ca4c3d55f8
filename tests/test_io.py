"""Asset ingestion: HDR read/write, cross-layout cubemaps, glTF."""

import json
import os
import struct

import numpy as np
import pytest

from spt_tpu.io.cubemap_cross import cross_to_equirect, extract_faces
from spt_tpu.io.hdr import detect_layout, read_hdr, write_hdr
from spt_tpu.io.gltf import bounding_box, load_gltf
from spt_tpu.scene import flatten_scene

CHAIR = "/root/reference/assets/models/rattan_dining_chair/scene.gltf"


class TestHdr:
    def test_roundtrip(self, tmp_path, rng):
        img = (rng.uniform(0, 50, size=(16, 32, 3)) ** 2).astype(np.float32)
        p = str(tmp_path / "t.hdr")
        write_hdr(p, img)
        back = read_hdr(p)
        assert back.shape == img.shape
        # RGBE shares one exponent across channels: per-pixel error is
        # bounded by max_channel / 256 (8-bit mantissa), not relative.
        bound = img.max(axis=-1, keepdims=True) / 256.0 + 1e-4
        assert np.all(np.abs(back - img) <= bound)

    def test_zero_pixels(self, tmp_path):
        img = np.zeros((4, 8, 3), np.float32)
        p = str(tmp_path / "z.hdr")
        write_hdr(p, img)
        np.testing.assert_array_equal(read_hdr(p), 0.0)

    def test_rle_scanlines(self, tmp_path):
        # Build an adaptive-RLE file by hand: constant rows compress to runs.
        w, h = 16, 2
        rgbe_row = np.tile(np.array([128, 64, 32, 136], np.uint8), (w, 1))
        with open(tmp_path / "rle.hdr", "wb") as f:
            f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
            f.write(f"-Y {h} +X {w}\n".encode())
            for _ in range(h):
                f.write(bytes([2, 2, 0, w]))
                for ch in range(4):
                    f.write(bytes([128 + w, int(rgbe_row[0, ch])]))  # one run
        img = read_hdr(str(tmp_path / "rle.hdr"))
        assert img.shape == (h, w, 3)
        # e=136 -> scale 1.0: value = (mantissa + 0.5)
        np.testing.assert_allclose(img[0, 0], [128.5, 64.5, 32.5], rtol=1e-6)

    def test_bench_hdr_config_uses_real_file(self, tmp_path, monkeypatch):
        # The benched HDR config must exercise the real file pipeline:
        # write_hdr -> read_hdr -> layout autodetect -> equirect env.
        # Small height here; bench uses 1024.
        import sys

        sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
        import tempfile

        monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
        from bench import build_workload

        r = build_workload("hdr", 64, 48)
        assert os.path.exists(str(tmp_path / "spt_bench_sunsky_1024.hdr"))
        img = np.asarray(r.env.image)
        assert img.shape == (1024, 2048, 3)
        # RGBE roundtrip keeps the sun's >5.0 radiance (clamped at sample
        # time, not in the stored image)
        assert img.max() > 5.0

    def test_detect_layout(self):
        assert detect_layout(2048, 1024) == "equirect"
        assert detect_layout(400, 300) == "cross"
        assert detect_layout(512, 512) == "unknown"


class TestCross:
    def _cross(self, s=16):
        # distinct constant color per face position
        img = np.zeros((3 * s, 4 * s, 3), np.float32)
        colors = {
            "+x": [1, 0, 0], "-x": [0, 1, 0], "+y": [0, 0, 1],
            "-y": [1, 1, 0], "+z": [1, 0, 1], "-z": [0, 1, 1],
        }
        offsets = {"+x": (2, 1), "-x": (0, 1), "+y": (1, 0),
                   "-y": (1, 2), "+z": (1, 1), "-z": (3, 1)}
        for name, (gx, gy) in offsets.items():
            img[gy * s:(gy + 1) * s, gx * s:(gx + 1) * s] = colors[name]
        return img, colors

    def test_extract_faces(self):
        img, colors = self._cross()
        faces = extract_faces(img)
        for name, c in colors.items():
            np.testing.assert_allclose(faces[name][0, 0], c)

    def test_cross_to_equirect_axes(self):
        img, colors = self._cross()
        eq = cross_to_equirect(img, out_height=64)
        h, w = eq.shape[:2]
        # +y (v=0 top rows) -> blue; -y -> yellow
        np.testing.assert_allclose(eq[0, w // 2], colors["+y"])
        np.testing.assert_allclose(eq[-1, w // 2], colors["-y"])
        # theta=0 -> +x at u=0.5
        np.testing.assert_allclose(eq[h // 2, w // 2], colors["+x"])
        # theta=±pi -> -x at u=0 / u=1
        np.testing.assert_allclose(eq[h // 2, 0], colors["-x"])
        # theta=pi/2 -> +z at u=0.75
        np.testing.assert_allclose(eq[h // 2, 3 * w // 4], colors["+z"])


class TestGltf:
    @pytest.mark.skipif(not os.path.exists(CHAIR), reason="no chair asset")
    def test_load_reference_chair(self):
        sd = load_gltf(CHAIR)
        assert sd.total_triangles == 6116
        assert len(sd.instances) == 1
        dev = flatten_scene(sd)
        assert dev.num_triangles >= 6116
        lo, hi = bounding_box(sd)
        assert (hi > lo).all()
        # chair is ~0.76 m tall, sits on the ground plane
        assert 0.5 < hi[1] - lo[1] < 1.5

    def test_minimal_gltf_with_trs(self, tmp_path):
        # one triangle, instanced twice: identity node + translated node
        positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        indices = np.array([0, 1, 2], np.uint16)
        bin_data = positions.tobytes() + indices.tobytes() + b"\x00\x00"
        doc = {
            "asset": {"version": "2.0"},
            "scene": 0,
            "scenes": [{"nodes": [0, 1]}],
            "nodes": [
                {"mesh": 0},
                {"mesh": 0, "translation": [5, 0, 0], "scale": [2, 2, 2]},
            ],
            "meshes": [{
                "primitives": [{
                    "attributes": {"POSITION": 0}, "indices": 1, "material": 0,
                }],
            }],
            "materials": [{
                "pbrMetallicRoughness": {
                    "baseColorFactor": [0.8, 0.1, 0.1, 1.0],
                    "metallicFactor": 0.0,
                    "roughnessFactor": 0.4,
                },
            }],
            "accessors": [
                {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
                {"bufferView": 1, "componentType": 5123, "count": 3, "type": "SCALAR"},
            ],
            "bufferViews": [
                {"buffer": 0, "byteOffset": 0, "byteLength": 36},
                {"buffer": 0, "byteOffset": 36, "byteLength": 6},
            ],
            "buffers": [{"uri": "data.bin", "byteLength": len(bin_data)}],
        }
        (tmp_path / "data.bin").write_bytes(bin_data)
        (tmp_path / "tri.gltf").write_text(json.dumps(doc))

        sd = load_gltf(str(tmp_path / "tri.gltf"))
        assert len(sd.meshes) == 1 and len(sd.instances) == 2
        np.testing.assert_allclose(sd.materials[0].base_color, [0.8, 0.1, 0.1])
        dev = flatten_scene(sd)
        # second instance: translated by (5,0,0), scaled 2x
        v0 = np.asarray(dev.tri_v0[1])
        np.testing.assert_allclose(v0, [5, 0, 0], atol=1e-6)
        e1 = np.asarray(dev.tri_e1[1])
        np.testing.assert_allclose(e1, [2, 0, 0], atol=1e-6)

    def test_glb_container(self, tmp_path):
        positions = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        bin_chunk = positions.tobytes()
        doc = {
            "asset": {"version": "2.0"},
            "scenes": [{"nodes": [0]}],
            "nodes": [{"mesh": 0}],
            "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
            "accessors": [
                {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
            ],
            "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 36}],
            "buffers": [{"byteLength": len(bin_chunk)}],
        }
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        bin_pad = bin_chunk + b"\x00" * (-len(bin_chunk) % 4)
        total = 12 + 8 + len(js) + 8 + len(bin_pad)
        glb = (
            struct.pack("<III", 0x46546C67, 2, total)
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(bin_pad), 0x004E4942) + bin_pad
        )
        p = tmp_path / "t.glb"
        p.write_bytes(glb)
        sd = load_gltf(str(p))
        assert len(sd.meshes) == 1
        assert sd.meshes[0].triangle_count == 1


class TestEnvLayoutAutodetect:
    def test_cross_hdr_converted(self, tmp_path):
        from spt_tpu.env import load_environment
        import jax.numpy as jnp
        from spt_tpu.env import environment_color_v
        from spt_tpu.ops.vec3 import Vec3

        s = 16
        img = np.zeros((3 * s, 4 * s, 3), np.float32)
        offsets = {"+x": (2, 1), "-x": (0, 1), "+y": (1, 0),
                   "-y": (1, 2), "+z": (1, 1), "-z": (3, 1)}
        colors = {"+x": [1, 0, 0], "-x": [0, 1, 0], "+y": [0, 0, 1],
                  "-y": [1, 1, 0], "+z": [1, 0, 1], "-z": [0, 1, 1]}
        for name, (gx, gy) in offsets.items():
            img[gy * s:(gy + 1) * s, gx * s:(gx + 1) * s] = colors[name]
        p = str(tmp_path / "cross.hdr")
        write_hdr(p, img)

        env = load_environment(p)
        assert bool(env.enabled)
        # +y direction must sample the +y face color (blue)
        up = Vec3(jnp.array([0.0]), jnp.array([1.0]), jnp.array([0.0]))
        c = np.array(environment_color_v(env, up).to_array())[0]
        # intensity 0.8 scaling applies
        np.testing.assert_allclose(c, np.array([0, 0, 1.0]) * 0.8, atol=0.02)

    def test_equirect_hdr_used_directly(self, tmp_path, rng):
        from spt_tpu.env import load_environment

        img = rng.uniform(0, 2, (32, 64, 3)).astype(np.float32)
        p = str(tmp_path / "eq.hdr")
        write_hdr(p, img)
        env = load_environment(p)
        assert env.image.shape == (32, 64, 3)
