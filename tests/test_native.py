"""Native runtime library (C++ RGBE decode) vs Python."""

import numpy as np
import pytest

from spt_tpu.io import native
from spt_tpu.io.hdr import read_hdr, write_hdr


needs_native = pytest.mark.skipif(
    native.load() is None, reason="native toolchain unavailable"
)


@pytest.fixture
def force_python(monkeypatch):
    """Disable the native lib for a test (exercise the fallback)."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)


@needs_native
class TestRgbeNative:
    def test_flat_scanlines_match_python(self, tmp_path, rng, force_python):
        img = (rng.uniform(0, 30, (64, 128, 3)) ** 2).astype(np.float32)
        p = str(tmp_path / "a.hdr")
        write_hdr(p, img)
        py = read_hdr(p)

        native._TRIED = False
        native._LIB = None
        nat = read_hdr(p)
        np.testing.assert_array_equal(py, nat)

    def test_rle_scanlines(self, tmp_path):
        # constant rows compress to runs (same fixture as test_io)
        w, h = 32, 4
        with open(tmp_path / "r.hdr", "wb") as f:
            f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
            f.write(f"-Y {h} +X {w}\n".encode())
            for _ in range(h):
                f.write(bytes([2, 2, 0, w]))
                for val in (128, 64, 32, 136):
                    f.write(bytes([128 + w, val]))
        img = read_hdr(str(tmp_path / "r.hdr"))
        np.testing.assert_allclose(img[0, 0], [128.5, 64.5, 32.5], rtol=1e-6)

    def test_rle_literal_runs_mixed(self, tmp_path):
        # one channel as literals, rest as runs
        w, h = 16, 1
        lit = bytes(range(10, 10 + w))
        with open(tmp_path / "m.hdr", "wb") as f:
            f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
            f.write(f"-Y {h} +X {w}\n".encode())
            f.write(bytes([2, 2, 0, w]))
            f.write(bytes([w]) + lit)              # R literal
            f.write(bytes([128 + w, 0]))           # G run of 0
            f.write(bytes([128 + w, 0]))           # B run of 0
            f.write(bytes([128 + w, 136]))         # E run
        img = read_hdr(str(tmp_path / "m.hdr"))
        np.testing.assert_allclose(img[0, :, 0], np.arange(10, 26) + 0.5, rtol=1e-6)
        np.testing.assert_allclose(img[0, :, 1], 0.5, rtol=1e-6)
