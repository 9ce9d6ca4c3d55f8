// spt_native: native runtime components for the path tracer.
//
// The reference leans on native libraries around its kernels: stb_image
// decodes HDRs (Cubemap.cpp:18-46 stbi_loadf).  The compute path here is
// XLA, but asset decode is genuinely serial CPU work, so it lives here as
// C++ with ctypes bindings (spt_tpu/io/native.py) and a pure-Python
// fallback.
//
// Exposed C ABI:
//   spt_rgbe_decode      Radiance RGBE scanlines -> float RGB (RLE + flat)
//
// Build: g++ -O3 -march=native -shared -fPIC spt_native.cpp -o libspt_native.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Radiance RGBE decode (the stbi_loadf role).
//
// data: the pixel payload (after the header + resolution line).
// Returns 0 on success, negative error codes otherwise.
// ---------------------------------------------------------------------------
int spt_rgbe_decode(const uint8_t* data, int64_t len, int width, int height,
                    float* out /* width*height*3 */) {
    int64_t bp = 0;
    std::vector<uint8_t> row(static_cast<size_t>(width) * 4);

    for (int y = 0; y < height; ++y) {
        if (bp + 4 > len) return -1;
        const bool rle = width >= 8 && width <= 0x7FFF &&
                         data[bp] == 2 && data[bp + 1] == 2;
        if (rle) {
            const int w_check = (data[bp + 2] << 8) | data[bp + 3];
            if (w_check != width) return -2;
            bp += 4;
            for (int ch = 0; ch < 4; ++ch) {
                int x = 0;
                while (x < width) {
                    if (bp >= len) return -1;
                    int count = data[bp++];
                    if (count > 128) {               // run
                        count -= 128;
                        if (bp >= len || x + count > width) return -3;
                        std::memset(&row[static_cast<size_t>(ch) * width + x],
                                    data[bp], count);
                        ++bp;
                        x += count;
                    } else {                          // literal
                        if (bp + count > len || x + count > width) return -3;
                        std::memcpy(&row[static_cast<size_t>(ch) * width + x],
                                    &data[bp], count);
                        bp += count;
                        x += count;
                    }
                }
            }
            // planar row -> float RGB
            for (int x = 0; x < width; ++x) {
                const int e = row[static_cast<size_t>(3) * width + x];
                const float scale =
                    e > 0 ? std::ldexp(1.0f, e - 136) : 0.0f;
                float* px = out + (static_cast<int64_t>(y) * width + x) * 3;
                px[0] = (row[x] + 0.5f) * scale;
                px[1] = (row[static_cast<size_t>(1) * width + x] + 0.5f) * scale;
                px[2] = (row[static_cast<size_t>(2) * width + x] + 0.5f) * scale;
            }
        } else {
            // flat scanline: width RGBE quads
            if (bp + static_cast<int64_t>(width) * 4 > len) return -1;
            for (int x = 0; x < width; ++x) {
                const uint8_t* q = &data[bp + static_cast<int64_t>(x) * 4];
                const int e = q[3];
                const float scale =
                    e > 0 ? std::ldexp(1.0f, e - 136) : 0.0f;
                float* px = out + (static_cast<int64_t>(y) * width + x) * 3;
                px[0] = (q[0] + 0.5f) * scale;
                px[1] = (q[1] + 0.5f) * scale;
                px[2] = (q[2] + 0.5f) * scale;
            }
            bp += static_cast<int64_t>(width) * 4;
        }
    }
    return 0;
}

}  // extern "C"
