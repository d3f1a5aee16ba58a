// assetlib — native host-side asset pipeline for tpu_renderer.
//
// The reference implements its asset path in C++ (fastgltf accessor
// iteration vk_loader.cpp:286-358, stb_image decode, vkCmdBlitImage mip
// generation vk_images.cpp:66-133). This library is this renderer's native
// tier for the same host work, exposed over a C ABI consumed via ctypes
// (tpu_renderer/utils/native.py). Every entry point has a numpy fallback
// with identical semantics; tests assert bit-parity.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Accessor decode: strided interleaved buffer -> contiguous float32,
// with integer normalization per glTF 2.0 (KHR_mesh_quantization).
// component_type: glTF enums (5120..5126). n: components per element.
// ---------------------------------------------------------------------------

int decode_accessor_f32(const uint8_t* src, int64_t count, int n,
                        int component_type, int stride, int normalized,
                        float* dst) {
  for (int64_t i = 0; i < count; i++) {
    const uint8_t* p = src + i * stride;
    for (int c = 0; c < n; c++) {
      float v;
      switch (component_type) {
        case 5120: {  // BYTE
          int8_t x; std::memcpy(&x, p + c, 1);
          v = normalized ? std::max((float)x / 127.0f, -1.0f) : (float)x;
          break;
        }
        case 5121: {  // UNSIGNED_BYTE
          uint8_t x = p[c];
          v = normalized ? (float)x / 255.0f : (float)x;
          break;
        }
        case 5122: {  // SHORT
          int16_t x; std::memcpy(&x, p + 2 * c, 2);
          v = normalized ? std::max((float)x / 32767.0f, -1.0f) : (float)x;
          break;
        }
        case 5123: {  // UNSIGNED_SHORT
          uint16_t x; std::memcpy(&x, p + 2 * c, 2);
          v = normalized ? (float)x / 65535.0f : (float)x;
          break;
        }
        case 5125: {  // UNSIGNED_INT
          uint32_t x; std::memcpy(&x, p + 4 * c, 4);
          v = (float)x;
          break;
        }
        case 5126: {  // FLOAT
          std::memcpy(&v, p + 4 * c, 4);
          break;
        }
        default:
          return -1;
      }
      dst[i * n + c] = v;
    }
  }
  return 0;
}

int decode_indices_u32(const uint8_t* src, int64_t count, int component_type,
                       int stride, uint32_t* dst) {
  for (int64_t i = 0; i < count; i++) {
    const uint8_t* p = src + i * stride;
    switch (component_type) {
      case 5121: dst[i] = p[0]; break;
      case 5123: { uint16_t x; std::memcpy(&x, p, 2); dst[i] = x; break; }
      case 5125: { uint32_t x; std::memcpy(&x, p, 4); dst[i] = x; break; }
      default: return -1;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Mip generation: linear-filtered half-size blit, the semantics of
// vkCmdBlitImage in generate_mipmaps (vk_images.cpp:66-133). RGBA8.
// ---------------------------------------------------------------------------

void downsample_blit_rgba8(const uint8_t* src, int h, int w, uint8_t* dst) {
  int nh = h / 2 > 0 ? h / 2 : 1;
  int nw = w / 2 > 0 ? w / 2 : 1;
  double sy = (double)h / nh;
  double sx = (double)w / nw;
  for (int y = 0; y < nh; y++) {
    double fy = (y + 0.5) * sy - 0.5;
    int y0 = (int)std::floor(fy);
    double wy = fy - y0;
    if (y0 < 0) { y0 = 0; wy = 0.0; }
    int y1 = std::min(y0 + 1, h - 1);
    for (int x = 0; x < nw; x++) {
      double fx = (x + 0.5) * sx - 0.5;
      int x0 = (int)std::floor(fx);
      double wx = fx - x0;
      if (x0 < 0) { x0 = 0; wx = 0.0; }
      int x1 = std::min(x0 + 1, w - 1);
      for (int c = 0; c < 4; c++) {
        double v = src[(y0 * w + x0) * 4 + c] * (1 - wy) * (1 - wx)
                 + src[(y0 * w + x1) * 4 + c] * (1 - wy) * wx
                 + src[(y1 * w + x0) * 4 + c] * wy * (1 - wx)
                 + src[(y1 * w + x1) * 4 + c] * wy * wx;
        double r = std::floor(v + 0.5);  // UNORM round-to-nearest
        dst[(y * nw + x) * 4 + c] = (uint8_t)std::min(std::max(r, 0.0), 255.0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Atlas assembly: pack RGBA8 -> u32 texels and expand to prebaked bilinear
// quad rows [T(x,y), T(x+1,y), T(x,y+1), T(x+1,y+1)] with REPEAT wrap
// (tpu_renderer/resources.py:_quad_rows).
// dst is the (atlas_h, atlas_w, 4) u32 atlas; the level is written at
// (ox, oy).
// ---------------------------------------------------------------------------

void blit_quad_rows_u32(const uint8_t* level, int h, int w,
                        uint32_t* atlas, int64_t atlas_w, int ox, int oy) {
  for (int y = 0; y < h; y++) {
    int yp = (y + 1) % h;
    for (int x = 0; x < w; x++) {
      int xp = (x + 1) % w;
      uint32_t t00, t10, t01, t11;
      std::memcpy(&t00, level + (y * w + x) * 4, 4);
      std::memcpy(&t10, level + (y * w + xp) * 4, 4);
      std::memcpy(&t01, level + (yp * w + x) * 4, 4);
      std::memcpy(&t11, level + (yp * w + xp) * 4, 4);
      uint32_t* q = atlas + ((int64_t)(oy + y) * atlas_w + (ox + x)) * 4;
      q[0] = t00; q[1] = t10; q[2] = t01; q[3] = t11;
    }
  }
}

int assetlib_version() { return 1; }

}  // extern "C"
