// Native EXR I/O for nart-jax, wrapping the system OpenEXR C++ library.
//
// Role parity: the reference renderer reads textures with Imf::RgbaInputFile
// (src/patterns/texturepattern.cpp:111-128) and writes renders with
// Imf::RgbaOutputFile (src/core/render.cpp:208-234).  This module provides the
// same capability (including PIZ-compressed texture decode) behind a C ABI so
// Python binds via ctypes — no pybind11 dependency.
//
// Build: see nart_jax/native/Makefile (g++ -shared, links libOpenEXR-3_1).

#include <OpenEXR/ImfArray.h>
#include <OpenEXR/ImfRgbaFile.h>

#include <cstdint>
#include <cstring>
#include <string>

extern "C" {

// Reads an RGBA EXR.  On success returns 0 and fills *width/*height; the
// caller then calls exr_read_into() with a float buffer of size w*h*4.
// A thread-local slot keeps the decoded pixels between the two calls.
static thread_local Imf::Array2D<Imf::Rgba> g_pixels;
static thread_local int g_w = 0, g_h = 0;
static thread_local std::string g_error;

int exr_read_open(const char* path, int32_t* width, int32_t* height) {
  try {
    Imf::RgbaInputFile file(path);
    auto dw = file.dataWindow();
    g_w = dw.max.x - dw.min.x + 1;
    g_h = dw.max.y - dw.min.y + 1;
    g_pixels.resizeErase(g_h, g_w);
    file.setFrameBuffer(&g_pixels[0][0] - dw.min.x - dw.min.y * g_w, 1, g_w);
    file.readPixels(dw.min.y, dw.max.y);
    *width = g_w;
    *height = g_h;
    return 0;
  } catch (const std::exception& e) {
    g_error = e.what();
    return 1;
  }
}

// Copies the decoded image into out (row-major, RGBA float32, h*w*4).
int exr_read_into(float* out) {
  for (int y = 0; y < g_h; ++y) {
    for (int x = 0; x < g_w; ++x) {
      const Imf::Rgba& p = g_pixels[y][x];
      float* o = out + (static_cast<size_t>(y) * g_w + x) * 4;
      o[0] = p.r;
      o[1] = p.g;
      o[2] = p.b;
      o[3] = p.a;
    }
  }
  return 0;
}

// Writes an RGBA half EXR (ZIP compression, matching Imf::RgbaOutputFile
// defaults used by the reference).  data is row-major RGBA float32.
int exr_write(const char* path, const float* data, int32_t width,
              int32_t height) {
  try {
    Imf::Array2D<Imf::Rgba> pixels(height, width);
    for (int y = 0; y < height; ++y) {
      for (int x = 0; x < width; ++x) {
        const float* p = data + (static_cast<size_t>(y) * width + x) * 4;
        pixels[y][x] = Imf::Rgba(p[0], p[1], p[2], p[3]);
      }
    }
    Imf::RgbaOutputFile file(path, width, height, Imf::WRITE_RGBA);
    file.setFrameBuffer(&pixels[0][0], 1, width);
    file.writePixels(height);
    return 0;
  } catch (const std::exception& e) {
    g_error = e.what();
    return 1;
  }
}

const char* exr_last_error() { return g_error.c_str(); }

}  // extern "C"
