// Native asset/runtime core for nart-jax: .geo mesh parsing (with fan
// triangulation and world-space transform), .vol density-grid parsing, and
// the LBVH build (Morton sort + bottom-up AABB tree).
//
// Role parity: the reference's runtime is native C++ — its scene loader
// parses .geo text meshes (src/core/scene.cpp:77-343) and .vol grids
// (src/core/scene.cpp:825-867), and its accel build bins triangles into an
// octree (src/core/bvh.cpp:252-326).  This module is this framework's
// native equivalent of that cold-path runtime: the parse/triangulate/build
// work stays in C++, the results land in preallocated numpy buffers via a
// plain C ABI (ctypes — no pybind11 dependency), and the traversal itself
// runs on-device (nart_jax/accel.py, nart_jax/pallas_accel.py).
//
// The Python implementations in nart_jax/{geo,vol}.py and accel.build_bvh
// remain as behavior-defining fallbacks; tests/test_native.py asserts exact
// agreement between the two paths.
//
// Build: make -C nart_jax/native libnartcore.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <numeric>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

// Whole-file slurp.
bool slurp(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    g_error = std::string("could not open ") + path;
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(&(*out)[0], 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  if (got != static_cast<size_t>(n)) {
    g_error = std::string("short read on ") + path;
    return false;
  }
  return true;
}

// Whitespace-separated numeric tokenizer over a slurped buffer.  Parses as
// double (exact for uint32 indices) and narrows coordinates to float like
// numpy's float64 -> float32 astype does.
struct Tokens {
  const char* p;
  const char* end;
  bool next_d(double* out) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
    if (p >= end) return false;
    char* q;
    *out = std::strtod(p, &q);
    if (q == p) return false;
    p = q;
    return true;
  }
  bool next(float* out) {
    double v;
    if (!next_d(&v)) return false;
    *out = static_cast<float>(v);
    return true;
  }
  bool next_u32(uint32_t* out) {
    double v;
    if (!next_d(&v)) return false;
    *out = static_cast<uint32_t>(v);
    return true;
  }
};

// ---------------------------------------------------------------------------
// .geo meshes
// ---------------------------------------------------------------------------

struct GeoState {
  std::vector<float> v, n, uv;  // (T,3,3) (T,3,3) (T,3,2)
  int64_t n_tris = 0;
};
thread_local GeoState g_geo;

}  // namespace

extern "C" {

const char* core_last_error() { return g_error.c_str(); }

// Parses + fan-triangulates a .geo mesh into world space.  m16 is the
// row-major objectToWorld 4x4 (points: p' = M[:3,:3] p + M[:3,3]); nm9 the
// row-major 3x3 normal matrix (n' = normalize(N n), N = inv(M)[:3,:3]^T).
// On success returns 0 and sets *n_tris; call geo_read_into to copy out.
int geo_open(const char* path, const float* m16, const float* nm9,
             int64_t* n_tris) {
  std::string buf;
  if (!slurp(path, &buf)) return 1;
  Tokens tk{buf.data(), buf.data() + buf.size()};

  uint32_t num_faces;
  if (!tk.next_u32(&num_faces)) {
    g_error = "could not read face count";
    return 1;
  }
  std::vector<uint32_t> faces(num_faces);
  uint64_t nvi = 0;
  for (uint32_t i = 0; i < num_faces; ++i) {
    if (!tk.next_u32(&faces[i])) {
      g_error = "truncated face counts";
      return 1;
    }
    nvi += faces[i];
  }
  auto read_indices = [&](std::vector<uint32_t>* idx, uint32_t* max_idx,
                          bool* missing) -> bool {
    idx->resize(nvi);
    *max_idx = 0;
    for (uint64_t i = 0; i < nvi; ++i) {
      if (!tk.next_u32(&(*idx)[i])) {
        if (missing != nullptr && i == 0) {
          *missing = true;  // optional section absent (scene.cpp:186-193)
          return true;
        }
        g_error = "truncated index section";
        return false;
      }
      *max_idx = std::max(*max_idx, (*idx)[i]);
    }
    return true;
  };
  auto read_floats = [&](std::vector<float>* out, uint64_t count) -> bool {
    out->resize(count);
    for (uint64_t i = 0; i < count; ++i) {
      if (!tk.next(&(*out)[i])) {
        g_error = "truncated coordinate section";
        return false;
      }
    }
    return true;
  };

  std::vector<uint32_t> vert_idx, norm_idx, uv_idx;
  std::vector<float> verts, norms, uvs;
  uint32_t max_v, max_n, max_uv;
  if (!read_indices(&vert_idx, &max_v, nullptr)) return 1;
  if (!read_floats(&verts, (static_cast<uint64_t>(max_v) + 1) * 3)) return 1;
  if (!read_indices(&norm_idx, &max_n, nullptr)) return 1;
  if (!read_floats(&norms, (static_cast<uint64_t>(max_n) + 1) * 3)) return 1;
  bool no_uvs = false;
  if (!read_indices(&uv_idx, &max_uv, &no_uvs)) return 1;
  if (!no_uvs &&
      !read_floats(&uvs, (static_cast<uint64_t>(max_uv) + 1) * 2))
    return 1;

  // World-space transforms (geo.py:67-71 / scene.cpp:240-254).
  for (uint64_t i = 0; i + 2 < verts.size(); i += 3) {
    float x = verts[i], y = verts[i + 1], z = verts[i + 2];
    verts[i] = m16[0] * x + m16[1] * y + m16[2] * z + m16[3];
    verts[i + 1] = m16[4] * x + m16[5] * y + m16[6] * z + m16[7];
    verts[i + 2] = m16[8] * x + m16[9] * y + m16[10] * z + m16[11];
  }
  for (uint64_t i = 0; i + 2 < norms.size(); i += 3) {
    float x = norms[i], y = norms[i + 1], z = norms[i + 2];
    float nx = nm9[0] * x + nm9[1] * y + nm9[2] * z;
    float ny = nm9[3] * x + nm9[4] * y + nm9[5] * z;
    float nz = nm9[6] * x + nm9[7] * y + nm9[8] * z;
    float len = std::sqrt(nx * nx + ny * ny + nz * nz);
    float inv = 1.0f / std::max(len, 1e-20f);
    norms[i] = nx * inv;
    norms[i + 1] = ny * inv;
    norms[i + 2] = nz * inv;
  }

  // Fan triangulation: face (i0..ik) -> (i0, ij+1, ij+2) (scene.cpp:274-282).
  int64_t n_tri = 0;
  for (uint32_t i = 0; i < num_faces; ++i)
    n_tri += faces[i] >= 2 ? faces[i] - 2 : 0;
  g_geo.v.resize(static_cast<size_t>(n_tri) * 9);
  g_geo.n.resize(static_cast<size_t>(n_tri) * 9);
  g_geo.uv.resize(static_cast<size_t>(n_tri) * 6);
  // Default UVs when the mesh has none: Triangle ctor defaults
  // (geometry.h:58-60) — (0,0) (0,1) (1,0).
  static const float kDefaultUV[6] = {0, 0, 0, 1, 1, 0};

  uint64_t start = 0;
  size_t w = 0;
  for (uint32_t i = 0; i < num_faces; ++i) {
    for (uint32_t j = 0; j + 2 < faces[i]; ++j) {
      const uint64_t corner[3] = {start, start + j + 1, start + j + 2};
      for (int c = 0; c < 3; ++c) {
        uint32_t vi = vert_idx[corner[c]];
        uint32_t ni = norm_idx[corner[c]];
        std::memcpy(&g_geo.v[w * 9 + c * 3], &verts[vi * 3u],
                    3 * sizeof(float));
        std::memcpy(&g_geo.n[w * 9 + c * 3], &norms[ni * 3u],
                    3 * sizeof(float));
        if (no_uvs) {
          g_geo.uv[w * 6 + c * 2] = kDefaultUV[c * 2];
          g_geo.uv[w * 6 + c * 2 + 1] = kDefaultUV[c * 2 + 1];
        } else {
          uint32_t ui = uv_idx[corner[c]];
          std::memcpy(&g_geo.uv[w * 6 + c * 2], &uvs[ui * 2u],
                      2 * sizeof(float));
        }
      }
      ++w;
    }
    start += faces[i];
  }
  g_geo.n_tris = n_tri;
  *n_tris = n_tri;
  return 0;
}

// Copies the parsed mesh into caller buffers: v/n are (T,3,3), uv (T,3,2).
int geo_read_into(float* v, float* n, float* uv) {
  std::memcpy(v, g_geo.v.data(), g_geo.v.size() * sizeof(float));
  std::memcpy(n, g_geo.n.data(), g_geo.n.size() * sizeof(float));
  std::memcpy(uv, g_geo.uv.data(), g_geo.uv.size() * sizeof(float));
  return 0;
}

// ---------------------------------------------------------------------------
// .vol density grids (scene.cpp:825-867: bmin3 bmax3 res3 then res^3 floats)
// ---------------------------------------------------------------------------

namespace {
thread_local std::vector<float> g_vol;
}

int vol_open(const char* path, double* header9) {
  std::string buf;
  if (!slurp(path, &buf)) return 1;
  Tokens tk{buf.data(), buf.data() + buf.size()};
  float h[9];
  for (int i = 0; i < 9; ++i) {
    if (!tk.next(&h[i])) {
      g_error = "truncated .vol header";
      return 1;
    }
    header9[i] = h[i];
  }
  int64_t count = static_cast<int64_t>(h[6]) * static_cast<int64_t>(h[7]) *
                  static_cast<int64_t>(h[8]);
  g_vol.resize(static_cast<size_t>(count));
  for (int64_t i = 0; i < count; ++i) {
    if (!tk.next(&g_vol[i])) {
      g_error = "truncated .vol density data";
      return 1;
    }
  }
  return 0;
}

int vol_read_into(float* density) {
  std::memcpy(density, g_vol.data(), g_vol.size() * sizeof(float));
  return 0;
}

// ---------------------------------------------------------------------------
// LBVH build (accel.py build_bvh, kept bit-identical)
// ---------------------------------------------------------------------------

namespace {

inline uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

inline uint32_t quantize10(float a) {
  float s = a * 1024.0f;
  s = std::min(std::max(s, 0.0f), 1023.0f);
  return static_cast<uint32_t>(s);
}

}  // namespace

// Builds the complete-binary-tree LBVH over Morton-ordered leaves.
// Inputs: tri_v (t, 3, 3) float32, leaf_size, n_leaves (power of two,
// computed by the caller exactly as accel.build_bvh does).  Outputs
// (caller-allocated): node_lo/node_hi (2*n_leaves-1, 3), order
// (n_leaves*leaf_size,) int32 with -1 padding, tri_out
// (n_leaves*leaf_size, 3, 3) float32 zero-padded.
int lbvh_build(const float* tri_v, int64_t t, int32_t leaf_size,
               int32_t n_leaves, float* node_lo, float* node_hi,
               int32_t* order, float* tri_out) {
  const float inf = std::numeric_limits<float>::infinity();
  std::vector<float> lo(static_cast<size_t>(t) * 3),
      hi(static_cast<size_t>(t) * 3);
  float scene_lo[3] = {inf, inf, inf}, scene_hi[3] = {-inf, -inf, -inf};
  for (int64_t i = 0; i < t; ++i) {
    const float* v = tri_v + i * 9;
    for (int a = 0; a < 3; ++a) {
      float m = std::min(v[a], std::min(v[3 + a], v[6 + a]));
      float M = std::max(v[a], std::max(v[3 + a], v[6 + a]));
      lo[i * 3 + a] = m;
      hi[i * 3 + a] = M;
      scene_lo[a] = std::min(scene_lo[a], m);
      scene_hi[a] = std::max(scene_hi[a], M);
    }
  }
  float extent[3];
  for (int a = 0; a < 3; ++a)
    extent[a] = std::max(scene_hi[a] - scene_lo[a], 1e-12f);

  std::vector<uint32_t> codes(static_cast<size_t>(t));
  for (int64_t i = 0; i < t; ++i) {
    uint32_t q[3];
    for (int a = 0; a < 3; ++a) {
      float c = 0.5f * (lo[i * 3 + a] + hi[i * 3 + a]);
      q[a] = quantize10((c - scene_lo[a]) / extent[a]);
    }
    codes[i] = (expand_bits(q[0]) << 2) | (expand_bits(q[1]) << 1) |
               expand_bits(q[2]);
  }
  std::vector<int32_t> idx(static_cast<size_t>(t));
  std::iota(idx.begin(), idx.end(), 0);
  std::stable_sort(idx.begin(), idx.end(), [&](int32_t a, int32_t b) {
    return codes[static_cast<size_t>(a)] < codes[static_cast<size_t>(b)];
  });

  const int64_t t_pad = static_cast<int64_t>(n_leaves) * leaf_size;
  std::fill(order, order + t_pad, -1);
  std::memset(tri_out, 0, static_cast<size_t>(t_pad) * 9 * sizeof(float));
  for (int64_t i = 0; i < t; ++i) {
    order[i] = idx[static_cast<size_t>(i)];
    std::memcpy(tri_out + i * 9, tri_v + static_cast<int64_t>(order[i]) * 9,
                9 * sizeof(float));
  }

  const int64_t n_nodes = 2 * static_cast<int64_t>(n_leaves) - 1;
  const int64_t leaf0 = n_leaves - 1;
  for (int64_t i = 0; i < n_nodes * 3; ++i) {
    node_lo[i] = inf;
    node_hi[i] = -inf;
  }
  for (int64_t leaf = 0; leaf < n_leaves; ++leaf) {
    float* nl = node_lo + (leaf0 + leaf) * 3;
    float* nh = node_hi + (leaf0 + leaf) * 3;
    for (int64_t j = 0; j < leaf_size; ++j) {
      int64_t k = leaf * leaf_size + j;
      if (k >= t) break;  // padding keeps the +-inf init
      int64_t src = order[k];
      for (int a = 0; a < 3; ++a) {
        nl[a] = std::min(nl[a], lo[src * 3 + a]);
        nh[a] = std::max(nh[a], hi[src * 3 + a]);
      }
    }
  }
  for (int64_t i = leaf0 - 1; i >= 0; --i) {
    for (int a = 0; a < 3; ++a) {
      node_lo[i * 3 + a] = std::min(node_lo[(2 * i + 1) * 3 + a],
                                    node_lo[(2 * i + 2) * 3 + a]);
      node_hi[i * 3 + a] = std::max(node_hi[(2 * i + 1) * 3 + a],
                                    node_hi[(2 * i + 2) * 3 + a]);
    }
  }
  return 0;
}

}  // extern "C"
