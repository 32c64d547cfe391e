// Surface evaluation shared by the hit shading (shade.cu) and the
// G-buffer (gbuffer.cu): three-component vector arithmetic, the bilinear
// texture tap (ops/texture.py sample_bilinear), the packed material row's
// material point (ops/shade.py material_point_from_row) and the normal
// map (shade.apply_normal_map).
//
// Every function does its plain version's float operations in its order
// (the library is compiled with -fmad=false), with PyTorch's own rules on
// the card where an operator is not one IEEE operation: a division by a
// Python number is a multiplication by its float reciprocal; clamp
// returns NaN unchanged and otherwise fminf / fmaxf; a norm over three
// components sums x*x + z*z and y*y on the reduction's two lanes, then
// adds them.
#pragma once

#include "common.cuh"

// The bindless texture stack (schema.TextureStack) as a kernel reads it.
struct HrTextures {
  const float* data;  // (N, h, w, 4) stack, or null
  const int* sizes;   // (N, 2) height, width in use
  int h, w;
  int slots;  // bit k: slot k is sampled (colour, emission, r/m, normal)
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 splat(float s) { return {s, s, s}; }
__device__ __forceinline__ V3 sub_from(float s, V3 a) {  // s - a
  return {s - a.x, s - a.y, s - a.z};
}

// maths.dot: left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
// torch.clamp on the card: NaN passes, else fmaxf / fminf
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}
// torch.linalg.vector_norm over a last axis of 3 on the card
__device__ __forceinline__ float norm(V3 a) {
  return sqrtf((a.x * a.x + a.z * a.z) + a.y * a.y);
}
__device__ __forceinline__ V3 normalize(V3 a) {
  const float n = clamp_min(norm(a), 1e-12f);
  return {a.x / n, a.y / n, a.z / n};
}
// a division by a Python number: times its float reciprocal
__device__ __forceinline__ float div_scalar(float x, float c) {
  return x * (1.0f / c);
}
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ void store3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}
__device__ __forceinline__ int floor_mod(int a, int b) {  // torch.remainder
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// texture.sample_bilinear of one texture of the stack at uv
static __device__ float4 sample_tex(const HrTextures& t, int tex_id,
                                    float u, float v, float4 dflt) {
  if (tex_id < 0) return dflt;
  const float h = static_cast<float>(t.sizes[2 * tex_id]);
  const float w = static_cast<float>(t.sizes[2 * tex_id + 1]);
  const float x = u * w - 0.5f;
  const float y = v * h - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const int wi = static_cast<int>(w);
  const int hi = static_cast<int>(h);
  const float4* texels = reinterpret_cast<const float4*>(t.data);
  auto tap = [&](float xf, float yf) {
    const int xi = floor_mod(static_cast<int>(xf), wi);
    const int yi = floor_mod(static_cast<int>(yf), hi);
    return __ldg(texels + (static_cast<long long>(tex_id) * t.h + yi) * t.w +
                 xi);
  };
  const float4 c00 = tap(x0, y0);
  const float4 c10 = tap(x0 + 1.0f, y0);
  const float4 c01 = tap(x0, y0 + 1.0f);
  const float4 c11 = tap(x0 + 1.0f, y0 + 1.0f);
  const float gx = 1.0f - fx;
  const float gy = 1.0f - fy;
  auto lerp = [&](float a00, float a10, float a01, float a11) {
    const float top = a00 * gx + a10 * fx;
    const float bot = a01 * gx + a11 * fx;
    return top * gy + bot * fy;
  };
  return make_float4(lerp(c00.x, c10.x, c01.x, c11.x),
                     lerp(c00.y, c10.y, c01.y, c11.y),
                     lerp(c00.z, c10.z, c01.z, c11.z),
                     lerp(c00.w, c10.w, c01.w, c11.w));
}

constexpr float kMinRoughness = static_cast<float>(0.03 * 0.03);

// shade.MaterialPoint, less opacity and the type
struct HrMaterialPoint {
  V3 colour, emission;
  float roughness;  // squared, 0 below kMinRoughness
  float metallic;
};

// shade.material_point_from_row of a packed (16) material row at uv:
// each slot the stack binds (t.slots) modulates its term by its texel
static __device__ __forceinline__ HrMaterialPoint material_point(
    const HrTextures& t, const float* mrow, float u, float v) {
  HrMaterialPoint mp;
  mp.colour = load3(mrow);
  mp.emission = load3(mrow + 4);
  float roughness = mrow[7];
  mp.metallic = mrow[8];
  const float4 ones = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  if (t.slots & 1) {
    const float4 a = sample_tex(t, static_cast<int>(mrow[10]), u, v, ones);
    mp.colour = mp.colour * V3{a.x, a.y, a.z};
  }
  if (t.slots & 2) {
    const float4 e = sample_tex(t, static_cast<int>(mrow[11]), u, v, ones);
    mp.emission = mp.emission * V3{e.x, e.y, e.z};
  }
  if (t.slots & 4) {
    const float4 mr = sample_tex(t, static_cast<int>(mrow[12]), u, v, ones);
    roughness = roughness * mr.y;
    mp.metallic = mp.metallic * mr.z;
  }
  const float r2 = roughness * roughness;
  mp.roughness = r2 < kMinRoughness ? 0.0f : r2;
  return mp;
}

// shade.apply_normal_map where a material binds a normal texture (slot
// bit 8): ``n`` the normalized shading normal, ``tw`` the world tangent
// (normalized once), ``w`` its bitangent sign, ``nrm_id`` the normal
// texture (the material row's column 13)
static __device__ __forceinline__ V3 normal_map(const HrTextures& t, V3 n,
                                                V3 tw, float w, int nrm_id,
                                                float u, float v) {
  const V3 tn = normalize(tw);
  const float t_len = norm(tw);
  const float sign = fabsf(w) < 0.001f ? 1.0f : w;
  const V3 b = cross(n, tn) * sign;
  const float4 tx =
      sample_tex(t, nrm_id, u, v, make_float4(0.5f, 0.5f, 1.0f, 1.0f));
  const V3 mapped =
      normalize((tn * (tx.x * 2.0f - 1.0f) + b * (tx.y * 2.0f - 1.0f)) +
                n * (tx.z * 2.0f - 1.0f));
  return nrm_id >= 0 && t_len >= 0.001f ? mapped : n;
}
