// Hit shading of radiance rays (closesthit.rchit) and the sky on a miss
// (miss.rmiss), in two kernels around the hits' occlusion query.
//
// The reference shades radiance hits in plain jnp
// (hybridrenderer_tpu/ops/trace.py _shade_hit :703, trace_radiance
// :691); there is no TPU kernel. The port's plain version
// (ops/shade_cuda.py) is the reference's order of operations split at
// the occlusion query:
//
// hr_shade_hit (prepare), one thread a traced ray: the hit triangle's
// shade row, read in place (vertex normal, tangent and uv at 9k, normal
// matrix at 27, material row at 37), interpolated; the geometric normal
// in world space, turned to face the ray; the material point with its
// texture taps (ops/texture.py sample_bilinear: four taps, floor-mod
// wrap, f32 weights) and the normal map; the sun's BRDF; the NEE light
// sample (TEA seed, area CDF search) and its BRDF; the IBL ambient term
// (procedural or equirect sky); the occlusion origin offset by integer
// steps. It writes the occlusion rays (sun, then light, stacked as
// SceneTracer.occluded takes them) and four rgb terms a ray: the sun's
// BRDF, the NEE term where a light was sampled toward a facing hit,
// ambient and emission.
//
// hr_shade_finish, one thread a pixel: the shadowed sun term plus the
// NEE term where its ray is unoccluded, plus ambient, plus emission at a
// hit; the sky toward the ray (black with IBL off) at a miss; the hit
// distance or -1. A pixel reads its ray's traced position from ``pos``
// when the rays were traced in another order (the wide kernels' tiles).
//
// Every float operation is the plain version's, in its order, under the
// library's -fmad=false, with PyTorch's own rules on the card where an
// operator is not one IEEE operation: a division by a Python number is a
// multiplication by its float reciprocal; ``2.0 / x`` is
// ``reciprocal(x) * 2``; clamp returns NaN unchanged and otherwise
// fminf / fmaxf; ``** 5`` and ``** 128`` are powf; a norm over three
// components sums x*x + z*z and y*y on the reduction's two lanes, then
// adds them. powf, atan2f, asinf, cosf, sinf are the CUDA library's, as
// PyTorch's, and may differ in the last ulp from another build's.
//
// At rays that hit nothing the prepare writes zeros and no active
// occlusion ray, as its plain version does, and does no other work.
#include "surface.cuh"

struct HrShadeScene {
  const float* rows;  // (n_rows, 53) hit-shading rows
  long long n_rows;
  HrTextures tex;  // the stack; its slots sampled at hits
  int sky_tex, has_sky, light_on, ibl;
  int n_lights, n_cdf;
  const int* light_inst;
  const int* light_cdf_start;
  const int* light_cdf_count;
  const int* light_env;
  const float* cdf;
  const int* inst_index_offset;
  const float* inst_emission;  // (N, 3): emission x 5 of each instance
  const float* v0;
  const float* v1;
  const float* v2;
  // sun direction toward it (3), sun intensity rgb (3), ambient strength
  const float* uniforms;
  const long long* frame_index;
};

namespace {

constexpr int kRow = 53;
constexpr int kTerms = 12;
constexpr int kThreads = 128;
constexpr float kPi = static_cast<float>(3.14159265359);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265359);

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// sky.procedural_sky
__device__ V3 procedural_sky(V3 dir) {
  const float t = (dir.y + 1.0f) * 0.5f;
  const V3 horizon = {0.4f, 0.5f, 0.6f};
  const V3 span = {0.1f - 0.4f, 0.2f - 0.5f, 0.4f - 0.6f};
  const V3 sky = horizon + span * t;
  const float g = 1.0f / sqrtf(3.0f);  // normalize((1, 1, -1))
  const float sun = powf(clamp_min(dot(dir, {g, g, -g}), 0.0f), 128.0f);
  return sky + splat(sun * 5.0f);
}

// sky.sample_environment with IBL on
__device__ V3 environment(const HrShadeScene& s, V3 dir) {
  if (!s.has_sky || s.sky_tex < 0) return procedural_sky(dir);
  const float phi = atan2f(dir.z, dir.x);
  const float theta = asinf(isnan(dir.y) ? dir.y
                                         : fminf(fmaxf(dir.y, -1.0f), 1.0f));
  const float u = div_scalar(phi, kTwoPi) + 0.5f;
  const float w = 1.0f - (div_scalar(theta, kPi) + 0.5f);
  const float4 env =
      sample_tex(s.tex, s.sky_tex, u, w, make_float4(0, 0, 0, 0));
  return {env.x, env.y, env.z};
}

// shade.fresnel_schlick
__device__ V3 fresnel_schlick(V3 spec, V3 normal, V3 outgoing) {
  const float cosine = dot(normal, outgoing);
  const float p = powf(clamp01(1.0f - fabsf(cosine)), 5.0f);
  const V3 f = spec + sub_from(1.0f, spec) * p;
  const bool nonzero = spec.x != 0.0f || spec.y != 0.0f || spec.z != 0.0f;
  return nonzero ? f : splat(0.0f);
}

__device__ float shadowing1(float roughness, V3 normal, V3 halfway, V3 dir) {
  const float cosine = dot(normal, dir);
  const float c2 = cosine * cosine;
  const float cosine_h = dot(halfway, dir);
  const float r2 = roughness * roughness;
  const float q = ((r2 * (1.0f - c2)) + c2) / clamp_min(c2, 1e-12f);
  const float g = (1.0f / (sqrtf(clamp_min(q, 0.0f)) + 1.0f)) * 2.0f;
  return cosine * cosine_h > 0.0f ? g : 0.0f;
}

// shade.eval_pbr at ior 1.5
__device__ V3 eval_pbr(V3 colour, float roughness, float metallic,
                       V3 normal, V3 outgoing, V3 incoming) {
  const V3 refl = splat(0.04f) + (colour - splat(0.04f)) * metallic;
  const float n_dot_o = dot(normal, outgoing);
  const V3 up = n_dot_o <= 0.0f ? -normal : normal;
  const V3 f1 = fresnel_schlick(refl, up, outgoing);
  const V3 halfway = normalize(incoming + outgoing);
  const V3 f = fresnel_schlick(refl, halfway, incoming);
  // microfacet_distribution
  const float ch = dot(up, halfway);
  const float r2 = roughness * roughness;
  const float c2 = ch * ch;
  const float denom_d = c2 * (r2 - 1.0f) + 1.0f;
  const float dd = r2 / ((denom_d * kPi) * denom_d);
  const float d = ch > 0.0f ? dd : 0.0f;
  const float g = shadowing1(roughness, up, halfway, outgoing) *
                  shadowing1(roughness, up, halfway, incoming);
  const float cosine = fabsf(dot(up, incoming));
  const V3 diffuse = colour * (1.0f - metallic) * sub_from(1.0f, f1);
  const V3 diffuse_pi = {div_scalar(diffuse.x, kPi),
                         div_scalar(diffuse.y, kPi),
                         div_scalar(diffuse.z, kPi)};
  const float denom =
      (4.0f * fabsf(dot(up, outgoing))) * fabsf(dot(up, incoming));
  const float dn = clamp_min(denom, 1e-8f);
  const V3 fdg = f * d * g;
  const V3 specular = {fdg.x / dn, fdg.y / dn, fdg.z / dn};
  const V3 result = (diffuse_pi + specular) * cosine;
  const bool visible = dot(normal, incoming) * dot(normal, outgoing) > 0.0f;
  return visible ? result : splat(0.0f);
}

// sampling.offset_ray: integer-ulp steps along the normal
__device__ __forceinline__ float offset1(float p, float n) {
  const int of = static_cast<int>(256.0f * n);
  const unsigned step = p < 0.0f ? 0u - static_cast<unsigned>(of)
                                 : static_cast<unsigned>(of);
  const float p_int =
      __int_as_float(static_cast<int>(static_cast<unsigned>(__float_as_int(p)) +
                                      step));
  return fabsf(p) < (1.0f / 32.0f) ? p + (1.0f / 65536.0f) * n : p_int;
}

// sampling.init_random_seed and random_float in uint32 arithmetic
__device__ __forceinline__ uint32_t tea(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}
__device__ __forceinline__ float random_float(uint32_t& seed) {
  seed = (seed ^ 61u) ^ (seed >> 16);
  seed *= 9u;
  seed ^= seed >> 4;
  seed *= 0x27D4EB2Du;
  seed ^= seed >> 15;
  return static_cast<float>(seed) * (1.0f / 4294967296.0f);
}

// sampling.sample_lights → direction, sampled instance (or -1)
__device__ V3 sample_light(const HrShadeScene& s, V3 position, uint32_t seed,
                           int* sampled) {
  const float rand_l = random_float(seed);
  const float rand_el = random_float(seed);
  const float ru = random_float(seed);
  const float rv = random_float(seed);
  const int L = s.n_lights;
  long long lid = static_cast<long long>(rand_l * static_cast<float>(L));
  lid = lid < 0 ? 0 : (lid > L - 1 ? L - 1 : lid);
  const int inst = s.light_inst[lid];
  const int env = s.light_env[lid];
  // sampling.sample_discrete_cdf
  const long long start = s.light_cdf_start[lid];
  const long long count = s.light_cdf_count[lid];
  long long last = start + count - 1;
  last = last < 0 ? 0 : last;
  const float x = rand_el * s.cdf[last];
  long long low = start, high = start + count;
  for (int k = 0; k < 32 && low < high; ++k) {
    const long long mid = low + floor_div(high - low, 2);
    const long long m = mid < 0 ? 0 : (mid > s.n_cdf - 1 ? s.n_cdf - 1 : mid);
    if (x >= s.cdf[m]) {
      low = mid + 1;
    } else {
      high = mid;
    }
  }
  long long a = low - start, b = count - 1;
  a = a < 0 ? 0 : a;
  b = b < 0 ? 0 : b;
  const long long elem = a < b ? a : b;
  *sampled = inst;
  if (inst != -1) {
    const float r = sqrtf(ru);
    const float tu = 1.0f - r;
    const float tv = rv * r;
    const long long tri =
        floor_div(static_cast<long long>(s.inst_index_offset[inst]), 3) + elem;
    const V3 p0 = load3(s.v0 + 3 * tri);
    const V3 p1 = load3(s.v1 + 3 * tri);
    const V3 p2 = load3(s.v2 + 3 * tri);
    const V3 pos = (p1 * tu + p2 * tv) + p0 * ((1.0f - tu) - tv);
    return normalize(pos - position);
  }
  if (env != -1) {
    const float z = 2.0f * ru - 1.0f;
    const float r = sqrtf(clamp_min(1.0f - z * z, 0.0f));
    const float phi = kTwoPi * rv;
    return {r * cosf(phi), r * sinf(phi), z};
  }
  return splat(0.0f);
}

__global__ void __launch_bounds__(kThreads)
    shade_hit_kernel(HrShadeScene s, const float* __restrict__ o,
                     const float* __restrict__ d, const float* __restrict__ t,
                     const int* __restrict__ tri, const float* __restrict__ u,
                     const float* __restrict__ v, const bool* __restrict__ hit,
                     const long long* __restrict__ ray_idx,
                     long long idx_offset, int R, float* __restrict__ occ_o,
                     float* __restrict__ occ_d, bool* __restrict__ occ_act,
                     float* __restrict__ terms) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const bool nee_on = s.n_lights > 0;
  const long long sun_at = i;
  const long long nee_at = s.light_on ? static_cast<long long>(R) + i : i;
  float* out = terms + static_cast<long long>(i) * kTerms;
  if (!hit[i]) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) out[k] = 0.0f;
    if (s.light_on) {
      store3(occ_o + 3 * sun_at, splat(0.0f));
      store3(occ_d + 3 * sun_at, splat(0.0f));
      occ_act[sun_at] = false;
    }
    if (nee_on) {
      store3(occ_o + 3 * nee_at, splat(0.0f));
      store3(occ_d + 3 * nee_at, splat(0.0f));
      occ_act[nee_at] = false;
    }
    return;
  }
  long long id = tri[i];
  id = id < 0 ? 0 : (id > s.n_rows - 1 ? s.n_rows - 1 : id);
  const float* row = s.rows + id * kRow;
  const float b1 = u[i], b2 = v[i];
  const float b0 = (1.0f - b1) - b2;
  const V3 dir = load3(d + 3 * i);
  const V3 world_pos = load3(o + 3 * i) + dir * t[i];
  // row[0:27] interpolated, column k: row[k] b0 + row[9 + k] b1 + ...
  auto lerp = [&](int k) {
    return row[k] * b0 + row[9 + k] * b1 + row[18 + k] * b2;
  };
  const float* nm = row + 27;
  auto to_world = [&](V3 x) {
    return V3{nm[0] * x.x + nm[1] * x.y + nm[2] * x.z,
              nm[3] * x.x + nm[4] * x.y + nm[5] * x.z,
              nm[6] * x.x + nm[7] * x.y + nm[8] * x.z};
  };
  V3 geo_n = normalize(to_world({lerp(0), lerp(1), lerp(2)}));
  if (dot(geo_n, dir) > 0.0f) geo_n = -geo_n;  // face the ray
  const float* mrow = row + 37;
  const bool textured = s.tex.slots != 0;
  const float uv_u = textured ? lerp(7) : 0.0f;
  const float uv_v = textured ? lerp(8) : 0.0f;
  const HrMaterialPoint mp = material_point(s.tex, mrow, uv_u, uv_v);
  const V3 colour = mp.colour;
  const V3 emission = mp.emission;
  const float r2 = mp.roughness;
  const float metallic = mp.metallic;
  V3 n = normalize(geo_n);
  if (s.tex.slots & 8) {
    const V3 tw = normalize(to_world({lerp(3), lerp(4), lerp(5)}));
    n = normal_map(s.tex, n, tw, lerp(6), static_cast<int>(mrow[13]), uv_u,
                   uv_v);
  }

  const V3 view = -dir;
  const V3 sun_dir = load3(s.uniforms);
  const V3 shadow_origin = {offset1(world_pos.x, geo_n.x),
                            offset1(world_pos.y, geo_n.y),
                            offset1(world_pos.z, geo_n.z)};
  const V3 sun_brdf = eval_pbr(colour, r2, metallic, n, view, sun_dir) *
                      load3(s.uniforms + 3);
  if (s.light_on) {
    store3(occ_o + 3 * sun_at, shadow_origin);
    store3(occ_d + 3 * sun_at, sun_dir);
    occ_act[sun_at] = dot(geo_n, sun_dir) > 0.0f;
  }
  V3 nee = splat(0.0f);
  if (nee_on) {
    const long long idx = (ray_idx != nullptr ? ray_idx[i] : i) + idx_offset;
    const uint32_t seed =
        tea(static_cast<uint32_t>(idx & 0xFFFFFFFFll),
            static_cast<uint32_t>(*s.frame_index & 0xFFFFFFFFll));
    int sampled;
    const V3 ldir = sample_light(s, world_pos, seed, &sampled);
    const bool has = norm(ldir) > 0.001f && dot(geo_n, ldir) > 0.0f;
    if (has && sampled >= 0) {
      nee = eval_pbr(colour, r2, metallic, n, view, ldir) *
            load3(s.inst_emission + 3 * sampled);
    }
    store3(occ_o + 3 * nee_at, shadow_origin);
    store3(occ_d + 3 * nee_at, ldir);
    occ_act[nee_at] = has;
  }
  V3 ambient = splat(0.0f);
  if (s.ibl) {  // closesthit.rchit:99-113
    const V3 r = dir - n * (dot(n, dir) * 2.0f);
    const V3 env_spec = environment(s, r);
    const V3 env_diff = environment(s, n);
    const V3 f0 = splat(0.04f) + (colour - splat(0.04f)) * metallic;
    const V3 f = fresnel_schlick(f0, n, view);
    const V3 kd = sub_from(1.0f, f) * (1.0f - metallic);
    const float amb = s.uniforms[6];
    ambient = (kd * env_diff * colour + f * env_spec) * amb;
  }
  store3(out, sun_brdf);
  store3(out + 3, nee);
  store3(out + 6, ambient);
  store3(out + 9, emission);
}

__global__ void __launch_bounds__(kThreads)
    shade_finish_kernel(HrShadeScene s, const float* __restrict__ terms,
                        const float* __restrict__ sun_vis,
                        const float* __restrict__ l_vis,
                        const bool* __restrict__ hit,
                        const float* __restrict__ t,
                        const float* __restrict__ d,
                        const long long* __restrict__ pos, int P,
                        float* __restrict__ rgb, float* __restrict__ dist) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const long long i = pos != nullptr ? pos[p] : p;
  V3 c;
  if (hit[i]) {
    const float* in = terms + i * kTerms;
    const float sv = sun_vis != nullptr ? sun_vis[i] : 0.0f;
    V3 direct = load3(in) * sv;
    if (l_vis != nullptr) {
      const bool lit = l_vis[i] > 0.5f;
      direct = direct + (lit ? load3(in + 3) : splat(0.0f));
    }
    c = (direct + load3(in + 6)) + load3(in + 9);
    dist[p] = t[i];
  } else {
    c = s.ibl ? environment(s, load3(d + 3 * i)) : splat(0.0f);
    dist[p] = -1.0f;
  }
  store3(rgb + 3 * static_cast<long long>(p), c);
}

}  // namespace

HR_EXPORT int hr_shade_hit(const HrShadeScene* scene, const void* o,
                           const void* d, const void* t, const void* tri,
                           const void* u, const void* v, const void* hit,
                           const void* ray_idx, long long idx_offset, int R,
                           void* occ_o, void* occ_d, void* occ_act,
                           void* terms, void* stream) {
  if (R > 0) {
    shade_hit_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        *scene, static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(t), static_cast<const int*>(tri),
        static_cast<const float*>(u), static_cast<const float*>(v),
        static_cast<const bool*>(hit),
        static_cast<const long long*>(ray_idx), idx_offset, R,
        static_cast<float*>(occ_o), static_cast<float*>(occ_d),
        static_cast<bool*>(occ_act), static_cast<float*>(terms));
  }
  HR_RETURN_LAUNCH_STATUS();
}

HR_EXPORT int hr_shade_finish(const HrShadeScene* scene, const void* terms,
                              const void* sun_vis, const void* l_vis,
                              const void* hit, const void* t, const void* d,
                              const void* pos, int P, void* rgb, void* dist,
                              void* stream) {
  if (P > 0) {
    shade_finish_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        *scene, static_cast<const float*>(terms),
        static_cast<const float*>(sun_vis), static_cast<const float*>(l_vis),
        static_cast<const bool*>(hit), static_cast<const float*>(t),
        static_cast<const float*>(d), static_cast<const long long*>(pos), P,
        static_cast<float*>(rgb), static_cast<float*>(dist));
  }
  HR_RETURN_LAUNCH_STATUS();
}
