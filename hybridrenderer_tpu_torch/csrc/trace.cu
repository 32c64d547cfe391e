// K2 and K2c: ray / BVH traversal, any-hit (shadow, AO and shading
// occlusion rays) and closest-hit (reflection and GI radiance rays).
// K2b (trace_packet, at the end of the file): the same queries as packet
// traversal, one warp per packet of 32 rays.
//
// Replaces hybridrenderer_tpu/ops/trace_pallas.py _wide_direct_kernel
// (:869) in both its modes. Same contracts:
// * any-hit: a ray reports a hit (triangle id) as soon as it finds any
//   triangle with tmin <= t <= tmax, else -1;
// * closest-hit: a ray reports (t, tri, u, v) of its nearest triangle with
//   tmin <= t <= tmax; a leaf hit with t <= the best so far replaces it, so
//   the later of two equal-t hits wins (ops/trace.py intersect_bvh); a miss
//   reports t = +inf, tri = -1, u = v = 0.
// Inactive rays do no work and report a miss.
//
// Design: one thread per ray, a 64-entry stack per thread over the
// binary SAH tree of native/bvh_builder.cpp. At an internal node both
// child boxes are tested (against the best t so far, which shrinks as
// closest-hit rays find triangles) and the hit children pushed far first,
// so the nearer one is popped next. The TPU kernel's 8-wide collapse,
// bf16 records and 2048-ray packets with a shared stack were VMEM and
// packet workarounds and are not kept. Bound on the card: latency of the
// dependent node and triangle loads (32 B per node, 36 B per triangle,
// L2-resident for the 65k-triangle scene) and warp divergence, worst for
// the incoherent GI rays. The arithmetic is written in the order of the
// plain version (ops/trace_cuda.py), which takes the same path through
// the tree.
#include "common.cuh"

namespace {

constexpr int kStack = 64;
constexpr float kTriEps = 1e-9f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// slab test against one node box → (hit, entry distance)
__device__ __forceinline__ bool box_hit(const float4 lo, const float4 hi,
                                        V3 o, V3 inv_d, float tmin,
                                        float tmax, float* tnear) {
  const float t0x = (lo.x - o.x) * inv_d.x, t1x = (hi.x - o.x) * inv_d.x;
  const float t0y = (lo.y - o.y) * inv_d.y, t1y = (hi.y - o.y) * inv_d.y;
  const float t0z = (lo.z - o.z) * inv_d.z, t1z = (hi.z - o.z) * inv_d.z;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  *tnear = tn;
  return tn <= tf && tf >= tmin && tn <= tmax;
}

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d);
}

// Möller–Trumbore, both-faced; true with (t, u, v) on a hit in
// [tmin, tmax]
__device__ __forceinline__ bool tri_hit(const float* tv, V3 org, V3 dir,
                                        float tmin, float tmax, float* t_out,
                                        float* u_out, float* v_out) {
  const V3 p0 = {tv[0], tv[1], tv[2]};
  const V3 e1 = sub({tv[3], tv[4], tv[5]}, p0);
  const V3 e2 = sub({tv[6], tv[7], tv[8]}, p0);
  const V3 pvec = cross(dir, e2);
  const float det = dot(e1, pvec);
  const float inv_det = 1.0f / (fabsf(det) < kTriEps ? kTriEps : det);
  const V3 tvec = sub(org, p0);
  const float u = dot(tvec, pvec) * inv_det;
  const V3 qvec = cross(tvec, e1);
  const float v = dot(dir, qvec) * inv_det;
  const float t = dot(e2, qvec) * inv_det;
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return fabsf(det) >= kTriEps && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t >= tmin && t <= tmax;
}

// One ray's traversal. Returns the hit triangle or -1; closest-hit also
// leaves the hit's (t, u, v) in *best_t, *best_u, *best_v (best_t enters
// as the ray's tmax).
template <bool kAnyHit>
__device__ __forceinline__ int traverse(const float4* __restrict__ nodes,
                                        const int* __restrict__ node_tri,
                                        const float* __restrict__ tri_verts,
                                        int n_internal, V3 org, V3 dir,
                                        float tmin, float* best_t,
                                        float* best_u, float* best_v) {
  const V3 inv_d = {safe_inv(dir.x), safe_inv(dir.y), safe_inv(dir.z)};
  int best_tri = -1;
  int stack[kStack];
  int sp = 1;
  stack[0] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    if (node >= n_internal) {
      const int tri = node_tri[node];
      if (tri < 0) continue;
      float t, u, v;
      if (tri_hit(tri_verts + 9 * static_cast<size_t>(tri), org, dir, tmin,
                  *best_t, &t, &u, &v)) {
        if (kAnyHit) return tri;
        best_tri = tri;
        *best_t = t;
        *best_u = u;
        *best_v = v;
      }
      continue;
    }
    const float4 nlo = nodes[2 * node];
    const float4 nhi = nodes[2 * node + 1];
    const int left = __float_as_int(nlo.w);
    const int right = __float_as_int(nhi.w);
    float lt, rt;
    const bool lhit = box_hit(nodes[2 * left], nodes[2 * left + 1], org,
                              inv_d, tmin, *best_t, &lt);
    const bool rhit = box_hit(nodes[2 * right], nodes[2 * right + 1], org,
                              inv_d, tmin, *best_t, &rt);
    const bool l_nearer = lt <= rt;
    // far child first, so the near one is popped next
    const int first = l_nearer ? right : left;
    const bool first_ok = l_nearer ? rhit : lhit;
    const int second = l_nearer ? left : right;
    const bool second_ok = l_nearer ? lhit : rhit;
    if (first_ok && sp < kStack) stack[sp++] = first;
    if (second_ok && sp < kStack) stack[sp++] = second;
  }
  return best_tri;
}

__global__ void trace_any_kernel(const float4* __restrict__ nodes,
                                 const int* __restrict__ node_tri,
                                 const float* __restrict__ tri_verts,
                                 int n_internal, const float* __restrict__ o,
                                 const float* __restrict__ d,
                                 const float* __restrict__ tmax_in,
                                 const uint8_t* __restrict__ active,
                                 float tmin, int R, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  if (!active[i]) {
    out[i] = -1;
    return;
  }
  const V3 org = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const V3 dir = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  float t = tmax_in[i], u, v;
  out[i] = traverse<true>(nodes, node_tri, tri_verts, n_internal, org, dir,
                          tmin, &t, &u, &v);
}

__global__ void trace_closest_kernel(
    const float4* __restrict__ nodes, const int* __restrict__ node_tri,
    const float* __restrict__ tri_verts, int n_internal,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ tmax_in, const uint8_t* __restrict__ active,
    float tmin, int R, float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  int tri = -1;
  float t = 0.0f, u = 0.0f, v = 0.0f;
  if (active[i]) {
    t = tmax_in[i];
    const V3 org = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    const V3 dir = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    tri = traverse<false>(nodes, node_tri, tri_verts, n_internal, org, dir,
                          tmin, &t, &u, &v);
  }
  t_out[i] = tri < 0 ? __int_as_float(0x7f800000) : t;
  tri_out[i] = tri;
  u_out[i] = u;
  v_out[i] = v;
}

constexpr int kBlock = 128;

// ---------------------------------------------------------------------------
// K2b: packet traversal.
//
// Replaces hybridrenderer_tpu/ops/trace_pallas.py _traverse_kernel (:132,
// entry intersect_packed :338), the binary-BVH packet traversal of
// trace_backend="pallas". The TPU kernel's packet is 8x128 rays sharing
// one scalar stack of 96 entries; here a packet is one warp of 32
// consecutive rays (the caller orders coherent rays in 8x4 pixel tiles)
// sharing one 96-entry stack in shared memory. Same rules:
// * the warp pops one node at a time;
// * at an internal node each live lane slab-tests both child boxes
//   against its own best t (any-hit: only lanes without a hit yet); a
//   child is pushed if any lane hits it (__ballot_sync), the far one
//   first; near and far come from the warp's sums of entry distances
//   over the lanes that hit each box (trace_pallas.py:281-290), summed
//   in the xor-butterfly order the plain version repeats;
// * at a leaf each live lane runs K2's Moller-Trumbore with the
//   t <= best replacement (:244), in any-hit mode too;
// * any-hit: the warp stops once every live lane has a hit;
// * tmax is clamped to 1e6 (:359-360). Inactive rays do no work, take
//   no part in the warp's votes and report a miss (the TPU kernel has
//   no active mask: inactive rays there get tmax 0).
// A tree of depth D needs D + 1 entries (ops/trace_cuda.pack_bvh raises
// above 96), so no child is dropped.
// Bound on the card: as K2, the latency of dependent node loads, now
// shared by the warp: one node load serves 32 rays, and lanes of a
// coherent packet agree on most boxes; an incoherent packet visits the
// union of its rays' nodes.
constexpr int kPacketStack = 96;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kBlock)
trace_packet_kernel(const float4* __restrict__ nodes,
                    const int* __restrict__ node_tri,
                    const float* __restrict__ tri_verts, int n_internal,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmax_in,
                    const uint8_t* __restrict__ active_in, float tmin, int R,
                    int any_hit, float* __restrict__ t_out,
                    int* __restrict__ tri_out, float* __restrict__ u_out,
                    float* __restrict__ v_out) {
  __shared__ int stacks[kBlock / kWarp][kPacketStack];
  const int lane = threadIdx.x % kWarp;
  int* stack = stacks[threadIdx.x / kWarp];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < R && active_in[i];

  V3 org = {0.0f, 0.0f, 0.0f}, dir = {0.0f, 0.0f, 1.0f};
  float best_t = 0.0f;
  if (active) {
    org = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    dir = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    best_t = fminf(tmax_in[i], 1e6f);
  }
  const V3 inv_d = {safe_inv(dir.x), safe_inv(dir.y), safe_inv(dir.z)};
  int best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;

  // sp is the same in every lane; only lane 0 writes the stack
  int sp = __any_sync(kFull, active) ? 1 : 0;
  if (lane == 0) stack[0] = 0;
  __syncwarp();
  while (sp > 0) {
    if (any_hit && __all_sync(kFull, !active || best_tri >= 0)) break;
    const int node = stack[--sp];
    __syncwarp();  // every lane has read the top before it is rewritten
    if (node >= n_internal) {
      const int tri = node_tri[node];
      float t, u, v;
      if (tri >= 0 && active &&
          tri_hit(tri_verts + 9 * static_cast<size_t>(tri), org, dir, tmin,
                  best_t, &t, &u, &v)) {
        best_tri = tri;
        best_t = t;
        best_u = u;
        best_v = v;
      }
      continue;
    }
    const float4 nlo = nodes[2 * node];
    const float4 nhi = nodes[2 * node + 1];
    const int left = __float_as_int(nlo.w);
    const int right = __float_as_int(nhi.w);
    const bool live = active && !(any_hit && best_tri >= 0);
    float lt = 0.0f, rt = 0.0f;
    const bool lhit = live && box_hit(nodes[2 * left], nodes[2 * left + 1],
                                      org, inv_d, tmin, best_t, &lt);
    const bool rhit = live && box_hit(nodes[2 * right],
                                      nodes[2 * right + 1], org, inv_d,
                                      tmin, best_t, &rt);
    const bool l_any = __any_sync(kFull, lhit);
    const bool r_any = __any_sync(kFull, rhit);
    const float l_sum = warp_sum(lhit ? lt : 0.0f);
    const float r_sum = warp_sum(rhit ? rt : 0.0f);
    const bool l_nearer = l_sum <= r_sum;
    // far child first, so the near one is popped next
    const int first = l_nearer ? right : left;
    const bool first_ok = l_nearer ? r_any : l_any;
    const int second = l_nearer ? left : right;
    const bool second_ok = l_nearer ? l_any : r_any;
    if (lane == 0) {
      if (first_ok) stack[sp] = first;
      if (second_ok) stack[sp + first_ok] = second;
    }
    sp += first_ok + second_ok;
    __syncwarp();
  }
  if (i >= R) return;
  t_out[i] = best_tri < 0 ? __int_as_float(0x7f800000) : best_t;
  tri_out[i] = best_tri;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

}  // namespace

HR_EXPORT int hr_trace_any(const void* nodes, const void* node_tri,
                           const void* tri_verts, int n_internal,
                           const void* o, const void* d, const void* tmax,
                           const void* active, float tmin, int R, void* out,
                           void* stream) {
  if (R > 0) {
    trace_any_kernel<<<(R + kBlock - 1) / kBlock, kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(nodes), static_cast<const int*>(node_tri),
        static_cast<const float*>(tri_verts), n_internal,
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(tmax),
        static_cast<const uint8_t*>(active), tmin, R,
        static_cast<int*>(out));
  }
  HR_RETURN_LAUNCH_STATUS();
}

HR_EXPORT int hr_trace_closest(const void* nodes, const void* node_tri,
                               const void* tri_verts, int n_internal,
                               const void* o, const void* d,
                               const void* tmax, const void* active,
                               float tmin, int R, void* t_out, void* tri_out,
                               void* u_out, void* v_out, void* stream) {
  if (R > 0) {
    trace_closest_kernel<<<(R + kBlock - 1) / kBlock, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(nodes), static_cast<const int*>(node_tri),
        static_cast<const float*>(tri_verts), n_internal,
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(tmax),
        static_cast<const uint8_t*>(active), tmin, R,
        static_cast<float*>(t_out), static_cast<int*>(tri_out),
        static_cast<float*>(u_out), static_cast<float*>(v_out));
  }
  HR_RETURN_LAUNCH_STATUS();
}

// any_hit 0 or 1; for any-hit the caller may ignore t, u and v
HR_EXPORT int hr_trace_packet(const void* nodes, const void* node_tri,
                              const void* tri_verts, int n_internal,
                              const void* o, const void* d, const void* tmax,
                              const void* active, float tmin, int R,
                              int any_hit, void* t_out, void* tri_out,
                              void* u_out, void* v_out, void* stream) {
  if (R > 0) {
    trace_packet_kernel<<<(R + kBlock - 1) / kBlock, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(nodes), static_cast<const int*>(node_tri),
        static_cast<const float*>(tri_verts), n_internal,
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(tmax),
        static_cast<const uint8_t*>(active), tmin, R, any_hit,
        static_cast<float*>(t_out), static_cast<int*>(tri_out),
        static_cast<float*>(u_out), static_cast<float*>(v_out));
  }
  HR_RETURN_LAUNCH_STATUS();
}
