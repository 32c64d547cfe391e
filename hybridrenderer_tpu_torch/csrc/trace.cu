// K2: any-hit ray / BVH traversal for shadow and AO rays.
//
// Replaces hybridrenderer_tpu/ops/trace_pallas.py _wide_direct_kernel
// (:869) in its any-hit mode. Same contract: a ray reports a hit
// (triangle id) as soon as it finds any triangle with tmin <= t <= tmax,
// else -1; inactive rays do no work and report -1.
//
// Design: one thread per ray, a 64-entry stack per thread over the
// binary SAH tree of native/bvh_builder.cpp. At an internal node both
// child boxes are tested and the hit children pushed far first, so the
// nearer one is popped next; the first triangle hit ends the ray. The
// TPU kernel's 8-wide collapse, bf16 records and 2048-ray packets with a
// shared stack were VMEM and packet workarounds; any-hit visibility does
// not depend on ray order, so none is kept. Bound on the card: latency
// of the dependent node and triangle loads (32 B per node, 36 B per
// triangle, L2-resident for the 65k-triangle scene) and warp divergence.
// The arithmetic is written in the order of the plain version
// (ops/trace_cuda.py), which takes the same path through the tree.
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
  const V3 inv_d = {safe_inv(dir.x), safe_inv(dir.y), safe_inv(dir.z)};
  const float tmax = tmax_in[i];

  int stack[kStack];
  int sp = 1;
  stack[0] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    if (node >= n_internal) {
      const int tri = node_tri[node];
      if (tri < 0) continue;
      const float* tv = tri_verts + 9 * static_cast<size_t>(tri);
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
      if (fabsf(det) >= kTriEps && u >= 0.0f && v >= 0.0f &&
          u + v <= 1.0f && t >= tmin && t <= tmax) {
        out[i] = tri;
        return;
      }
      continue;
    }
    const float4 nlo = nodes[2 * node];
    const float4 nhi = nodes[2 * node + 1];
    const int left = __float_as_int(nlo.w);
    const int right = __float_as_int(nhi.w);
    float lt, rt;
    const bool lhit = box_hit(nodes[2 * left], nodes[2 * left + 1], org,
                              inv_d, tmin, tmax, &lt);
    const bool rhit = box_hit(nodes[2 * right], nodes[2 * right + 1], org,
                              inv_d, tmin, tmax, &rt);
    const bool l_nearer = lt <= rt;
    // far child first, so the near one is popped next
    const int first = l_nearer ? right : left;
    const bool first_ok = l_nearer ? rhit : lhit;
    const int second = l_nearer ? left : right;
    const bool second_ok = l_nearer ? lhit : rhit;
    if (first_ok && sp < kStack) stack[sp++] = first;
    if (second_ok && sp < kStack) stack[sp++] = second;
  }
  out[i] = -1;
}

}  // namespace

HR_EXPORT int hr_trace_any(const void* nodes, const void* node_tri,
                           const void* tri_verts, int n_internal,
                           const void* o, const void* d, const void* tmax,
                           const void* active, float tmin, int R, void* out,
                           void* stream) {
  if (R > 0) {
    constexpr int kBlock = 128;
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
