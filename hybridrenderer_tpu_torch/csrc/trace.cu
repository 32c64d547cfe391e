// K2 and K2c: ray / BVH traversal, any-hit (shadow, AO and shading
// occlusion rays) and closest-hit (reflection and GI radiance rays).
// K2b (trace_packet): the same queries as packet traversal, one warp per
// packet of 32 rays. K2w (trace_wide) and K2m (trace_mimt), at the end of
// the file: packet traversals of the 8-wide BVH (ops/bvh_wide.py).
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
// Design: one thread per ray over the binary SAH tree of
// native/bvh_builder.cpp, in records ops/trace_cuda.pack_bvh lays out
// for these two kernels:
// * one 64 B record per internal node that holds both children: the left
//   child's box and reference, then the right child's (four aligned
//   float4), so one round trip a step brings both boxes and both
//   references. A reference is an internal node's index (>= 0), or ~k for
//   leaf k, whose triangle row is row k;
// * one 48 B row per leaf, in leaf (SAH) order: v0 and the triangle id,
//   e1 = v1 - v0, e2 = v2 - v0 (the subtraction tri_hit does, so the same
//   bits), reached straight from the reference, with no triangle-id
//   indirection and no step of its own;
// * the near child kept in a register: both children hit, push the far
//   one and go on with the near one; one hit, go on with it; none, pop.
//   That is the order of "push far, push near, pop near" exactly, so a ray
//   visits the nodes of the plain version (ops/trace_cuda.py, which walks
//   the per-node records) in its order, and reports its triangle, the
//   choice among equal-t hits included. A tree of depth D needs D stack
//   entries (the far children of the current path).
// * image queries (``width`` > 0): each warp traces an 8x4 pixel tile,
//   whose rays start close together and, for shadow rays, run parallel.
// The stack is a 64-entry local array (cached in L1), in blocks of 128
// threads, one step of either kind a turn of the loop: on the 1080p
// headline and full-graph rays that beat a stack in shared memory, blocks
// of 256 and a "while-while" loop (PERF.md §6 has the readings). The
// TPU kernel's 8-wide collapse, bf16 records and 2048-ray packets with a
// shared stack were VMEM and packet workarounds and are not kept. Bound
// on the card: instruction issue (~70 instructions an internal step, its
// float operations in the plain version's order under -fmad=false)
// thinned by warp divergence, worst for the incoherent GI rays; the
// records are L2-resident for the 65k-triangle scene.
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

// Möller–Trumbore, both-faced, on the corner p0 and the edges e1 = p1 - p0,
// e2 = p2 - p0; true with (t, u, v) on a hit in [tmin, tmax]
__device__ __forceinline__ bool tri_hit_edges(V3 p0, V3 e1, V3 e2, V3 org,
                                              V3 dir, float tmin, float tmax,
                                              float* t_out, float* u_out,
                                              float* v_out) {
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

// the same test on the corners tv[0:9]
__device__ __forceinline__ bool tri_hit(const float* tv, V3 org, V3 dir,
                                        float tmin, float tmax, float* t_out,
                                        float* u_out, float* v_out) {
  const V3 p0 = {tv[0], tv[1], tv[2]};
  return tri_hit_edges(p0, sub({tv[3], tv[4], tv[5]}, p0),
                       sub({tv[6], tv[7], tv[8]}, p0), org, dir, tmin, tmax,
                       t_out, u_out, v_out);
}

__device__ __forceinline__ V3 xyz(float4 a) { return {a.x, a.y, a.z}; }

// K2 / K2c's block; image queries: each warp traces one 8x4 pixel tile
constexpr int kTraceBlock = 128;
constexpr int kTileW = 8, kTileH = 4;

// A ray's stack of references: a 64-entry array in local memory
struct Stack {
  int s[kStack];
  int sp = 0;
  __device__ void push(int ref) {
    if (sp < kStack) s[sp++] = ref;
  }
  __device__ bool pop(int* ref) {
    if (sp == 0) return false;
    *ref = s[--sp];
    return true;
  }
};

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// threads for R rays: R, or for an image ``width`` columns wide whole
// 8x4 tiles of it
constexpr int trace_threads(int R, int width) {
  return width <= 0 ? R
                    : ceil_div(width, kTileW) *
                          ceil_div(ceil_div(R, width), kTileH) * 32;
}

// this thread's ray, or -1: thread i traces ray i, or with ``width`` > 0
// warp w traces tile w of the image (tiles row-major, rows of a tile
// row-major too), ray y * width + x at pixel (x, y)
__device__ __forceinline__ int ray_of_thread(int R, int width) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (width <= 0) return t < R ? t : -1;
  const int lane = t % 32, tile = t / 32;
  const int tiles_x = ceil_div(width, kTileW);
  const int x = tile % tiles_x * kTileW + lane % kTileW;
  const int i = (tile / tiles_x * kTileH + lane / kTileW) * width + x;
  return x < width && i < R ? i : -1;
}

// One internal step at record ``ref``: both child boxes tested against
// the best t so far. → true with the next reference in *ref (the near
// child when both are hit, the far one pushed), false when neither is
// hit (the caller pops).
__device__ __forceinline__ bool inner_step(const float4* __restrict__ inner,
                                           int* ref, Stack* stack, V3 org,
                                           V3 inv_d, float tmin,
                                           float best_t) {
  const float4* rec = inner + 4 * static_cast<size_t>(*ref);
  const float4 lmin = rec[0], lmax = rec[1], rmin = rec[2], rmax = rec[3];
  float lt, rt;
  const bool lhit = box_hit(lmin, lmax, org, inv_d, tmin, best_t, &lt);
  const bool rhit = box_hit(rmin, rmax, org, inv_d, tmin, best_t, &rt);
  const int left = __float_as_int(lmin.w);
  const int right = __float_as_int(rmin.w);
  if (lhit && rhit) {
    const bool l_nearer = lt <= rt;
    stack->push(l_nearer ? right : left);
    *ref = l_nearer ? left : right;
    return true;
  }
  if (lhit || rhit) {
    *ref = lhit ? left : right;
    return true;
  }
  return false;
}

// One leaf step at reference ``ref`` (< 0): its triangle row tested; a
// hit with t <= the best so far replaces it. → true when an any-hit ray
// is done.
template <bool kAnyHit>
__device__ __forceinline__ bool leaf_step(const float4* __restrict__ leaves,
                                          int ref, V3 org, V3 dir,
                                          float tmin, int* best_tri,
                                          float* best_t, float* best_u,
                                          float* best_v) {
  const float4* row = leaves + 3 * static_cast<size_t>(~ref);
  const float4 a = row[0], e1 = row[1], e2 = row[2];
  const int tri = __float_as_int(a.w);
  float t, u, v;
  if (tri >= 0 && tri_hit_edges(xyz(a), xyz(e1), xyz(e2), org, dir, tmin,
                                *best_t, &t, &u, &v)) {
    *best_tri = tri;
    *best_t = t;
    *best_u = u;
    *best_v = v;
    return kAnyHit;
  }
  return false;
}

// One ray's traversal. Returns the hit triangle or -1; closest-hit also
// leaves the hit's (t, u, v) in *best_t, *best_u, *best_v (best_t enters
// as the ray's tmax). ``inner`` holds 4 float4 per internal node,
// ``leaves`` 3 per leaf (the layout above).
template <bool kAnyHit>
__device__ __forceinline__ int traverse(const float4* __restrict__ inner,
                                        const float4* __restrict__ leaves,
                                        int n_internal, V3 org, V3 dir,
                                        float tmin, float* best_t,
                                        float* best_u, float* best_v) {
  const V3 inv_d = {safe_inv(dir.x), safe_inv(dir.y), safe_inv(dir.z)};
  int best_tri = -1;
  Stack stack;
  // the root: internal node 0, or for one triangle leaf 0 (tested
  // without a box, as the root is)
  int ref = n_internal > 0 ? 0 : ~0;
  for (;;) {
    if (ref >= 0) {
      if (inner_step(inner, &ref, &stack, org, inv_d, tmin, *best_t)) {
        continue;
      }
    } else if (leaf_step<kAnyHit>(leaves, ref, org, dir, tmin, &best_tri,
                                  best_t, best_u, best_v)) {
      return best_tri;
    }
    if (!stack.pop(&ref)) return best_tri;
  }
}

__global__ void __launch_bounds__(kTraceBlock)
trace_any_kernel(const float4* __restrict__ inner,
                 const float4* __restrict__ leaves, int n_internal,
                 const float* __restrict__ o,
                 const float* __restrict__ d,
                 const float* __restrict__ tmax_in,
                 const uint8_t* __restrict__ active, float tmin, int R,
                 int width, int* __restrict__ out) {
  const int i = ray_of_thread(R, width);
  if (i < 0) return;
  if (!active[i]) {
    out[i] = -1;
    return;
  }
  const V3 org = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const V3 dir = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  float t = tmax_in[i], u, v;
  out[i] = traverse<true>(inner, leaves, n_internal, org, dir, tmin, &t, &u,
                          &v);
}

__global__ void __launch_bounds__(kTraceBlock)
trace_closest_kernel(const float4* __restrict__ inner,
                     const float4* __restrict__ leaves, int n_internal,
                     const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ tmax_in,
                     const uint8_t* __restrict__ active, float tmin, int R,
                     int width, float* __restrict__ t_out,
                     int* __restrict__ tri_out, float* __restrict__ u_out,
                     float* __restrict__ v_out) {
  const int i = ray_of_thread(R, width);
  if (i < 0) return;
  int tri = -1;
  float t = 0.0f, u = 0.0f, v = 0.0f;
  if (active[i]) {
    t = tmax_in[i];
    const V3 org = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    const V3 dir = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    tri = traverse<false>(inner, leaves, n_internal, org, dir, tmin, &t, &u,
                          &v);
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


// ---------------------------------------------------------------------------
// K2w and K2m: packet traversals of the 8-wide BVH (ops/bvh_wide.py: flat
// records of 48 floats, node rows of 8 child boxes, leaf rows of 4
// triangles as v0, e1, e2, id; meta (ibase*256 | imask, lbase*256 |
// lmask) per node).
//
// Replace hybridrenderer_tpu/ops/trace_pallas.py _wide_traverse_kernel
// (:457, entry intersect_wide :746) and _mimt_traverse_kernel (:1518,
// entry intersect_mimt :1757). Same contract: a packet is 1024
// consecutive rays; a program, here one block of 1024 threads, runs two
// packets, thread i holding ray i of each; inactive rays (and the padding
// past R: o = 0, d = 1) carry tmax -1 and start with the sentinel id
// INACTIVE_TRI, so they never hit and count as done for any-hit; tmax is
// clamped to 1e6. Each step pops one internal node and one leaf cluster
// (per packet, or per 128-ray row for K2m), runs the 4 Moller-Trumbore
// tests of the cluster (a hit with t <= the best so far replaces it, in
// any-hit mode too) and the 8 slab tests of the node against each ray's
// best t (any-hit rays with a hit test against -inf), ORs the hits of the
// packet's (row's) rays per child slot and pushes the hit children of
// each kind, masked by the meta masks (empty slots' inverted boxes pass
// every slab test). The block tests liveness every 16 steps and runs
// while either packet has stack entries and, any-hit, a ray without a
// hit: a finished packet keeps popping beside its live sibling, as the
// reference's chunked loop does, so the kernels report the reference's
// triangles, any-hit included.
// * K2w: one stack per kind per packet of compressed entries
//   (node << 8 | pending child mask); a pop takes the lowest pending
//   slot and decodes its id with the meta popcount rule; the entry leaves
//   the stack with its last bit. Votes: __reduce_or_sync per warp, then a
//   shared atomicOr per packet; thread 0 writes the stacks.
// * K2m: each row (4 warps) has its own stacks of direct ids; a row pushes
//   its hit children at sp + popcount(hits below), id base +
//   popcount(mask below), threads 0..7 of the row one slot each, and pops
//   the last pushed first.
// Stacks live in shared memory. Internal stacks hold 128 entries (the TPU
// kernels' 128 register lanes), enough for any tree ops/trace_cuda.
// check_wide_stacks accepts. Leaf stacks hold 512: the TPU kernels drop
// leaf pushes past 128 and miss their triangles (a packet's leaf stack
// reaches ~150 on the stress scene); here a packet (row) whose leaf stack
// could overflow pops no internal node that step, only a leaf, so the
// visiting order is the reference's wherever the reference drops nothing
// and no push is ever dropped. Leaf pushes past 128 are counted in
// *deep_pushes. Arithmetic in the order of the plain versions
// (ops/trace_cuda.py); -fmad=false makes the card check exact.
// Bound on the card: two block barriers and a vote per step for 1024
// threads, and the step count, which is the union of the nodes the
// packet's (row's) rays visit; records are read from L2 (5 MB for the
// 65k-triangle scene), each once per step, broadcast to the block.
constexpr int kWidePacket = 1024;
constexpr int kWideChunk = 16;
constexpr int kWideMaxSteps = 1 << 16;
constexpr int kWideStack = 128;
constexpr int kWideLeafStack = 512;
constexpr int kWideRows = 8;
constexpr int kRowRays = kWidePacket / kWideRows;
constexpr int kInactiveTri = 1 << 29;

struct WideRay {
  V3 o, d, inv;
  float t, u, v;
  int tri;
};

__device__ __forceinline__ WideRay wide_ray(const float* __restrict__ o,
                                            const float* __restrict__ d,
                                            const float* __restrict__ tmax,
                                            const uint8_t* __restrict__ act,
                                            long i, int R) {
  WideRay r;
  float tm = -1.0f;
  if (i < R) {
    r.o = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    r.d = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    if (act[i]) tm = fminf(tmax[i], 1e6f);
  } else {
    r.o = {0.0f, 0.0f, 0.0f};
    r.d = {1.0f, 1.0f, 1.0f};
  }
  r.inv = {safe_inv(r.d.x), safe_inv(r.d.y), safe_inv(r.d.z)};
  r.t = tm;
  r.u = 0.0f;
  r.v = 0.0f;
  r.tri = tm < 0.0f ? kInactiveTri : -1;
  return r;
}

__device__ __forceinline__ void wide_store(const WideRay& r, long i, int R,
                                           float* __restrict__ t_out,
                                           int* __restrict__ tri_out,
                                           float* __restrict__ u_out,
                                           float* __restrict__ v_out) {
  if (i >= R) return;
  t_out[i] = r.tri < 0 ? __int_as_float(0x7f800000) : r.t;
  tri_out[i] = r.tri;
  u_out[i] = r.u;
  v_out[i] = r.v;
}

// the 4 triangles of leaf record `rec`
__device__ __forceinline__ void wide_leaf(const float* __restrict__ rec,
                                          WideRay& r, float tmin) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* f = rec + 12 * k;
    const float p0x = __ldg(f + 0), p0y = __ldg(f + 1), p0z = __ldg(f + 2);
    const float a1x = __ldg(f + 3), a1y = __ldg(f + 4), a1z = __ldg(f + 5);
    const float a2x = __ldg(f + 6), a2y = __ldg(f + 7), a2z = __ldg(f + 8);
    const float tid = __ldg(f + 9);
    const float pvx = r.d.y * a2z - r.d.z * a2y;
    const float pvy = r.d.z * a2x - r.d.x * a2z;
    const float pvz = r.d.x * a2y - r.d.y * a2x;
    const float det = a1x * pvx + a1y * pvy + a1z * pvz;
    const float inv_det = 1.0f / (fabsf(det) < kTriEps ? kTriEps : det);
    const float tvx = r.o.x - p0x;
    const float tvy = r.o.y - p0y;
    const float tvz = r.o.z - p0z;
    const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * a1z - tvz * a1y;
    const float qvy = tvz * a1x - tvx * a1z;
    const float qvz = tvx * a1y - tvy * a1x;
    const float vv = (r.d.x * qvx + r.d.y * qvy + r.d.z * qvz) * inv_det;
    const float tt = (a2x * qvx + a2y * qvy + a2z * qvz) * inv_det;
    if (fabsf(det) >= kTriEps && uu >= 0.0f && vv >= 0.0f &&
        uu + vv <= 1.0f && tt >= tmin && tt <= r.t && tid >= 0.0f) {
      r.t = tt;
      r.tri = static_cast<int>(tid);
      r.u = uu;
      r.v = vv;
    }
  }
}

// the mask of the 8 child boxes of node record `rec` that the ray hits
__device__ __forceinline__ unsigned wide_votes(const float* __restrict__ rec,
                                               const WideRay& r, float tmin,
                                               bool any_hit) {
  const float tb = (any_hit && r.tri >= 0) ? -__int_as_float(0x7f800000)
                                           : r.t;
  unsigned hm = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float* f = rec + 6 * c;
    const float t0x = (__ldg(f + 0) - r.o.x) * r.inv.x;
    const float t1x = (__ldg(f + 3) - r.o.x) * r.inv.x;
    const float t0y = (__ldg(f + 1) - r.o.y) * r.inv.y;
    const float t1y = (__ldg(f + 4) - r.o.y) * r.inv.y;
    const float t0z = (__ldg(f + 2) - r.o.z) * r.inv.z;
    const float t1z = (__ldg(f + 5) - r.o.z) * r.inv.z;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fmaxf(t0z, t1z));
    if (tn <= tf && tf >= tmin && tn <= tb) hm |= 1u << c;
  }
  return hm;
}

// K2w's pop decode: entry (parent << 8 | pending mask) → the id of its
// lowest pending child of kind `col` (0 internal, 1 leaf); *rem gets the
// mask without that bit
__device__ __forceinline__ int wide_decode(int e, const int2* __restrict__ meta,
                                           int n_meta, int col, int* rem) {
  const int bits = e & 255;
  const int below = (bits & -bits) - 1;
  const int2 mm = __ldg(meta + max(min(e >> 8, n_meta - 1), 0));
  const int m = col ? mm.y : mm.x;
  *rem = bits & (bits - 1);
  return (m >> 8) + __popc((m & 255) & below);
}

// OR of `v` over the warp, added into *dst by lane 0
__device__ __forceinline__ void vote_or(unsigned v, unsigned* dst) {
  v = __reduce_or_sync(kFull, v);
  if ((threadIdx.x & (kWarp - 1)) == 0 && v) atomicOr(dst, v);
}

__global__ void __launch_bounds__(kWidePacket)
trace_wide_kernel(const float* __restrict__ nodes,
                  const float* __restrict__ leaves,
                  const int2* __restrict__ meta, int n_nodes, int n_leaves,
                  int n_meta, const float* __restrict__ o,
                  const float* __restrict__ d,
                  const float* __restrict__ tmax,
                  const uint8_t* __restrict__ active, float tmin, int R,
                  int any_hit, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ u_out,
                  float* __restrict__ v_out, int* __restrict__ deep_pushes) {
  __shared__ int s_istack[2][kWideStack];
  __shared__ int s_lstack[2][kWideLeafStack];
  __shared__ unsigned s_vote[2][2];  // [buffer][packet]
  const int tid = threadIdx.x;
  const long base = static_cast<long>(blockIdx.x) * 2 * kWidePacket + tid;
  WideRay ray[2];
  for (int p = 0; p < 2; ++p) {
    ray[p] = wide_ray(o, d, tmax, active, base + p * kWidePacket, R);
  }
  // the bootstrap entry (super-root 0, mask 1) decodes to the root
  int isp[2] = {1, 1}, lsp[2] = {0, 0};
  if (tid < 2) {
    s_istack[tid][0] = 1;
    s_lstack[tid][0] = 0;
  }
  if (tid < 4) s_vote[tid / 2][tid % 2] = 0u;
  __syncthreads();
  int buf = 0;
  for (int steps = 0; steps < kWideMaxSteps; steps += kWideChunk) {
    bool live = false;
    for (int p = 0; p < 2; ++p) {
      bool pl = isp[p] > 0 || lsp[p] > 0;
      if (any_hit) pl = pl && !__syncthreads_and(ray[p].tri >= 0);
      live = live || pl;
    }
    if (!live) break;
    for (int s = 0; s < kWideChunk; ++s) {
      int node[2], itop[2], ltop[2], ient[2], lent[2];
      bool ivalid[2], lvalid[2];
      for (int p = 0; p < 2; ++p) {
        // a packet whose leaf stack is full pops no node this step
        ivalid[p] = isp[p] > 0 && lsp[p] < kWideLeafStack;
        itop[p] = max(isp[p] - 1, 0);
        // an empty stack's top is never read: it may hold anything
        const int ie = (isp[p] > 0 && itop[p] < kWideStack)
                           ? s_istack[p][itop[p]] : 0;
        int irem, lrem;
        const int ichild = wide_decode(ie, meta, n_meta, 0, &irem);
        ient[p] = ((ie >> 8) << 8) | irem;
        lvalid[p] = lsp[p] > 0;
        ltop[p] = max(lsp[p] - 1, 0);
        const int le = lsp[p] > 0 ? s_lstack[p][ltop[p]] : 0;
        const int lchild = wide_decode(le, meta, n_meta, 1, &lrem);
        lent[p] = ((le >> 8) << 8) | lrem;
        node[p] = ivalid[p] ? min(ichild, n_nodes - 1) : 0;
        const int leaf = lvalid[p] ? min(lchild, n_leaves - 1)
                                   : n_leaves - 1;
        wide_leaf(leaves + 48L * leaf, ray[p], tmin);
        vote_or(wide_votes(nodes + 48L * node[p], ray[p], tmin, any_hit),
                &s_vote[buf][p]);
        // the entry leaves the stack with its last pending bit
        isp[p] -= (ivalid[p] && irem == 0) ? 1 : 0;
        lsp[p] -= (lvalid[p] && lrem == 0) ? 1 : 0;
      }
      __syncthreads();  // votes in; every thread has read the tops
      for (int p = 0; p < 2; ++p) {
        const unsigned hm = ivalid[p] ? s_vote[buf][p] : 0u;
        const int2 mm = __ldg(meta + min(node[p], n_meta - 1));
        const int hi = static_cast<int>(hm) & mm.x & 255;
        const int hl = static_cast<int>(hm) & mm.y & 255;
        if (tid == 0) {
          if (ivalid[p] && itop[p] < kWideStack) {
            s_istack[p][itop[p]] = ient[p];
          }
          if (lvalid[p]) s_lstack[p][ltop[p]] = lent[p];
          if (hi && isp[p] < kWideStack) {
            s_istack[p][isp[p]] = (node[p] << 8) | hi;
          }
          if (hl) {
            s_lstack[p][lsp[p]] = (node[p] << 8) | hl;
            if (lsp[p] >= kWideStack) atomicAdd(deep_pushes, 1);
          }
          s_vote[buf ^ 1][p] = 0u;
        }
        isp[p] += hi != 0;
        lsp[p] += hl != 0;
      }
      __syncthreads();  // stacks written before the next step's pops
      buf ^= 1;
    }
  }
  for (int p = 0; p < 2; ++p) {
    wide_store(ray[p], base + p * kWidePacket, R, t_out, tri_out, u_out,
               v_out);
  }
}

__global__ void __launch_bounds__(kWidePacket)
trace_mimt_kernel(const float* __restrict__ nodes,
                  const float* __restrict__ leaves,
                  const int2* __restrict__ meta, int n_nodes, int n_leaves,
                  int n_meta, const float* __restrict__ o,
                  const float* __restrict__ d,
                  const float* __restrict__ tmax,
                  const uint8_t* __restrict__ active, float tmin, int R,
                  int any_hit, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ u_out,
                  float* __restrict__ v_out, int* __restrict__ deep_pushes) {
  __shared__ int s_istack[2][kWideRows][kWideStack];
  __shared__ int s_lstack[2][kWideRows][kWideLeafStack];
  __shared__ unsigned s_vote[2][2][kWideRows];  // [buffer][packet][row]
  const int tid = threadIdx.x;
  const int row = tid / kRowRays, lane = tid % kRowRays;
  const long base = static_cast<long>(blockIdx.x) * 2 * kWidePacket + tid;
  WideRay ray[2];
  for (int p = 0; p < 2; ++p) {
    ray[p] = wide_ray(o, d, tmax, active, base + p * kWidePacket, R);
  }
  // every row starts on the super-root's id 0; sp is the thread's row's
  int isp[2] = {1, 1}, lsp[2] = {0, 0};
  if (lane < 2) {
    s_istack[lane][row][0] = 0;
    s_lstack[lane][row][0] = 0;
  }
  if (lane < 4) s_vote[lane / 2][lane % 2][row] = 0u;
  __syncthreads();
  int buf = 0;
  for (int steps = 0; steps < kWideMaxSteps; steps += kWideChunk) {
    bool live = false;
    for (int p = 0; p < 2; ++p) {
      bool pl = __syncthreads_or(isp[p] > 0 || lsp[p] > 0);
      if (any_hit) pl = pl && !__syncthreads_and(ray[p].tri >= 0);
      live = live || pl;
    }
    if (!live) break;
    for (int s = 0; s < kWideChunk; ++s) {
      int node[2];
      bool ivalid[2];
      for (int p = 0; p < 2; ++p) {
        // a row whose leaf stack could overflow pops no node this step
        ivalid[p] = isp[p] > 0 && lsp[p] <= kWideLeafStack - 8;
        const int itop = max(isp[p] - 1, 0);
        const int ichild = (isp[p] > 0 && itop < kWideStack)
                               ? s_istack[p][row][itop] : 0;
        const bool lvalid = lsp[p] > 0;
        const int ltop = max(lsp[p] - 1, 0);
        const int lchild = lvalid ? s_lstack[p][row][ltop] : 0;
        node[p] = ivalid[p] ? min(ichild, n_nodes - 1) : n_nodes - 1;
        const int leaf = lvalid ? min(lchild, n_leaves - 1) : n_leaves - 1;
        wide_leaf(leaves + 48L * leaf, ray[p], tmin);
        vote_or(wide_votes(nodes + 48L * node[p], ray[p], tmin, any_hit),
                &s_vote[buf][p][row]);
        isp[p] -= ivalid[p] ? 1 : 0;
        lsp[p] -= lvalid ? 1 : 0;
      }
      __syncthreads();  // votes in; every thread has read the tops
      for (int p = 0; p < 2; ++p) {
        const unsigned hm = ivalid[p] ? s_vote[buf][p][row] : 0u;
        const int2 mm = __ldg(meta + min(node[p], n_meta - 1));
        const int hi = static_cast<int>(hm) & mm.x & 255;
        const int hl = static_cast<int>(hm) & mm.y & 255;
        if (lane < 8) {
          // thread c of the row pushes child slot c of each kind
          const int bit = 1 << lane, below = bit - 1;
          if (hi & bit) {
            const int pos = isp[p] + __popc(hi & below);
            if (pos < kWideStack) {
              s_istack[p][row][pos] = (mm.x >> 8) + __popc(mm.x & 255 & below);
            }
          }
          if (hl & bit) {
            const int pos = lsp[p] + __popc(hl & below);
            s_lstack[p][row][pos] = (mm.y >> 8) + __popc(mm.y & 255 & below);
            if (pos >= kWideStack) atomicAdd(deep_pushes, 1);
          }
        }
        if (lane == 0) s_vote[buf ^ 1][p][row] = 0u;
        isp[p] += __popc(hi);
        lsp[p] += __popc(hl);
      }
      __syncthreads();  // stacks written before the next step's pops
      buf ^= 1;
    }
  }
  for (int p = 0; p < 2; ++p) {
    wide_store(ray[p], base + p * kWidePacket, R, t_out, tri_out, u_out,
               v_out);
  }
}

}  // namespace

// inner: (n_internal, 16) f32 records, leaves: (n_internal + 1, 12) f32
// rows, both 16-byte aligned (pack_bvh's check holds the tree's depth
// below 64); width: the columns of an image query, whose rays the kernel
// traces in 8x4 tiles, or 0 for rays in any order
HR_EXPORT int hr_trace_any(const void* inner, const void* leaves,
                           int n_internal, const void* o, const void* d,
                           const void* tmax, const void* active, float tmin,
                           int R, int width, void* out, void* stream) {
  if (R > 0) {
    trace_any_kernel<<<ceil_div(trace_threads(R, width), kTraceBlock),
                       kTraceBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(inner), static_cast<const float4*>(leaves),
        n_internal, static_cast<const float*>(o),
        static_cast<const float*>(d), static_cast<const float*>(tmax),
        static_cast<const uint8_t*>(active), tmin, R, width,
        static_cast<int*>(out));
  }
  HR_RETURN_LAUNCH_STATUS();
}

HR_EXPORT int hr_trace_closest(const void* inner, const void* leaves,
                               int n_internal, const void* o, const void* d,
                               const void* tmax, const void* active,
                               float tmin, int R, int width, void* t_out,
                               void* tri_out, void* u_out, void* v_out,
                               void* stream) {
  if (R > 0) {
    trace_closest_kernel<<<ceil_div(trace_threads(R, width), kTraceBlock),
                           kTraceBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(inner), static_cast<const float4*>(leaves),
        n_internal, static_cast<const float*>(o),
        static_cast<const float*>(d), static_cast<const float*>(tmax),
        static_cast<const uint8_t*>(active), tmin, R, width,
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

// K2w / K2m: meta is (n_meta, 2) i32; n_nodes and n_leaves are the record
// rows; any_hit 0 or 1; deep_pushes a device int the kernel adds to
#define HR_WIDE_ENTRY(NAME, KERNEL)                                          \
  HR_EXPORT int NAME(const void* nodes, const void* leaves, const void* meta, \
                     int n_nodes, int n_leaves, int n_meta, const void* o,    \
                     const void* d, const void* tmax, const void* active,     \
                     float tmin, int R, int any_hit, void* t_out,             \
                     void* tri_out, void* u_out, void* v_out,                 \
                     void* deep_pushes, void* stream) {                      \
    if (R > 0) {                                                             \
      const int programs = (R + 2 * kWidePacket - 1) / (2 * kWidePacket);    \
      KERNEL<<<programs, kWidePacket, 0,                                     \
               static_cast<cudaStream_t>(stream)>>>(                         \
          static_cast<const float*>(nodes),                                  \
          static_cast<const float*>(leaves),                                 \
          static_cast<const int2*>(meta), n_nodes, n_leaves, n_meta,         \
          static_cast<const float*>(o), static_cast<const float*>(d),        \
          static_cast<const float*>(tmax),                                   \
          static_cast<const uint8_t*>(active), tmin, R, any_hit,             \
          static_cast<float*>(t_out), static_cast<int*>(tri_out),            \
          static_cast<float*>(u_out), static_cast<float*>(v_out),            \
          static_cast<int*>(deep_pushes));                                   \
    }                                                                        \
    HR_RETURN_LAUNCH_STATUS();                                               \
  }

HR_WIDE_ENTRY(hr_trace_wide, trace_wide_kernel)
HR_WIDE_ENTRY(hr_trace_mimt, trace_mimt_kernel)
