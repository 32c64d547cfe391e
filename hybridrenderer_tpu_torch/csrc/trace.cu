// K2 and K2c: ray / BVH traversal, any-hit (shadow, AO and shading
// occlusion rays) and closest-hit (reflection and GI radiance rays).
// K2b (trace_packet): the same queries as packet traversal over the same
// records, one warp per packet of 32 rays (an image query's 8x4 pixel
// tile). K2w (trace_wide) and K2m (trace_mimt), at the end of the file:
// packet traversals of the 8-wide BVH (ops/bvh_wide.py).
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

// ---------------------------------------------------------------------------
// K2b: packet traversal.
//
// Replaces hybridrenderer_tpu/ops/trace_pallas.py _traverse_kernel (:132,
// entry intersect_packed :338), the binary-BVH packet traversal of
// trace_backend="pallas". The TPU kernel's packet is 8x128 rays sharing
// one scalar stack of 96 entries; here a packet is one warp of 32 rays
// sharing one stack of 96 entries: 32 consecutive rays, or for an image
// query (``width`` > 0) the 8x4 pixel tile ray_of_thread gives the warp,
// row-major inside the tile (ragged edge tiles leave lanes dead). Same
// rules:
// * the warp visits one node at a time;
// * at an internal node each live lane slab-tests both child boxes
//   against its own best t (any-hit: only lanes without a hit yet); a
//   child is taken if any lane hits it; near and far come
//   from the warp's sums of entry distances over the lanes that hit each
//   box (trace_pallas.py:281-290), summed in the xor-butterfly order the
//   plain version repeats;
// * at a leaf each live lane runs K2's Moller-Trumbore with the
//   t <= best replacement (:244), in any-hit mode too;
// * any-hit: the warp stops once every live lane has a hit;
// * tmax is clamped to 1e6 (:359-360). Inactive rays do no work, take
//   no part in the warp's votes and report a miss (the TPU kernel has
//   no active mask: inactive rays there get tmax 0).
//
// Design for the card: K2's records (ops/trace_cuda.pack_bvh), one 64 B
// record an internal step, read as four float4 broadcasts that carry
// both child boxes and both references, and a leaf's 48 B row reached
// straight from its reference (no node_tri indirection). The near child
// stays in a register: both children taken, push the far one and go on
// with the near one; one taken, go on with it; none, pop. That is the
// plain version's "push far, push near, pop" exactly, so the warp visits
// the plain version's nodes in its order. One __reduce_or_sync carries
// both votes; the near/far sums run only where both children are taken,
// and the any-hit test only after a leaf, the one step that changes it.
// The warp-uniform stack lives in registers across the lanes: entry k in
// lane k % 32, slot k / 32, three slots for 96 entries; a push is one
// predicated move in one lane, a pop one __shfl_sync, with no shared
// memory and no __syncwarp. A tree of depth D needs D entries (pack_bvh
// holds it to D + 1 <= 96, the plain version's need). Blocks of 128
// threads: a shared-memory stack, blocks of 256, launch bounds that force
// 16 blocks an SM (spills) and loading both children's records before the
// votes settle all ran slower on the 1080p ray-traced frame (PERF.md).
// Bound on the card: instruction issue, ~80 SASS instructions an internal
// step that takes one child, ~120 one that takes both (the sums' ten
// shuffles), ~100 a leaf (the triangle test's IEEE division), over every
// step of every packet; the lanes of an 8x4 tile agree on most boxes, but
// a packet still visits the union of its rays' nodes.
constexpr int kPacketStack = 96;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPacketBlock = 128;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// The warp's stack of references in registers across its lanes: entry k
// is slot k / 32 of lane k % 32. sp is the same in every lane.
struct PacketStack {
  int s0 = 0, s1 = 0, s2 = 0;
  int sp = 0;
  __device__ __forceinline__ void push(int lane, int ref) {
    if (lane == (sp & (kWarp - 1))) {
      const int slot = sp >> 5;
      if (slot == 0) {
        s0 = ref;
      } else if (slot == 1) {
        s1 = ref;
      } else {
        s2 = ref;
      }
    }
    ++sp;
  }
  __device__ __forceinline__ int pop() {
    --sp;
    const int slot = sp >> 5;
    const int mine = slot == 0 ? s0 : (slot == 1 ? s1 : s2);
    return __shfl_sync(kFull, mine, sp & (kWarp - 1));
  }
};

__global__ void __launch_bounds__(kPacketBlock)
trace_packet_kernel(const float4* __restrict__ inner,
                    const float4* __restrict__ leaves, int n_internal,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmax_in,
                    const uint8_t* __restrict__ active_in, float tmin, int R,
                    int width, int any_hit, float* __restrict__ t_out,
                    int* __restrict__ tri_out, float* __restrict__ u_out,
                    float* __restrict__ v_out) {
  const int lane = threadIdx.x % kWarp;
  const int i = ray_of_thread(R, width);
  const bool active = i >= 0 && active_in[i];

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

  PacketStack stack;
  // the root: internal node 0, or for one triangle leaf 0
  int ref = n_internal > 0 ? 0 : ~0;
  if (__any_sync(kFull, active)) {
    for (;;) {
      if (ref >= 0) {
        const float4* rec = inner + 4 * static_cast<size_t>(ref);
        const float4 lmin = rec[0], lmax = rec[1], rmin = rec[2],
                     rmax = rec[3];
        const int left = __float_as_int(lmin.w);
        const int right = __float_as_int(rmin.w);
        const bool live = active && !(any_hit && best_tri >= 0);
        float lt = 0.0f, rt = 0.0f;
        const bool lhit =
            live && box_hit(lmin, lmax, org, inv_d, tmin, best_t, &lt);
        const bool rhit =
            live && box_hit(rmin, rmax, org, inv_d, tmin, best_t, &rt);
        // bit 0: some lane hits the left box, bit 1: the right one
        const unsigned votes =
            __reduce_or_sync(kFull, (lhit ? 1u : 0u) | (rhit ? 2u : 0u));
        if (votes != 0u) {
          bool go_left = votes == 1u;
          if (votes == 3u) {
            // both: the near one is next, the far one waits on the stack
            const float l_sum = warp_sum(lhit ? lt : 0.0f);
            const float r_sum = warp_sum(rhit ? rt : 0.0f);
            go_left = l_sum <= r_sum;
            stack.push(lane, go_left ? right : left);
          }
          ref = go_left ? left : right;
          continue;
        }
      } else {
        const float4* row = leaves + 3 * static_cast<size_t>(~ref);
        const float4 a = row[0], e1 = row[1], e2 = row[2];
        const int tri = __float_as_int(a.w);
        float t, u, v;
        if (tri >= 0 && active &&
            tri_hit_edges(xyz(a), xyz(e1), xyz(e2), org, dir, tmin, best_t,
                          &t, &u, &v)) {
          best_tri = tri;
          best_t = t;
          best_u = u;
          best_v = v;
        }
        // only a leaf gives a ray its hit: any-hit, the warp is done
        // once every active lane has one
        if (any_hit && __all_sync(kFull, !active || best_tri >= 0)) break;
      }
      if (stack.sp == 0) break;
      ref = stack.pop();
    }
  }
  if (i < 0) return;
  t_out[i] = best_tri < 0 ? __int_as_float(0x7f800000) : best_t;
  tri_out[i] = best_tri;
  u_out[i] = best_u;
  v_out[i] = best_v;
}


// ---------------------------------------------------------------------------
// K2w and K2m: packet traversals of the 8-wide BVH (ops/bvh_wide.py: flat
// records, node rows of 8 child boxes (48 floats), leaf rows of L
// triangles as v0, e1, e2, id (12 L floats; L = 4, 8 or 16 for K2w, one
// instantiation each, and 4 for K2m, as the reference packs its p8
// layout only for those); meta (ibase*256 | imask, lbase*256 | lmask)
// per node).
//
// Replace hybridrenderer_tpu/ops/trace_pallas.py _wide_traverse_kernel
// (:457, entry intersect_wide :746) and _mimt_traverse_kernel (:1518,
// entry intersect_mimt :1757). Same contract: a packet is 1024
// consecutive rays and a program, here one block, runs two packets;
// inactive rays (and the padding past R: o = 0, d = 1) carry tmax -1 and
// start with the sentinel id INACTIVE_TRI, so they never hit and count
// as done for any-hit; tmax is clamped to 1e6. Each step pops one
// internal node and one leaf cluster (per packet, or per 128-ray row for
// K2m), runs the L Moller-Trumbore tests of the cluster (a hit with t <=
// the best so far replaces it, in any-hit mode too) and then the 8 slab
// tests of the node against each ray's best t (any-hit rays with a hit
// test against -inf), ORs the hits of the packet's (row's) rays per
// child slot and pushes the hit children of each kind, masked by the
// meta masks (empty slots' inverted boxes pass every slab test). The
// block tests liveness every 16 steps and runs while either packet has
// stack entries and, any-hit, a ray without a hit: a finished packet
// keeps popping beside its live sibling, as the reference's chunked loop
// does, so the kernels report the reference's triangles, any-hit
// included.
// * K2w: one stack per kind per packet of compressed entries
//   (node << 8 | pending child mask); a pop takes the lowest pending
//   slot; the entry leaves the stack with its last bit.
// * K2m: each row has its own stacks of direct ids; a row pushes its
//   hit children at sp + popcount(hits below), id base + popcount(mask
//   below), and pops the last pushed first.
// Internal stacks hold 128 entries (the TPU kernels' 128 register
// lanes), enough for any tree ops/trace_cuda.check_wide_stacks accepts.
// Leaf stacks hold 512: the TPU kernels drop leaf pushes past 128 and
// miss their triangles (a packet's leaf stack reaches ~150 on the stress
// scene); here a packet (row) whose leaf stack could overflow pops no
// internal node that step, only a leaf, so the visiting order is the
// reference's wherever the reference drops nothing and no push is ever
// dropped. Leaf pushes past 128 are counted in *deep_pushes. Arithmetic
// in the order of the plain versions (ops/trace_cuda.py); -fmad=false
// makes the card check exact.
//
// Design for the card:
// * No test that cannot change a result, skipped a warp at a time: a
//   packet (row) with nothing to pop of a kind runs no tests of that
//   kind (its vote is dropped, the dummy leaf has ids -1); a warp whose
//   rays are all any-hit rays with a hit runs no slab tests (against
//   -inf only an empty slot's box can pass, and the meta masks drop
//   those); a warp whose rays all have t < tmin (inactive rays) runs no
//   triangle tests. A packet (row) with both stacks empty is done for
//   good and waits for the next liveness test. Closest-hit inactive rays
//   keep their slab tests: their bound is -1, which a box around the
//   origin passes.
// * 4 rays a thread, so that each record load serves them all: records
//   are read as float4 broadcasts, 12 for a node and 3 L for a leaf.
// * K2w: a packet runs on its own half of the block (8 warps) behind a
//   named barrier, one a step; each thread keeps the tops of its
//   packet's stacks, with the meta word their decode needs, in
//   registers, so only an entry that leaves the stack sends the threads
//   to shared memory for the one below, and one thread writes an entry
//   only when a push covers it. The votes rotate through three words per
//   packet, each cleared two steps before it is used again.
// * K2m: a row is one warp; its steps need only __syncwarp, and the
//   block meets only at the liveness test.
// Bound on the card (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): the issue
// of the tests that remain, at one block of 16 warps an SM (120-123
// registers, no spills), and the warps that wait: a program runs the
// steps of its longest packet (row), rounded up to 16, and a packet
// (row) done early leaves its warps idle until then. On the four 1080p
// wide queries of chip_smoke.py, the contract's own tests (every pop
// tested against every ray of its packet or row) are ~67 GFLOP for K2w
// and ~28 for K2m, 1.0 and 0.4 ms at the fp32 peak; most program steps
// pop nothing of a kind (54% of K2w's packet steps no node, 61% of
// K2m's row steps). Larger clusters (bvh_leaf_tris 8 or 16) cut the
// leaf pops and add the tests of their padded slots; the instantiations'
// registers and shared memory are the same design's, reported by
// chip_smoke.py phase 3.
constexpr int kWidePacket = 1024;
constexpr int kWideChunk = 16;
constexpr int kWideMaxSteps = 1 << 16;
constexpr int kWideStack = 128;
constexpr int kWideLeafStack = 512;
constexpr int kWideRows = 8;
constexpr int kRowRays = kWidePacket / kWideRows;
constexpr int kInactiveTri = 1 << 29;
// both kernels: 4 rays a thread, a program on a block of 512 threads;
// K2w's packets on its two halves, K2m's rows a warp each
constexpr int kWideRays = 4;
constexpr int kWideThreads = 2 * kWidePacket / kWideRays;
constexpr int kWideHalf = kWideThreads / 2;
constexpr int kMimtWarps = kWideThreads / kWarp;
static_assert(kRowRays == kWarp * kWideRays, "K2m walks a row a warp");

// a ray's state but its (u, v), which only a hit writes
struct WideRay {
  V3 o, d, inv;
  float t;
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
  r.tri = tm < 0.0f ? kInactiveTri : -1;
  return r;
}

__device__ __forceinline__ void wide_store(const WideRay& r, float u,
                                           float v, long i, int R,
                                           float* __restrict__ t_out,
                                           int* __restrict__ tri_out,
                                           float* __restrict__ u_out,
                                           float* __restrict__ v_out) {
  if (i >= R) return;
  t_out[i] = r.tri < 0 ? __int_as_float(0x7f800000) : r.t;
  tri_out[i] = r.tri;
  u_out[i] = u;
  v_out[i] = v;
}

// whether a warp's leaf tests can change a ray of it: some ray has
// t >= tmin (a hit needs tmin <= t' <= t)
template <int N>
__device__ __forceinline__ bool warp_can_hit(const WideRay (&r)[N],
                                             float tmin) {
  bool any = false;
#pragma unroll
  for (int n = 0; n < N; ++n) any = any || r[n].t >= tmin;
  return __any_sync(kFull, any);
}

// whether a warp's slab tests can vote for a real slot: closest-hit, or
// some ray without a hit
template <int N>
__device__ __forceinline__ bool warp_can_vote(const WideRay (&r)[N],
                                              bool any_hit) {
  bool any = !any_hit;
#pragma unroll
  for (int n = 0; n < N; ++n) any = any || r[n].tri < 0;
  return __any_sync(kFull, any);
}

// the kLeafTris triangles of leaf record `rec` (3 kLeafTris float4:
// triangle k is v0, e1, e2, id, 0, 0 at float4 3k..3k+2) against each of
// the N rays, whose (u, v) are u[n], v[n]; the loop over the triangles
// unrolled kUnroll times
template <int kLeafTris, int kUnroll, int N>
__device__ __forceinline__ void wide_leaf(const float4* __restrict__ rec,
                                          WideRay (&r)[N], float (&u)[N],
                                          float (&v)[N], float tmin) {
#pragma unroll kUnroll
  for (int k = 0; k < kLeafTris; ++k) {
    const float4 a = __ldg(rec + 3 * k), b = __ldg(rec + 3 * k + 1),
                 c = __ldg(rec + 3 * k + 2);
    const float p0x = a.x, p0y = a.y, p0z = a.z;
    const float a1x = a.w, a1y = b.x, a1z = b.y;
    const float a2x = b.z, a2y = b.w, a2z = c.x;
    const float tid = c.y;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      WideRay& q = r[n];
      const float pvx = q.d.y * a2z - q.d.z * a2y;
      const float pvy = q.d.z * a2x - q.d.x * a2z;
      const float pvz = q.d.x * a2y - q.d.y * a2x;
      const float det = a1x * pvx + a1y * pvy + a1z * pvz;
      const float inv_det = 1.0f / (fabsf(det) < kTriEps ? kTriEps : det);
      const float tvx = q.o.x - p0x;
      const float tvy = q.o.y - p0y;
      const float tvz = q.o.z - p0z;
      const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      const float qvx = tvy * a1z - tvz * a1y;
      const float qvy = tvz * a1x - tvx * a1z;
      const float qvz = tvx * a1y - tvy * a1x;
      const float vv = (q.d.x * qvx + q.d.y * qvy + q.d.z * qvz) * inv_det;
      const float tt = (a2x * qvx + a2y * qvy + a2z * qvz) * inv_det;
      if (fabsf(det) >= kTriEps && uu >= 0.0f && vv >= 0.0f &&
          uu + vv <= 1.0f && tt >= tmin && tt <= q.t && tid >= 0.0f) {
        q.t = tt;
        q.tri = static_cast<int>(tid);
        u[n] = uu;
        v[n] = vv;
      }
    }
  }
}

// one slab test of box (lo, hi) against ray q and bound tb
__device__ __forceinline__ bool wide_slab(float lx, float ly, float lz,
                                          float hx, float hy, float hz,
                                          const WideRay& q, float tmin,
                                          float tb) {
  const float t0x = (lx - q.o.x) * q.inv.x;
  const float t1x = (hx - q.o.x) * q.inv.x;
  const float t0y = (ly - q.o.y) * q.inv.y;
  const float t1y = (hy - q.o.y) * q.inv.y;
  const float t0z = (lz - q.o.z) * q.inv.z;
  const float t1z = (hz - q.o.z) * q.inv.z;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  return tn <= tf && tf >= tmin && tn <= tb;
}

// the mask of the 8 child boxes of node record `rec` (12 float4: the
// boxes of children 2k and 2k+1 at float4 3k..3k+2) that any of the N
// rays hits
template <int N>
__device__ __forceinline__ unsigned wide_votes(const float4* __restrict__ rec,
                                               const WideRay (&r)[N],
                                               float tmin, bool any_hit) {
  float tb[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    tb[n] = (any_hit && r[n].tri >= 0) ? -__int_as_float(0x7f800000)
                                       : r[n].t;
  }
  unsigned hm = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 a = __ldg(rec + 3 * k), b = __ldg(rec + 3 * k + 1),
                 c = __ldg(rec + 3 * k + 2);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (wide_slab(a.x, a.y, a.z, a.w, b.x, b.y, r[n], tmin, tb[n])) {
        hm |= 1u << (2 * k);
      }
      if (wide_slab(b.z, b.w, c.x, c.y, c.z, c.w, r[n], tmin, tb[n])) {
        hm |= 2u << (2 * k);
      }
    }
  }
  return hm;
}

// K2w's pop: entry (parent << 8 | pending mask), with m the parent's
// meta word of the stack's kind → the id of the lowest pending child;
// *rem gets the mask without that bit
__device__ __forceinline__ int wide_decode(int e, int m, int* rem) {
  const int bits = e & 255;
  const int below = (bits & -bits) - 1;
  *rem = bits & (bits - 1);
  return (m >> 8) + __popc((m & 255) & below);
}

// a named barrier over the `count` threads that use barrier `id`
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// One of K2w's compressed stacks as its packet's threads see it: the top
// entry and its meta word in registers (every thread of the packet
// holds the same), the entries below it in shared memory.
struct WideStack {
  int sp, e, m;

  // after a pop that took `child` from the top and left it `rem`
  // (`popped`), and a push of `pushed` (entry, meta) if `push`: the new
  // top. `lead` writes shared memory: the top when a push covers it, the
  // pushed entry; the others read the entry below when the top leaves.
  // Entries past `cap` are dropped on push and read as (0, *m0), the
  // super-root's meta word, as the plain version's stack reads them.
  __device__ __forceinline__ void update(int2* __restrict__ s, int cap,
                                         bool popped, int rem, bool push,
                                         int2 pushed,
                                         const int* __restrict__ m0,
                                         bool lead) {
    if (popped) {
      if (rem) {
        e = ((e >> 8) << 8) | rem;
      } else {
        --sp;
      }
    }
    if (push) {
      if (lead) {
        if (popped && rem && sp - 1 < cap) s[sp - 1] = make_int2(e, m);
        if (sp < cap) s[sp] = pushed;
      }
      const bool kept = sp < cap;
      e = kept ? pushed.x : 0;
      m = kept ? pushed.y : __ldg(m0);
      ++sp;
    } else if (popped && !rem && sp > 0) {
      const int2 below =
          sp - 1 < cap ? s[sp - 1] : make_int2(0, __ldg(m0));
      e = below.x;
      m = below.y;
    }
  }
};

// kLeafTris: the triangles of a leaf cluster, 4, 8 or 16
template <int kLeafTris>
__global__ void __launch_bounds__(kWideThreads)
trace_wide_kernel(const float4* __restrict__ nodes,
                  const float4* __restrict__ leaves,
                  const int2* __restrict__ meta, int n_nodes, int n_leaves,
                  int n_meta, const float* __restrict__ o,
                  const float* __restrict__ d,
                  const float* __restrict__ tmax,
                  const uint8_t* __restrict__ active, float tmin, int R,
                  int any_hit, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ u_out,
                  float* __restrict__ v_out, int* __restrict__ deep_pushes) {
  constexpr int N = kWideRays;
  __shared__ int2 s_istack[2][kWideStack];
  __shared__ int2 s_lstack[2][kWideLeafStack];
  __shared__ unsigned s_vote[2][3];  // [packet][step % 3]
  // the rays' (u, v), in shared memory: registers are the scarce resource
  __shared__ float s_u[kWideThreads][N], s_v[kWideThreads][N];
  // packet p on threads [p * kWideHalf, (p + 1) * kWideHalf), thread j
  // holding its rays N j .. N j + N - 1
  const int p = threadIdx.x / kWideHalf, j = threadIdx.x % kWideHalf;
  const bool lead = j == 0;
  const long first = (2L * blockIdx.x + p) * kWidePacket + N * j;
  WideRay ray[N];
  float(&u)[N] = s_u[threadIdx.x];
  float(&v)[N] = s_v[threadIdx.x];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    ray[n] = wide_ray(o, d, tmax, active, first + n, R);
    u[n] = 0.0f;
    v[n] = 0.0f;
  }
  if (threadIdx.x < 6) s_vote[threadIdx.x / 3][threadIdx.x % 3] = 0u;
  // the super-root's meta words
  const int* m0 = reinterpret_cast<const int*>(meta);
  // the bootstrap entry (super-root 0, mask 1) decodes to the root
  WideStack is{1, 1, __ldg(m0)}, ls{0, 0, 0};
  int buf = 0;
  __syncthreads();
  for (int steps = 0; steps < kWideMaxSteps; steps += kWideChunk) {
    bool done = true;
#pragma unroll
    for (int n = 0; n < N; ++n) done = done && ray[n].tri >= 0;
    // the packet's stack state is the same in all its threads
    if (!__syncthreads_or((is.sp > 0 || ls.sp > 0) && !(any_hit && done))) {
      break;
    }
    for (int s = 0; s < kWideChunk; ++s) {
      // a packet whose leaf stack is full pops no node this step
      const bool ivalid = is.sp > 0 && ls.sp < kWideLeafStack;
      const bool lvalid = ls.sp > 0;
      if (!ivalid && !lvalid) break;  // both stacks empty: done for good
      int irem = 0, lrem = 0;
      const int ichild = ivalid ? wide_decode(is.e, is.m, &irem) : 0;
      const int lchild = lvalid ? wide_decode(ls.e, ls.m, &lrem) : 0;
      const int node = ivalid ? min(ichild, n_nodes - 1) : 0;
      const int2 mm =
          ivalid ? __ldg(meta + min(node, n_meta - 1)) : make_int2(0, 0);
      if (lvalid && warp_can_hit(ray, tmin)) {
        wide_leaf<kLeafTris, 4>(
            leaves + 3L * kLeafTris * min(lchild, n_leaves - 1), ray, u, v,
            tmin);
      }
      if (ivalid && warp_can_vote(ray, any_hit)) {
        const unsigned hits = __reduce_or_sync(
            kFull, wide_votes(nodes + 12L * node, ray, tmin, any_hit));
        if ((threadIdx.x & (kWarp - 1)) == 0 && hits) {
          atomicOr(&s_vote[p][buf], hits);
        }
      }
      named_sync(1 + p, kWideHalf);  // votes in
      const unsigned hm = ivalid ? s_vote[p][buf] : 0u;
      if (lead) s_vote[p][buf == 0 ? 2 : buf - 1] = 0u;  // used at step + 2
      buf = buf == 2 ? 0 : buf + 1;
      const int hi = static_cast<int>(hm) & mm.x & 255;
      const int hl = static_cast<int>(hm) & mm.y & 255;
      // the leaf push goes to the slot above the popped stack
      const int lpos = ls.sp - (lvalid && !lrem ? 1 : 0);
      if (lead && hl && lpos >= kWideStack) atomicAdd(deep_pushes, 1);
      is.update(s_istack[p], kWideStack, ivalid, irem, hi != 0,
                make_int2((node << 8) | hi, mm.x), m0, lead);
      ls.update(s_lstack[p], kWideLeafStack, lvalid, lrem, hl != 0,
                make_int2((node << 8) | hl, mm.y), m0 + 1, lead);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    wide_store(ray[n], u[n], v[n], first + n, R, t_out, tri_out, u_out,
               v_out);
  }
}

__global__ void __launch_bounds__(kWideThreads)
trace_mimt_kernel(const float4* __restrict__ nodes,
                  const float4* __restrict__ leaves,
                  const int2* __restrict__ meta, int n_nodes, int n_leaves,
                  int n_meta, const float* __restrict__ o,
                  const float* __restrict__ d,
                  const float* __restrict__ tmax,
                  const uint8_t* __restrict__ active, float tmin, int R,
                  int any_hit, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ u_out,
                  float* __restrict__ v_out, int* __restrict__ deep_pushes) {
  constexpr int N = kWideRays;
  __shared__ int s_istack[kMimtWarps][kWideStack];
  __shared__ int s_lstack[kMimtWarps][kWideLeafStack];
  // each row's liveness at the last two tests: bit 0 stack entries, bit
  // 1 a ray without a hit
  __shared__ unsigned s_live[2][kMimtWarps];
  // warp w walks row w % 8 of packet w / 8, lane l holding its rays
  // N l .. N l + N - 1
  const int w = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long first = blockIdx.x * 2L * kWidePacket + w * kRowRays + N * lane;
  WideRay ray[N];
  float u[N], v[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    ray[n] = wide_ray(o, d, tmax, active, first + n, R);
    u[n] = 0.0f;
    v[n] = 0.0f;
  }
  int* istack = s_istack[w];
  int* lstack = s_lstack[w];
  // every row starts on the super-root's id 0
  int isp = 1, lsp = 0;
  if (lane == 0) istack[0] = 0;
  __syncwarp();
  for (int steps = 0, test = 0; steps < kWideMaxSteps;
       steps += kWideChunk, test ^= 1) {
    bool open = false;
#pragma unroll
    for (int n = 0; n < N; ++n) open = open || ray[n].tri < 0;
    open = __any_sync(kFull, open);
    if (lane == 0) s_live[test][w] = (isp > 0 || lsp > 0) | (open << 1);
    __syncthreads();
    unsigned f[2] = {0u, 0u};
#pragma unroll
    for (int x = 0; x < kMimtWarps; ++x) f[x / kWideRows] |= s_live[test][x];
    bool live = false;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      live = live || ((f[q] & 1u) && (!any_hit || (f[q] & 2u)));
    }
    if (!live) break;
    for (int s = 0; s < kWideChunk; ++s) {
      // a row whose leaf stack could overflow pops no node this step
      const bool ivalid = isp > 0 && lsp <= kWideLeafStack - 8;
      const bool lvalid = lsp > 0;
      if (!ivalid && !lvalid) break;  // both stacks empty: done for good
      const int ichild =
          (ivalid && isp - 1 < kWideStack) ? istack[isp - 1] : 0;
      const int lchild = lvalid ? lstack[lsp - 1] : 0;
      isp -= ivalid ? 1 : 0;
      lsp -= lvalid ? 1 : 0;
      const int node = min(ichild, n_nodes - 1);
      const int2 mm =
          ivalid ? __ldg(meta + min(node, n_meta - 1)) : make_int2(0, 0);
      if (lvalid && warp_can_hit(ray, tmin)) {
        // one triangle at a time (3% faster than all four at once)
        wide_leaf<4, 1>(leaves + 12L * min(lchild, n_leaves - 1), ray, u, v,
                        tmin);
      }
      unsigned hm = 0u;
      if (ivalid && warp_can_vote(ray, any_hit)) {
        hm = __reduce_or_sync(
            kFull, wide_votes(nodes + 12L * node, ray, tmin, any_hit));
      }
      const int hi = static_cast<int>(hm) & mm.x & 255;
      const int hl = static_cast<int>(hm) & mm.y & 255;
      __syncwarp();  // every lane has read the tops
      if (lane < 8) {
        // lane c pushes child slot c of each kind
        const int bit = 1 << lane, below = bit - 1;
        if (hi & bit) {
          const int pos = isp + __popc(hi & below);
          if (pos < kWideStack) {
            istack[pos] = (mm.x >> 8) + __popc(mm.x & 255 & below);
          }
        }
        if (hl & bit) {
          const int pos = lsp + __popc(hl & below);
          lstack[pos] = (mm.y >> 8) + __popc(mm.y & 255 & below);
          if (pos >= kWideStack) atomicAdd(deep_pushes, 1);
        }
      }
      __syncwarp();  // pushes in before the next pops
      isp += __popc(hi);
      lsp += __popc(hl);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    wide_store(ray[n], u[n], v[n], first + n, R, t_out, tri_out, u_out,
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

// K2b over K2's records; width as for K2; any_hit 0 or 1, for any-hit the
// caller may ignore t, u and v
HR_EXPORT int hr_trace_packet(const void* inner, const void* leaves,
                              int n_internal, const void* o, const void* d,
                              const void* tmax, const void* active,
                              float tmin, int R, int width, int any_hit,
                              void* t_out, void* tri_out, void* u_out,
                              void* v_out, void* stream) {
  if (R > 0) {
    trace_packet_kernel<<<ceil_div(trace_threads(R, width), kPacketBlock),
                          kPacketBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(inner), static_cast<const float4*>(leaves),
        n_internal, static_cast<const float*>(o),
        static_cast<const float*>(d), static_cast<const float*>(tmax),
        static_cast<const uint8_t*>(active), tmin, R, width, any_hit,
        static_cast<float*>(t_out), static_cast<int*>(tri_out),
        static_cast<float*>(u_out), static_cast<float*>(v_out));
  }
  HR_RETURN_LAUNCH_STATUS();
}

// K2w / K2m: meta is (n_meta, 2) i32; nodes and leaves (n_nodes, 48) and
// (n_leaves, 12 leaf_tris) f32, 16-byte aligned; leaf_tris 4, 8 or 16
// (K2m: 4); any_hit 0 or 1; deep_pushes a device int the kernel adds to
#define HR_WIDE_ENTRY(NAME, KERNEL_OF)                                       \
  HR_EXPORT int NAME(const void* nodes, const void* leaves, int leaf_tris,   \
                     const void* meta, int n_nodes, int n_leaves, int n_meta, \
                     const void* o, const void* d, const void* tmax,          \
                     const void* active, float tmin, int R, int any_hit,      \
                     void* t_out, void* tri_out, void* u_out, void* v_out,    \
                     void* deep_pushes, void* stream) {                      \
    const auto kernel = KERNEL_OF(leaf_tris);                                \
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);   \
    if (R > 0) {                                                             \
      const int programs = (R + 2 * kWidePacket - 1) / (2 * kWidePacket);    \
      kernel<<<programs, kWideThreads, 0,                                    \
               static_cast<cudaStream_t>(stream)>>>(                         \
          static_cast<const float4*>(nodes),                                 \
          static_cast<const float4*>(leaves),                                \
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

namespace {

using WideKernel = void (*)(const float4*, const float4*, const int2*, int,
                            int, int, const float*, const float*,
                            const float*, const uint8_t*, float, int, int,
                            float*, int*, float*, float*, int*);

// K2w's instantiation for `leaf_tris`-triangle clusters, or null
WideKernel wide_kernel_of(int leaf_tris) {
  switch (leaf_tris) {
    case 4:
      return trace_wide_kernel<4>;
    case 8:
      return trace_wide_kernel<8>;
    case 16:
      return trace_wide_kernel<16>;
    default:
      return nullptr;
  }
}

WideKernel mimt_kernel_of(int leaf_tris) {
  return leaf_tris == 4 ? &trace_mimt_kernel : nullptr;
}

}  // namespace

HR_WIDE_ENTRY(hr_trace_wide, wide_kernel_of)
HR_WIDE_ENTRY(hr_trace_mimt, mimt_kernel_of)

// K2w over 4-triangle clusters (which 0), K2m (1), K2b (2), K2w over 8-
// (3) or 16-triangle clusters (4) as built: registers a thread, local
// memory bytes a thread (stack frame and spills), static shared memory
// bytes, threads a block and the blocks an SM holds → out[0..4] (host
// ints)
HR_EXPORT int hr_trace_info(int which, void* out) {
  const void* f = which == 2
                      ? reinterpret_cast<const void*>(trace_packet_kernel)
                  : which == 1
                      ? reinterpret_cast<const void*>(trace_mimt_kernel)
                      : reinterpret_cast<const void*>(wide_kernel_of(
                            which == 3 ? 8 : which == 4 ? 16 : 4));
  const int threads = which == 2 ? kPacketBlock : kWideThreads;
  cudaFuncAttributes a{};
  int blocks = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, threads,
                                                      0);
  }
  int* v = static_cast<int*>(out);
  v[0] = a.numRegs;
  v[1] = static_cast<int>(a.localSizeBytes);
  v[2] = static_cast<int>(a.sharedSizeBytes);
  v[3] = threads;
  v[4] = blocks;
  return static_cast<int>(e);
}
