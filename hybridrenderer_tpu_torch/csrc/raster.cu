// K1 and K1v: binned tile rasterizers.
//
// K1 (raster_tiles) replaces hybridrenderer_tpu/ops/raster_pallas.py
// _raster_kernel_t (:784, with _tile_body :842). Same contract: for every
// pixel the covering candidate of largest reversed-Z depth wins; the
// kernel writes its depth, triangle id, perspective-correct barycentrics
// of the original triangle and, unless it runs vis-only (the ray-traced
// path's depth prepass, the Pallas kernel's has_attrs=False), the 40
// attribute channels (16 vertex attributes interpolated with those
// barycentrics + the triangle's 24 constants, from scene raster_rows).
//
// K1v (raster_vis, K1's keyed vis-only mode) replaces raster_pallas.py
// _raster_kernel (:519) in its vis-only eval modes v2 / v3
// (eval_block_v2 :621, eval_block_v3 :682):
// the tile's candidate list is cut into groups of 128 consecutive
// entries (the Pallas kernel's 128-lane record blocks). Inside a group
// the largest integer key (clip(Z * 131071, 0, 131071) << 7 | position)
// wins, so a near-tie within 2^-17 of depth goes to the later entry;
// across groups, in list order, a group's winner replaces the running
// one only with a strictly larger exact depth. Where the winner is the
// same, every output is K1's.
//
// The arithmetic is that of the reference's jnp resolve
// (hybridrenderer_tpu/ops/raster.py rasterize), the correctness baseline
// the Pallas kernel is tested against and the path the goldens were
// rendered with: edge functions evaluated in screen space and then
// normalized by the area, depth interpolated with the normalized
// weights, barycentrics normalized from the 1/w-weighted ones. Near-plane
// clipped triangles have vertex coordinates of ~1e6 px, where the
// Pallas kernel's pre-folded affine forms and this order round apart by
// up to ~1e-3 in barycentrics; following the jnp order keeps the port's
// images on the reference's.
//
// Design: one 16x16 pixel tile per block, one thread per pixel. The
// block walks its tile's candidate list (ops/raster_cuda.bin_candidates:
// every candidate whose screen bbox touches the tile, in ascending
// candidate order; nothing is capped or dropped) in chunks staged
// through shared memory (256 records for K1, one group of 128 for K1v),
// and each thread keeps only its running winner. A chunk is staged with
// one barrier after it (and one before it where a chunk came before):
// thread e loads entry e's candidate and then its record as six float4.
// K1 breaks depth ties to the lowest candidate index, so its result does
// not depend on list order. Barycentrics and attributes are evaluated
// once, for the winner only: each thread writes its pixel's depth,
// triangle and barycentrics (16 B) and puts its winner's triangle and
// barycentrics into shared memory; after a barrier that every thread
// reaches, pixels outside the image too, the block writes the tile's 40
// attribute channels per pixel cooperatively, consecutive threads on
// consecutive float4s (a tile row is 640 contiguous floats), reading the
// winners' raster_rows rows as float4s the same way. A thread per pixel
// storing its own 40 floats would touch 32 sectors per warp store, 8x
// the bytes. Bound on the card: the output, 176 B per pixel with
// attributes (16 B vis-only), after the candidate loop, ~20 FLOP per
// candidate per pixel out of shared memory (broadcast reads). K1v's
// groups run in series in their tile's block: the 1080p depth prepass
// lists at most 212 entries in a tile (PERF.md), and resolving a tile's
// groups in parallel blocks, with a second pass to combine them, was no
// faster. The TPU kernels' 128-lane record blocks, one-hot MXU picks
// and quantized depth keys were TPU workarounds; K1 does not keep them,
// K1v keeps only the key's winner rule, which is its contract.
#include "common.cuh"

namespace {

constexpr int kTile = 16;                 // tile edge in pixels
constexpr int kThreads = kTile * kTile;   // one thread per pixel
constexpr int kRec = 24;                  // floats per candidate record
constexpr int kRec4 = kRec / 4;           // float4s per candidate record
constexpr int kAttrRow = 72;              // raster_rows width
constexpr int kAttrOut = 40;              // 16 interpolated + 24 constant
constexpr int kGroup = 128;               // K1v's candidates per key group

// record layout (ops/raster_cuda.pack_candidates):
//   [0:3] [3:6] [6:9] edge functions (alpha, beta, gamma) opposite
//   vertices 0, 1, 2; [9] winding sign; [10] 1 / |2 area|;
//   [11:14] vertex NDC depth; [14:17] vertex 1/w;
//   [17:20] original-triangle barycentric 1 of the three vertices;
//   [20:23] barycentric 2; [23] triangle id
__device__ __forceinline__ float edge(const float* r, float sgn, float px,
                                      float py) {
  return sgn * (r[0] * px + r[1] * py + r[2]);
}

// Depth at the pixel of a covering record, K1's order; false if the
// pixel is not covered or the depth lies outside [0, 1].
__device__ __forceinline__ bool cover_depth(const float* r, float px,
                                            float py, float* z) {
  const float sgn = r[9];
  const float e0 = edge(r, sgn, px, py);
  const float e1 = edge(r + 3, sgn, px, py);
  const float e2 = edge(r + 6, sgn, px, py);
  if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)) return false;
  const float inv_area = r[10];
  *z = (e0 * inv_area) * r[11] + (e1 * inv_area) * r[12] +
       (e2 * inv_area) * r[13];
  return *z >= 0.0f && *z <= 1.0f;
}

// cover_depth on a record staged as float4s (its first 14 floats)
__device__ __forceinline__ bool cover_depth4(const float4* s, float px,
                                             float py, float* z) {
  const float4 q0 = s[0], q1 = s[1], q2 = s[2], q3 = s[3];
  const float r[16] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                       q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w};
  return cover_depth(r, px, py, z);
}

// Stage tile-list entries [base, base + n), n <= the block's threads:
// thread e puts entry e's candidate into scand and its record, six
// float4, into srec; the caller syncs after.
__device__ __forceinline__ void stage(const float4* __restrict__ rec4,
                                      const int* __restrict__ entry_cand,
                                      int base, int n, float4* srec,
                                      int* scand) {
  const int e = threadIdx.x;
  if (e < n) {
    const int c = entry_cand[base + e];
    scand[e] = c;
    const float4* r = rec4 + static_cast<size_t>(c) * kRec4;
#pragma unroll
    for (int k = 0; k < kRec4; ++k) srec[e * kRec4 + k] = r[k];
  }
}

// The winner's visibility outputs at pixel p → its triangle id (-1 for
// none) and original-triangle barycentrics b1, b2.
__device__ __forceinline__ int write_winner(
    const float* __restrict__ rec, int best, float best_z, float px,
    float py, size_t p, float* __restrict__ depth_out,
    int* __restrict__ tri_out, float* __restrict__ bary_out, float* b1_out,
    float* b2_out) {
  if (best < 0) {
    depth_out[p] = 0.0f;
    tri_out[p] = -1;
    bary_out[2 * p] = 0.0f;
    bary_out[2 * p + 1] = 0.0f;
    *b1_out = 0.0f;
    *b2_out = 0.0f;
    return -1;
  }
  const float* r = rec + static_cast<size_t>(best) * kRec;
  const float sgn = r[9];
  const float inv_area = r[10];
  const float l0 = edge(r, sgn, px, py) * inv_area;
  const float l1 = edge(r + 3, sgn, px, py) * inv_area;
  const float l2 = edge(r + 6, sgn, px, py) * inv_area;
  const float u0 = l0 * r[14], u1 = l1 * r[15], u2 = l2 * r[16];
  const float s = fmaxf(u0 + u1 + u2, 1e-20f);
  const float pc0 = u0 / s, pc1 = u1 / s, pc2 = u2 / s;
  const float b1 = pc0 * r[17] + pc1 * r[18] + pc2 * r[19];
  const float b2 = pc0 * r[20] + pc1 * r[21] + pc2 * r[22];
  const int tri = static_cast<int>(r[23]);
  depth_out[p] = best_z;
  tri_out[p] = tri;
  bary_out[2 * p] = b1;
  bary_out[2 * p + 1] = b2;
  *b1_out = b1;
  *b2_out = b2;
  return tri;
}

// K1's attribute image for the block's tile, from the winners in shared
// memory (stri < 0: background). The tile's (pixel, channel) pairs are
// walked as float4s in memory order, so a warp stores 512 contiguous
// bytes: a tile row of 16 pixels is 640 contiguous floats, and a float4
// never straddles two pixels (40 = 10 x 4). Each value is the plain
// version's expression in its order.
__device__ __forceinline__ void write_attrs(
    const float* __restrict__ attr_table, const int* stri, const float* sb1,
    const float* sb2, int x0, int y0, int width, int height,
    float* __restrict__ attr_out) {
  constexpr int kVec = kAttrOut / 4;            // float4s per pixel
  constexpr int kRowVec = kTile * kVec;         // float4s per tile row
  float4* out = reinterpret_cast<float4*>(attr_out);
  for (int i = threadIdx.x; i < kTile * kRowVec; i += kThreads) {
    const int ly = i / kRowVec;
    const int j = i - ly * kRowVec;
    const int lx = j / kVec;
    const int v = j - lx * kVec;
    if (x0 + lx >= width || y0 + ly >= height) continue;
    const int s = ly * kTile + lx;
    const int tri = stri[s];
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (tri >= 0) {
      const float4* row = reinterpret_cast<const float4*>(
          attr_table + static_cast<size_t>(tri) * kAttrRow);
      if (v < 4) {   // channels 4v..4v+3 of the 16 interpolated
        const float b1 = sb1[s], b2 = sb2[s];
        const float b0 = 1.0f - b1 - b2;
        const float4 a0 = row[v], a1 = row[4 + v], a2 = row[8 + v];
        o.x = a0.x * b0 + a1.x * b1 + a2.x * b2;
        o.y = a0.y * b0 + a1.y * b1 + a2.y * b2;
        o.z = a0.z * b0 + a1.z * b1 + a2.z * b2;
        o.w = a0.w * b0 + a1.w * b1 + a2.w * b2;
      } else {       // the 24 constants, row[48:72]
        o = row[8 + v];
      }
    }
    out[(static_cast<size_t>(y0 + ly) * width + x0 + lx) * kVec + v] = o;
  }
}

// kKeyed: K1v's winner rule (vis-only), in chunks of one 128-entry group
template <bool kAttrs, bool kKeyed>
__global__ void __launch_bounds__(kThreads)
raster_tiles_kernel(const float4* __restrict__ rec4,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ entry_cand,
                    const float* __restrict__ attr_table, int width,
                    int height, int ntx, float* __restrict__ depth_out,
                    int* __restrict__ tri_out, float* __restrict__ bary_out,
                    float* __restrict__ attr_out) {
  constexpr int kChunk = kKeyed ? kGroup : kThreads;
  __shared__ float4 srec[kChunk * kRec4];
  __shared__ int scand[kChunk];

  const int tile = blockIdx.x;
  const int x = (tile % ntx) * kTile + threadIdx.x % kTile;
  const int y = (tile / ntx) * kTile + threadIdx.x / kTile;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const int start = tile_start[tile];
  const int end = tile_start[tile + 1];

  // depth must beat 0 (the cleared far plane) to win
  float best_z = 0.0f;
  int best = -1;
  for (int base = start; base < end; base += kChunk) {
    const int n = min(kChunk, end - base);
    // the block is done reading the chunk before
    if (base != start) __syncthreads();
    stage(rec4, entry_cand, base, n, srec, scand);
    __syncthreads();
    if constexpr (kKeyed) {
      // the group's winner: the largest key; positions make keys unique
      int key = -1, win = -1;
      float win_z = 0.0f;
      for (int e = 0; e < n; ++e) {
        float z;
        if (cover_depth4(&srec[e * kRec4], px, py, &z)) {
          const int k = (static_cast<int>(
                            fminf(fmaxf(z * 131071.0f, 0.0f), 131071.0f))
                        << 7) | e;
          if (k > key) {
            key = k;
            win = scand[e];
            win_z = z;
          }
        }
      }
      // across groups a strictly larger exact depth replaces
      if (win >= 0 && win_z > best_z) {
        best_z = win_z;
        best = win;
      }
    } else {
      for (int e = 0; e < n; ++e) {
        float z;
        if (cover_depth4(&srec[e * kRec4], px, py, &z)) {
          const int c = scand[e];
          if (z > best_z || (z == best_z && best >= 0 && c < best)) {
            best_z = z;
            best = c;
          }
        }
      }
    }
  }
  const float* rec = reinterpret_cast<const float*>(rec4);
  const bool inside = x < width && y < height;
  float b1 = 0.0f, b2 = 0.0f;
  const int tri = inside ? write_winner(rec, best, best_z, px, py,
                                        static_cast<size_t>(y) * width + x,
                                        depth_out, tri_out, bary_out, &b1,
                                        &b2)
                         : -1;
  if constexpr (kAttrs) {
    // every thread reaches the barrier, pixels outside the image too
    __shared__ int stri[kThreads];
    __shared__ float sb1[kThreads], sb2[kThreads];
    stri[threadIdx.x] = tri;
    sb1[threadIdx.x] = b1;
    sb2[threadIdx.x] = b2;
    __syncthreads();
    write_attrs(attr_table, stri, sb1, sb2, (tile % ntx) * kTile,
                (tile / ntx) * kTile, width, height, attr_out);
  }
}

}  // namespace

// attr_table and attrs null: vis-only; keyed (vis-only): K1v. rec (and
// attr_table, attrs) are 16-byte aligned.
HR_EXPORT int hr_raster_tiles(const void* rec, const void* tile_start,
                              const void* entry_cand, const void* attr_table,
                              int keyed, int width, int height, int ntx,
                              void* depth, void* tri, void* bary,
                              void* attrs, void* stream) {
  if (keyed && attr_table) return static_cast<int>(cudaErrorInvalidValue);
  const int nty = (height + kTile - 1) / kTile;
  auto kernel = keyed        ? raster_tiles_kernel<false, true>
                : attr_table ? raster_tiles_kernel<true, false>
                             : raster_tiles_kernel<false, false>;
  kernel<<<ntx * nty, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rec), static_cast<const int*>(tile_start),
      static_cast<const int*>(entry_cand),
      static_cast<const float*>(attr_table), width, height, ntx,
      static_cast<float*>(depth), static_cast<int*>(tri),
      static_cast<float*>(bary), static_cast<float*>(attrs));
  HR_RETURN_LAUNCH_STATUS();
}

HR_EXPORT const char* hr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
