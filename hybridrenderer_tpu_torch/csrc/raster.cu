// K1: binned tile rasterizer with the G-buffer attribute ride-along.
//
// Replaces hybridrenderer_tpu/ops/raster_pallas.py _raster_kernel_t
// (:784, with _tile_body :842). Same contract: for every pixel the
// covering candidate of largest reversed-Z depth wins; the kernel writes
// its depth, triangle id, perspective-correct barycentrics of the
// original triangle, and the 40 attribute channels (16 vertex
// attributes interpolated with those barycentrics + the triangle's 24
// constants, from scene raster_rows).
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
// every candidate whose screen bbox touches the tile; nothing is capped
// or dropped) in chunks of 256 records staged through shared memory, and
// each thread keeps only its running winner. Ties in depth go to the
// lowest candidate index, so the result does not depend on list order.
// Barycentrics and attributes are evaluated once, for the winner only.
// Bound on the card: the candidate loop, ~20 FLOP per candidate per
// pixel out of shared memory (broadcast reads); output writes are
// 176 B per pixel. The TPU kernel's 128-lane record blocks, one-hot MXU
// picks and quantized depth keys were TPU workarounds and are not kept.
#include "common.cuh"

namespace {

constexpr int kTile = 16;                 // tile edge in pixels
constexpr int kThreads = kTile * kTile;   // one thread per pixel
constexpr int kRec = 24;                  // floats per candidate record
constexpr int kAttrRow = 72;              // raster_rows width
constexpr int kAttrOut = 40;              // 16 interpolated + 24 constant

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

__global__ void __launch_bounds__(kThreads)
raster_tiles_kernel(const float* __restrict__ rec,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ entry_cand,
                    const float* __restrict__ attr_table, int width,
                    int height, int ntx, float* __restrict__ depth_out,
                    int* __restrict__ tri_out, float* __restrict__ bary_out,
                    float* __restrict__ attr_out) {
  __shared__ float srec[kThreads * kRec];
  __shared__ int scand[kThreads];

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
  for (int base = start; base < end; base += kThreads) {
    const int n = min(kThreads, end - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * kRec; i += kThreads) {
      const int e = i / kRec;
      srec[i] = rec[static_cast<size_t>(entry_cand[base + e]) * kRec +
                    (i - e * kRec)];
    }
    if (threadIdx.x < n) scand[threadIdx.x] = entry_cand[base + threadIdx.x];
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      const float* r = &srec[e * kRec];
      const float sgn = r[9];
      const float e0 = edge(r, sgn, px, py);
      const float e1 = edge(r + 3, sgn, px, py);
      const float e2 = edge(r + 6, sgn, px, py);
      if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) {
        const float inv_area = r[10];
        const float z = (e0 * inv_area) * r[11] + (e1 * inv_area) * r[12] +
                        (e2 * inv_area) * r[13];
        const int c = scand[e];
        if (z >= 0.0f && z <= 1.0f &&
            (z > best_z || (z == best_z && best >= 0 && c < best))) {
          best_z = z;
          best = c;
        }
      }
    }
  }
  if (x >= width || y >= height) return;

  const size_t p = static_cast<size_t>(y) * width + x;
  float* a = attr_out + p * kAttrOut;
  if (best < 0) {
    depth_out[p] = 0.0f;
    tri_out[p] = -1;
    bary_out[2 * p] = 0.0f;
    bary_out[2 * p + 1] = 0.0f;
    for (int c = 0; c < kAttrOut; ++c) a[c] = 0.0f;
    return;
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

  const float b0 = 1.0f - b1 - b2;
  const float* row = attr_table + static_cast<size_t>(tri) * kAttrRow;
  for (int c = 0; c < 16; ++c) {
    a[c] = row[c] * b0 + row[16 + c] * b1 + row[32 + c] * b2;
  }
  for (int c = 0; c < 24; ++c) a[16 + c] = row[48 + c];
}

}  // namespace

HR_EXPORT int hr_raster_tiles(const void* rec, const void* tile_start,
                              const void* entry_cand, const void* attr_table,
                              int width, int height, int ntx, void* depth,
                              void* tri, void* bary, void* attrs,
                              void* stream) {
  const int nty = (height + kTile - 1) / kTile;
  raster_tiles_kernel<<<ntx * nty, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rec), static_cast<const int*>(tile_start),
      static_cast<const int*>(entry_cand),
      static_cast<const float*>(attr_table), width, height, ntx,
      static_cast<float*>(depth), static_cast<int*>(tri),
      static_cast<float*>(bary), static_cast<float*>(attrs));
  HR_RETURN_LAUNCH_STATUS();
}

HR_EXPORT const char* hr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
