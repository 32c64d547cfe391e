// K3: SVGF temporal history fetch (reprojection), and K5: the TAA
// history fetch (bilinear sample of P planes).
//
// K3
// Replaces hybridrenderer_tpu/ops/temporal_pallas.py _kernel (:55). Same
// contract for one signal: each pixel reprojects through its motion
// vector into the previous frame, takes the 2x2 bilinear footprint
// there, and keeps a tap only if the previous object id matches, the
// normals' dot product is >= 0.95 and the relative linear-depth change is
// <= 5%. Out per pixel: the weighted history signal (4), moments m1 m2,
// history length, and the sum of the kept weights.
//
// A row window: the current planes may hold rows row0 .. row0 + H - 1 of
// an image of FH rows, whose whole history the fetch reads (a row-sharded
// frame's shard, parallel/sharded.py; reprojection can read any row).
// The pixel's v is (row0 + y + 0.5) / FH, its footprint clamps to FH.
//
// Design: one thread per pixel and the exact per-pixel footprint fetch
// (ops/svgf.py temporal_multi, gather="pixel"). The TPU kernel's
// windowed candidate sweep, which drops history whose footprint lies
// >= 8 px from its tile's minimum, was a TPU gather workaround and is not
// kept. History may be stored as bf16 or f32 and is read in its storage
// type; all arithmetic is f32. Bound on the card: memory, ~60 B read
// per tap (history 16 B, validation 20 B) and 60 B of current-frame
// planes and output per pixel, mostly L2 hits for smooth motion.
//
// K5 replaces temporal_pallas.py _sample_kernel (:264, window_sample).
// Its contract is the reference's CPU path, ops/image.py sample_bilinear:
// each query point uv samples an (H, W, P) f32 image bilinearly at
// x = u * W - 0.5, y = v * H - 0.5 with clamp-to-edge taps. The TPU
// kernel's tile window, outside which a pixel lost its history, was a
// VMEM workaround and is not kept: no history is dropped.
//
// Bound on the card: bytes. A point reads 8 B of uv and writes 4P B, and
// the image is read once: 66.4 MB at 1080p with P = 3 (TAA's history),
// 0.0198 ms at 3.35 TB/s. The taps of neighbouring points share cache
// lines, so the design spends its effort on bytes in flight and on whole
// sectors: each warp takes 128 consecutive points, a lane four of them
// 32 apart, so every warp-wide access is contiguous (uv as 8-byte loads,
// 256 B a warp; the taps of neighbouring lanes in neighbouring pixels)
// and a lane has four points' loads to overlap; the image is read
// through the read-only path. For P = 1..4 the warp's results go
// through shared memory and out as 16-byte stores of its 512P contiguous
// bytes (a lane's own points sit 4P bytes apart). A uv view that is not
// 8-byte aligned, an output chunk's ragged tail and any other P take
// 4-byte accesses. The arithmetic is the plain version's in its order,
// so the result is the same bit for bit.
// Measured on an H100 80GB HBM3 at 700 W (device time, inputs not in
// L2; chip_smoke.py): 0.0266 ms at 1080p, 75% of the bound, against
// 0.0350 for the one-point-a-thread kernel before it and 0.0422 for
// grid_sample; 0.0079-0.0082 ms for 270 rows of uv over the 1080-row
// history (a row-sharded frame's shard). P = 3 takes 40 registers and
// 12 KB of shared memory a block, no spills. Storing each point's
// results as soon as they were computed let the compiler keep 32
// registers and request the points' taps one point after another: the
// same at 1080p, 0.0087 ms at the shard shape.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float load(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void temporal_fetch_kernel(
    const T* __restrict__ hist_signal, const T* __restrict__ hist_moments,
    const float* __restrict__ prev_normal,
    const float* __restrict__ prev_depth, const int* __restrict__ prev_oid,
    const float* __restrict__ motion_plane, const float* __restrict__ normal,
    const int* __restrict__ oid, int H, int W, int row0, int FH,
    float* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t p = static_cast<size_t>(y) * W + x;

  const float u = (static_cast<float>(x) + 0.5f) / static_cast<float>(W);
  const float v =
      (static_cast<float>(row0 + y) + 0.5f) / static_cast<float>(FH);
  const float ppx = (u - motion_plane[4 * p]) * static_cast<float>(W) - 0.5f;
  const float ppy =
      (v - motion_plane[4 * p + 1]) * static_cast<float>(FH) - 0.5f;
  const float z = motion_plane[4 * p + 2];
  const float bxf = fminf(fmaxf(floorf(ppx), 0.0f), static_cast<float>(W - 2));
  const float byf =
      fminf(fmaxf(floorf(ppy), 0.0f), static_cast<float>(FH - 2));
  const float fx = ppx - bxf;
  const float fy = ppy - byf;
  const int bx = static_cast<int>(bxf);
  const int by = static_cast<int>(byf);
  const bool footprint_ok = ppx >= 0.0f && ppx <= static_cast<float>(W - 1) &&
                            ppy >= 0.0f && ppy <= static_cast<float>(FH - 1);
  const float nx = normal[3 * p], ny = normal[3 * p + 1],
              nz = normal[3 * p + 2];
  const float oid_c = static_cast<float>(oid[p]);

  const float weights[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                            (1.0f - fx) * fy, fx * fy};
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int tap = 0; tap < 4; ++tap) {
    const size_t q = static_cast<size_t>(by + (tap >> 1)) * W + bx + (tap & 1);
    const float ndot = prev_normal[3 * q] * nx + prev_normal[3 * q + 1] * ny +
                       prev_normal[3 * q + 2] * nz;
    const bool ok = footprint_ok &&
                    static_cast<float>(prev_oid[q]) == oid_c &&
                    ndot >= 0.95f &&
                    fabsf(z - prev_depth[q]) / (z + 1e-6f) <= 0.05f;
    const float w = ok ? weights[tap] : 0.0f;
    acc[0] = acc[0] + w * load(hist_signal, 4 * q);
    acc[1] = acc[1] + w * load(hist_signal, 4 * q + 1);
    acc[2] = acc[2] + w * load(hist_signal, 4 * q + 2);
    acc[3] = acc[3] + w * load(hist_signal, 4 * q + 3);
    acc[4] = acc[4] + w * load(hist_moments, 4 * q);
    acc[5] = acc[5] + w * load(hist_moments, 4 * q + 1);
    acc[6] = acc[6] + w * load(hist_moments, 4 * q + 3);
    acc[7] = acc[7] + w;
  }
  for (int c = 0; c < 8; ++c) out[8 * p + c] = acc[c];
}

// K5's shape: a block of 8 warps; each warp samples one chunk of 128
// consecutive query points, lane l taking points l, l + 32, l + 64 and
// l + 96 of it, so every warp-wide access is contiguous
constexpr int kSampleThreads = 256;
constexpr int kSamplePoints = 4;
constexpr int kSampleChunk = 32 * kSamplePoints;

// The bilinear footprint of one query point: its four tap pixels and
// weights, as ops/image.py sample_bilinear computes them (clamp in float,
// then convert: the same taps as the reference's clip(int(x0)) for every
// representable coordinate)
struct Footprint {
  size_t p00, p10, p01, p11;
  float fx, fy;
};

__device__ __forceinline__ Footprint footprint(float u, float v, int H,
                                               int W) {
  const float x = u * static_cast<float>(W) - 0.5f;
  const float y = v * static_cast<float>(H) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wm = static_cast<float>(W - 1), hm = static_cast<float>(H - 1);
  const size_t xa = static_cast<int>(fminf(fmaxf(x0, 0.0f), wm));
  const size_t xb = static_cast<int>(fminf(fmaxf(x0 + 1.0f, 0.0f), wm));
  const size_t ya = static_cast<int>(fminf(fmaxf(y0, 0.0f), hm));
  const size_t yb = static_cast<int>(fminf(fmaxf(y0 + 1.0f, 0.0f), hm));
  return {ya * W + xa, ya * W + xb, yb * W + xa, yb * W + xb, x - x0, y - y0};
}

__device__ __forceinline__ float bilinear(float c00, float c10, float c01,
                                          float c11, float fx, float fy) {
  return (c00 * (1.0f - fx) + c10 * fx) * (1.0f - fy) +
         (c01 * (1.0f - fx) + c11 * fx) * fy;
}

// P = 1..4: a lane's taps in registers, the warp's results stored through
// shared memory as whole 16-byte words. P = 0: any P, given at run time,
// one tap value at a time, stored directly.
template <int P>
__global__ void __launch_bounds__(kSampleThreads)
    window_sample_kernel(const float* __restrict__ planes, int H, int W,
                         int p_any, const float* __restrict__ uv, int Q,
                         float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first =
      (static_cast<long long>(blockIdx.x) * (kSampleThreads / 32) + warp) *
      kSampleChunk;
  if (first >= Q) return;  // a whole warp
  const int n = static_cast<int>(
      min(static_cast<long long>(kSampleChunk), Q - first));

  // uv: one 8-byte load a point (a warp reads 256 contiguous bytes) where
  // uv is 8-byte aligned; points past Q sample (0, 0) and store nothing
  const bool uv_vec = (reinterpret_cast<uintptr_t>(uv) & 7) == 0;
  Footprint fp[kSamplePoints];
#pragma unroll
  for (int j = 0; j < kSamplePoints; ++j) {
    const long long q = first + 32 * j + lane;
    float u = 0.0f, v = 0.0f;
    if (q < Q) {
      if (uv_vec) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(uv) + q);
        u = t.x, v = t.y;
      } else {
        u = __ldg(uv + 2 * q), v = __ldg(uv + 2 * q + 1);
      }
    }
    fp[j] = footprint(u, v, H, W);
  }

  if constexpr (P == 0) {
    for (int j = 0; j < kSamplePoints; ++j) {
      const long long q = first + 32 * j + lane;
      if (q >= Q) break;
      const Footprint& f = fp[j];
      for (int c = 0; c < p_any; ++c) {
        const float* p = planes + c;
        out[static_cast<size_t>(q) * p_any + c] =
            bilinear(__ldg(p + f.p00 * p_any), __ldg(p + f.p10 * p_any),
                     __ldg(p + f.p01 * p_any), __ldg(p + f.p11 * p_any),
                     f.fx, f.fy);
      }
    }
  } else {
    float c00[kSamplePoints][P], c10[kSamplePoints][P];
    float c01[kSamplePoints][P], c11[kSamplePoints][P];
#pragma unroll
    for (int j = 0; j < kSamplePoints; ++j) {
      const float* p00 = planes + fp[j].p00 * P;
      const float* p10 = planes + fp[j].p10 * P;
      const float* p01 = planes + fp[j].p01 * P;
      const float* p11 = planes + fp[j].p11 * P;
#pragma unroll
      for (int c = 0; c < P; ++c) c00[j][c] = __ldg(p00 + c);
#pragma unroll
      for (int c = 0; c < P; ++c) c10[j][c] = __ldg(p10 + c);
#pragma unroll
      for (int c = 0; c < P; ++c) c01[j][c] = __ldg(p01 + c);
#pragma unroll
      for (int c = 0; c < P; ++c) c11[j][c] = __ldg(p11 + c);
    }
    // all four points' results before any is stored: the compiler then
    // keeps more of the lane's tap loads in flight at once
    float r[kSamplePoints][P];
#pragma unroll
    for (int j = 0; j < kSamplePoints; ++j) {
#pragma unroll
      for (int c = 0; c < P; ++c) {
        r[j][c] = bilinear(c00[j][c], c10[j][c], c01[j][c], c11[j][c],
                           fp[j].fx, fp[j].fy);
      }
    }
    // lane l's points sit 4P bytes apart: the warp writes its 128P
    // results to shared memory (P = 3: stride 3 words, no bank conflict)
    // and stores them as 32P contiguous float4s
    __shared__ __align__(16) float stage[kSampleThreads / 32]
                                        [kSampleChunk * P];
    float* s = stage[warp];
#pragma unroll
    for (int j = 0; j < kSamplePoints; ++j) {
#pragma unroll
      for (int c = 0; c < P; ++c) {
        s[(32 * j + lane) * P + c] = r[j][c];
      }
    }
    __syncwarp();
    float* dst = out + first * P;
    if (n == kSampleChunk && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        reinterpret_cast<float4*>(dst)[32 * i + lane] = s4[32 * i + lane];
      }
    } else {
      for (int i = lane; i < n * P; i += 32) dst[i] = s[i];
    }
  }
}

}  // namespace

HR_EXPORT int hr_window_sample(const void* planes, int H, int W, int P,
                               const void* uv, int Q, void* out,
                               void* stream) {
  if (Q > 0 && P > 0) {
    const long long chunks = (static_cast<long long>(Q) + kSampleChunk - 1) /
                             kSampleChunk;
    const int blocks =
        static_cast<int>((chunks + kSampleThreads / 32 - 1) /
                         (kSampleThreads / 32));
    auto launch = [&](auto kernel) {
      kernel<<<blocks, kSampleThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(planes), H, W, P,
          static_cast<const float*>(uv), Q, static_cast<float*>(out));
    };
    switch (P) {
      case 1: launch(window_sample_kernel<1>); break;
      case 2: launch(window_sample_kernel<2>); break;
      case 3: launch(window_sample_kernel<3>); break;
      case 4: launch(window_sample_kernel<4>); break;
      default: launch(window_sample_kernel<0>); break;
    }
  }
  HR_RETURN_LAUNCH_STATUS();
}

HR_EXPORT int hr_temporal_fetch(const void* hist_signal,
                                const void* hist_moments, int bf16,
                                const void* prev_normal,
                                const void* prev_depth, const void* prev_oid,
                                const void* motion_plane, const void* normal,
                                const void* oid, int H, int W, int row0,
                                int FH, void* out, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8);
  auto s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto* sig, auto* mom) {
    temporal_fetch_kernel<<<grid, block, 0, s>>>(
        sig, mom, static_cast<const float*>(prev_normal),
        static_cast<const float*>(prev_depth),
        static_cast<const int*>(prev_oid),
        static_cast<const float*>(motion_plane),
        static_cast<const float*>(normal), static_cast<const int*>(oid), H, W,
        row0, FH, static_cast<float*>(out));
  };
  if (bf16) {
    args(static_cast<const __nv_bfloat16*>(hist_signal),
         static_cast<const __nv_bfloat16*>(hist_moments));
  } else {
    args(static_cast<const float*>(hist_signal),
         static_cast<const float*>(hist_moments));
  }
  HR_RETURN_LAUNCH_STATUS();
}
