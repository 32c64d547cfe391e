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
// VMEM workaround and is not kept. Design: one thread per query point,
// four P-float taps. Bound on the card: memory, 8 B of uv read and 4P B
// written per point, the image read once (neighbouring threads share
// taps through L1/L2).
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
    const int* __restrict__ oid, int H, int W, float* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t p = static_cast<size_t>(y) * W + x;

  const float u = (static_cast<float>(x) + 0.5f) / static_cast<float>(W);
  const float v = (static_cast<float>(y) + 0.5f) / static_cast<float>(H);
  const float ppx = (u - motion_plane[4 * p]) * static_cast<float>(W) - 0.5f;
  const float ppy = (v - motion_plane[4 * p + 1]) * static_cast<float>(H) - 0.5f;
  const float z = motion_plane[4 * p + 2];
  const float bxf = fminf(fmaxf(floorf(ppx), 0.0f), static_cast<float>(W - 2));
  const float byf = fminf(fmaxf(floorf(ppy), 0.0f), static_cast<float>(H - 2));
  const float fx = ppx - bxf;
  const float fy = ppy - byf;
  const int bx = static_cast<int>(bxf);
  const int by = static_cast<int>(byf);
  const bool footprint_ok = ppx >= 0.0f && ppx <= static_cast<float>(W - 1) &&
                            ppy >= 0.0f && ppy <= static_cast<float>(H - 1);
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

__global__ void window_sample_kernel(const float* __restrict__ planes, int H,
                                     int W, int P,
                                     const float* __restrict__ uv, int Q,
                                     float* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const float x = uv[2 * q] * static_cast<float>(W) - 0.5f;
  const float y = uv[2 * q + 1] * static_cast<float>(H) - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  // clamp in float, then convert: the same taps as the reference's
  // clip(int(x0)) for every representable coordinate
  const float wm = static_cast<float>(W - 1), hm = static_cast<float>(H - 1);
  const int xa = static_cast<int>(fminf(fmaxf(x0, 0.0f), wm));
  const int xb = static_cast<int>(fminf(fmaxf(x0 + 1.0f, 0.0f), wm));
  const int ya = static_cast<int>(fminf(fmaxf(y0, 0.0f), hm));
  const int yb = static_cast<int>(fminf(fmaxf(y0 + 1.0f, 0.0f), hm));
  const float* c00 = planes + (static_cast<size_t>(ya) * W + xa) * P;
  const float* c10 = planes + (static_cast<size_t>(ya) * W + xb) * P;
  const float* c01 = planes + (static_cast<size_t>(yb) * W + xa) * P;
  const float* c11 = planes + (static_cast<size_t>(yb) * W + xb) * P;
  for (int c = 0; c < P; ++c) {
    out[static_cast<size_t>(q) * P + c] =
        (c00[c] * (1.0f - fx) + c10[c] * fx) * (1.0f - fy) +
        (c01[c] * (1.0f - fx) + c11[c] * fx) * fy;
  }
}

}  // namespace

HR_EXPORT int hr_window_sample(const void* planes, int H, int W, int P,
                               const void* uv, int Q, void* out,
                               void* stream) {
  if (Q > 0) {
    constexpr int kBlock = 256;
    window_sample_kernel<<<(Q + kBlock - 1) / kBlock, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(planes), H, W, P,
        static_cast<const float*>(uv), Q, static_cast<float*>(out));
  }
  HR_RETURN_LAUNCH_STATUS();
}

HR_EXPORT int hr_temporal_fetch(const void* hist_signal,
                                const void* hist_moments, int bf16,
                                const void* prev_normal,
                                const void* prev_depth, const void* prev_oid,
                                const void* motion_plane, const void* normal,
                                const void* oid, int H, int W, void* out,
                                void* stream) {
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
        static_cast<float*>(out));
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
