// TAA's resolve (taa.comp) in two kernels around the history fetch K5.
//
// The reference resolves in plain jnp (hybridrenderer_tpu/ops/taa.py
// resolve :52); there is no TPU kernel. The port's plain version
// (ops/taa.py) is the reference's order of operations split at K5's
// bilinear history sample, which stays a launch of its own
// (csrc/temporal.cu window_sample_kernel):
//
// hr_taa_reproject, one thread a pixel: the velocity dilation (the motion
// of the 3x3 neighbour with the largest reversed-Z depth, taps in row
// order, a later tap winning only on a strictly larger depth, neighbours
// clamped to the edge of the planes passed in), the jitter-compensated
// reprojection prev_uv = uv - jitter/2 - motion + prev_jitter/2 with uv at
// pixel centres of rows row0.. of an image FH rows tall, and the blend
// weight: clamp(0.1 + 0.1 |motion (W, FH)|, 0.1, 0.9), 1 where prev_uv
// leaves [0, 1]^2 or with no valid history. Out: prev_uv (H, W, 2) and
// alpha (H, W).
//
// hr_taa_resolve, one thread a pixel: a block stages its tile of colour
// with a one-pixel apron in shared memory, tonemapped (non-finite to 0,
// negative to 0, c / (1 + max c)) and in YCoCg, once a pixel; each
// thread sums its 3x3 neighbourhood's moments into the mean / sigma box
// (+-1.5 sigma), tonemaps and converts the K5 sample, clips it toward
// the box centre (ray-box, direction floored at 1e-5), blends with alpha
// and converts back and untonemaps (c / max(1 - max c, 1e-4)). Out:
// (H, W, 3).
//
// Bound on the card: bytes. The reprojection reads depth (4 B, its
// neighbours from cache) and the winner's motion (8 B) and writes 12 B;
// the resolve reads colour, the sample and alpha (28 B) and writes 12 B:
// 24 and 40 B a pixel, 0.015 and 0.025 ms at 1080p and 3.35 TB/s. Both
// are elementwise but for their 3x3 stencils, whose taps the L1 cache
// (depth) or the staged tile (colour, each tap's tonemap and YCoCg done
// once) serve.
//
// Every float operation is the plain version's, in its order, under the
// library's -fmad=false, with PyTorch's own rules on the card where an
// operator is not one IEEE operation: a division by a Python number is a
// multiplication by its float reciprocal (m / 9); ``1.0 / x`` is
// reciprocal(x), a true division; clamp, maximum and minimum return NaN
// unchanged and otherwise fminf / fmaxf; a norm over two components is
// sqrtf(x*x + y*y); the pixel centres' uv are true divisions by the size.
#include "common.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kApronW = kTileW + 2;
constexpr int kApronH = kTileH + 2;

// torch.clamp / clamp_min on the card: NaN passes, else fmaxf / fminf
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
// torch.maximum / minimum and amax: NaN propagates
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

struct C3 {
  float x, y, z;
};

__device__ __forceinline__ float amax3(C3 c) {
  return max_nan(max_nan(c.x, c.y), c.z);
}

// ops/taa.py _tonemap
__device__ __forceinline__ C3 tonemap(C3 c) {
  c.x = clamp_min(isfinite(c.x) ? c.x : 0.0f, 0.0f);
  c.y = clamp_min(isfinite(c.y) ? c.y : 0.0f, 0.0f);
  c.z = clamp_min(isfinite(c.z) ? c.z : 0.0f, 0.0f);
  const float den = amax3(c) + 1.0f;
  return {c.x / den, c.y / den, c.z / den};
}

// ops/taa.py _rgb_to_ycocg: each product by its scalar, summed left to
// right
__device__ __forceinline__ C3 to_ycocg(C3 c) {
  return {c.x * 0.25f + c.y * 0.5f + c.z * 0.25f, c.x * 0.5f - c.z * 0.5f,
          c.x * -0.25f + c.y * 0.5f - c.z * 0.25f};
}

__device__ __forceinline__ C3 load_rgb(const float* p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

__global__ void __launch_bounds__(kThreads)
    taa_reproject_kernel(const float* __restrict__ depth,
                         const float* __restrict__ motion, int ms0, int ms1,
                         const float* __restrict__ jitter,
                         const float* __restrict__ prev_jitter, int H, int W,
                         int row0, int FH, int history_valid,
                         float* __restrict__ prev_uv,
                         float* __restrict__ alpha) {
  const int x = static_cast<int>(blockIdx.x * kTileW + threadIdx.x);
  const int y = static_cast<int>(blockIdx.y * kTileH + threadIdx.y);
  if (x >= W || y >= H) return;

  // 1. velocity dilation: the 3x3-closest pixel (largest reversed-Z)
  float best = 0.0f;
  int bx = 0, by = 0;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = hr_clampi(y + dy, 0, H - 1);
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = hr_clampi(x + dx, 0, W - 1);
      const float d = __ldg(depth + static_cast<size_t>(yy) * W + xx);
      if (dy == -1 && dx == -1) {
        best = d, bx = xx, by = yy;
      } else {
        if (d > best) bx = xx, by = yy;
        best = max_nan(d, best);
      }
    }
  }
  const float* m = motion + static_cast<size_t>(by) * ms0 +
                   static_cast<size_t>(bx) * ms1;
  const float mx = __ldg(m), my = __ldg(m + 1);

  // 2. reprojection with jitter compensation, uv at pixel centres
  const float u = (static_cast<float>(x) + 0.5f) / static_cast<float>(W);
  const float v =
      (static_cast<float>(row0 + y) + 0.5f) / static_cast<float>(FH);
  const float pu = u - __ldg(jitter) * 0.5f - mx + __ldg(prev_jitter) * 0.5f;
  const float pv =
      v - __ldg(jitter + 1) * 0.5f - my + __ldg(prev_jitter + 1) * 0.5f;

  // 5. (the weight of) the motion-adaptive blend
  const float sx = mx * static_cast<float>(W);
  const float sy = my * static_cast<float>(FH);
  const float len = sqrtf(sx * sx + sy * sy);
  float a = clamp(len * 0.1f + 0.1f, 0.1f, 0.9f);
  const bool off = pu < 0.0f || pu > 1.0f || pv < 0.0f || pv > 1.0f;
  if (off || !history_valid) a = 1.0f;

  const size_t p = static_cast<size_t>(y) * W + x;
  reinterpret_cast<float2*>(prev_uv)[p] = make_float2(pu, pv);
  alpha[p] = a;
}

__global__ void __launch_bounds__(kThreads)
    taa_resolve_kernel(const float* __restrict__ cur,
                       const float* __restrict__ hist,
                       const float* __restrict__ alpha, int H, int W,
                       float* __restrict__ out) {
  // the tile's colour and its one-pixel apron, clamped to the edge,
  // tonemapped and in YCoCg
  __shared__ float tile[3][kApronH][kApronW];
  const int x0 = static_cast<int>(blockIdx.x) * kTileW - 1;
  const int y0 = static_cast<int>(blockIdx.y) * kTileH - 1;
  const int tid = static_cast<int>(threadIdx.y * kTileW + threadIdx.x);
  for (int i = tid; i < kApronH * kApronW; i += kThreads) {
    const int ty = i / kApronW, tx = i % kApronW;
    const int yy = hr_clampi(y0 + ty, 0, H - 1);
    const int xx = hr_clampi(x0 + tx, 0, W - 1);
    const float* px = cur + (static_cast<size_t>(yy) * W + xx) * 3;
    const C3 c = to_ycocg(tonemap(load_rgb(px)));
    tile[0][ty][tx] = c.x;
    tile[1][ty][tx] = c.y;
    tile[2][ty][tx] = c.z;
  }
  __syncthreads();
  const int tx = static_cast<int>(threadIdx.x);
  const int ty = static_cast<int>(threadIdx.y);
  const int x = x0 + 1 + tx;
  const int y = y0 + 1 + ty;
  if (x >= W || y >= H) return;

  // 3. neighbourhood statistics AABB
  float m1[3] = {0.0f, 0.0f, 0.0f}, m2[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float c = tile[k][ty + dy][tx + dx];
        m1[k] = m1[k] + c;
        m2[k] = m2[k] + c * c;
      }
    }
  }
  const float ninth = 1.0f / 9.0f;
  float cur_c[3], lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    cur_c[k] = tile[k][ty + 1][tx + 1];
    const float mu = m1[k] * ninth;
    const float sigma = sqrtf(clamp_min(m2[k] * ninth - mu * mu, 0.0f));
    lo[k] = mu - sigma * 1.5f;
    hi[k] = mu + sigma * 1.5f;
  }

  // 4. clip the sampled history toward the box centre
  const size_t p = static_cast<size_t>(y) * W + x;
  const C3 h3 = to_ycocg(tonemap(load_rgb(hist + p * 3)));
  const float h[3] = {h3.x, h3.y, h3.z};
  float filtered[3], enter[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    filtered[k] = (lo[k] + hi[k]) * 0.5f;
    float dir = filtered[k] - h[k];
    dir = fabsf(dir) < 1e-5f ? 1e-5f : dir;
    const float inv = 1.0f / dir;
    const float t_min = (lo[k] - h[k]) * inv;
    const float t_max = (hi[k] - h[k]) * inv;
    enter[k] = min_nan(t_min, t_max);
  }
  const float t = clamp(amax3({enter[0], enter[1], enter[2]}), 0.0f, 1.0f);

  // 5. motion-adaptive blend, back to rgb, untonemapped
  const float a = __ldg(alpha + p);
  float res[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float hc = h[k] + (filtered[k] - h[k]) * t;
    res[k] = hc + (cur_c[k] - hc) * a;
  }
  const C3 rgb = {res[0] + res[1] - res[2], res[0] + res[2],
                  res[0] - res[1] - res[2]};
  const float den = clamp_min(1.0f - amax3(rgb), 0.0001f);
  float* o = out + p * 3;
  o[0] = rgb.x / den;
  o[1] = rgb.y / den;
  o[2] = rgb.z / den;
}

dim3 grid_of(int H, int W) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
}

}  // namespace

HR_EXPORT int hr_taa_reproject(const void* depth, const void* motion,
                               int ms0, int ms1, const void* jitter,
                               const void* prev_jitter, int H, int W,
                               int row0, int FH, int history_valid,
                               void* prev_uv, void* alpha, void* stream) {
  if (H > 0 && W > 0) {
    taa_reproject_kernel<<<grid_of(H, W), dim3(kTileW, kTileH), 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(depth), static_cast<const float*>(motion),
        ms0, ms1, static_cast<const float*>(jitter),
        static_cast<const float*>(prev_jitter), H, W, row0, FH,
        history_valid, static_cast<float*>(prev_uv),
        static_cast<float*>(alpha));
  }
  HR_RETURN_LAUNCH_STATUS();
}

HR_EXPORT int hr_taa_resolve(const void* cur, const void* hist,
                             const void* alpha, int H, int W, void* out,
                             void* stream) {
  if (H > 0 && W > 0) {
    taa_resolve_kernel<<<grid_of(H, W), dim3(kTileW, kTileH), 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cur), static_cast<const float*>(hist),
        static_cast<const float*>(alpha), H, W, static_cast<float*>(out));
  }
  HR_RETURN_LAUNCH_STATUS();
}
