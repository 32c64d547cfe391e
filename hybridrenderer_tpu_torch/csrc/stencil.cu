// K4: the SVGF spatial stencils — filter_moments, variance_blur, atrous.
//
// Replaces hybridrenderer_tpu/ops/stencil_pallas.py: filter_moments
// (:246), variance_blur (:308) and atrous (:183), which share
// _stencil_call (:102) and edge_stack (:90). Same contract as those (and
// as the jnp versions in ops/svgf.py): clamp-to-edge borders,
// edge-stopping weights from luma against variance, a power of the
// normals' dot product and the linear-depth gradient.
//
// Design of filter_moments and atrous: one thread per output pixel, and
// a block stages its tile's window (the outputs plus the halo the taps
// reach) into shared memory once, with coalesced loads, before any tap
// is taken. Each staged pixel holds only the channels a stencil reads,
// one plane per channel: r, g, b, luma (hr_luma, once per pixel instead
// of once per tap), normal x, y, z and linear depth, then the variance
// (atrous) or the moments m1, m2 (filter_moments); the centre's depth
// gradient, history length and variance come from global memory. A halo
// pixel holds the value at its clamped coordinate, which is what the
// per-tap clamp of the plain version reads, for every image size. Every
// tap then reads shared memory only, consecutive threads at consecutive
// words (no bank conflicts).
//
// Staging took the traffic away but hardly the time: the taps are bound
// by issue, and powf is half of a tap's instructions. The normal weight
// max(0, n_c . n_q) ** phi_n is symmetric in (c, q) bit for bit (the
// same three products summed in the same order), so the block computes
// it once per pixel pair into shared memory (NormalWeights): 13.4 powf
// per atrous output instead of 24, 29.1 per filter_moments output
// instead of 49.
//
//  * filter_moments: 32x16 outputs per block, a 38x22 window of 10
//    planes and 24 weight planes (100 KB, two blocks an SM).
//  * atrous at step s: the block's outputs are 32x16 pixels s apart in x
//    and y (one of the s^2 phases of a 32s x 16s region), so its 5x5
//    taps at distance s fall on a 36x20 window of pixels s apart: 1.4
//    staged pixels per output and 56 KB (with 12 weight planes) at every
//    step, where a dense 32x16 tile at step 4 would stage 48x32 (3 per
//    output). Blocks of one region's phases are adjacent in launch
//    order, so their strided loads and stores share cache sectors in
//    L2. Background pixels (depth 0 or beyond 1000) output their signal
//    without taking taps, and a block with no other pixel computes no
//    weights.
// Of 8, 16 and 32 rows a tile, 16 was the fastest for both on the H100:
// fewer rows pay more halo per output, 32 rows hold one block an SM.
//
// Bound on the card: not the memory traffic (each input byte crosses
// HBM about once) but the issue of the per-tap arithmetic: an accurate
// expf, two IEEE divisions, the pow's share, and the weighted sums (no
// fast-math intrinsics: the SVGF chains are chaotic at shadow edges, and
// a last-ulp change moves the goldens). All sums run in the plain
// version's order (ops/stencil_cuda.py), with its operands, so outputs
// equal the direct per-tap kernel's bit for bit and match the plain
// version to the last ulp of exp and pow. variance_blur keeps the direct
// design (a thread per pixel, 9 cached taps): it reaches 60% of its
// bound and no render path launches it.
#include "common.cuh"

namespace {

struct Pix {
  int x, y;
  size_t p;
};

__device__ __forceinline__ bool pixel(int H, int W, Pix* px) {
  px->x = blockIdx.x * blockDim.x + threadIdx.x;
  px->y = blockIdx.y * blockDim.y + threadIdx.y;
  px->p = static_cast<size_t>(px->y) * W + px->x;
  return px->x < W && px->y < H;
}

__device__ __forceinline__ size_t tap(int x, int y, int dx, int dy, int H,
                                      int W) {
  return static_cast<size_t>(hr_clampi(y + dy, 0, H - 1)) * W +
         hr_clampi(x + dx, 0, W - 1);
}

// planes of a staged window
enum Plane { kR, kG, kB, kLuma, kNx, kNy, kNz, kZ, kVar, kM1 = kVar, kM2 };

// A block's window: kBX x kBY outputs and kHalo staged pixels around
// them; plane k of staged pixel i lives at s[k * kN + i].
template <int kBX_, int kBY_, int kHalo_, bool kMoments>
struct Window {
  static constexpr int kBX = kBX_, kBY = kBY_, kHalo = kHalo_;
  static constexpr int kSW = kBX + 2 * kHalo;
  static constexpr int kN = kSW * (kBY + 2 * kHalo);
  static constexpr int kPlanes = kMoments ? kM2 + 1 : kVar + 1;

  // Stage staged pixel (sx, sy) from image pixel
  // (clamp(ox + stride * sx), clamp(oy + stride * sy)).
  static __device__ __forceinline__ void stage(
      const float* __restrict__ sig, const float* __restrict__ mom,
      const float* __restrict__ normal, const float* __restrict__ mp, int H,
      int W, int ox, int oy, int stride, float* s) {
    for (int i = threadIdx.y * kBX + threadIdx.x; i < kN; i += kBX * kBY) {
      const int sy = i / kSW;
      const int sx = i - sy * kSW;
      const size_t q =
          static_cast<size_t>(hr_clampi(oy + stride * sy, 0, H - 1)) * W +
          hr_clampi(ox + stride * sx, 0, W - 1);
      const float4 c = reinterpret_cast<const float4*>(sig)[q];
      s[kR * kN + i] = c.x;
      s[kG * kN + i] = c.y;
      s[kB * kN + i] = c.z;
      s[kLuma * kN + i] = hr_luma(c.x, c.y, c.z);
      s[kNx * kN + i] = normal[3 * q];
      s[kNy * kN + i] = normal[3 * q + 1];
      s[kNz * kN + i] = normal[3 * q + 2];
      s[kZ * kN + i] = mp[4 * q + 2];
      if constexpr (kMoments) {
        const float2 m = reinterpret_cast<const float2*>(mom)[2 * q];
        s[kM1 * kN + i] = m.x;
        s[kM2 * kN + i] = m.y;
      } else {
        s[kVar * kN + i] = c.w;
      }
    }
  }

  // staged index of the output at thread (threadIdx.x, threadIdx.y)
  static __device__ __forceinline__ int centre() {
    return (threadIdx.y + kHalo) * kSW + threadIdx.x + kHalo;
  }
};

// The normal weights w_n(c, q) = max(0, n_c . n_q) ** phi_n of a
// (2 kRad + 1)^2 stencil whose taps are one window pixel apart, computed
// once per unordered pair of window pixels: n_c . n_q and n_q . n_c sum
// the same three products in the same order, so w_n(c, q) = w_n(q, c)
// bit for bit. Forward offset k (dy > 0, or dy = 0 and dx > 0) of pixel
// i lives at w[k * kWN + i], over the window's rows [0, kRad + kBY); the
// tap at -d_k of output c reads the forward weight of pixel c - d_k.
// The stencil's radius kRad is the window's halo.
template <class Win>
struct NormalWeights {
  static constexpr int kBX = Win::kBX, kBY = Win::kBY, kRad = Win::kHalo;
  static constexpr int kSide = 2 * kRad + 1;
  static constexpr int kForward = (kSide * kSide - 1) / 2;
  static constexpr int kSW = Win::kSW;
  static constexpr int kWN = kSW * (kRad + kBY);
  static constexpr int kFloats = kForward * kWN;
  // atrous' 12 offsets run faster unrolled; filter_moments' 24 rolled,
  // where 48 inlined copies of powf's code would double the kernel
  static constexpr int kUnroll = kForward <= 12 ? kForward : 1;

  static __host__ __device__ constexpr int dx(int k) {
    return k < kRad ? k + 1 : (k - kRad) % kSide - kRad;
  }
  static __host__ __device__ constexpr int dy(int k) {
    return k < kRad ? 0 : (k - kRad) / kSide + 1;
  }
  // the forward offset (dx, dy) → k
  static __host__ __device__ constexpr int index(int x, int y) {
    return y == 0 ? x - 1 : kRad + (y - 1) * kSide + x + kRad;
  }

  static __device__ __forceinline__ float pair(const float* s, int i, int q,
                                               float phi_n) {
    constexpr int kN = Win::kN;
    const float ndot = s[kNx * kN + i] * s[kNx * kN + q] +
                       s[kNy * kN + i] * s[kNy * kN + q] +
                       s[kNz * kN + i] * s[kNz * kN + q];
    return powf(fmaxf(0.0f, ndot), phi_n);
  }

  // Every forward weight a tap of the block's outputs reads: each thread
  // those of its own output; then the window pixels above and beside
  // the outputs, those whose partner is an output. Ends with a barrier.
  static __device__ __forceinline__ void compute(const float* s, float* w,
                                                 float phi_n) {
    const int c = Win::centre();
#pragma unroll (kUnroll)
    for (int k = 0; k < kForward; ++k) {
      w[k * kWN + c] = pair(s, c, c + dy(k) * kSW + dx(k), phi_n);
    }
    constexpr int kTop = kRad * kSW;
    constexpr int kBorder = kTop + 2 * kRad * kBY;
    for (int e = threadIdx.y * kBX + threadIdx.x; e < kBorder;
         e += kBX * kBY) {
      int wy, wx;
      if (e < kTop) {
        wy = e / kSW;
        wx = e - wy * kSW;
      } else {   // the kRad columns on each side, column by column
        const int col = (e - kTop) / kBY;
        wy = kRad + (e - kTop) - col * kBY;
        wx = col < kRad ? col : kBX + col;
      }
      const int i = wy * kSW + wx;
#pragma unroll (kUnroll)
      for (int k = 0; k < kForward; ++k) {
        const int tx = wx + dx(k) - kRad, ty = wy + dy(k) - kRad;
        if (tx >= 0 && tx < kBX && ty >= 0 && ty < kBY) {
          w[k * kWN + i] = pair(s, i, i + dy(k) * kSW + dx(k), phi_n);
        }
      }
    }
    __syncthreads();
  }

  // w_n of output c (centre()) and its tap at (x, y), (x, y) != (0, 0)
  static __device__ __forceinline__ float at(const float* w, int c, int x,
                                             int y) {
    if (y > 0 || (y == 0 && x > 0)) return w[index(x, y) * kWN + c];
    return w[index(-x, -y) * kWN + c + y * kSW + x];
  }
};

// dynamic shared memory above the default 48 KB needs the attribute
template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 grid, dim3 block, int smem,
           void* stream, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  HR_RETURN_LAUNCH_STATUS();
}

constexpr int kAtrousBX = 32, kAtrousBY = 16;
using AtrousWindow = Window<kAtrousBX, kAtrousBY, 2, false>;
using AtrousWeights = NormalWeights<AtrousWindow>;
constexpr int kAtrousSmem =
    (AtrousWindow::kPlanes * AtrousWindow::kN + AtrousWeights::kFloats) *
    static_cast<int>(sizeof(float));

// blockIdx.x = tile * step + phase (x), the same in y
__global__ void __launch_bounds__(kAtrousBX * kAtrousBY)
atrous_kernel(const float* __restrict__ sig,
              const float* __restrict__ normal,
              const float* __restrict__ mp, int H, int W, int step,
              float phi_l_scale, float phi_n, float* __restrict__ out) {
  using Win = AtrousWindow;
  constexpr int kN = Win::kN, kSW = Win::kSW;
  extern __shared__ float s[];
  float* wn = s + Win::kPlanes * kN;
  const int tile_x = blockIdx.x / step, tile_y = blockIdx.y / step;
  // image coordinates of the block's first output, and of staged (0, 0)
  const int bx = blockIdx.x - tile_x * step + step * kAtrousBX * tile_x;
  const int by = blockIdx.y - tile_y * step + step * kAtrousBY * tile_y;
  Win::stage(sig, nullptr, normal, mp, H, W, bx - 2 * step, by - 2 * step,
             step, s);
  __syncthreads();
  const int x = bx + step * threadIdx.x, y = by + step * threadIdx.y;
  const bool inside = x < W && y < H;
  const int c = Win::centre();
  const float z_c = s[kZ * kN + c];
  // background: the signal as it is, and no taps; a block of background
  // computes no weights (the barrier's result is the same in every thread)
  const bool bg = z_c == 0.0f || z_c > 1000.0f;
  if (__syncthreads_or(inside && !bg)) AtrousWeights::compute(s, wn, phi_n);
  if (!inside) return;
  const size_t p = static_cast<size_t>(y) * W + x;
  const float r = s[kR * kN + c], g = s[kG * kN + c], b = s[kB * kN + c];
  const float var_c = s[kVar * kN + c];
  if (bg) {
    reinterpret_cast<float4*>(out)[p] = make_float4(r, g, b, var_c);
    return;
  }
  const float kw[3] = {3.0f / 8.0f, 1.0f / 4.0f, 1.0f / 16.0f};
  const float luma_c = s[kLuma * kN + c];
  const float phi_luma = phi_l_scale * sqrtf(fmaxf(0.0f, 1e-10f + var_c)) +
                         1e-6f;
  const float phi_z_base = fmaxf(mp[4 * p + 3], 1e-8f) *
                           static_cast<float>(step) + 1e-6f;
  const float w_center = kw[0] * kw[0];
  float sum_w = w_center;
  float acc_r = r * w_center, acc_g = g * w_center, acc_b = b * w_center;
  float acc_v = var_c * w_center;
#pragma unroll
  for (int yy = -2; yy <= 2; ++yy) {
#pragma unroll
    for (int xx = -2; xx <= 2; ++xx) {
      if (xx == 0 && yy == 0) continue;
      const int q = c + yy * kSW + xx;
      const float k = kw[abs(xx)] * kw[abs(yy)];
      const float dist = sqrtf(static_cast<float>(xx * xx + yy * yy));
      const float pr = s[kR * kN + q], pg = s[kG * kN + q],
                  pb = s[kB * kN + q];
      const float w_n = AtrousWeights::at(wn, c, xx, yy);
      const float w_z = fabsf(z_c - s[kZ * kN + q]) / (phi_z_base * dist);
      const float w_l = fabsf(luma_c - s[kLuma * kN + q]) / phi_luma;
      const float w = expf(-w_l - w_z) * w_n * k;
      sum_w = sum_w + w;
      acc_r = acc_r + pr * w;
      acc_g = acc_g + pg * w;
      acc_b = acc_b + pb * w;
      acc_v = acc_v + s[kVar * kN + q] * w * w;
    }
  }
  reinterpret_cast<float4*>(out)[p] =
      make_float4(acc_r / sum_w, acc_g / sum_w, acc_b / sum_w,
                  acc_v / (sum_w * sum_w));
}

constexpr int kMomentsBX = 32, kMomentsBY = 16;
using MomentsWindow = Window<kMomentsBX, kMomentsBY, 3, true>;
using MomentsWeights = NormalWeights<MomentsWindow>;
constexpr int kMomentsSmem =
    (MomentsWindow::kPlanes * MomentsWindow::kN + MomentsWeights::kFloats) *
    static_cast<int>(sizeof(float));

__global__ void __launch_bounds__(kMomentsBX * kMomentsBY)
filter_moments_kernel(const float* __restrict__ sig,
                      const float* __restrict__ mom,
                      const float* __restrict__ normal,
                      const float* __restrict__ mp, int H, int W,
                      float phi_luma, float phi_n,
                      float* __restrict__ out_sig,
                      float* __restrict__ out_mom) {
  using Win = MomentsWindow;
  constexpr int kN = Win::kN, kSW = Win::kSW;
  extern __shared__ float s[];
  float* wn = s + Win::kPlanes * kN;
  const int bx = blockIdx.x * kMomentsBX, by = blockIdx.y * kMomentsBY;
  Win::stage(sig, mom, normal, mp, H, W, bx - 3, by - 3, 1, s);
  __syncthreads();
  MomentsWeights::compute(s, wn, phi_n);
  const int x = bx + threadIdx.x, y = by + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t p = static_cast<size_t>(y) * W + x;
  const int c = Win::centre();
  const float luma_c = s[kLuma * kN + c];
  const float z_c = s[kZ * kN + c];
  const float phi_z_base = fmaxf(mp[4 * p + 3], 1e-8f) * 3.0f;
  float sum_w = 0.0f;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int yy = -3; yy <= 3; ++yy) {
#pragma unroll
    for (int xx = -3; xx <= 3; ++xx) {
      const int q = c + yy * kSW + xx;
      const float dist = sqrtf(static_cast<float>(xx * xx + yy * yy));
      const float pr = s[kR * kN + q], pg = s[kG * kN + q],
                  pb = s[kB * kN + q];
      const float w_n = xx == 0 && yy == 0
                            ? MomentsWeights::pair(s, c, c, phi_n)
                            : MomentsWeights::at(wn, c, xx, yy);
      const float w_z = fabsf(z_c - s[kZ * kN + q]) /
                        (phi_z_base * dist + 1e-6f);
      const float w_l = fabsf(luma_c - s[kLuma * kN + q]) / phi_luma;
      const float w = expf(-w_l - w_z) * w_n;
      sum_w = sum_w + w;
      acc[0] = acc[0] + pr * w;
      acc[1] = acc[1] + pg * w;
      acc[2] = acc[2] + pb * w;
      acc[3] = acc[3] + s[kM1 * kN + q] * w;
      acc[4] = acc[4] + s[kM2 * kN + q] * w;
    }
  }
  sum_w = fmaxf(sum_w, 1e-6f);
  const float m1 = acc[3] / sum_w;
  const float m2 = acc[4] / sum_w;
  const bool bg = z_c == 0.0f;
  const float4 sc = reinterpret_cast<const float4*>(sig)[p];
  float variance = fmaxf(0.0f, m2 - m1 * m1);
  const float hlen = mom[4 * p + 3];
  // <4-frame variance boost
  if (hlen < 4.0f) variance = variance * (4.0f / fmaxf(1.0f, hlen));
  if (bg) variance = sc.w;
  reinterpret_cast<float4*>(out_sig)[p] =
      bg ? make_float4(sc.x, sc.y, sc.z, variance)
         : make_float4(acc[0] / sum_w, acc[1] / sum_w, acc[2] / sum_w,
                       variance);
  reinterpret_cast<float4*>(out_mom)[p] = make_float4(m1, m2, variance, hlen);
}

__global__ void variance_blur_kernel(const float* __restrict__ mom, int H,
                                     int W, float* __restrict__ out) {
  Pix c;
  if (!pixel(H, W, &c)) return;
  const size_t p = c.p;
  const float k1[3] = {1.0f, 2.0f, 1.0f};
  float blurred = 0.0f;
  float vmax = -INFINITY;
  for (int yy = -1; yy <= 1; ++yy) {
    for (int xx = -1; xx <= 1; ++xx) {
      const float v = mom[4 * tap(c.x, c.y, xx, yy, H, W) + 2];
      blurred = blurred + v * (k1[xx + 1] * k1[yy + 1]);
      vmax = fmaxf(vmax, v);
    }
  }
  out[4 * p] = mom[4 * p];
  out[4 * p + 1] = mom[4 * p + 1];
  out[4 * p + 2] = 0.5f * (blurred / 16.0f) + 0.5f * vmax;
  out[4 * p + 3] = mom[4 * p + 3];
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// sig and out 16-byte aligned (float4 loads and stores)
HR_EXPORT int hr_atrous(const void* sig, const void* normal, const void* mp,
                        int H, int W, int step, float phi_l_scale,
                        float phi_n, void* out, void* stream) {
  if (step < 1) return static_cast<int>(cudaErrorInvalidValue);
  // per phase at most ceil(W / step) x ceil(H / step) outputs
  const dim3 grid(ceil_div(ceil_div(W, step), kAtrousBX) * step,
                  ceil_div(ceil_div(H, step), kAtrousBY) * step);
  return launch(atrous_kernel, grid, dim3(kAtrousBX, kAtrousBY), kAtrousSmem,
                stream, static_cast<const float*>(sig),
                static_cast<const float*>(normal),
                static_cast<const float*>(mp), H, W, step, phi_l_scale, phi_n,
                static_cast<float*>(out));
}

// sig, out_sig and out_mom 16-byte aligned, mom 8-byte aligned
HR_EXPORT int hr_filter_moments(const void* sig, const void* mom,
                                const void* normal, const void* mp, int H,
                                int W, float phi_luma, float phi_n,
                                void* out_sig, void* out_mom, void* stream) {
  const dim3 grid(ceil_div(W, kMomentsBX), ceil_div(H, kMomentsBY));
  return launch(filter_moments_kernel, grid, dim3(kMomentsBX, kMomentsBY),
                kMomentsSmem, stream, static_cast<const float*>(sig),
                static_cast<const float*>(mom),
                static_cast<const float*>(normal),
                static_cast<const float*>(mp), H, W, phi_luma, phi_n,
                static_cast<float*>(out_sig), static_cast<float*>(out_mom));
}

HR_EXPORT int hr_variance_blur(const void* mom, int H, int W, void* out,
                               void* stream) {
  variance_blur_kernel<<<dim3(ceil_div(W, 32), ceil_div(H, 8)), dim3(32, 8),
                         0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mom), H, W, static_cast<float*>(out));
  HR_RETURN_LAUNCH_STATUS();
}
