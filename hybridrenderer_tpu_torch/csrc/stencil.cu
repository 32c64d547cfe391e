// K4: the SVGF spatial stencils — filter_moments, variance_blur, atrous.
//
// Replaces hybridrenderer_tpu/ops/stencil_pallas.py: filter_moments
// (:246), variance_blur (:308) and atrous (:183), which share
// _stencil_call (:102) and edge_stack (:90). Same contract as those (and
// as the jnp versions in ops/svgf.py): clamp-to-edge borders,
// edge-stopping weights from luma against variance, a power of the
// normals' dot product and the linear-depth gradient.
//
// Design: one thread per pixel; every tap is read straight from global
// memory at a clamped coordinate (the neighbourhood is shared by the
// block and stays in L1/L2). The TPU kernels' padded (+16, +256) halo
// windows and pre-padded edge stack existed for aligned DMAs and are not
// kept. Bound on the card: memory traffic of the taps (7x7 x 36 B for
// filter_moments, 24 x 32 B for atrous), mostly cache hits; the exp and
// pow per tap are the arithmetic. All sums run in the plain version's
// order (ops/stencil_cuda.py).
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

// the normal-similarity weight max(0, n_c . n_p) ** phi_n
__device__ __forceinline__ float normal_weight(const float* n, size_t c,
                                               size_t q, float phi_n) {
  const float ndot = n[3 * c] * n[3 * q] + n[3 * c + 1] * n[3 * q + 1] +
                     n[3 * c + 2] * n[3 * q + 2];
  return powf(fmaxf(0.0f, ndot), phi_n);
}

__global__ void atrous_kernel(const float* __restrict__ sig,
                              const float* __restrict__ normal,
                              const float* __restrict__ mp, int H, int W,
                              int step, float phi_l_scale, float phi_n,
                              float* __restrict__ out) {
  Pix c;
  if (!pixel(H, W, &c)) return;
  const size_t p = c.p;
  const float kw[3] = {3.0f / 8.0f, 1.0f / 4.0f, 1.0f / 16.0f};
  const float r = sig[4 * p], g = sig[4 * p + 1], b = sig[4 * p + 2];
  const float var_c = sig[4 * p + 3];
  const float luma_c = hr_luma(r, g, b);
  const float z_c = mp[4 * p + 2];
  const float phi_luma = phi_l_scale * sqrtf(fmaxf(0.0f, 1e-10f + var_c)) +
                         1e-6f;
  const float phi_z_base = fmaxf(mp[4 * p + 3], 1e-8f) *
                           static_cast<float>(step) + 1e-6f;
  const float w_center = kw[0] * kw[0];
  float sum_w = w_center;
  float acc_r = r * w_center, acc_g = g * w_center, acc_b = b * w_center;
  float acc_v = var_c * w_center;
  for (int yy = -2; yy <= 2; ++yy) {
    for (int xx = -2; xx <= 2; ++xx) {
      if (xx == 0 && yy == 0) continue;
      const size_t q = tap(c.x, c.y, xx * step, yy * step, H, W);
      const float k = kw[abs(xx)] * kw[abs(yy)];
      const float dist = sqrtf(static_cast<float>(xx * xx + yy * yy));
      const float pr = sig[4 * q], pg = sig[4 * q + 1], pb = sig[4 * q + 2];
      const float w_n = normal_weight(normal, p, q, phi_n);
      const float w_z = fabsf(z_c - mp[4 * q + 2]) / (phi_z_base * dist);
      const float w_l = fabsf(luma_c - hr_luma(pr, pg, pb)) / phi_luma;
      const float w = expf(-w_l - w_z) * w_n * k;
      sum_w = sum_w + w;
      acc_r = acc_r + pr * w;
      acc_g = acc_g + pg * w;
      acc_b = acc_b + pb * w;
      acc_v = acc_v + sig[4 * q + 3] * w * w;
    }
  }
  const bool bg = z_c == 0.0f || z_c > 1000.0f;
  out[4 * p] = bg ? r : acc_r / sum_w;
  out[4 * p + 1] = bg ? g : acc_g / sum_w;
  out[4 * p + 2] = bg ? b : acc_b / sum_w;
  out[4 * p + 3] = bg ? var_c : acc_v / (sum_w * sum_w);
}

__global__ void filter_moments_kernel(const float* __restrict__ sig,
                                      const float* __restrict__ mom,
                                      const float* __restrict__ normal,
                                      const float* __restrict__ mp, int H,
                                      int W, float phi_luma, float phi_n,
                                      float* __restrict__ out_sig,
                                      float* __restrict__ out_mom) {
  Pix c;
  if (!pixel(H, W, &c)) return;
  const size_t p = c.p;
  const float luma_c = hr_luma(sig[4 * p], sig[4 * p + 1], sig[4 * p + 2]);
  const float z_c = mp[4 * p + 2];
  const float phi_z_base = fmaxf(mp[4 * p + 3], 1e-8f) * 3.0f;
  float sum_w = 0.0f;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int yy = -3; yy <= 3; ++yy) {
    for (int xx = -3; xx <= 3; ++xx) {
      const size_t q = tap(c.x, c.y, xx, yy, H, W);
      const float dist = sqrtf(static_cast<float>(xx * xx + yy * yy));
      const float pr = sig[4 * q], pg = sig[4 * q + 1], pb = sig[4 * q + 2];
      const float w_n = normal_weight(normal, p, q, phi_n);
      const float w_z = fabsf(z_c - mp[4 * q + 2]) /
                        (phi_z_base * dist + 1e-6f);
      const float w_l = fabsf(luma_c - hr_luma(pr, pg, pb)) / phi_luma;
      const float w = expf(-w_l - w_z) * w_n;
      sum_w = sum_w + w;
      acc[0] = acc[0] + pr * w;
      acc[1] = acc[1] + pg * w;
      acc[2] = acc[2] + pb * w;
      acc[3] = acc[3] + mom[4 * q] * w;
      acc[4] = acc[4] + mom[4 * q + 1] * w;
    }
  }
  sum_w = fmaxf(sum_w, 1e-6f);
  const float m1 = acc[3] / sum_w;
  const float m2 = acc[4] / sum_w;
  const bool bg = z_c == 0.0f;
  float variance = fmaxf(0.0f, m2 - m1 * m1);
  const float hlen = mom[4 * p + 3];
  // <4-frame variance boost
  if (hlen < 4.0f) variance = variance * (4.0f / fmaxf(1.0f, hlen));
  if (bg) variance = sig[4 * p + 3];
  out_sig[4 * p] = bg ? sig[4 * p] : acc[0] / sum_w;
  out_sig[4 * p + 1] = bg ? sig[4 * p + 1] : acc[1] / sum_w;
  out_sig[4 * p + 2] = bg ? sig[4 * p + 2] : acc[2] / sum_w;
  out_sig[4 * p + 3] = variance;
  out_mom[4 * p] = m1;
  out_mom[4 * p + 1] = m2;
  out_mom[4 * p + 2] = variance;
  out_mom[4 * p + 3] = hlen;
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

const dim3 kBlock(32, 8);

dim3 grid_for(int H, int W) { return dim3((W + 31) / 32, (H + 7) / 8); }

}  // namespace

HR_EXPORT int hr_atrous(const void* sig, const void* normal, const void* mp,
                        int H, int W, int step, float phi_l_scale,
                        float phi_n, void* out, void* stream) {
  atrous_kernel<<<grid_for(H, W), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(normal),
      static_cast<const float*>(mp), H, W, step, phi_l_scale, phi_n,
      static_cast<float*>(out));
  HR_RETURN_LAUNCH_STATUS();
}

HR_EXPORT int hr_filter_moments(const void* sig, const void* mom,
                                const void* normal, const void* mp, int H,
                                int W, float phi_luma, float phi_n,
                                void* out_sig, void* out_mom, void* stream) {
  filter_moments_kernel<<<grid_for(H, W), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(mom),
      static_cast<const float*>(normal), static_cast<const float*>(mp), H, W,
      phi_luma, phi_n, static_cast<float*>(out_sig),
      static_cast<float*>(out_mom));
  HR_RETURN_LAUNCH_STATUS();
}

HR_EXPORT int hr_variance_blur(const void* mom, int H, int W, void* out,
                               void* stream) {
  variance_blur_kernel<<<grid_for(H, W), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mom), H, W, static_cast<float*>(out));
  HR_RETURN_LAUNCH_STATUS();
}
