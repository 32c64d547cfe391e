// The G-buffer planes from K1's visibility buffer and attribute image.
//
// The reference builds them in plain jnp
// (hybridrenderer_tpu/ops/gbuffer.py _gbuffer_from_kernel_attrs :217 and
// _finish_gbuffer :240); there is no TPU kernel. As plain PyTorch the
// build was some 80 elementwise launches, 150 with the texture taps, each
// reading and writing whole (H, W, k) planes. Here it is one thread a
// pixel (ops/gbuffer_cuda.py, plain version ``gbuffer_planes_plain``):
//
// hr_gbuffer reads the pixel's winner (tri_id, reversed-Z depth) and its
// row of the (H, W, 40) attribute image (world position at 0, previous
// world position at 3, normal at 6, tangent and its sign at 9, uv at 13,
// the packed material row at 16, the instance at 33), staged a block at
// a time through shared memory in coalesced float4 loads. It normalizes
// the normal twice (the G-buffer's world normal, then the shading
// normal's), evaluates the material point with its texture taps and the
// normal map (surface.cuh, shared with the hit shading), the uv motion
// between the unjittered current and previous view-projections (each a
// left-to-right sum of products, w guarded at 1e-6), the linear depth
// (w guarded at 1e-12) of itself, its right and its lower neighbour, and
// their forward differences, clamped at the last column and at the last
// row; in a row window the lower neighbour of the last row is the next
// window's first row (``depth_below``, ``tri_below``). It writes every
// plane GBuffer holds but the depth, zero at background pixels (object
// id -1), the motion plane in the Motion RT layout (motion.xy, linear
// depth, d lin-z/dx).
//
// Bound: bytes. 160 B of attributes, 8 B of winner and about 8 B of
// neighbours in, 100 B of planes out a pixel; the texture taps of a
// bound slot add four 16-byte texels each, mostly from L2.
//
// Every float operation is the plain version's, in its order, under the
// library's -fmad=false, with PyTorch's own rules on the card
// (surface.cuh): a division by 255 is a multiplication by its float
// reciprocal, the norms sum x*x + z*z and y*y, then add them.
#include "surface.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kAttrs = 40;           // channels of the attribute image
constexpr int kVec = kAttrs / 4;     // its float4s a pixel
constexpr int kUsedVec = 9;          // the float4s read: channels 0-35

// gbuffer.linearize_depth, zero at background
__device__ __forceinline__ float linear_depth(float d, int tri,
                                              const float* pinv) {
  if (tri < 0) return 0.0f;
  const float z = pinv[10] * d + pinv[11];
  float w = pinv[14] * d + pinv[15];
  w = fabsf(w) < 1e-12f ? 1e-12f : w;
  return fabsf(z / w);
}

// maths.transform_point_h's w and the uv of its clip position
__device__ __forceinline__ float2 clip_uv(const float* m, V3 p) {
  float c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j] = ((p.x * m[4 * j] + p.y * m[4 * j + 1]) + p.z * m[4 * j + 2]) +
           m[4 * j + 3];
  }
  const float w = fabsf(c[3]) < 1e-6f ? 1e-6f : c[3];
  return make_float2((c[0] / w) * 0.5f + 0.5f, (c[1] / w) * 0.5f + 0.5f);
}

__global__ void __launch_bounds__(kThreads)
    gbuffer_kernel(HrTextures tex, const float* __restrict__ attrs,
                   const int* __restrict__ tri_id,
                   const float* __restrict__ depth,
                   const int* __restrict__ tri_below,
                   const float* __restrict__ depth_below,
                   const float* __restrict__ vp,
                   const float* __restrict__ prev_vp,
                   const float* __restrict__ pinv, int H, int W,
                   float* __restrict__ albedo, float* __restrict__ normal,
                   float4* __restrict__ material,
                   int* __restrict__ object_id,
                   float4* __restrict__ motion,
                   float2* __restrict__ depth_grad,
                   float* __restrict__ emissive,
                   float* __restrict__ world_pos,
                   float2* __restrict__ uv_out) {
  __shared__ float4 stage[kThreads * kVec];
  __shared__ float mats[48];  // vp, prev_vp, proj_inverse
  const long long P = static_cast<long long>(H) * W;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int count =
      static_cast<int>(P - first < kThreads ? P - first : kThreads);
  const float4* src = reinterpret_cast<const float4*>(attrs) + first * kVec;
  for (int k = threadIdx.x; k < count * kVec; k += kThreads) {
    if (k % kVec < kUsedVec) stage[k] = __ldg(src + k);
  }
  if (threadIdx.x < 16) {
    mats[threadIdx.x] = vp[threadIdx.x];
    mats[16 + threadIdx.x] = prev_vp[threadIdx.x];
    mats[32 + threadIdx.x] = pinv[threadIdx.x];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= count) return;
  const long long i = first + threadIdx.x;
  const int y = static_cast<int>(i / W);
  const int x = static_cast<int>(i - static_cast<long long>(y) * W);
  const int tri = tri_id[i];
  if (tri < 0) {  // background: zeros, object id -1
    store3(albedo + 3 * i, splat(0.0f));
    store3(normal + 3 * i, splat(0.0f));
    material[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    object_id[i] = -1;
    motion[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    depth_grad[i] = make_float2(0.0f, 0.0f);
    store3(emissive + 3 * i, splat(0.0f));
    store3(world_pos + 3 * i, splat(0.0f));
    uv_out[i] = make_float2(0.0f, 0.0f);
    return;
  }
  float a[kUsedVec * 4];
#pragma unroll
  for (int k = 0; k < kUsedVec; ++k) {
    const float4 q = stage[threadIdx.x * kVec + k];
    a[4 * k] = q.x;
    a[4 * k + 1] = q.y;
    a[4 * k + 2] = q.z;
    a[4 * k + 3] = q.w;
  }
  const V3 pos = load3(a);
  const V3 prev_pos = load3(a + 3);
  const float u = a[13], v = a[14];
  const float* mrow = a + 16;

  // the world normal, then the shading normal: normalized again, or
  // mapped where a material binds a normal texture
  V3 n = normalize(normalize(load3(a + 6)));
  if (tex.slots & 8) {
    n = normal_map(tex, n, normalize(load3(a + 9)), a[12],
                   static_cast<int>(mrow[13]), u, v);
  }
  const HrMaterialPoint mp = material_point(tex, mrow, u, v);
  const float model = static_cast<float>(static_cast<int>(mrow[9])) *
                      (1.0f / 255.0f);

  // motion from the unjittered current and previous clip positions
  const float2 cur = clip_uv(mats, pos);
  const float2 prev = clip_uv(mats + 16, prev_pos);

  // linear depth and its forward differences
  const float* pi = mats + 32;
  const float z = linear_depth(depth[i], tri, pi);
  const float z_right =
      x + 1 < W ? linear_depth(depth[i + 1], tri_id[i + 1], pi) : z;
  float z_down = z;
  if (y + 1 < H) {
    z_down = linear_depth(depth[i + W], tri_id[i + W], pi);
  } else if (tri_below != nullptr) {
    z_down = linear_depth(depth_below[x], tri_below[x], pi);
  }
  const float dzdx = z_right - z;

  store3(albedo + 3 * i, mp.colour);
  store3(normal + 3 * i, n);
  material[i] = make_float4(mp.roughness, mp.metallic, 1.0f, model);
  object_id[i] = static_cast<int>(a[33]);
  motion[i] = make_float4(cur.x - prev.x, cur.y - prev.y, z, dzdx);
  depth_grad[i] = make_float2(dzdx, z_down - z);
  store3(emissive + 3 * i, mp.emission);
  store3(world_pos + 3 * i, pos);
  uv_out[i] = make_float2(u, v);
}

}  // namespace

HR_EXPORT int hr_gbuffer(const HrTextures* tex, const void* attrs,
                         const void* tri_id, const void* depth,
                         const void* tri_below, const void* depth_below,
                         const void* vp, const void* prev_vp,
                         const void* proj_inverse, int H, int W,
                         void* albedo, void* normal, void* material,
                         void* object_id, void* motion, void* depth_grad,
                         void* emissive, void* world_pos, void* uv,
                         void* stream) {
  const long long P = static_cast<long long>(H) * W;
  if (P > 0) {
    gbuffer_kernel<<<static_cast<unsigned>((P + kThreads - 1) / kThreads),
                     kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        *tex, static_cast<const float*>(attrs),
        static_cast<const int*>(tri_id), static_cast<const float*>(depth),
        static_cast<const int*>(tri_below),
        static_cast<const float*>(depth_below),
        static_cast<const float*>(vp), static_cast<const float*>(prev_vp),
        static_cast<const float*>(proj_inverse), H, W,
        static_cast<float*>(albedo), static_cast<float*>(normal),
        static_cast<float4*>(material), static_cast<int*>(object_id),
        static_cast<float4*>(motion), static_cast<float2*>(depth_grad),
        static_cast<float*>(emissive), static_cast<float*>(world_pos),
        static_cast<float2*>(uv));
  }
  HR_RETURN_LAUNCH_STATUS();
}
