// Shared helpers for the port's CUDA kernels.
//
// The library is compiled with -fmad=false: no multiply-add contraction,
// so an expression written in the same order as its plain PyTorch
// version rounds the same way at every step.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HR_EXPORT extern "C" __attribute__((visibility("default")))

// the C entry points return cudaGetLastError() after their launches
#define HR_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())

__device__ __forceinline__ int hr_clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Rec.709 luma, summed left to right as ops/shade.luminance does
__device__ __forceinline__ float hr_luma(float r, float g, float b) {
  return 0.2126f * r + 0.7152f * g + 0.0722f * b;
}
