// Soft threshold, the L1 proximal operator: y = sign(x) * max(|x| - t, 0).
//
// Replaces: src/repro/kernels/soft_threshold.py `soft_threshold_2d`
// (_kernel): computed in float32, written in x's dtype (float32 or
// bfloat16).
//
// What bounds it on an H100: bytes.  Each element is read once and written
// once (8 bytes in float32, 4 in bfloat16) for 4 operations, far under the
// card's ~20 operations per byte in fp32: a 1024 x 1024 float32 tensor moves
// 8.4 MB, 2.5 us at 3.35 TB/s.
//
// Design.  One grid-stride loop over the flattened tensor, 16-byte loads and
// stores (4 floats or 8 bfloat16 values a thread) when both pointers are
// 16-byte aligned, then a scalar tail.  The TPU kernel pads the tensor to
// (256, 256) tiles; here nothing is padded or copied.  In float32 the result
// is bit-equal to the reference: |x| - t is one rounding and the sign
// product is exact.  A NaN stays NaN, as in the reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float shrink(float x, float t) {
  float v = fabsf(x) - t;
  v = v < 0.f ? 0.f : v;  // max(v, 0) that lets a NaN through
  const float sg = static_cast<float>((x > 0.f) - (x < 0.f));
  return sg * v;
}

__global__ void soft_threshold_f32(const float* __restrict__ x,
                                   float* __restrict__ y, long long n, float t,
                                   int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* y4 = reinterpret_cast<float4*>(y);
    for (long long k = tid; k < n4; k += stride) {
      float4 v = x4[k];
      v.x = shrink(v.x, t);
      v.y = shrink(v.y, t);
      v.z = shrink(v.z, t);
      v.w = shrink(v.w, t);
      y4[k] = v;
    }
    done = n4 * 4;
  }
  for (long long k = done + tid; k < n; k += stride) y[k] = shrink(x[k], t);
}

__global__ void soft_threshold_bf16(const __nv_bfloat16* __restrict__ x,
                                    __nv_bfloat16* __restrict__ y, long long n,
                                    float t, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n8 = n / 8;
    const uint4* x8 = reinterpret_cast<const uint4*>(x);
    uint4* y8 = reinterpret_cast<uint4*>(y);
    for (long long k = tid; k < n8; k += stride) {
      uint4 v = x8[k];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float2 f = __bfloat1622float2(h[p]);
        h[p] = __floats2bfloat162_rn(shrink(f.x, t), shrink(f.y, t));
      }
      y8[k] = v;
    }
    done = n8 * 8;
  }
  for (long long k = done + tid; k < n; k += stride)
    y[k] = __float2bfloat16_rn(shrink(__bfloat162float(x[k]), t));
}

}  // namespace

// x and y contiguous, n elements of one dtype: dtype 0 = float32,
// 1 = bfloat16.  y may not alias x.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int soft_threshold(const void* x, void* y, long long n, float t,
                              int dtype, int n_sm, void* stream) {
  if (n <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const long long per = vec ? (dtype == 0 ? 4 : 8) : 1;
  const int threads = 256;
  long long blocks = (n / per + threads - 1) / threads;
  const long long cap = (long long)n_sm * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    soft_threshold_f32<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, t, vec);
  else
    soft_threshold_bf16<<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, t, vec);
  return static_cast<int>(cudaGetLastError());
}
