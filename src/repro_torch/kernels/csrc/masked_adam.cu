// Fused (masked) Adam step: one pass over a leaf.
//
// Replaces: src/repro/kernels/masked_adam.py `masked_adam_2d` (_kernel and
// _nomask_kernel): g <- g * mask (optional), mu <- b1 mu + (1-b1) g,
// nu <- b2 nu + (1-b2) g^2, p <- p - lr * (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps).
//
// What bounds it on an H100: bytes.  Per element it reads p, g, mu, nu (and
// the mask) and writes p, mu, nu: 28 (32) bytes for ~12 flops, far below the
// card's ~20 flops/byte fp32 balance point.
//
// Design.  One elementwise grid-stride loop, each element read once and
// written once, the mask an optional pointer (null = the unmasked variant,
// so no all-ones tensor is streamed).  The TPU kernel takes one scalar pair
// (1-b1^t, 1-b2^t) per call; here the corrections are PER ROW of a stacked
// leaf, read from device arrays: the mask-Adam state carries a per-client
// step vector and clients are selected on different iterations, so the S
// rows of a stacked (S, ...) mask leaf have different steps.  Keeping the
// corrections on the device means no host read of the step.  Built with
// -fmad=false so every multiply and add rounds as in the plain fp32 version.
// One launch per leaf, as the reference loops per leaf; a multi-tensor launch
// is later work.
#include <cuda_runtime.h>

namespace {

__global__ void masked_adam_kernel(
    const float* __restrict__ p, const float* __restrict__ g,
    const float* __restrict__ mu, const float* __restrict__ nu,
    const float* __restrict__ mask, const float* __restrict__ b1t,
    const float* __restrict__ b2t, float* __restrict__ p_out,
    float* __restrict__ mu_out, float* __restrict__ nu_out, long long n,
    long long row_len, float lr, float b1, float b2, float one_m_b1,
    float one_m_b2, float eps) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long row = i / row_len;
    float gi = g[i];
    if (mask != nullptr) gi = gi * mask[i];
    const float m = b1 * mu[i] + one_m_b1 * gi;
    const float v = b2 * nu[i] + one_m_b2 * gi * gi;
    const float mhat = m / b1t[row];
    const float nhat = v / b2t[row];
    p_out[i] = p[i] - lr * mhat / (sqrtf(nhat) + eps);
    mu_out[i] = m;
    nu_out[i] = v;
  }
}

}  // namespace

// All tensors float32, contiguous, n elements; b1t/b2t hold n / row_len
// values (1 - beta^step per row).  `mask` may be null.  Outputs may not alias
// inputs.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int masked_adam_f32(const void* p, const void* g, const void* mu,
                               const void* nu, const void* mask,
                               const void* b1t, const void* b2t, void* p_out,
                               void* mu_out, void* nu_out, long long n,
                               long long row_len, float lr, float b1, float b2,
                               float one_m_b1, float one_m_b2, float eps,
                               int n_sm, void* stream) {
  if (n <= 0 || row_len <= 0 || n % row_len != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)n_sm * 8;
  if (blocks > cap) blocks = cap;
  masked_adam_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(g),
      static_cast<const float*>(mu), static_cast<const float*>(nu),
      static_cast<const float*>(mask), static_cast<const float*>(b1t),
      static_cast<const float*>(b2t), static_cast<float*>(p_out),
      static_cast<float*>(mu_out), static_cast<float*>(nu_out), n, row_len, lr,
      b1, b2, one_m_b1, one_m_b2, eps);
  return static_cast<int>(cudaGetLastError());
}
