// Fused (masked) Adam step over many leaves in one launch.
//
// Replaces: src/repro/kernels/masked_adam.py `masked_adam_2d` (_kernel and
// _nomask_kernel): g <- g * mask (optional), mu <- b1 mu + (1-b1) g,
// nu <- b2 nu + (1-b2) g^2, p <- p - lr * (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps).
// The same kernel, in the other rounding order, also runs the client step's
// plain Adam (src/repro/optim/adam.py `adam_update`, which XLA computes:
// p <- p - lr * (mhat / (sqrt(nhat) + eps))).
//
// What bounds it on an H100: bytes.  Per element it reads p, g, mu, nu (and
// the mask) and writes p, mu, nu: 28 (32) bytes for ~12 flops, far below the
// card's ~20 flops/byte fp32 balance point.  At the trainer's shapes the
// global step's 20 leaves hold ~130 K floats (a launch costs more than the
// bytes), the client step's 5 leaves 6.6 M (184 MB, ~55 us of bytes).
//
// Design.  One launch per optimizer call, whatever its number of leaves: the
// leaves are described by a table passed by value as a kernel argument
// (pointers, length, row length, first block), as PyTorch's multi-tensor
// apply does; each CTA takes CHUNK elements of one leaf and finds that leaf
// by scanning the table's first blocks (uniform across the CTA, constant-bank
// loads).  A call with more than MAX_LEAVES leaves is split by the caller
// into as few launches as needed.  Loads and stores are float4 where all of a
// leaf's pointers are 16-byte aligned, with a scalar tail; the mask is an
// optional pointer (null = the unmasked variant, so no all-ones tensor is
// streamed).  The bias corrections (1-b1^t, 1-b2^t) are PER ROW of a stacked
// leaf, read from device arrays: the per-client step vectors of the client and
// mask-Adam states make the rows of a stacked (S, ...) leaf sit at different
// steps.  Keeping them on the device means no host read and no host-to-device
// copy per call.  Built with -fmad=false so every multiply and add rounds as
// in the plain fp32 versions; the template flag picks their rounding order.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = THREADS * 4;  // elements per CTA: a float4 each
constexpr int MAX_LEAVES = 32;
constexpr int LEAF_WORDS = 11;  // int64 words per leaf in the host table

struct Leaf {
  const float* p;
  const float* g;
  const float* mu;
  const float* nu;
  const float* mask;  // null: unmasked
  float* p_out;
  float* mu_out;
  float* nu_out;
  long long n;
  long long row_len;  // elements per row of b1t/b2t (n for one step)
  int first_block;
  int vec;  // all pointers 16-byte aligned: float4 loads and stores
};

struct Table {  // 32 * 88 + 4 bytes: inside the 4 KB of kernel parameters
  Leaf leaf[MAX_LEAVES];
  int n_leaves;
};

struct Hyper {
  float lr, b1, b2, one_m_b1, one_m_b2, eps;
};

template <bool CLIENT_ORDER>
__device__ __forceinline__ void update(float p, float g, float mu, float nu,
                                       float c1, float c2, const Hyper& h,
                                       float& p_o, float& mu_o, float& nu_o) {
  const float m = h.b1 * mu + h.one_m_b1 * g;
  const float v = h.b2 * nu + h.one_m_b2 * g * g;
  const float mhat = m / c1;
  const float nhat = v / c2;
  const float den = sqrtf(nhat) + h.eps;
  p_o = CLIENT_ORDER ? p - h.lr * (mhat / den) : p - h.lr * mhat / den;
  mu_o = m;
  nu_o = v;
}

template <bool CLIENT_ORDER>
__global__ void __launch_bounds__(THREADS)
    adam_multi_kernel(const __grid_constant__ Table t,
                      const float* __restrict__ b1t,
                      const float* __restrict__ b2t, const Hyper h) {
  const int blk = blockIdx.x;
  int l = 0;
#pragma unroll 1
  while (l + 1 < t.n_leaves && blk >= t.leaf[l + 1].first_block) ++l;
  const Leaf& lf = t.leaf[l];
  const long long n = lf.n, row_len = lf.row_len;
  const long long start = (long long)(blk - lf.first_block) * CHUNK;
  const long long end = start + CHUNK < n ? start + CHUNK : n;
  const bool masked = lf.mask != nullptr;

  // one float4 per thread, so that a small leaf's CTA waits for one round
  // trip to memory; the row of element i, then advanced along the 4
  // elements: one division per 4 elements, and any row length (mask rows of
  // 6 floats cross a row inside a float4)
  const long long i = start + (long long)threadIdx.x * 4;
  if (i >= end) return;
  long long row = i / row_len, r = i - row * row_len;
  float po[4], mo[4], vo[4];
  if (lf.vec && i + 4 <= end) {
    const float4 p4 = *reinterpret_cast<const float4*>(lf.p + i);
    float4 g4 = *reinterpret_cast<const float4*>(lf.g + i);
    const float4 m4 = *reinterpret_cast<const float4*>(lf.mu + i);
    const float4 v4 = *reinterpret_cast<const float4*>(lf.nu + i);
    if (masked) {
      const float4 k4 = *reinterpret_cast<const float4*>(lf.mask + i);
      g4.x = g4.x * k4.x;
      g4.y = g4.y * k4.y;
      g4.z = g4.z * k4.z;
      g4.w = g4.w * k4.w;
    }
    const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
    const float ga[4] = {g4.x, g4.y, g4.z, g4.w};
    const float ma[4] = {m4.x, m4.y, m4.z, m4.w};
    const float va[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (r == row_len) {
        ++row;
        r = 0;
      }
      update<CLIENT_ORDER>(pa[e], ga[e], ma[e], va[e], __ldg(b1t + row),
                           __ldg(b2t + row), h, po[e], mo[e], vo[e]);
      ++r;
    }
    *reinterpret_cast<float4*>(lf.p_out + i) =
        make_float4(po[0], po[1], po[2], po[3]);
    *reinterpret_cast<float4*>(lf.mu_out + i) =
        make_float4(mo[0], mo[1], mo[2], mo[3]);
    *reinterpret_cast<float4*>(lf.nu_out + i) =
        make_float4(vo[0], vo[1], vo[2], vo[3]);
    return;
  }
  for (long long j = i; j < i + 4 && j < end; ++j) {
    if (r == row_len) {
      ++row;
      r = 0;
    }
    float gj = lf.g[j];
    if (masked) gj = gj * lf.mask[j];
    update<CLIENT_ORDER>(lf.p[j], gj, lf.mu[j], lf.nu[j], __ldg(b1t + row),
                         __ldg(b2t + row), h, po[0], mo[0], vo[0]);
    lf.p_out[j] = po[0];
    lf.mu_out[j] = mo[0];
    lf.nu_out[j] = vo[0];
    ++r;
  }
}

bool aligned16(long long ptr) { return ptr % 16 == 0; }

}  // namespace

extern "C" long long adam_chunk() { return CHUNK; }
extern "C" int adam_max_leaves() { return MAX_LEAVES; }

// One launch over n_leaves <= MAX_LEAVES leaves.  `leaves` holds LEAF_WORDS
// int64 words per leaf: pointers p, g, mu, nu, mask (0: none), p_out, mu_out,
// nu_out, then n, row_len and the leaf's first block; the first blocks must
// be the running sums of ceil(n / CHUNK) from 0, and n_blocks their total.
// All tensors float32, contiguous, n elements; b1t/b2t hold one value per row
// (n / row_len rows).  Outputs may not alias inputs.  client_order != 0 picks
// the client Adam's rounding order.  Returns cudaGetLastError() after the
// launch (0 = launched), cudaErrorInvalidValue for an inconsistent table.
extern "C" int adam_multi_f32(const long long* leaves, int n_leaves,
                              long long n_blocks, const void* b1t,
                              const void* b2t, float lr, float b1, float b2,
                              float one_m_b1, float one_m_b2, float eps,
                              int client_order, void* stream) {
  if (n_leaves <= 0 || n_leaves > MAX_LEAVES || n_blocks <= 0 ||
      n_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  t.n_leaves = n_leaves;
  long long next = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* w = leaves + (long long)l * LEAF_WORDS;
    Leaf& lf = t.leaf[l];
    lf.p = reinterpret_cast<const float*>(w[0]);
    lf.g = reinterpret_cast<const float*>(w[1]);
    lf.mu = reinterpret_cast<const float*>(w[2]);
    lf.nu = reinterpret_cast<const float*>(w[3]);
    lf.mask = reinterpret_cast<const float*>(w[4]);
    lf.p_out = reinterpret_cast<float*>(w[5]);
    lf.mu_out = reinterpret_cast<float*>(w[6]);
    lf.nu_out = reinterpret_cast<float*>(w[7]);
    lf.n = w[8];
    lf.row_len = w[9];
    if (lf.n <= 0 || lf.row_len <= 0 || lf.n % lf.row_len != 0 ||
        w[10] != next)
      return static_cast<int>(cudaErrorInvalidValue);
    lf.first_block = static_cast<int>(w[10]);
    next += (lf.n + CHUNK - 1) / CHUNK;
    bool vec = true;
    for (int k = 0; k < 8; ++k) vec = vec && aligned16(w[k]);
    lf.vec = vec;
  }
  if (next != n_blocks) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{lr, b1, b2, one_m_b1, one_m_b2, eps};
  const float* c1 = static_cast<const float*>(b1t);
  const float* c2 = static_cast<const float*>(b2t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_blocks);
  if (client_order)
    adam_multi_kernel<true><<<grid, THREADS, 0, s>>>(t, c1, c2, h);
  else
    adam_multi_kernel<false><<<grid, THREADS, 0, s>>>(t, c1, c2, h);
  return static_cast<int>(cudaGetLastError());
}
