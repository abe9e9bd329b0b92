// Flash attention forward: causal / sliding-window GQA with online softmax,
// and an optional per-row key length for right-padded (ragged) batches.
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention` (_kernel):
// out[b, h] = softmax(q[b, h] k[b, h // G]^T / sqrt(hd) + mask) v[b, h // G]
// for q (B, Hq, S, hd) and k, v (B, Hkv, S, hd), G = Hq / Hkv.  Beyond the TPU
// kernel it takes `kv_len` (B,) int32: keys j >= kv_len[b] are masked for
// every query of row b.  That is the serving path's key-validity mask
// (`kv_valid`, a prefix of each row for right-padded prompts), which turns
// the JAX package off its flash path; with it one kernel covers every
// prefill, equal-length or ragged.  S need not divide the tile: the last q
// and kv tiles are masked instead of padded (the TPU wrapper asserts
// S % block == 0).
//
// What bounds it on an H100.  On the serving path (Hq 14, Hkv 2, hd 64,
// bf16, causal, S up to 512) one call must read q, k, v and write o once:
// at B=8, S=512 that is 16.8 MB, 5.0 us at 3.35 TB/s, just above the
// 4 * hd * (S^2 / 2) * B * Hq = 3.8 GFLOP of its two products, 3.8 us at
// the 989 TFLOP/s of the bf16 tensor cores.  So the card's bound is bytes,
// with operations close behind.  This first kernel does its dots as fp32
// FMAs outside the tensor cores (67 TFLOP/s peak: 56 us for the same
// operations), so what bounds it is its FMA and shared-memory issue rate,
// at many times the card's bound; tensor cores (mma.sync / wgmma) and TMA
// staging are later work.
//
// Design.  One CTA per (64-row q tile, q head, batch row) with 128 threads:
// two threads per q row, each holding half of the row's q and of its f32
// accumulator (interleaved 4-wide chunks, so a warp's two shared-memory
// addresses fall in different banks).  A loop inside the CTA walks the KV
// tiles (the TPU's sequential kv grid axis): each 64x64 K and V tile is
// staged in shared memory as f32 (32 KB for both), the 64 scores of a row
// stay in registers (partner threads combine partial dots with one shuffle),
// and m, l and the accumulator are f32 in registers; scores are kept in the
// log2 domain (q pre-scaled by log2(e) / sqrt(hd)) for exp2f.  KV tiles
// wholly above the causal diagonal, before the window or past kv_len[b] are
// skipped, not computed and masked (the TPU kernel visits every kv block).
// GQA reads kv head h / G directly (no repeated K or V).  q, k, v and o are
// addressed through their strides (last dim contiguous), so the model's
// (B, S, H, hd) tensors come in as transposed views with no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBM = 64;        // q rows per CTA
constexpr int kBN = 64;        // keys per staged KV tile
constexpr int kThreads = 128;  // two threads per q row

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_len;  // (B,) or null
  // element strides of (batch, head, seq); the head dim is contiguous
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int Hq, Hkv, S, causal, window;
  float qk_scale;  // log2(e) / sqrt(hd)
};

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&a);
  raw.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int kChunks = HD / 4;      // 4-wide chunks per row
  constexpr int kMine = kChunks / 2;   // chunks per thread
  constexpr int kHalf = HD / 2;        // dims per thread
  __shared__ __align__(16) float Ks[kBN][HD];
  __shared__ __align__(16) float Vs[kBN][HD];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int qi = q0 + (tid >> 1);
  const int hk = h / (p.Hq / p.Hkv);
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int kv_end = p.S;
  if (p.kv_len != nullptr) kv_end = min(kv_end, p.kv_len[b]);

  // this thread's chunks of the row: c = 2 * i + half
  float q[kHalf], acc[kHalf];
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    if (qi < p.S) {
      load4(Q + qi * p.q_ss + 4 * (2 * i + half), &q[4 * i]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) q[4 * i + e] = 0.f;
    }
  }
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    q[d] *= p.qk_scale;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  // KV tiles that hold a key some row of this q tile may see
  int hi = kv_end;
  if (p.causal) hi = min(hi, q0 + kBM);
  int lo = p.window ? max(0, q0 - p.window + 1) : 0;
  lo = (lo / kBN) * kBN;

  for (int k0 = lo; k0 < hi; k0 += kBN) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int it = 0; it < kBN * kChunks / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / kChunks, c = idx % kChunks;
      const int key = k0 + r;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (key < kv_end) {
        load4(K + key * p.k_ss + 4 * c, kx);
        load4(V + key * p.v_ss + 4 * c, vx);
      }
      store4(&Ks[r][4 * c], kx);
      store4(&Vs[r][4 * c], vx);
    }
    __syncthreads();

    float s[kBN];
    float mt = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBN; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][4 * (2 * i + half)]);
        dot = fmaf(q[4 * i + 0], kk.x, dot);
        dot = fmaf(q[4 * i + 1], kk.y, dot);
        dot = fmaf(q[4 * i + 2], kk.z, dot);
        dot = fmaf(q[4 * i + 3], kk.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      const int key = k0 + j;
      const bool ok = key < kv_end && (!p.causal || key <= qi) &&
                      (!p.window || key > qi - p.window);
      s[j] = ok ? dot : -CUDART_INF_F;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    if (m_new != -CUDART_INF_F) {  // else no key of this tile is visible
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < kHalf; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kBN; ++j) {
        const float pj = exp2f(s[j] - m_new);
        l += pj;
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][4 * (2 * i + half)]);
          acc[4 * i + 0] = fmaf(pj, vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(pj, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(pj, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(pj, vv.w, acc[4 * i + 3]);
        }
      }
      m = m_new;
    }
  }

  if (qi < p.S) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + qi * p.o_ss;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[4 * i + e] * inv;
      store4(O + 4 * (2 * i + half), out);
    }
  }
}

template <typename T>
int launch(const Params& p, int B, void* stream) {
  const dim3 grid((p.S + kBM - 1) / kBM, p.Hq, B);
  flash_fwd_kernel<T, 64><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, S, hd), k and v (B, Hkv, S, hd), o (B, Hq, S, hd), all of one
// dtype (0 = float32, 1 = bfloat16), addressed by `strides`: 12 element
// strides (batch, head, seq) of q, k, v, o in that order; the head dim is
// contiguous and every row starts 4-element aligned.  kv_len is (B,) int32
// with values in [1, S], or null.  hd must be 64.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_fwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v, void* o,
                                   const void* kv_len,
                                   const long long* strides, int B, int Hq,
                                   int Hkv, int S, int causal, int window,
                                   void* stream) {
  if (head_dim != 64 || B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      window < 0 || B > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kv_len = static_cast<const int*>(kv_len);
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_ss = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_ss = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_ss = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_ss = strides[11];
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.S = S;
  p.causal = causal;
  p.window = window;
  p.qk_scale = 1.4426950408889634f / sqrtf(static_cast<float>(head_dim));
  if (dtype == 0) return launch<float>(p, B, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
