// Stacked panel GEMM for the AdaSplit per-client 5x5 conv (im2col form),
// with an optional bias + ReLU epilogue.
//
// Replaces: src/repro/kernels/client_conv.py `panel_gemm_2d` (_gemm_kernel)
// and `panel_gemm_bias_relu_2d` (_gemm_bias_relu_kernel): out[c] = A[c] @ B[c]
// (+ bias[c], ReLU) for A (C, M, K), B (C, K, N), bias (C, N), all float32.
//
// What bounds it on an H100: bytes.  On the LeNet path K = 25*Cin is 75..1600
// and N = Cout is 6..64, so the patch matrix A dominates the traffic and is
// read once: at C=32, B=32 the client block's A is 32*32768*75*4 B = 315 MB,
// ~94 us at 3.35 TB/s, against ~0.94 GFLOP of FMAs (~14 us at the 67 TFLOP/s
// fp32 rate).
//
// Design.  The TPU kernel holds the whole (K, N) filter panel in VMEM and
// pads K and N to multiples of 128; neither carries over.  At the last server
// block the panel is 1600x64x4 B = 400 KB, above the 227 KB of shared memory a
// block may use, and padding N=6 to 128 would multiply the work by 21.  Here
// each block owns a BM x BN output tile and walks K in BK-deep chunks staged
// in shared memory (A transposed so the inner loop reads broadcast rows); BN
// is a template parameter picked from N (8/16/32/64) so a 6-wide panel wastes
// at most 2 of 8 columns, and ragged M, K and N edges are masked on load and
// store instead of padded.  Accumulation is float32 FMA, no TF32, so results
// are comparable with the plain fp32 version.  Grid: M tiles x N tiles x C.
// Simple and right first: no wgmma, TMA or cp.async pipelining yet.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;      // rows of the output tile
constexpr int kBK = 16;       // depth of one staged K chunk
constexpr int kTM = 4;        // rows per thread

template <int BN, bool BIAS_RELU>
__global__ void __launch_bounds__(kThreads)
panel_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int M, int K, int N) {
  constexpr int TN = BN / 8;              // columns per thread
  // 8 thread columns x 32 thread rows; 32 * kTM = kBM
  __shared__ float As[kBK][kBM + 1];      // A chunk, transposed (k, m)
  __shared__ float Bs[kBK][BN];

  const int c = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;

  const float* ac = a + (long long)c * M * K;
  const float* bc = b + (long long)c * K * N;

  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A chunk: kBM x kBK = 2048 values, 8 per thread; neighbouring threads
    // read neighbouring k of one row.
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int e = r * kThreads + tid;
      const int mm = e / kBK, kk = e % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? ac[(long long)gm * K + gk] : 0.f;
    }
    // B chunk: kBK x BN values
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int kk = e / BN, nn = e % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? bc[(long long)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[TN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = As[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* oc = out + (long long)c * M * N;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (BIAS_RELU) v = fmaxf(v + bias[(long long)c * N + gn], 0.f);
      oc[(long long)gm * N + gn] = v;
    }
  }
}

template <int BN>
void launch(const float* a, const float* b, const float* bias, float* out,
            int C, int M, int K, int N, cudaStream_t stream) {
  dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN, C);
  if (bias != nullptr)
    panel_gemm_kernel<BN, true><<<grid, kThreads, 0, stream>>>(a, b, bias, out,
                                                               M, K, N);
  else
    panel_gemm_kernel<BN, false><<<grid, kThreads, 0, stream>>>(a, b, nullptr,
                                                                out, M, K, N);
}

}  // namespace

// out (C, M, N) = A (C, M, K) @ B (C, K, N); with `bias` (C, N) non-null,
// relu(A @ B + bias).  All float32, contiguous, on the current device.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int panel_gemm_f32(const void* a, const void* b, const void* bias,
                              void* out, int C, int M, int K, int N,
                              void* stream) {
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  const float* bi = static_cast<const float*>(bias);
  float* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || M <= 0 || N <= 0 || K <= 0 || C > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 8)
    launch<8>(A, B, bi, O, C, M, K, N, s);
  else if (N <= 16)
    launch<16>(A, B, bi, O, C, M, K, N, s);
  else if (N <= 32)
    launch<32>(A, B, bi, O, C, M, K, N, s);
  else
    launch<64>(A, B, bi, O, C, M, K, N, s);
  return static_cast<int>(cudaGetLastError());
}
