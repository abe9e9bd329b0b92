// Stacked panel GEMM for the AdaSplit per-client 5x5 conv (im2col form),
// with an optional bias + ReLU epilogue.
//
// Replaces: src/repro/kernels/client_conv.py `panel_gemm_2d` (_gemm_kernel)
// and `panel_gemm_bias_relu_2d` (_gemm_bias_relu_kernel): out[c] = A[c] @ B[c]
// (+ bias[c], ReLU) for A (C, M, K), B (C, K, N), bias (C, N), all float32.
//
// What bounds it on an H100: bytes, with fp32 FMAs close behind on the deep
// blocks.  On the LeNet path K = 25*Cin is 75..1600 and N = Cout is 6..64,
// so the patch matrix A dominates the traffic and is read once: the client
// block's A (C=32, B=32) is 315 MB, 94 us at 3.35 TB/s, against 14 us of
// FMAs at the 67 TFLOP/s fp32 rate; the last server block (M=2432, K=1600,
// N=64) is 7.4 us of bytes and 7.4 us of FMAs.  Strict fp32: no TF32 (the
// card-vs-CPU checks and the rungs' equality rest on f32 sums).
//
// What held the first design back: one CTA per 128-row output tile walked
// all of K, so the server blocks, with small M and long K, launched 19-76
// CTAs on 132 SMs (block 4 took 8.4x torch.bmm); each 16-deep K chunk was
// loaded with plain loads behind a barrier, and read back as scalars.
//
// Design.
//  - Split-K across a thread-block cluster.  The wrapper's planner
//    (`plan_panel_gemm`, kernels/client_conv.py) picks the tile and splits K
//    into 1, 2, 4 or 8 ranges of whole 32-deep chunks until the grid has a
//    CTA for every SM.  The splits of one output tile are one cluster
//    (cudaLaunchKernelEx, cluster dimension = splits).  Each CTA accumulates
//    its K range in registers and writes the partial tile to its own shared
//    memory; after cluster.sync() each CTA reduces a slice of the tile's rows
//    over the cluster's shared memory (distributed shared memory), summing
//    the ranks in a fixed order, applies bias and ReLU after the sum and
//    stores.  No workspace, no second launch, no atomics: two launches on
//    the same inputs are bit-equal.  One split is the plain tiled path.
//  - Register tiles: BN = 8/16/32/64 from N (a 6-wide panel wastes 2 of 8
//    columns, not 122 of 128); 256 threads each own TM x TN outputs, 8x4 at
//    BN 64, 4x4 at BN 32 and 16 (BM 128, 128, 256), 4x2 at BN 8 (BM 256),
//    a thread's rows TY apart so that a warp reads neighbouring rows.  A is
//    staged row-major (rows padded to 36 floats: 16-byte aligned, and
//    neighbouring rows 4 banks apart, so free of bank conflicts) and read as
//    float4 along K, B as float4/float2 along N: four K steps cost TM + 4
//    shared loads for 4*TM*TN FMAs.
//  - Loads: a cp.async ring of 32-deep K chunks (3 stages; 2 at BN 16, so
//    that two CTAs fit an SM), the next chunks in flight while this one is
//    multiplied; at K = 75 (BN 8) the three stages hold all of K at once.  A rows move as 16-byte copies where K % 4 == 0 and
//    A is 16-byte aligned (K = 400, 800, 1600), else as 4-byte copies (the
//    K = 75 and 150 rows are only 4-byte aligned); ragged M, K and N edges
//    are zero-filled by the copy (src-size 0) and masked on store.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;       // depth of one staged K chunk
constexpr int kLDA = kBK + 4; // padded row of the A chunk, floats
constexpr int kMaxDevices = 64;

template <int BN>
struct Tile;  // outputs per thread (TM rows x TN columns), ring depth
template <>
struct Tile<64> { static constexpr int TM = 8, TN = 4, STAGES = 3; };
template <>
struct Tile<32> { static constexpr int TM = 4, TN = 4, STAGES = 3; };
template <>
struct Tile<16> { static constexpr int TM = 4, TN = 4, STAGES = 2; };
template <>
struct Tile<8> { static constexpr int TM = 4, TN = 2, STAGES = 3; };

template <int BN>
struct Cfg {
  static constexpr int TM = Tile<BN>::TM, TN = Tile<BN>::TN;
  static constexpr int TX = BN / TN;         // thread columns
  static constexpr int TY = kThreads / TX;   // thread rows
  static constexpr int BM = TY * TM;
  static constexpr int STAGES = Tile<BN>::STAGES;
  static constexpr int A_STAGE = BM * kLDA;  // floats
  static constexpr int B_STAGE = kBK * BN;
  static constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * 4;  // bytes
  static_assert(BM * BN <= STAGES * (A_STAGE + B_STAGE), "partial tile fits");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4- and 16-byte copies; with ok false nothing is read and zeros are written
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int TN>
__device__ __forceinline__ void load_row(const float* p, float (&v)[TN]) {
  if constexpr (TN == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
}

__device__ __forceinline__ float component(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <bool BIAS_RELU>
__device__ __forceinline__ float epilogue(float v, const float* bias, int gn) {
  return BIAS_RELU ? fmaxf(v + bias[gn], 0.f) : v;
}

template <int BN, bool BIAS_RELU, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    panel_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int M, int K, int N, int splits) {
  using C = Cfg<BN>;
  constexpr int TM = C::TM, TN = C::TN, BM = C::BM, STAGES = C::STAGES;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + STAGES * C::A_STAGE;

  const int split = blockIdx.x % splits;  // the CTA's rank in its cluster
  const int m0 = (blockIdx.x / splits) * BM;
  const int n0 = blockIdx.y * BN;
  const int c = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % C::TX, ty = tid / C::TX;
  const float* ac = a + (long long)c * M * K;
  const float* bc = b + (long long)c * K * N;

  // this split's chunks: [split * n / splits, (split + 1) * n / splits)
  const int n_chunks = (K + kBK - 1) / kBK;
  const int ch0 = split * n_chunks / splits;
  const int n_mine = (split + 1) * n_chunks / splits - ch0;

  auto load = [&](int chunk, int stage) {
    const int k0 = chunk * kBK;
    float* as = As + stage * C::A_STAGE;
    float* bs = Bs + stage * C::B_STAGE;
    if (VEC) {
#pragma unroll
      for (int it = 0; it < BM * kBK / 4 / kThreads; ++it) {
        const int v = tid + it * kThreads;
        const int r = v / (kBK / 4), kq = 4 * (v % (kBK / 4));
        const int gm = m0 + r, gk = k0 + kq;
        const bool ok = gm < M && gk < K;
        cp16(as + r * kLDA + kq, ok ? ac + (long long)gm * K + gk : ac, ok);
      }
    } else {
      // a warp copies 32 consecutive k of one row; 8 rows per pass
      const int kk = tid % kBK, r0 = tid / kBK;
      const bool k_ok = k0 + kk < K;
      const float* src = ac + (long long)(m0 + r0) * K + k0 + kk;
#pragma unroll 4
      for (int r = r0; r < BM; r += kThreads / kBK) {
        const bool ok = k_ok && m0 + r < M;
        cp4(as + r * kLDA + kk, ok ? src : ac, ok);
        src += (long long)(kThreads / kBK) * K;
      }
    }
#pragma unroll
    for (int it = 0; it < kBK * BN / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int kk = e / BN, nn = e % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      const bool ok = gk < K && gn < N;
      cp4(bs + e, ok ? bc + (long long)gk * N + gn : bc, ok);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_mine) load(ch0 + s, s);
    cp_commit();  // one group per chunk slot, empty or not
  }
  for (int i = 0; i < n_mine; ++i) {
    cp_wait<STAGES - 2>();  // chunk i has landed (this thread's copies)
    __syncthreads();        // everyone's copies; chunk i - 1 is consumed
    if (i + STAGES - 1 < n_mine) load(ch0 + i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_commit();
    const float* as = As + (i % STAGES) * C::A_STAGE + ty * kLDA;
    const float* bs = Bs + (i % STAGES) * C::B_STAGE + tx * TN;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 av[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r)
        av[r] = *reinterpret_cast<const float4*>(as + r * C::TY * kLDA + kk);
      float bv[4][TN];
#pragma unroll
      for (int j = 0; j < 4; ++j) load_row<TN>(bs + (kk + j) * BN, bv[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float x = component(av[r], j);
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[r][n] = fmaf(x, bv[j][n], acc[r][n]);
        }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: every copy landed, every read done

  const float* bias_c = BIAS_RELU ? bias + (long long)c * N : nullptr;
  float* oc = out + (long long)c * M * N;
  if (splits == 1) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int gm = m0 + ty + r * C::TY;
      if (gm >= M) continue;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int gn = n0 + tx * TN + n;
        if (gn < N) oc[(long long)gm * N + gn] = epilogue<BIAS_RELU>(acc[r][n], bias_c, gn);
      }
    }
    return;
  }

  // split-K: partial tiles in each CTA's shared memory, reduced over the
  // cluster in rank order
  float* part = smem;  // BM x BN
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int n = 0; n < TN; ++n) part[(ty + r * C::TY) * BN + tx * TN + n] = acc[r][n];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = BM / splits;
  for (int e = tid; e < rows * BN / 4; e += kThreads) {
    const int r = split * rows + e / (BN / 4), cc = 4 * (e % (BN / 4));
    float4 sum = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0) + r * BN + cc);
    for (int q = 1; q < splits; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, q) + r * BN + cc);
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    const int gm = m0 + r;
    if (gm < M) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + cc + j;
        if (gn < N)
          oc[(long long)gm * N + gn] = epilogue<BIAS_RELU>(component(sum, j), bias_c, gn);
      }
    }
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

template <int BN, bool BIAS_RELU, bool VEC>
cudaError_t launch(const float* a, const float* b, const float* bias, float* out,
                   int C, int M, int K, int N, int splits, cudaStream_t stream) {
  auto kernel = panel_gemm_kernel<BN, BIAS_RELU, VEC>;
  // the shared-memory opt-in, once per variant and device (it is a host
  // round trip; setting it twice in a race is harmless)
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<BN>::SMEM);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + Cfg<BN>::BM - 1) / Cfg<BN>::BM * splits,
                     (N + BN - 1) / BN, C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<BN>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, b, bias, out, M, K, N, splits);
}

template <int BN>
cudaError_t launch_bn(const float* a, const float* b, const float* bias, float* out,
                      int C, int M, int K, int N, int splits, bool vec,
                      cudaStream_t s) {
  if (bias != nullptr)
    return vec ? launch<BN, true, true>(a, b, bias, out, C, M, K, N, splits, s)
               : launch<BN, true, false>(a, b, bias, out, C, M, K, N, splits, s);
  return vec ? launch<BN, false, true>(a, b, bias, out, C, M, K, N, splits, s)
             : launch<BN, false, false>(a, b, bias, out, C, M, K, N, splits, s);
}

}  // namespace

// The output tile's rows for a tile `block_n` columns wide (8, 16, 32 or
// 64), 0 for any other width: kernels/client_conv.py's planner reads its
// BLOCK_M table from here.
extern "C" int panel_gemm_block_m(int block_n) {
  switch (block_n) {
    case 8: return Cfg<8>::BM;
    case 16: return Cfg<16>::BM;
    case 32: return Cfg<32>::BM;
    case 64: return Cfg<64>::BM;
    default: return 0;
  }
}

// out (C, M, N) = A (C, M, K) @ B (C, K, N); with `bias` (C, N) non-null,
// relu(A @ B + bias).  All float32, contiguous, on the current device.
// (block_n, splits) is the plan of kernels/client_conv.py's
// `plan_panel_gemm`: block_n in {8, 16, 32, 64}, splits in {1, 2, 4, 8} and
// at most the number of 32-deep K chunks.  Returns the launch's cudaError_t
// (0 = launched).
extern "C" int panel_gemm_f32(const void* a, const void* b, const void* bias,
                              void* out, int C, int M, int K, int N, int block_n,
                              int splits, void* stream) {
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  const float* bi = static_cast<const float*>(bias);
  float* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || M <= 0 || N <= 0 || K <= 0 || C > 65535 ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      splits > (K + kBK - 1) / kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies of A rows need K % 4 == 0 and an aligned base
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (block_n == 8)
    err = launch_bn<8>(A, B, bi, O, C, M, K, N, splits, vec, s);
  else if (block_n == 16)
    err = launch_bn<16>(A, B, bi, O, C, M, K, N, splits, vec, s);
  else if (block_n == 32)
    err = launch_bn<32>(A, B, bi, O, C, M, K, N, splits, vec, s);
  else if (block_n == 64)
    err = launch_bn<64>(A, B, bi, O, C, M, K, N, splits, vec, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
