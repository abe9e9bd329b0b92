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
// S % block == 0).  q, k, v and o are addressed through their strides (last
// dim contiguous), so the model's (B, S, H, hd) tensors come in as
// transposed views with no copy.  A query row that sees no key is zeros.
//
// Head dims 64, 96 and 128 (the TPU kernel takes any; these are the head
// dims of the configs the port serves).  Another head dim is refused.
//
// What bounds it on an H100.  On the serving path (bf16, causal, S up to
// 512) one call must read q, k, v and write o once.  qwen2-0.5b (Hq 14,
// Hkv 2, hd 64) at B=8, S=512: 16.8 MB, 5.0 us at 3.35 TB/s, just above the
// 4 * hd * (S^2 / 2) * B * Hq = 3.8 GFLOP of its two products, 3.8 us at
// the 989 TFLOP/s of the bf16 tensor cores.  granite-3-8b (Hq 32, Hkv 8,
// hd 128) at the same B and S: 84 MB, 25 us, against 17.2 GFLOP, 17.4 us.
// So the card's bound is bytes, with operations close behind; either way
// only the tensor cores and loads that overlap the math come near it.  The
// f32 SIMT design this replaces (fp32 FMAs from K/V staged as f32, each
// load followed by a barrier) took 60x the bound.
//
// Design, bf16 (the serving path).  One warpgroup (128 threads) per 64-row
// q tile, grid (q tiles, Hq, B), the longest causal tiles launched first;
// GQA reads kv head h / G directly.  The head dim is carried in 64-column
// chunks (one for hd 64, two for 96 and 128): a 128-byte swizzle row holds
// at most 64 bf16 values.
//  - TMA brings the q tile once and the 64-key K and V tiles through a
//    two-stage ring in shared memory (one mbarrier per stage; the next
//    tile's load is issued before this tile's math), 128-byte swizzled, one
//    64x64 box per chunk.  The tensor maps are 4-D (hd, S, H, B) over the
//    strided views, encoded on the host per call through the driver entry
//    point that the runtime hands out (cudaGetDriverEntryPointByVersion),
//    so nothing links -lcuda.  Rows past S come in as zeros, and so do
//    columns 96-127 of hd 96's second chunk (the map's head axis is 96):
//    they add nothing to Q K^T, and the output columns they make in P V
//    are not stored.  Shared memory: 5 tiles of 8 KB per chunk (41 KB at
//    hd 64, 81 KB at 96 and 128, past the 48 KB default: opted in once per
//    head dim and device).
//  - S = Q K^T is hd / 16 (4, 6 or 8) wgmma.mma_async m64n64k16 (bf16 in,
//    f32 out in registers), A = Q and B = K both K-major in shared memory.
//    The f32 scores are scaled by log2(e) / sqrt(hd) after the product (q
//    is not pre-scaled in bf16, which would round it).
//  - Masks (causal, window, kv_len) and the online softmax run on the
//    accumulator fragment: each thread holds 2 rows x 16 columns; the row
//    max and sum combine across the quad with shuffles; m and l are f32;
//    exp2f.  Masks are evaluated only on tiles that straddle a mask edge;
//    tiles wholly above the diagonal, before the window or past kv_len are
//    not visited.
//  - O += P V is wgmma with A = P from registers (the f32 accumulator
//    fragment of S is, element for element, the A fragment of a 16-bit
//    m64k16 operand) and B = the V tile, MN-major (transposed by wgmma).
//    P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), two products
//    per k-step and output chunk (one 32-register accumulator fragment per
//    64 columns of hd), so P keeps ~16 bits as in the f32 reference instead
//    of the 8 that rounding it once to bf16 (the TPU kernel's, and SDPA's,
//    choice) would keep.
//  - Epilogue: divide by l (0 gives zeros), round to bf16, store through
//    the strides, rows past S masked.
// Design, f32 (the strict-fp32 card-vs-CPU prefill and the f32 tests): the
// SIMT kernel below, kept so that no product runs in TF32: two threads per
// q row, K/V tiles staged in shared memory, fp32 FMAs.  At hd 96 and 128
// the staged tile is 32 keys (static shared memory stays under 48 KB, and
// the scores of a tile fit in registers beside the 64 q values and 64
// accumulators a thread holds at hd 128).  The path is chosen by dtype
// only.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // q rows per CTA
constexpr int kBN = 64;        // keys per staged KV tile
constexpr int kThreads = 128;  // one warpgroup

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

// ---------------------------------------------------------------------------
// float32: SIMT, fp32 FMAs (no tensor cores, so no TF32)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// BN keys per staged K/V tile: 64 at hd 64, 32 at hd 96 and 128
template <int HD, int BN>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(const Params p) {
  constexpr int kChunks = HD / 4;      // 4-wide chunks per row
  constexpr int kMine = kChunks / 2;   // chunks per thread
  constexpr int kHalf = HD / 2;        // dims per thread
  static_assert(BN * kChunks % kThreads == 0, "whole staging passes");
  __shared__ __align__(16) float Ks[BN][HD];
  __shared__ __align__(16) float Vs[BN][HD];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int qi = q0 + (tid >> 1);
  const int hk = h / (p.Hq / p.Hkv);
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

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
  lo = (lo / BN) * BN;

  for (int k0 = lo; k0 < hi; k0 += BN) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int it = 0; it < BN * kChunks / kThreads; ++it) {
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

    float s[BN];
    float mt = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
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
      for (int j = 0; j < BN; ++j) {
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
    float* O = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + qi * p.o_ss;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[4 * i + e] * inv;
      store4(O + 4 * (2 * i + half), out);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: TMA ring, wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr uint32_t kTileBytes = kBM * 64 * 2;  // one 64x64 bf16 tile, 8 KB
constexpr int kMaxDevices = 64;

// 64-column chunks of the head dim, and the shared memory of one CTA: Q,
// K[2], V[2] per chunk, each tile 1024-byte aligned for the 128-byte swizzle
template <int HD>
struct Bf16Cfg {
  static constexpr int kChunks = (HD + 63) / 64;
  static constexpr int kSteps = HD / 16;  // k-steps of 16 over hd in Q K^T
  static constexpr uint32_t kSmem = 5 * kChunks * kTileBytes + 1024;
  static_assert(HD % 16 == 0 && HD <= 128, "hd 64, 96 or 128");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one 64 (hd) x 64 (seq) box at (d, s, h, b) of a 4-D (hd, S, H, B) map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(s), "r"(h), "r"(b)
      : "memory");
}

// the tile of every chunk of hd, 64 columns each, into consecutive 8 KB tiles
template <int NC>
__device__ __forceinline__ void tma_load_chunks(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int s, int h, int b) {
#pragma unroll
  for (int c = 0; c < NC; ++c) tma_load(dst + c * kTileBytes, map, bar, 64 * c, s, h, b);
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue and its wait
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC32(d)                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),          \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),          \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),          \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define D32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64x64 f32) += A (64x16, K-major smem) * B (16x64, K-major smem)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(1));
}

// d (64x64 f32) += A (64x16 bf16 in registers) * B (16x64, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// P_hi = bf16(x), P_lo = bf16(x - P_hi) for a pair of adjacent columns
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - back.x, x1 - back.y);
}

__device__ __forceinline__ bool visible(int row, int key, int kv_end,
                                        const Params& p) {
  return key < kv_end && (!p.causal || key <= row) &&
         (!p.window || key > row - p.window);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Params p) {
  constexpr int NC = Bf16Cfg<HD>::kChunks;
  constexpr uint32_t kChunkBytes = NC * kTileBytes;  // one tile, every chunk
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // q, K/V stage 0, stage 1

  // chunk c of a tile at + c * kTileBytes
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK[2] = {base + kChunkBytes, base + 2 * kChunkBytes};
  const uint32_t sV[2] = {base + 3 * kChunkBytes, base + 4 * kChunkBytes};
  const uint32_t bar_q = smem_addr(&bars[0]);
  const uint32_t bar_kv[2] = {smem_addr(&bars[1]), smem_addr(&bars[2])};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest tiles first
  const int hk = h / (p.Hq / p.Hkv);

  int kv_end = p.S;
  if (p.kv_len != nullptr) kv_end = min(kv_end, p.kv_len[b]);
  int hi = kv_end;
  if (p.causal) hi = min(hi, q0 + kBM);
  int lo = p.window ? max(0, q0 - p.window + 1) : 0;
  lo = (lo / kBN) * kBN;
  const int n_tiles = hi > lo ? (hi - lo + kBN - 1) / kBN : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv[0], 1);
    mbar_init(bar_kv[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    // a box past the map's edges (rows past S, hd 96's columns 96-127)
    // comes in as zeros and still counts its full bytes
    mbar_expect_tx(bar_q, kChunkBytes);
    tma_load_chunks<NC>(sQ, &tq, bar_q, q0, h, b);
    mbar_expect_tx(bar_kv[0], 2 * kChunkBytes);
    tma_load_chunks<NC>(sK[0], &tk, bar_kv[0], lo, hk, b);
    tma_load_chunks<NC>(sV[0], &tv, bar_kv[0], lo, hk, b);
  }

  // this thread's rows of the tile and its column pair in each 8-column block
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int cpair = 2 * (lane & 3);
  float o[NC][32];  // O, one m64n64 fragment per 64 columns of hd
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = lo + t * kBN;
    const int st = t & 1;
    __syncthreads();  // every warp is done with tile t - 1, in stage st ^ 1
    if (tid == 0 && t + 1 < n_tiles) {
      mbar_expect_tx(bar_kv[st ^ 1], 2 * kChunkBytes);
      tma_load_chunks<NC>(sK[st ^ 1], &tk, bar_kv[st ^ 1], k0 + kBN, hk, b);
      tma_load_chunks<NC>(sV[st ^ 1], &tv, bar_kv[st ^ 1], k0 + kBN, hk, b);
    }
    if (t == 0) mbar_wait(bar_q, 0);
    mbar_wait(bar_kv[st], (t >> 1) & 1);

    // S = Q K^T: hd / 16 k-steps of 16 over hd, four to a chunk, 32 bytes
    // apart in a swizzled row
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Bf16Cfg<HD>::kSteps; ++kk) {
      const uint32_t off = (kk >> 2) * kTileBytes + 32 * (kk & 3);
      wgmma_ss(s, sw128_desc(sQ + off, 16, 1024), sw128_desc(sK[st] + off, 16, 1024));
    }
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    // scale, mask, and the online softmax on the fragment: s[4j + e] is
    // (r0, k0 + 8j + cpair + e), s[4j + 2 + e] is (r1, same column)
    const bool edge = k0 + kBN > kv_end || (p.causal && k0 + kBN - 1 > q0) ||
                      (p.window && k0 <= q0 + kBM - 1 - p.window);
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v0 = s[4 * j + e] * p.qk_scale, v1 = s[4 * j + 2 + e] * p.qk_scale;
        if (edge) {
          const int key = k0 + 8 * j + cpair + e;
          if (!visible(r0, key, kv_end, p)) v0 = -CUDART_INF_F;
          if (!visible(r1, key, kv_end, p)) v1 = -CUDART_INF_F;
        }
        s[4 * j + e] = v0;
        s[4 * j + 2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no visible key so far keeps p = 0 and l = 0
    const float z0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float z1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float c0 = exp2f(m0 - z0), c1 = exp2f(m1 - z1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j + 0] *= c0;
        o[c][4 * j + 1] *= c0;
        o[c][4 * j + 2] *= c1;
        o[c][4 * j + 3] *= c1;
      }
    // P as the A fragments of four m64k16 steps over the keys: step kk
    // takes column blocks 2kk and 2kk + 1
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p00 = exp2f(s[4 * j + 0] - z0), p01 = exp2f(s[4 * j + 1] - z0);
      const float p10 = exp2f(s[4 * j + 2] - z1), p11 = exp2f(s[4 * j + 3] - z1);
      l0 += p00 + p01;
      l1 += p10 + p11;
      const int r = 4 * (j >> 1) + 2 * (j & 1);
      split_pair(p00, p01, ph[r], pl[r]);
      split_pair(p10, p11, ph[r + 1], pl[r + 1]);
    }

    // O += P_hi V + P_lo V: V is MN-major (hd contiguous), 16 keys per step,
    // each 64-column chunk of V into its own fragment of O
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t dv =
            sw128_desc(sV[st] + c * kTileBytes + 2048 * kk, kTileBytes, 1024);
        wgmma_rs(o[c], ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3], dv);
        wgmma_rs(o[c], pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], dv);
      }
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + cpair;
      if (col >= HD) continue;  // hd 96's zero columns 96-127
      if (r0 < p.S)
        *reinterpret_cast<uint32_t*>(O + r0 * p.o_ss + col) =
            pack_bf16(o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
      if (r1 < p.S)
        *reinterpret_cast<uint32_t*>(O + r1 * p.o_ss + col) =
            pack_bf16(o[c][4 * j + 2] * inv1, o[c][4 * j + 3] * inv1);
    }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a 4-D (hd, S, H, B) bf16 map over a strided view, 64 x 64 boxes
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int hd, int S,
            int H, int B, long long ss, long long sh, long long sb) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, kBN, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr uint32_t smem = Bf16Cfg<HD>::kSmem;
  // the shared-memory opt-in, once per head dim and device (a host round
  // trip; setting it twice in a race is harmless)
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, p.q, HD, p.S, p.Hq, B, p.q_ss, p.q_sh, p.q_sb) ||
      !encode(fn, &tk, p.k, HD, p.S, p.Hkv, B, p.k_ss, p.k_sh, p.k_sb) ||
      !encode(fn, &tv, p.v, HD, p.S, p.Hkv, B, p.v_ss, p.v_sh, p.v_sb))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.S + kBM - 1) / kBM, p.Hq, B);
  flash_fwd_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int BN>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid((p.S + kBM - 1) / kBM, p.Hq, B);
  flash_fwd_f32_kernel<HD, BN><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hq, S, hd), k and v (B, Hkv, S, hd), o (B, Hq, S, hd), all of one
// dtype (0 = float32, 1 = bfloat16), addressed by `strides`: 12 element
// strides (batch, head, seq) of q, k, v, o in that order; the head dim is
// contiguous; rows start 4-element aligned (float32) or 8-element, 16-byte
// aligned (bfloat16: TMA's rule).  kv_len is (B,) int32 with values in
// [1, S], or null.  hd must be 64, 96 or 128.  Returns cudaGetLastError()
// after the launch (0 = launched), or the error that kept it from launching.
extern "C" int flash_attention_fwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v, void* o,
                                   const void* kv_len,
                                   const long long* strides, int B, int Hq,
                                   int Hkv, int S, int causal, int window,
                                   void* stream) {
  if ((head_dim != 64 && head_dim != 96 && head_dim != 128) || B <= 0 || S <= 0 ||
      Hkv <= 0 || Hq % Hkv != 0 ||
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (head_dim == 64) return launch_f32<64, 64>(p, B, s);
    if (head_dim == 96) return launch_f32<96, 32>(p, B, s);
    return launch_f32<128, 32>(p, B, s);
  }
  if (dtype == 1) {
    if (head_dim == 64) return launch_bf16<64>(p, B, s);
    if (head_dim == 96) return launch_bf16<96>(p, B, s);
    return launch_bf16<128>(p, B, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
