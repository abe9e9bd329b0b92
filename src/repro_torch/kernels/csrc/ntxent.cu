// Supervised NT-Xent statistics (AdaSplit eq. 5), batched over clients.
//
// Replaces: src/repro/kernels/ntxent.py `ntxent_stats` (_kernel).  For each
// client c and row i of its q (B, D):
//   lse_i     = logsumexp_{j != i} (q_i . q_j / tau)
//   pos_sum_i = sum_{j != i, y_j == y_i} (q_i . q_j / tau)
//   pos_cnt_i = |{j != i : y_j == y_i}|   (as a float)
// from which the client's loss is sum(cnt * lse - pos_sum) / max(sum(cnt), 1).
// The TPU kernel takes one client and pads B up to its row block; this one
// takes all C clients in one launch and needs no padding.
//
// What bounds it on an H100.  The trainer's client step (C=32, B=32, D=64)
// does 2 * C * B * B * D = 4.2 MFLOP and moves 0.28 MB: 0.06 us of fp32 FMA
// time at 67 TFLOP/s, 0.08 us of device memory at 3.35 TB/s.  Both are far
// under a launch, so at the path's shapes the launch is the cost.  At large
// B the similarity FMAs bound it (fp32, outside the tensor cores).
//
// Design.  One CTA per (client, tile of ROWS rows), one warp per row.  The
// CTA's rows sit in shared memory; the client's q streams through shared
// memory in tiles of 32 columns (the TPU kernel keeps the whole (B, D) q in
// VMEM).  Lane l takes column l of each tile: a dot of D fp32 FMAs, then an
// online max and sum for the logsumexp, so any B works in one pass.  At the
// end the warp merges its lanes' (max, sum) pairs and its positive sums with
// shuffles.  The diagonal and the columns past B are skipped; the TPU kernel
// masks them with -1e30, which adds exp(-inf) = 0 to the same sums.  Shared
// rows have a stride of D + 1 floats, so the 32 lanes of a warp reading 32
// different columns hit 32 different banks.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;        // rows of a CTA, one warp each
constexpr int TILE = 32;       // columns staged per step, one per lane
constexpr float NEG = -1e30f;  // lse of a row with no other column
constexpr int MAX_D = 256;     // (ROWS + TILE) * (D + 1) floats < 48 KB

__global__ void ntxent_stats_kernel(const float* __restrict__ q,
                                    const int* __restrict__ labels,
                                    float* __restrict__ lse,
                                    float* __restrict__ pos_sum,
                                    float* __restrict__ pos_cnt, int B, int D,
                                    float tau) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* rows_s = smem;                  // ROWS x ld: this CTA's rows
  float* cols_s = smem + ROWS * ld;      // TILE x ld: one column tile
  int* lab_s = reinterpret_cast<int*>(cols_s + TILE * ld);  // TILE labels

  const int c = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const float* qc = q + (long long)c * B * D;
  const int* yc = labels + (long long)c * B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = row0 + warp;

  for (int e = threadIdx.x; e < ROWS * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    rows_s[r * ld + d] = row0 + r < B ? qc[(long long)(row0 + r) * D + d] : 0.f;
  }
  const int yi = i < B ? yc[i] : 0;

  float m = NEG, s = 0.f, psum = 0.f, pcnt = 0.f;
  for (int j0 = 0; j0 < B; j0 += TILE) {
    __syncthreads();  // the last tile is consumed (first pass: rows staged)
    for (int e = threadIdx.x; e < TILE * D; e += blockDim.x) {
      const int r = e / D, d = e - r * D;
      cols_s[r * ld + d] = j0 + r < B ? qc[(long long)(j0 + r) * D + d] : 0.f;
    }
    if (threadIdx.x < TILE)
      lab_s[threadIdx.x] = j0 + threadIdx.x < B ? yc[j0 + threadIdx.x] : 0;
    __syncthreads();
    const int j = j0 + lane;
    if (i < B && j < B && j != i) {
      const float* a = rows_s + warp * ld;
      const float* b = cols_s + lane * ld;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(a[d], b[d], dot);
      const float x = dot / tau;
      if (x > m) {
        s = s * expf(m - x) + 1.f;
        m = x;
      } else {
        s += expf(x - m);
      }
      if (lab_s[lane] == yi) {
        psum += x;
        pcnt += 1.f;
      }
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const float mm = fmaxf(m, m2);
    s = s * expf(m - mm) + s2 * expf(m2 - mm);
    m = mm;
    psum += __shfl_xor_sync(0xffffffffu, psum, off);
    pcnt += __shfl_xor_sync(0xffffffffu, pcnt, off);
  }
  if (lane == 0 && i < B) {
    const long long o = (long long)c * B + i;
    lse[o] = s > 0.f ? logf(s) + m : NEG;
    pos_sum[o] = psum;
    pos_cnt[o] = pcnt;
  }
}

}  // namespace

// q (C, B, D) float32 and labels (C, B) int32, contiguous; lse, pos_sum and
// pos_cnt (C, B) float32.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int ntxent_stats_f32(const void* q, const void* labels, void* lse,
                                void* pos_sum, void* pos_cnt, int C, int B,
                                int D, float tau, void* stream) {
  if (C <= 0 || B <= 0 || D <= 0 || D > MAX_D || C > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + ROWS - 1) / ROWS, C);
  const size_t shmem =
      sizeof(float) * (ROWS + TILE) * (D + 1) + sizeof(int) * TILE;
  ntxent_stats_kernel<<<grid, ROWS * 32, shmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int*>(labels),
      static_cast<float*>(lse), static_cast<float*>(pos_sum),
      static_cast<float*>(pos_cnt), B, D, tau);
  return static_cast<int>(cudaGetLastError());
}
