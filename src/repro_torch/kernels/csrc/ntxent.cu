// Supervised NT-Xent loss (AdaSplit eq. 5), batched over clients: one
// forward launch and one backward launch for all C clients.
//
// Forward replaces: src/repro/kernels/ntxent.py `ntxent_stats` (_kernel),
// with the row normalisation and the loss reduction around it
// (src/repro/kernels/ntxent.py `ntxent_loss`) fused in.  For each client c
// and row i of its q (B, D), after q_i <- q_i / (|q_i| + 1e-8):
//   lse_i     = logsumexp_{j != i} (q_i . q_j / tau)
//   pos_sum_i = sum_{j != i, y_j == y_i} (q_i . q_j / tau)
//   pos_cnt_i = |{j != i : y_j == y_i}|   (as a float)
//   loss_c    = sum_i (cnt_i lse_i - pos_sum_i) / max(sum_i cnt_i, 1).
// Backward replaces no TPU kernel (the JAX package differentiates outside
// its Pallas kernel, through XLA): from d_loss (C,) it recomputes the
// similarities from the saved norms, P_ij = each row's softmax off the
// diagonal, dsim_ij = (d_loss cnt_i / N) P_ij - (d_loss / N) [y_j == y_i],
// dq_i = sum_j (dsim_ij + dsim_ji) q_j / tau, then the normaliser's Jacobian
// dr_i = dq_i / (n_i + 1e-8) - r_i (r_i . dq_i) / ((n_i + 1e-8)^2 n_i).
//
// What bounds it on an H100.  The trainer's client step (C=32, B=32, D=64)
// does 2 * C * B * B * D = 4.2 MFLOP forward (twice that backward) and moves
// 0.27 MB: ~0.1 us of fp32 FMA time at 67 TFLOP/s or of device memory at
// 3.35 TB/s.  Both are far under a launch, so at the path's shapes the
// launch is the cost, and the design's aim is one launch each way in place of
// ~10 forward and ~35 backward torch ops.
//
// Design.  One CTA per client, holding the client's (B, D) q in shared memory
// (rows of D + 1 floats, so the 32 lanes of a warp reading 32 different rows
// hit 32 different banks), one warp per row in turn.  Forward: lane l takes
// columns l, l + 32, ... (held in registers): a dot of D fp32 FMAs each, then
// the logsumexp in two passes, the row's max and then its sum of exponentials
// (no rescaling of a running sum, whose roundings would add up); the warp
// merges its lanes with shuffles.  The row statistics go to shared memory,
// and warp 0 reduces the loss over the rows in a fixed order.  Backward: the
// (B, B) similarities go to shared memory, each row becomes its dsim with P
// normalised by the row's own sum (so that a row of P sums to 1 to rounding,
// as the exact gradient's rows of dsim sum to 0; P from the saved lse would
// carry the forward's rounding of lse into every term), then lane l of a
// row's warp sums columns l, l + 32, ... of dq over j in order.  Both kernels
// are deterministic: fixed-order sums, no atomics.  B is at most MAX_B, so
// that the backward's q and dsim fit in one SM's shared memory at D = 256.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;  // 32 warps: one row each at B = 32
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;  // lse of a row with no other column
constexpr float NORM_EPS = 1e-8f;
constexpr int MAX_D = 256;
constexpr int MAX_B = 128;
constexpr int MAX_DL = MAX_D / 32;  // columns of dq per lane
constexpr int MAX_JL = MAX_B / 32;  // similarity columns per lane

size_t forward_smem(int B, int D) {
  return sizeof(float) * ((size_t)B * (D + 1) + 3 * B) + sizeof(int) * B;
}

size_t backward_smem(int B, int D) {
  return sizeof(float) * ((size_t)B * (D + 1) + (size_t)B * (B + 1)) +
         sizeof(int) * B;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// q_s <- the client's rows, normalised when `normalize` (norms from `norms`
// when given, else computed and written to `norms_out`); labels to y_s.
__device__ void stage_rows(const float* __restrict__ qc,
                           const int* __restrict__ yc, float* q_s, int* y_s,
                           int B, int D, int normalize,
                           const float* __restrict__ norms,
                           float* __restrict__ norms_out) {
  const int ld = D + 1;
  for (int e = threadIdx.x; e < B * D; e += blockDim.x) {
    const int r = e / D, d = e - r * D;
    q_s[r * ld + d] = qc[e];
  }
  for (int i = threadIdx.x; i < B; i += blockDim.x) y_s[i] = yc[i];
  __syncthreads();
  if (!normalize) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < B; i += WARPS) {
    float* row = q_s + i * ld;
    float n;
    if (norms != nullptr) {
      n = norms[i];
    } else {
      float ss = 0.f;
      for (int d = lane; d < D; d += 32) ss = fmaf(row[d], row[d], ss);
      n = sqrtf(warp_sum(ss));
      if (lane == 0) norms_out[i] = n;
    }
    const float den = n + NORM_EPS;
    for (int d = lane; d < D; d += 32) row[d] = row[d] / den;
  }
  __syncthreads();
}

__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

__global__ void __launch_bounds__(THREADS)
    ntxent_forward_kernel(const float* __restrict__ q,
                          const int* __restrict__ labels,
                          float* __restrict__ loss, float* __restrict__ lse,
                          float* __restrict__ pos_sum,
                          float* __restrict__ pos_cnt,
                          float* __restrict__ norms, int B, int D, float tau,
                          int normalize) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;                    // B x ld
  float* lse_s = q_s + B * ld;          // B
  float* pos_s = lse_s + B;             // B
  float* cnt_s = pos_s + B;             // B
  int* y_s = reinterpret_cast<int*>(cnt_s + B);
  const int c = blockIdx.x;
  const long long o = (long long)c * B;
  stage_rows(q + o * D, labels + o, q_s, y_s, B, D, normalize, nullptr,
             normalize ? norms + o : nullptr);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < B; i += WARPS) {
    const float* a = q_s + i * ld;
    const int yi = y_s[i];
    float x[MAX_JL];
    float m = NEG, psum = 0.f, pcnt = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_JL; ++k) {
      const int j = lane + 32 * k;
      x[k] = NEG;
      if (j < B && j != i) {
        x[k] = dot(a, q_s + j * ld, D) / tau;
        m = fmaxf(m, x[k]);
        if (y_s[j] == yi) {
          psum += x[k];
          pcnt += 1.f;
        }
      }
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_JL; ++k) {
      const int j = lane + 32 * k;
      if (j < B && j != i) s += expf(x[k] - m);
    }
    s = warp_sum(s);
    psum = warp_sum(psum);
    pcnt = warp_sum(pcnt);
    if (lane == 0) {
      const float l = s > 0.f ? logf(s) + m : NEG;
      lse_s[i] = l;
      pos_s[i] = psum;
      cnt_s[i] = pcnt;
      lse[o + i] = l;
      pos_sum[o + i] = psum;
      pos_cnt[o + i] = pcnt;
    }
  }
  __syncthreads();
  if (warp == 0) {
    float num = 0.f, den = 0.f;
    for (int i = lane; i < B; i += 32) {
      num += cnt_s[i] * lse_s[i] - pos_s[i];
      den += cnt_s[i];
    }
    num = warp_sum(num);
    den = warp_sum(den);
    if (lane == 0) loss[c] = num / fmaxf(den, 1.f);
  }
}

__global__ void __launch_bounds__(THREADS)
    ntxent_backward_kernel(const float* __restrict__ q,
                           const int* __restrict__ labels,
                           const float* __restrict__ norms,
                           const float* __restrict__ pos_cnt,
                           const float* __restrict__ d_loss,
                           float* __restrict__ dq, int B, int D, float tau,
                           int normalize) {
  extern __shared__ float smem[];
  const int ld = D + 1, lg = B + 1;
  float* q_s = smem;                    // B x ld: normalised rows
  float* g_s = q_s + B * ld;            // B x lg: similarities, then dsim
  int* y_s = reinterpret_cast<int*>(g_s + B * lg);
  __shared__ float gscale;              // d_loss / max(sum cnt, 1)
  const int c = blockIdx.x;
  const long long o = (long long)c * B;
  const float* qc = q + o * D;
  stage_rows(qc, labels + o, q_s, y_s, B, D, normalize,
             normalize ? norms + o : nullptr, nullptr);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    float den = 0.f;
    for (int i = lane; i < B; i += 32) den += pos_cnt[o + i];
    den = warp_sum(den);
    if (lane == 0) gscale = d_loss[c] / fmaxf(den, 1.f);
  }
  // the similarities, one pair per thread in turn
  for (int e = threadIdx.x; e < B * B; e += blockDim.x) {
    const int i = e / B, j = e - i * B;
    if (i != j) g_s[i * lg + j] = dot(q_s + i * ld, q_s + j * ld, D) / tau;
  }
  __syncthreads();
  const float g = gscale;

  // dsim_ij = d_lse_i P_ij - g [y_j == y_i] off the diagonal, 0 on it; P is
  // each row's softmax, normalised by the row's own sum (so a row of P sums
  // to 1 to rounding, as the loss's gradient needs), one warp per row
  for (int i = warp; i < B; i += WARPS) {
    float* row = g_s + i * lg;
    float m = NEG;
    for (int j = lane; j < B; j += 32)
      if (j != i) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < B; j += 32)
      if (j != i) s += expf(row[j] - m);
    s = warp_sum(s);
    const float ai = g * pos_cnt[o + i];
    for (int j = lane; j < B; j += 32) {
      float v = 0.f;
      if (j != i) {
        v = ai * (expf(row[j] - m) / s);
        if (y_s[i] == y_s[j]) v = v - g;
      }
      row[j] = v;
    }
  }
  __syncthreads();

  // dq_i = sum_j (dsim_ij + dsim_ji) q_j / tau, then the normaliser's
  // Jacobian; lane l holds columns l, l + 32, ...
  for (int i = warp; i < B; i += WARPS) {
    float acc[MAX_DL];
#pragma unroll
    for (int k = 0; k < MAX_DL; ++k) acc[k] = 0.f;
    for (int j = 0; j < B; ++j) {
      const float w = g_s[i * lg + j] + g_s[j * lg + i];
      const float* qj = q_s + j * ld;
#pragma unroll
      for (int k = 0; k < MAX_DL; ++k) {
        const int d = lane + 32 * k;
        if (d < D) acc[k] = fmaf(w, qj[d], acc[k]);
      }
    }
    const float* ri = qc + (long long)i * D;
    float* out = dq + (o + i) * D;
    if (!normalize) {
#pragma unroll
      for (int k = 0; k < MAX_DL; ++k) {
        const int d = lane + 32 * k;
        if (d < D) out[d] = acc[k] / tau;
      }
      continue;
    }
    float rd = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_DL; ++k) {
      const int d = lane + 32 * k;
      if (d < D) {
        acc[k] = acc[k] / tau;
        rd = fmaf(acc[k], ri[d], rd);
      }
    }
    rd = warp_sum(rd);
    const float n = norms[o + i];
    const float den = n + NORM_EPS;
    const float t = n > 0.f ? -rd / (den * den) / n : 0.f;
#pragma unroll
    for (int k = 0; k < MAX_DL; ++k) {
      const int d = lane + 32 * k;
      if (d < D) out[d] = acc[k] / den + ri[d] * t;
    }
  }
}

bool shape_ok(int C, int B, int D) {
  return C > 0 && B > 0 && B <= MAX_B && D > 0 && D <= MAX_D;
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

}  // namespace

extern "C" int ntxent_max_rows() { return MAX_B; }

// q (C, B, D) float32 and labels (C, B) int32, contiguous; loss (C,), and
// lse, pos_sum, pos_cnt (C, B) float32; norms (C, B) float32, written when
// `normalize` (may be null otherwise).  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int ntxent_forward_f32(const void* q, const void* labels,
                                  void* loss, void* lse, void* pos_sum,
                                  void* pos_cnt, void* norms, int C, int B,
                                  int D, float tau, int normalize,
                                  void* stream) {
  if (!shape_ok(C, B, D) || (normalize && norms == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = forward_smem(B, D);
  if (int err = prepare(ntxent_forward_kernel, smem)) return err;
  ntxent_forward_kernel<<<C, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int*>(labels),
      static_cast<float*>(loss), static_cast<float*>(lse),
      static_cast<float*>(pos_sum), static_cast<float*>(pos_cnt),
      static_cast<float*>(norms), B, D, tau, normalize);
  return static_cast<int>(cudaGetLastError());
}

// The forward's q, labels, norms (when `normalize`) and pos_cnt, and d_loss
// (C,) -> dq (C, B, D), the gradient with respect to the forward's
// un-normalised q.  All float32 (labels int32), contiguous.
extern "C" int ntxent_backward_f32(const void* q, const void* labels,
                                   const void* norms, const void* pos_cnt,
                                   const void* d_loss,
                                   void* dq, int C, int B, int D, float tau,
                                   int normalize, void* stream) {
  if (!shape_ok(C, B, D) || (normalize && norms == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = backward_smem(B, D);
  if (int err = prepare(ntxent_backward_kernel, smem)) return err;
  ntxent_backward_kernel<<<C, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int*>(labels),
      static_cast<const float*>(norms), static_cast<const float*>(pos_cnt),
      static_cast<const float*>(d_loss),
      static_cast<float*>(dq), B, D, tau, normalize);
  return static_cast<int>(cudaGetLastError());
}
