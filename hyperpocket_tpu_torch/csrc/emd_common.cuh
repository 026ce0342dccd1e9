// The 9 rounds of the approximate matching, shared by the EMD cost kernel
// (emd_match_cost.cu, K6) and its gradient kernel (emd_match_cost_grad.cu,
// K7), as hyperpocket_tpu/ops/pallas_emd.py::_emd_rounds is shared by the two
// TPU kernels: one copy of the rounds means the gradient replays exactly the
// rounds whose cost the forward returns.
//
// One block owns one cloud pair x (N points), y (M points). Both clouds sit
// in shared memory as float4 and so do the four O(N + M) vectors remain_l,
// ratio_l (N) and remain_r, ratio_r (M): 24 (N + M) bytes, 96 KB at
// N = M = 2048. Every phase of every round recomputes the distances and
// their exp from the clouds, as the TPU kernel's streaming scaffolding does;
// nothing NM-sized is stored anywhere. Per round, with `level` = -4^(7-r):
//   A (a thread per query i): ratio_l[i] = remain_l[i] /
//       (sum_j exp(level d_ij) remain_r[j] + 1e-9)
//   B (a thread per key j): sumr = (sum_i exp(level d_ij) ratio_l[i]) remain_r[j];
//       ratio_r[j] = min(remain_r[j] / (sumr + 1e-9), 1) remain_r[j];
//       remain_r[j] = max(0, remain_r[j] - sumr)
//   C (a thread per query i): w_ij = exp(level d_ij) ratio_r[j]; the caller's
//       accumulation sees every (i, j, d_ij, w_ij) with ratio_l[i]; then
//       remain_l[i] = max(0, remain_l[i] - (sum_j w_ij) ratio_l[i])
//   then the caller's own phase after C (the gradient's per-key sums).
// Threads own points i = threadIdx.x + k blockDim.x, so any N, M >= 1 works.
// Every sum runs over its index in order inside one thread, so the result
// is deterministic. expf is the accurate one (no --use_fast_math): the
// rounds divide by sums of exps that span many orders of magnitude.

#pragma once

#include <cuda_runtime.h>

#include <math.h>

namespace hpcd_emd {

constexpr int kThreads = 512;  // threads per block
constexpr int kRounds = 9;

// -4^(7 - r): -16384, -4096, ..., -1, -0.25 (approxmatch.cu:55-60); exact.
__device__ __forceinline__ float level_of(const int r) { return -ldexpf(1.f, 2 * (7 - r)); }

// |y - x|^2 as the TPU kernel computes it: d = 0; for c: diff = y_c - x_c;
// d += diff * diff, each step rounded on its own (no FMA contraction).
__device__ __forceinline__ float sqdist(const float4 x, const float4 y) {
  const float dx = __fsub_rn(y.x, x.x);
  const float dy = __fsub_rn(y.y, x.y);
  const float dz = __fsub_rn(y.z, x.z);
  float d = __fmul_rn(dx, dx);
  d = __fadd_rn(d, __fmul_rn(dy, dy));
  return __fadd_rn(d, __fmul_rn(dz, dz));
}

__device__ __forceinline__ float kern(const float level, const float d) {
  return expf(__fmul_rn(level, d));
}

// The block's shared memory, carved from the dynamic allocation.
struct Shared {
  float4* x;
  float4* y;
  float* remain_l;
  float* ratio_l;
  float* remain_r;
  float* ratio_r;
};

__host__ __device__ inline size_t shared_bytes(const int n, const int m) {
  return 16 * ((size_t)n + m) + 8 * ((size_t)n + m);
}

// Lay out the shared arrays and stage cloud pair b (x (n, 3), y (m, 3)).
__device__ __forceinline__ Shared stage(unsigned char* smem, const float* __restrict__ x,
                                        const float* __restrict__ y, const int n, const int m) {
  Shared s;
  s.x = reinterpret_cast<float4*>(smem);
  s.y = s.x + n;
  s.remain_l = reinterpret_cast<float*>(s.y + m);
  s.ratio_l = s.remain_l + n;
  s.remain_r = s.ratio_l + n;
  s.ratio_r = s.remain_r + m;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s.x[i] = make_float4(x[3 * (size_t)i], x[3 * (size_t)i + 1], x[3 * (size_t)i + 2], 0.f);
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    s.y[j] = make_float4(y[3 * (size_t)j], y[3 * (size_t)j + 1], y[3 * (size_t)j + 2], 0.f);
  return s;
}

// Row and column budgets with C integer division (approxmatch.cu:36-42).
__host__ __device__ inline void multipliers(const int n, const int m, float* multi_l,
                                            float* multi_r) {
  *multi_l = n >= m ? 1.f : (float)(m / n);
  *multi_r = n >= m ? (float)(n / m) : 1.f;
}

// The 9 rounds. `acc` supplies:
//   typename Acc::Row; Row row_begin(int i);
//   void row_pair(Row&, float4 x_i, float4 y_j, float d, float w, float rl);
//   void row_end(Row&, int i, float rl);           // phase C, per query
//   void after_c(const Shared&, float level);     // after phase C's barrier
// after_c must end with a barrier if it writes anything phase A reads or
// reads anything phase A writes (ratio_l).
template <class Acc>
__device__ void emd_rounds(const Shared& s, const int n, const int m, Acc& acc) {
  float multi_l, multi_r;
  multipliers(n, m, &multi_l, &multi_r);
  for (int i = threadIdx.x; i < n; i += blockDim.x) s.remain_l[i] = multi_l;
  for (int j = threadIdx.x; j < m; j += blockDim.x) s.remain_r[j] = multi_r;
  __syncthreads();

  for (int r = 0; r < kRounds; ++r) {
    const float level = level_of(r);
    // A: row normalisation
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float4 xi = s.x[i];
      float suml = 0.f;
#pragma unroll 4
      for (int j = 0; j < m; ++j)
        suml = __fadd_rn(suml, __fmul_rn(kern(level, sqdist(xi, s.y[j])), s.remain_r[j]));
      s.ratio_l[i] = __fdiv_rn(s.remain_l[i], __fadd_rn(suml, 1e-9f));
    }
    __syncthreads();
    // B: column feasibility and the remain_r update
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      const float4 yj = s.y[j];
      float sumr = 0.f;
#pragma unroll 4
      for (int i = 0; i < n; ++i)
        sumr = __fadd_rn(sumr, __fmul_rn(kern(level, sqdist(s.x[i], yj)), s.ratio_l[i]));
      const float rr = s.remain_r[j];
      sumr = __fmul_rn(sumr, rr);
      const float consumption = fminf(__fdiv_rn(rr, __fadd_rn(sumr, 1e-9f)), 1.f);
      s.ratio_r[j] = __fmul_rn(consumption, rr);
      s.remain_r[j] = fmaxf(0.f, __fsub_rn(rr, sumr));
    }
    __syncthreads();
    // C: the transported mass, the caller's accumulation, the remain_l update
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float4 xi = s.x[i];
      const float rl = s.ratio_l[i];
      typename Acc::Row row = acc.row_begin(i);
      float wsum = 0.f;
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const float4 yj = s.y[j];
        const float d = sqdist(xi, yj);
        const float w = __fmul_rn(kern(level, d), s.ratio_r[j]);
        wsum = __fadd_rn(wsum, w);
        acc.row_pair(row, xi, yj, d, w, rl);
      }
      acc.row_end(row, i, rl);
      s.remain_l[i] = fmaxf(0.f, __fsub_rn(s.remain_l[i], __fmul_rn(wsum, rl)));
    }
    __syncthreads();
    acc.after_c(s, level);
  }
}

}  // namespace hpcd_emd
