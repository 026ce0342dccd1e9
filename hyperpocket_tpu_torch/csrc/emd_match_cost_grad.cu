// Gradient of the approximate EMD cost for Hopper (sm_90a).
//
// Replaces the TPU kernel hyperpocket_tpu/ops/pallas_emd.py::
// match_cost_pallas_bwd (_emd_bwd_kernel over _emd_rounds). It replays the 9
// rounds of emd_common.cuh, the forward kernel's own code, and with the
// match treated as a constant (matchcostgrad1/2, approxmatch.cu:260-322)
// sums, for a unit cotangent,
//   gx_i = sum_j wd_ij (x_i - y_j),   gy_j = sum_i wd_ij (y_j - x_i),
//   wd_ij = w_ij ratio_l[i] rsqrt(max(d_ij, 1e-20)).
// Each term pairs a weight with its own difference, as approxmatch.cu's
// matchcostgrad does, so no term exceeds the mass w_ij ratio_l[i] it
// carries. The TPU kernel factors the sums instead, gx_i = x_i sum_j wd_ij -
// sum_j wd_ij y_j: where a key nearly coincides with a query, wd grows as
// 1/dist and the two products cancel. From the same rounds, on (2, 1024, 3)
// clouds, the factored fp32 sums lie 8.3e-6 of the gradient's largest entry
// from exact sums, the paired ones 1.6e-7. The paired form costs the same.
//
// What bounds it on the H100: the forward's 27 sweeps over the N x M pairs
// plus a fourth per round (below): 36 sweeps, each recomputing the distance
// and an accurate expf, so the fp32 issue rate. The per-query sums are
// taken in phase C by the thread that owns the query. The per-key sums run
// over queries, which phase C spreads over threads; rather than merge them
// across threads (atomics, whose order changes from run to run), a phase D
// after C gives each key one owning thread that sums over all queries in
// order, recomputing wd with the same arithmetic. Phase D reads ratio_l and
// ratio_r only, which phase C leaves alone. Both owners add each round's sums
// to the outputs in place, in a fixed order, so the gradients are
// deterministic. The layout is the forward kernel's: one block of 512
// threads per cloud pair.

#include <cuda_runtime.h>

#include "emd_common.cuh"

namespace {

using namespace hpcd_emd;

__device__ __forceinline__ float wd_of(const float w, const float rl, const float d) {
  return __fmul_rn(__fmul_rn(w, rl), rsqrtf(fmaxf(d, 1e-20f)));
}

// This pair's slices of the outputs.
struct GradAcc {
  float* gx;  // (n, 3)
  float* gy;  // (m, 3)
  int n, m;

  struct Row {
    float x, y, z;
  };
  __device__ __forceinline__ Row row_begin(int) const { return {0.f, 0.f, 0.f}; }
  __device__ __forceinline__ void row_pair(Row& r, const float4 xi, const float4 yj,
                                           const float d, const float w,
                                           const float rl) const {
    const float wd = wd_of(w, rl, d);
    r.x = __fadd_rn(r.x, __fmul_rn(wd, __fsub_rn(xi.x, yj.x)));
    r.y = __fadd_rn(r.y, __fmul_rn(wd, __fsub_rn(xi.y, yj.y)));
    r.z = __fadd_rn(r.z, __fmul_rn(wd, __fsub_rn(xi.z, yj.z)));
  }
  __device__ __forceinline__ void row_end(const Row& r, const int i, float) const {
    gx[3 * i] = __fadd_rn(gx[3 * i], r.x);
    gx[3 * i + 1] = __fadd_rn(gx[3 * i + 1], r.y);
    gx[3 * i + 2] = __fadd_rn(gx[3 * i + 2], r.z);
  }
  // D: the per-key sums, a thread per key
  __device__ void after_c(const Shared& s, const float level) const {
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      const float4 yj = s.y[j];
      const float rr = s.ratio_r[j];
      float cx = 0.f, cy = 0.f, cz = 0.f;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float4 xi = s.x[i];
        const float d = sqdist(xi, yj);
        const float wd = wd_of(__fmul_rn(kern(level, d), rr), s.ratio_l[i], d);
        cx = __fadd_rn(cx, __fmul_rn(wd, __fsub_rn(yj.x, xi.x)));
        cy = __fadd_rn(cy, __fmul_rn(wd, __fsub_rn(yj.y, xi.y)));
        cz = __fadd_rn(cz, __fmul_rn(wd, __fsub_rn(yj.z, xi.z)));
      }
      gy[3 * j] = __fadd_rn(gy[3 * j], cx);
      gy[3 * j + 1] = __fadd_rn(gy[3 * j + 1], cy);
      gy[3 * j + 2] = __fadd_rn(gy[3 * j + 2], cz);
    }
    __syncthreads();  // the next round's phase A rewrites ratio_l
  }
};

__global__ void __launch_bounds__(kThreads)
emd_match_cost_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                           float* __restrict__ gx, float* __restrict__ gy, const int n,
                           const int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const Shared s = stage(smem, x + 3 * (size_t)b * n, y + 3 * (size_t)b * m, n, m);
  GradAcc acc{gx + 3 * (size_t)b * n, gy + 3 * (size_t)b * m, n, m};
  // each thread zeroes the entries it owns in phases C and D, and only it
  // touches them afterwards
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    acc.gx[3 * i] = acc.gx[3 * i + 1] = acc.gx[3 * i + 2] = 0.f;
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    acc.gy[3 * j] = acc.gy[3 * j + 1] = acc.gy[3 * j + 2] = 0.f;
  emd_rounds(s, n, m, acc);
}

}  // namespace

// x (batch, n, 3) and y (batch, m, 3) fp32, contiguous; gx (batch, n, 3) and
// gy (batch, m, 3) fp32 are written. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int hpcd_emd_match_cost_grad(const void* x, const void* y, void* gx, void* gy,
                                        int batch, int n, int m, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = shared_bytes(n, m);
  cudaError_t err = cudaFuncSetAttribute(emd_match_cost_grad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  emd_match_cost_grad_kernel<<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(gx),
      static_cast<float*>(gy), n, m);
  return (int)cudaGetLastError();
}
