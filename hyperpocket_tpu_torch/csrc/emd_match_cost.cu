// Approximate EMD cost (approxmatch + matchcost) for Hopper (sm_90a).
//
// Replaces the TPU kernel hyperpocket_tpu/ops/pallas_emd.py::
// match_cost_pallas_fwd (_emd_kernel over _emd_rounds). For each cloud pair
// x (N points), y (M points) it runs the 9 soft-matching rounds of
// emd_common.cuh and returns
//   cost = sum_r sum_i ratio_l[i] sum_j w_ij sqrt(d_ij)
// (Euclidean distances weighted by the transported mass), without ever
// holding the (N, M) match matrix.
//
// What bounds it on the H100: every round makes three sweeps over the N x M
// pairs (phases A, B, C), each recomputing the distance (8 rounded fp32
// steps) and an accurate expf (one MUFU.EX2 plus about eight fp32
// instructions): 27 such sweeps per pair, ~20 fp32 instructions per element
// and sweep, so the fp32 issue rate bounds it, then the SFU. The design is
// the simple one: one block of 512 threads per cloud pair, both clouds and
// the four budget vectors in shared memory (24 (N + M) bytes), one thread
// per query in phases A and C and one per key in phase B. Left for later:
// the TPU kernel's (M, N) distance cache (32 MB at 2048^2, it cannot fit in
// shared memory), fusing phase C of round r - 1 with phase A of round r,
// and splitting a pair over several blocks so that B = 64 fills more than
// 64 of the 132 SMs.
//
// The cost is summed in a fixed order: each thread over its queries and
// rounds, then a fixed tree over the block, so it is deterministic.

#include <cuda_runtime.h>

#include "emd_common.cuh"

namespace {

using namespace hpcd_emd;

struct CostAcc {
  float cost = 0.f;  // this thread's share of the pair's cost
  using Row = float;
  __device__ __forceinline__ Row row_begin(int) const { return 0.f; }
  __device__ __forceinline__ void row_pair(Row& row, float4, float4, const float d,
                                           const float w, float) const {
    row = __fadd_rn(row, __fmul_rn(w, sqrtf(d)));
  }
  __device__ __forceinline__ void row_end(Row& row, int, const float rl) {
    cost = __fadd_rn(cost, __fmul_rn(row, rl));
  }
  __device__ __forceinline__ void after_c(const Shared&, float) const {}
};

__global__ void __launch_bounds__(kThreads)
emd_match_cost_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      float* __restrict__ cost, const int n, const int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_sums[kThreads / 32];
  const int b = blockIdx.x;
  const Shared s = stage(smem, x + 3 * (size_t)b * n, y + 3 * (size_t)b * m, n, m);
  CostAcc acc;
  emd_rounds(s, n, m, acc);

  // fixed-order block reduction: a butterfly in each warp, then warp 0
  float v = acc.cost;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, w));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, w));
    if (lane == 0) cost[b] = v;
  }
}

}  // namespace

// x (batch, n, 3) and y (batch, m, 3) fp32, contiguous; cost (batch,) fp32
// is written. Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes it does not take).
extern "C" int hpcd_emd_match_cost(const void* x, const void* y, void* cost, int batch, int n,
                                   int m, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = shared_bytes(n, m);
  cudaError_t err = cudaFuncSetAttribute(emd_match_cost_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  emd_match_cost_kernel<<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(cost), n,
      m);
  return (int)cudaGetLastError();
}
