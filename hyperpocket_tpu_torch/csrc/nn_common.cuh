// Shared pieces of the nearest-neighbour kernels (nn_one_direction.cu,
// nn_min_fused.cu): the block shape, the key staging and the distance.

#pragma once

#include <cuda_runtime.h>

namespace hpcd_nn {

constexpr int kThreads = 64;                 // threads per block (two warps)
constexpr int kQpt = 4;                      // queries per thread, held in registers
constexpr int kQueries = kThreads * kQpt;    // queries per block
constexpr int kKeyChunk = 2048;              // keys staged in shared memory at a time

// Squared distance with the TPU kernel's arithmetic: d = 0; for c in 0..2:
// diff = k_c - q_c; d += diff * diff. Each step is rounded on its own
// (__fsub_rn/__fmul_rn/__fadd_rn), so nvcc cannot contract it into FMAs
// and the plain PyTorch version gives the same bits.
__device__ __forceinline__ float sqdist(const float4 k, const float qx, const float qy,
                                        const float qz) {
  const float dx = __fsub_rn(k.x, qx);
  const float dy = __fsub_rn(k.y, qy);
  const float dz = __fsub_rn(k.z, qz);
  float d = __fmul_rn(dx, dx);
  d = __fadd_rn(d, __fmul_rn(dy, dy));
  return __fadd_rn(d, __fmul_rn(dz, dz));
}

// Copy `count` keys (x, y, z) starting at `kb + 3 * start` into `sk` as
// float4, so that one 16-byte shared load reads a key.
__device__ __forceinline__ void stage_keys(const float* __restrict__ kb, const int start,
                                           const int count, float4* sk) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const float* p = kb + 3 * (size_t)(start + j);
    sk[j] = make_float4(p[0], p[1], p[2], 0.f);
  }
}

// Load this thread's queries of tile `tile`. Query slot s of thread t is
// query tile * kQueries + s * kThreads + t, so neighbouring threads read
// and write neighbouring queries. Slots past n repeat query n - 1: they
// are never stored, and a repeated query cannot change a minimum over
// queries either.
__device__ __forceinline__ void load_queries(const float* __restrict__ qb, const int n,
                                             const int tile, float* qx, float* qy,
                                             float* qz) {
#pragma unroll
  for (int s = 0; s < kQpt; ++s) {
    const int i = min(tile * kQueries + s * kThreads + (int)threadIdx.x, n - 1);
    qx[s] = qb[3 * (size_t)i];
    qy[s] = qb[3 * (size_t)i + 1];
    qz[s] = qb[3 * (size_t)i + 2];
  }
}

}  // namespace hpcd_nn
