// Nearest neighbour in one direction, with the index, for Hopper (sm_90a).
//
// Replaces the TPU kernel hyperpocket_tpu/ops/pallas_nn.py::_nn_one_direction
// (_nn_one_direction_kernel). For each query q_i of a cloud it computes
//   dist_i = min_j |k_j - q_i|^2   and   idx_i = the first j reaching it,
// with the TPU kernel's arithmetic (nn_common.cuh: three coordinate
// differences squared and added in order, no FMA). The training Chamfer loss
// runs it twice per step, once per direction, and its backward reads idx.
//
// What bounds it on the H100: about 11 fp32 instructions per (query, key)
// pair (3 sub, 3 mul, 2 add, a compare and two selects) against 12 bytes
// read per point, so it is bound by the SMs' fp32 issue rate, not by memory.
// At B=64, N=M=2048 that is 2.7e8 pairs. The design:
//   * one block per (cloud, 256-query tile): B=64, N=2048 gives 512 blocks
//     of two warps, all resident at once on the 132 SMs (a block per cloud
//     would leave half of the SMs idle);
//   * the cloud's keys are staged in shared memory as float4, 2048 at a
//     time (32 KB); every warp reads the same key at once, a broadcast;
//   * each thread holds four queries and their running min/argmin in
//     registers, so one shared load of a key feeds four distances. Keys
//     are visited in index order with a strict <, so ties keep the first
//     index, as jnp.argmin and torch.argmin do.
// Any N, M >= 1 works: the last query tile repeats query N - 1 in its spare
// slots and does not store them; key chunks end at M.

#include <cuda_runtime.h>

#include <math.h>

#include "nn_common.cuh"

namespace {

using namespace hpcd_nn;

__global__ void __launch_bounds__(kThreads)
nn_one_direction_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        float* __restrict__ dist, int* __restrict__ idx,
                        const int n, const int m, const int tiles) {
  __shared__ float4 sk[kKeyChunk];
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const float* qb = q + 3 * (size_t)b * n;
  const float* kb = k + 3 * (size_t)b * m;

  float qx[kQpt], qy[kQpt], qz[kQpt], best[kQpt];
  int arg[kQpt];
  load_queries(qb, n, tile, qx, qy, qz);
#pragma unroll
  for (int s = 0; s < kQpt; ++s) {
    best[s] = INFINITY;
    arg[s] = 0;
  }

  for (int start = 0; start < m; start += kKeyChunk) {
    const int count = min(kKeyChunk, m - start);
    __syncthreads();  // every thread is done with the previous chunk
    stage_keys(kb, start, count, sk);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < count; ++c) {
      const float4 key = sk[c];
#pragma unroll
      for (int s = 0; s < kQpt; ++s) {
        const float d = sqdist(key, qx[s], qy[s], qz[s]);
        if (d < best[s]) {
          best[s] = d;
          arg[s] = start + c;
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < kQpt; ++s) {
    const int i = tile * kQueries + s * kThreads + (int)threadIdx.x;
    if (i < n) {
      dist[(size_t)b * n + i] = best[s];
      idx[(size_t)b * n + i] = arg[s];
    }
  }
}

}  // namespace

// q (batch, n, 3) and k (batch, m, 3) fp32, contiguous; dist (batch, n) fp32
// and idx (batch, n) int32 are written. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int hpcd_nn_one_direction(const void* q, const void* k, void* dist, void* idx,
                                     int batch, int n, int m, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (n + kQueries - 1) / kQueries;
  if ((long long)batch * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  nn_one_direction_kernel<<<batch * tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<float*>(dist),
      static_cast<int*>(idx), n, m, tiles);
  return (int)cudaGetLastError();
}
