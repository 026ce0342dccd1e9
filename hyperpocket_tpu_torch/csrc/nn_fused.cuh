// The single-pass nearest-neighbour kernel with first argmins in both
// directions, shared by nn_fused_planes.cu (K5) and chamfer_loss_grad.cu
// (K9's first pass), which differ only in what they do with direction 1.
//
// It is nn_min_fused.cu (K3) with indices:
//   * blocks, key staging and distances are K3's (nn_common.cuh), so a
//     distance has the same bits as in K1, K3 and the plain version;
//   * direction 1: each thread keeps, for its four queries, a running
//     (min, first key) with a strict < in key order, as nn_one_direction.cu;
//   * direction 2: for 32 keys in a row each lane takes the (min, first
//     query) over its four queries, then a butterfly of 31 shuffle pairs
//     leaves lane l with the warp's pair for key l; at equal distances the
//     smaller query index is kept;
//   * the pairs merge into the block's per-key state in shared memory, and
//     each chunk's state into the cloud's in global memory, with a 64-bit
//     atomicMin on (float bits << 32) | query index. Squared distances are
//     >= +0, whose bits order as the floats, so the smallest word is the
//     smallest distance and, among equal ones, the first query: the same
//     result in any block order, with no tie broken by timing.
// Padding keys sit at +inf: a distance to them is +inf, which never passes
// a strict < against a finite one, and they are never stored. Spare query
// slots of the last tile repeat query n - 1 with its own index, so they
// change no minimum and no argmin.

#pragma once

#include <cuda_runtime.h>

#include <math.h>

#include "nn_common.cuh"

namespace hpcd_nn {

// (+inf, index 2^32 - 1): larger than every (distance, query) word
constexpr unsigned long long kEmptyPair = 0x7f800000ffffffffULL;

__device__ __forceinline__ unsigned long long pack_pair(const float d, const int i) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)i;
}

__device__ __forceinline__ float pair_dist(const unsigned long long p) {
  return __uint_as_float((unsigned)(p >> 32));
}

__device__ __forceinline__ int pair_index(const unsigned long long p) {
  return (int)(unsigned)(p & 0xffffffffULL);
}

// static: each source that includes this header gets its own copy
static __global__ void fill_empty_pairs(unsigned long long* __restrict__ a, const long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) a[i] = kEmptyPair;
}

// One step of the butterfly of nn_min_fused.cu, on (distance, index) pairs:
// lanes that differ in bit W swap halves and keep the smaller distance, and
// at equal distances the smaller index. Lanes with bit W set keep the upper
// half.
template <int W>
__device__ __forceinline__ void butterfly_argmin(float* part, int* pidx, const int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send_d = upper ? part[i] : part[i + W];
    const int send_i = upper ? pidx[i] : pidx[i + W];
    const float keep_d = upper ? part[i + W] : part[i];
    const int keep_i = upper ? pidx[i + W] : pidx[i];
    const float other_d = __shfl_xor_sync(0xffffffffu, send_d, W);
    const int other_i = __shfl_xor_sync(0xffffffffu, send_i, W);
    const bool take = other_d < keep_d || (other_d == keep_d && other_i < keep_i);
    part[i] = take ? other_d : keep_d;
    pidx[i] = take ? other_i : keep_i;
  }
}

// One block per (cloud, kQueries-query tile); key_pairs (batch, m) must hold
// kEmptyPair before the launch and ends as each key's (min, first query).
// Direction 1 ends in registers and goes to `epilogue(b, tile, qx, qy, qz,
// best, arg)`, called by every thread.
template <class Epilogue>
__global__ void __launch_bounds__(kThreads)
nn_fused_kernel(const float* __restrict__ q, const float* __restrict__ k,
                unsigned long long* __restrict__ key_pairs, const int n, const int m,
                const int tiles, const Epilogue epilogue) {
  __shared__ float4 sk[kKeyChunk];
  __shared__ unsigned long long skbest[kKeyChunk];
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int lane = threadIdx.x & 31;
  const float* qb = q + 3 * (size_t)b * n;
  const float* kb = k + 3 * (size_t)b * m;

  float qx[kQpt], qy[kQpt], qz[kQpt], best[kQpt];
  int arg[kQpt], qi[kQpt];
  load_queries(qb, n, tile, qx, qy, qz);
#pragma unroll
  for (int s = 0; s < kQpt; ++s) {
    best[s] = INFINITY;
    arg[s] = 0;
    qi[s] = min(tile * kQueries + s * kThreads + (int)threadIdx.x, n - 1);
  }

  for (int start = 0; start < m; start += kKeyChunk) {
    const int count = min(kKeyChunk, m - start);
    const int padded = (count + 31) & ~31;
    __syncthreads();  // the previous chunk's keys and pairs are consumed
    stage_keys(kb, start, count, sk);
    for (int j = count + (int)threadIdx.x; j < padded; j += blockDim.x)
      sk[j] = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    for (int j = threadIdx.x; j < count; j += blockDim.x) skbest[j] = kEmptyPair;
    __syncthreads();
    for (int c0 = 0; c0 < padded; c0 += 32) {
      float part[32];
      int pidx[32];
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) {
        const float4 key = sk[c0 + kk];
        float kmin = 0.f;
        int kidx = 0;
#pragma unroll
        for (int s = 0; s < kQpt; ++s) {
          const float d = sqdist(key, qx[s], qy[s], qz[s]);
          if (d < best[s]) {
            best[s] = d;
            arg[s] = start + c0 + kk;
          }
          if (s == 0 || d < kmin) {
            kmin = d;
            kidx = qi[s];
          }
        }
        part[kk] = kmin;
        pidx[kk] = kidx;
      }
      // as in nn_min_fused.cu, part[0] / pidx[0] end as the warp's pair for
      // key `lane` of the 32
      butterfly_argmin<16>(part, pidx, lane);
      butterfly_argmin<8>(part, pidx, lane);
      butterfly_argmin<4>(part, pidx, lane);
      butterfly_argmin<2>(part, pidx, lane);
      butterfly_argmin<1>(part, pidx, lane);
      if (c0 + lane < count) atomicMin(&skbest[c0 + lane], pack_pair(part[0], pidx[0]));
    }
    __syncthreads();
    unsigned long long* out = key_pairs + (size_t)b * m + start;
    for (int j = threadIdx.x; j < count; j += blockDim.x) atomicMin(&out[j], skbest[j]);
  }
  epilogue(b, tile, qx, qy, qz, best, arg);
}

// Launch fill_empty_pairs then nn_fused_kernel; returns cudaGetLastError().
template <class Epilogue>
cudaError_t launch_nn_fused(const float* q, const float* k, unsigned long long* key_pairs,
                            const int batch, const int n, const int m, const Epilogue& epilogue,
                            cudaStream_t s) {
  const int tiles = (n + kQueries - 1) / kQueries;
  if ((long long)batch * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long count = (long long)batch * m;
  fill_empty_pairs<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(key_pairs, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nn_fused_kernel<<<batch * tiles, kThreads, 0, s>>>(q, k, key_pairs, n, m, tiles, epilogue);
  return cudaGetLastError();
}

}  // namespace hpcd_nn
