// The single-pass nearest-neighbour sweep with first argmins in both
// directions, shared by nn_fused_planes.cu (K5) and chamfer_loss_grad.cu
// (K9), which differ only in what they do with its two word buffers.
//
// What bounds it: the fp32 issue rate, about 14 instructions a (query, key)
// pair: 8 for the distance (nn_common.cuh: no FMA, so the bits are K1's, K3's
// and the plain version's), then a compare and two selects in each
// direction. The work is to keep the SMs issuing them:
//   * grid (cloud, 1024-query tile, key split): the keys of a cloud are cut
//     into `splits` runs of `length` (ops/nn.py::nn_fused_split picks them
//     from the batch, the tiles, M and the SM count, so that the grid fills
//     every SM to its register limit). B=64 at 1024x2048 is 64 tiles x 8
//     splits; 128 threads at <= 128 registers put 16 warps on an SM, where a
//     grid of one block per tile had 4;
//   * eight queries a thread in registers, keys in shared memory as float4:
//     one 16-byte broadcast load feeds eight distances. A block that sweeps
//     more than one chunk of kFusedChunk keys copies the next chunk with
//     cp.async into the other half of a double buffer while it sweeps the
//     current one. TMA cannot copy the keys (a row is 12 bytes, under its
//     16-byte stride granule), and wgmma would need |q|^2 + |k|^2 - 2 q.k,
//     whose rounding changes distances and hence argmins: the sweep stays
//     on the fp32 cores;
//   * direction 1: each thread keeps, for its eight queries, a running
//     (min, first key) with a strict < in key order;
//   * direction 2: for 16 keys in a row each lane takes the (min, first
//     query) over its eight queries; a butterfly of 15 shuffle pairs (8 + 4
//     + 2 + 1) leaves lane l with its half-warp's pair for key l % 16, and
//     one more shuffle across the halves gives the warp's. At equal
//     distances the smaller query index is kept. Eight queries, not four,
//     spread the butterfly's ~11 instructions a key over twice the pairs
//     (about 15 instructions a pair in all). What keeps that under 128
//     registers: 16 keys, not 32, halve the pairs a lane holds, and a pair
//     carries a slot-and-lane code (slot * 32 + lane, which orders as the
//     query index inside a warp) in place of the index, rebuilt after the
//     butterfly, so the eight indices need no registers;
//   * both directions merge across blocks the same way: a 64-bit atomicMin
//     on (float bits << 32) | index into a word buffer filled with
//     kEmptyPair first; (batch, n) words for the queries (one merge per
//     split), (batch, m) for the keys (through a per-chunk buffer in shared
//     memory, then one merge per query tile). Squared distances are >= +0,
//     whose bits order as the floats, so the smallest word is the smallest
//     distance and, among equal ones, the first index: the same result in
//     any block order, with no tie broken by timing.
// Padding keys (a chunk is filled up to a multiple of 16) sit at +inf: a
// distance to them never passes a strict < against a finite one, and they
// are never stored. Spare query slots of the last tile repeat query n - 1
// with its own index, so they change no minimum and no argmin.

#pragma once

#include <cuda_runtime.h>

#include <math.h>

#include "nn_common.cuh"

namespace hpcd_nn {

constexpr int kFusedThreads = 128;                        // four warps
constexpr int kFusedQpt = 8;                              // queries per thread
constexpr int kFusedQueries = kFusedThreads * kFusedQpt;  // queries per block (a tile)
constexpr int kFusedBlocksPerSm = 4;   // 65536 registers / (128 threads x 128)
constexpr int kFusedChunk = 1024;      // keys a buffer of the double buffer holds
constexpr int kGroup = 16;             // keys a warp reduces at a time in direction 2

// (+inf, index 2^32 - 1): larger than every (distance, index) word
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

// static: each source that includes this header gets its own copy of each
// kernel. Sets `count` words to kEmptyPair and `zero_count` floats to 0.
static __global__ void fill_words(unsigned long long* __restrict__ words, const long long count,
                                  float* __restrict__ zeros, const long long zero_count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) words[i] = kEmptyPair;
  if (i < zero_count) zeros[i] = 0.f;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Start copying `count` keys from `kb + 3 * start` into `sk` as float4 (one
// commit group) and set the padding up to a multiple of kGroup to +inf.
__device__ __forceinline__ void stage_keys_async(const float* __restrict__ kb, const int start,
                                                 const int count, float4* sk) {
  for (int j = threadIdx.x; j < count; j += kFusedThreads) {
    const float* p = kb + 3 * (size_t)(start + j);
    float* s = reinterpret_cast<float*>(sk + j);
    cp_async4(s, p);
    cp_async4(s + 1, p + 1);
    cp_async4(s + 2, p + 2);
  }
  const int padded = (count + kGroup - 1) & ~(kGroup - 1);
  for (int j = count + (int)threadIdx.x; j < padded; j += kFusedThreads)
    sk[j] = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ bool pair_less(const float d, const int i, const float e,
                                          const int j) {
  return d < e || (d == e && i < j);
}

// One step of the butterfly of nn_min_fused.cu, on (distance, index) pairs:
// lanes that differ in bit W swap halves and keep the smaller pair. Lanes
// with bit W set keep the upper half. A template, so that every index into
// the arrays is a constant and they stay in registers.
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
    const bool take = pair_less(other_d, other_i, keep_d, keep_i);
    part[i] = take ? other_d : keep_d;
    pidx[i] = take ? other_i : keep_i;
  }
  if constexpr (W > 1) butterfly_argmin<W / 2>(part, pidx, lane);
}

// part / pidx hold a lane's pairs for kGroup keys; afterwards part[0] /
// pidx[0] of lane l hold the warp's pair for key l % kGroup.
__device__ __forceinline__ void reduce_keys(float* part, int* pidx, const int lane) {
  butterfly_argmin<kGroup / 2>(part, pidx, lane);
#pragma unroll
  for (int x = kGroup; x < 32; x <<= 1) {
    const float other_d = __shfl_xor_sync(0xffffffffu, part[0], x);
    const int other_i = __shfl_xor_sync(0xffffffffu, pidx[0], x);
    if (pair_less(other_d, other_i, part[0], pidx[0])) {
      part[0] = other_d;
      pidx[0] = other_i;
    }
  }
}

// One block per (cloud, tile, split), split fastest. query_words (batch, n)
// and key_words (batch, m) must hold kEmptyPair before the launch; they end
// as each query's (min, first key) and each key's (min, first query).
static __global__ void __launch_bounds__(kFusedThreads, kFusedBlocksPerSm)
nn_fused_kernel(const float* __restrict__ q, const float* __restrict__ k,
                unsigned long long* __restrict__ query_words,
                unsigned long long* __restrict__ key_words, const int n, const int m,
                const int tiles, const int splits, const int length) {
  __shared__ __align__(16) float4 sk[2][kFusedChunk];
  __shared__ unsigned long long skbest[kFusedChunk];
  const int split = (int)(blockIdx.x % (unsigned)splits);
  const int tile = (int)(blockIdx.x / (unsigned)splits % (unsigned)tiles);
  const int b = (int)(blockIdx.x / (unsigned)splits / (unsigned)tiles);
  const int lane = threadIdx.x & 31;
  const int first = split * length;
  const int last = (int)min((long long)first + length, (long long)m);
  const float* qb = q + 3 * (size_t)b * n;
  const float* kb = k + 3 * (size_t)b * m;

  // slot s of thread t is query tile * kFusedQueries + s * kFusedThreads + t,
  // which warp_base rebuilds from the code s * 32 + lane
  const int warp_base = tile * kFusedQueries + ((int)threadIdx.x & ~31);
  float qx[kFusedQpt], qy[kFusedQpt], qz[kFusedQpt], best[kFusedQpt];
  int arg[kFusedQpt];
#pragma unroll
  for (int s = 0; s < kFusedQpt; ++s) {
    const int i = min(warp_base + s * kFusedThreads + lane, n - 1);
    qx[s] = qb[3 * (size_t)i];
    qy[s] = qb[3 * (size_t)i + 1];
    qz[s] = qb[3 * (size_t)i + 2];
    best[s] = INFINITY;
    arg[s] = first;
  }
  for (int j = threadIdx.x; j < kFusedChunk; j += kFusedThreads) skbest[j] = kEmptyPair;
  stage_keys_async(kb, first, min(kFusedChunk, last - first), sk[0]);

  int buf = 0;
  for (int start = first; start < last; start += kFusedChunk, buf ^= 1) {
    const int count = min(kFusedChunk, last - start);
    if (start + kFusedChunk < last) {
      // sk[buf ^ 1] was last read before the __syncthreads that ended the
      // previous chunk
      stage_keys_async(kb, start + kFusedChunk, min(kFusedChunk, last - start - kFusedChunk),
                       sk[buf ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's keys, padding and empty skbest are visible
    const float4* keys = sk[buf];
    const int padded = (count + kGroup - 1) & ~(kGroup - 1);
    for (int c0 = 0; c0 < padded; c0 += kGroup) {
      float part[kGroup];
      int pidx[kGroup];
#pragma unroll
      for (int kk = 0; kk < kGroup; ++kk) {
        const float4 key = keys[c0 + kk];
        const int j = start + c0 + kk;
#pragma unroll
        for (int s = 0; s < kFusedQpt; ++s) {
          const float d = sqdist(key, qx[s], qy[s], qz[s]);
          if (d < best[s]) {
            best[s] = d;
            arg[s] = j;
          }
          if (s == 0 || d < part[kk]) {
            part[kk] = d;
            pidx[kk] = s;
          }
        }
        pidx[kk] = pidx[kk] * 32 + lane;
      }
      reduce_keys(part, pidx, lane);
      if (lane < kGroup && c0 + lane < count) {
        // a spare slot of the last tile stands for query n - 1
        const int i = min(warp_base + (pidx[0] >> 5) * kFusedThreads + (pidx[0] & 31), n - 1);
        atomicMin(&skbest[c0 + lane], pack_pair(part[0], i));
      }
    }
    __syncthreads();  // every warp has swept the chunk and merged its pairs
    unsigned long long* out = key_words + (size_t)b * m + start;
    for (int j = threadIdx.x; j < count; j += kFusedThreads) {
      atomicMin(&out[j], skbest[j]);
      skbest[j] = kEmptyPair;  // the thread that reads an entry resets it
    }
  }

#pragma unroll
  for (int s = 0; s < kFusedQpt; ++s) {
    const int i = warp_base + s * kFusedThreads + lane;
    if (i < n) atomicMin(&query_words[(size_t)b * n + i], pack_pair(best[s], arg[s]));
  }
}

// Fill `words` (batch * (n + m): the queries' words, then the keys') and
// zero `zeros`, then launch the sweep; returns cudaErrorInvalidValue for a
// split that does not cover the m keys with `splits` non-empty runs of
// `length`, else cudaGetLastError().
static cudaError_t launch_nn_fused(const float* q, const float* k, unsigned long long* words,
                                   const int batch, const int n, const int m, const int splits,
                                   const int length, float* zeros, const long long zero_count,
                                   cudaStream_t s) {
  if (splits < 1 || length < 1 || (long long)splits * length < m ||
      (long long)(splits - 1) * length >= m)
    return cudaErrorInvalidValue;
  const int tiles = (n + kFusedQueries - 1) / kFusedQueries;
  const long long blocks = (long long)batch * tiles * splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long count = (long long)batch * (n + m);
  const long long fill = count > zero_count ? count : zero_count;
  fill_words<<<(unsigned)((fill + 255) / 256), 256, 0, s>>>(words, count, zeros, zero_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nn_fused_kernel<<<(unsigned)blocks, kFusedThreads, 0, s>>>(
      q, k, words, words + (size_t)batch * n, n, m, tiles, splits, length);
  return cudaGetLastError();
}

}  // namespace hpcd_nn
