// Nearest-neighbour distances in both directions, without indices, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel hyperpocket_tpu/ops/pallas_nn.py::_nn_min_fused
// (_nn_min_fused_kernel). For clouds q (N points) and k (M points) it
// computes, from one pass over the (query, key) distances,
//   dist1_i = min_j |k_j - q_i|^2   and   dist2_j = min_i |k_j - q_i|^2,
// with the arithmetic of nn_common.cuh (the same bits as nn_one_direction.cu
// and the plain PyTorch version). The loss value of the val step and of any
// Chamfer that needs no gradient comes from it.
//
// What bounds it on the H100: the fp32 issue rate, as for
// nn_one_direction.cu, plus the reduction of direction 2 across threads.
// The design:
//   * the block shape and key staging of nn_one_direction.cu: one block per
//     (cloud, 256-query tile), keys in shared memory 2048 at a time, four
//     queries per thread; direction 1 is a running min in registers;
//   * direction 2: each lane first takes, for 32 keys in a row, the min over
//     its four queries, holding the 32 partial minima in registers; a
//     butterfly of 31 shuffles (16 + 8 + 4 + 2 + 1, each lane keeping half
//     of what is left) then leaves lane l with the warp's min for key l.
//     Reducing key by key would cost 5 shuffles a key, and the shuffle unit
//     issues at a quarter of the fp32 rate. The lanes then merge their keys
//     into the block's minima in shared memory with an atomicMin each (no
//     two lanes on one address), and each chunk's minima merge across the
//     cloud's query tiles with a global atomicMin;
//   * blocks run in no order, so the cross-block merge uses an unsigned
//     atomicMin on the bits of the float into a buffer set to +inf first:
//     squared distances are >= +0, and such floats order as their bits.
//     Min is order-independent, so the result is deterministic.
// Key chunks are padded to a multiple of 32 with keys at +inf, whose
// distances (+inf) change no minimum and are never stored.

#include <cuda_runtime.h>

#include <math.h>

#include "nn_common.cuh"

namespace {

using namespace hpcd_nn;

constexpr unsigned kInfBits = 0x7f800000u;  // +inf as float bits

__global__ void fill_inf_bits(unsigned* __restrict__ a, const long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) a[i] = kInfBits;
}

// One step of the butterfly: lanes that differ in bit W swap halves, so
// each keeps W of its 2W partial minima, merged with its partner's. Lanes
// with bit W set keep the upper half. A template, so that every index into
// `part` is a constant and the array stays in registers.
template <int W>
__device__ __forceinline__ void butterfly_min(float* part, const int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? part[i] : part[i + W];
    const float keep = upper ? part[i + W] : part[i];
    part[i] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, W));
  }
}

__global__ void __launch_bounds__(kThreads)
nn_min_fused_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    float* __restrict__ dist1, unsigned* __restrict__ dist2_bits,
                    const int n, const int m, const int tiles) {
  __shared__ float4 sk[kKeyChunk];
  __shared__ unsigned skmin[kKeyChunk];
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int lane = threadIdx.x & 31;
  const float* qb = q + 3 * (size_t)b * n;
  const float* kb = k + 3 * (size_t)b * m;

  float qx[kQpt], qy[kQpt], qz[kQpt], best[kQpt];
  load_queries(qb, n, tile, qx, qy, qz);
#pragma unroll
  for (int s = 0; s < kQpt; ++s) best[s] = INFINITY;

  for (int start = 0; start < m; start += kKeyChunk) {
    const int count = min(kKeyChunk, m - start);
    const int padded = (count + 31) & ~31;
    __syncthreads();  // the previous chunk's keys and minima are consumed
    stage_keys(kb, start, count, sk);
    for (int j = count + (int)threadIdx.x; j < padded; j += blockDim.x)
      sk[j] = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    for (int j = threadIdx.x; j < count; j += blockDim.x) skmin[j] = kInfBits;
    __syncthreads();
    for (int c0 = 0; c0 < padded; c0 += 32) {
      float part[32];
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) {
        const float4 key = sk[c0 + kk];
        float kmin = INFINITY;
#pragma unroll
        for (int s = 0; s < kQpt; ++s) {
          const float d = sqdist(key, qx[s], qy[s], qz[s]);
          best[s] = fminf(best[s], d);
          kmin = fminf(kmin, d);
        }
        part[kk] = kmin;
      }
      // after the step of width W, part[i] holds key i + (the lane's bits
      // >= W, as an offset), so part[0] ends as the warp's min for key `lane`
      butterfly_min<16>(part, lane);
      butterfly_min<8>(part, lane);
      butterfly_min<4>(part, lane);
      butterfly_min<2>(part, lane);
      butterfly_min<1>(part, lane);
      if (c0 + lane < count) atomicMin(&skmin[c0 + lane], __float_as_uint(part[0]));
    }
    __syncthreads();
    unsigned* out = dist2_bits + (size_t)b * m + start;
    for (int j = threadIdx.x; j < count; j += blockDim.x) atomicMin(&out[j], skmin[j]);
  }

#pragma unroll
  for (int s = 0; s < kQpt; ++s) {
    const int i = tile * kQueries + s * kThreads + (int)threadIdx.x;
    if (i < n) dist1[(size_t)b * n + i] = best[s];
  }
}

}  // namespace

// q (batch, n, 3) and k (batch, m, 3) fp32, contiguous; dist1 (batch, n) and
// dist2 (batch, m) fp32 are written (dist2 is set to +inf first). Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int hpcd_nn_min_fused(const void* q, const void* k, void* dist1, void* dist2,
                                 int batch, int n, int m, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (n + kQueries - 1) / kQueries;
  if ((long long)batch * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long count = (long long)batch * m;
  fill_inf_bits<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(static_cast<unsigned*>(dist2),
                                                                count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_min_fused_kernel<<<batch * tiles, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<float*>(dist1),
      static_cast<unsigned*>(dist2), n, m, tiles);
  return (int)cudaGetLastError();
}
