// Nearest neighbours in both directions, with first argmins, in one pass,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel hyperpocket_tpu/ops/pallas_nn.py::_nn_fused_planes
// (_nn_fused_planes_kernel). For clouds q (N points) and k (M points) it
// computes, from one sweep over the (query, key) distances,
//   dist1_i = min_j |k_j - q_i|^2, idx1_i = the first j reaching it,
//   dist2_j = min_i |k_j - q_i|^2, idx2_j = the first i reaching it,
// the same bits and indices as nn_one_direction.cu run once each way. It is
// the grad forward of every NN/Chamfer op whose two clouds differ in size
// (ops/nn.py::nn_forward), where it computes each distance once instead of
// twice.
//
// What bounds it on the H100: the fp32 issue rate, about 14 instructions a
// (query, key) pair (8 for the distance, then a compare and two selects in
// each direction). The design is nn_fused.cuh's: K3's blocks and butterfly,
// carrying (distance, index) pairs, merged across blocks by a 64-bit
// atomicMin. The TPU kernel's (M, 128) planes are its layout for the
// sequential grid and are not carried over. Then a pass of one thread per
// key unpacks the words into dist2 and idx2.

#include <cuda_runtime.h>

#include "nn_fused.cuh"

namespace {

using namespace hpcd_nn;

struct StoreNearest {
  float* dist1;
  int* idx1;
  int n;

  __device__ void operator()(const int b, const int tile, const float*, const float*,
                             const float*, const float* best, const int* arg) const {
#pragma unroll
    for (int s = 0; s < kQpt; ++s) {
      const int i = tile * kQueries + s * kThreads + (int)threadIdx.x;
      if (i < n) {
        dist1[(size_t)b * n + i] = best[s];
        idx1[(size_t)b * n + i] = arg[s];
      }
    }
  }
};

__global__ void unpack_pairs(const unsigned long long* __restrict__ pairs,
                             float* __restrict__ dist2, int* __restrict__ idx2,
                             const long long count) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < count) {
    const unsigned long long p = pairs[j];
    dist2[j] = pair_dist(p);
    idx2[j] = pair_index(p);
  }
}

}  // namespace

// q (batch, n, 3) and k (batch, m, 3) fp32, contiguous; writes dist1, idx1
// (batch, n) and dist2, idx2 (batch, m) (fp32, int32); `pairs` is (batch, m)
// 64-bit scratch. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int hpcd_nn_fused_planes(const void* q, const void* k, void* dist1, void* idx1,
                                    void* dist2, void* idx2, void* pairs, int batch, int n,
                                    int m, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<unsigned long long*>(pairs);
  cudaError_t err = launch_nn_fused(
      static_cast<const float*>(q), static_cast<const float*>(k), words, batch, n, m,
      StoreNearest{static_cast<float*>(dist1), static_cast<int*>(idx1), n}, s);
  if (err != cudaSuccess) return (int)err;
  const long long count = (long long)batch * m;
  unpack_pairs<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
      words, static_cast<float*>(dist2), static_cast<int*>(idx2), count);
  return (int)cudaGetLastError();
}
