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
// each direction). The design is nn_fused.cuh's: a grid of (cloud, query
// tile, key split) blocks that fills every SM to its register limit, both
// directions merged across blocks by a 64-bit atomicMin into words. The
// TPU kernel's (M, 128) planes are its layout for the sequential grid and
// are not carried over. Three launches: the fill, the sweep, and a pass of
// one thread per word that unpacks both directions into (distance, index).

#include <cuda_runtime.h>

#include "nn_fused.cuh"

namespace {

using namespace hpcd_nn;

__global__ void unpack_pairs(const unsigned long long* __restrict__ pairs,
                             float* __restrict__ dist, int* __restrict__ idx,
                             const long long count) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < count) {
    const unsigned long long p = pairs[j];
    dist[j] = pair_dist(p);
    idx[j] = pair_index(p);
  }
}

}  // namespace

// q (batch, n, 3) and k (batch, m, 3) fp32, contiguous; dist (fp32) and idx
// (int32) hold batch * (n + m) values: dist1, idx1 (batch, n), then dist2,
// idx2 (batch, m). `words` is batch * (n + m) 64-bit scratch. The keys are
// swept in `splits` runs of `length` (ops/nn.py::nn_fused_split). Launches
// on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int hpcd_nn_fused_planes(const void* q, const void* k, void* dist, void* idx,
                                    void* words, int batch, int n, int m, int splits,
                                    int length, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<unsigned long long*>(words);
  cudaError_t err = launch_nn_fused(static_cast<const float*>(q), static_cast<const float*>(k),
                                    w, batch, n, m, splits, length, nullptr, 0, s);
  if (err != cudaSuccess) return (int)err;
  const long long count = (long long)batch * (n + m);
  unpack_pairs<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
      w, static_cast<float*>(dist), static_cast<int*>(idx), count);
  return (int)cudaGetLastError();
}
