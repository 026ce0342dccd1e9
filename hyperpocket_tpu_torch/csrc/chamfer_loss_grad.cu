// Per-sample Chamfer loss and both gradient fields in one host call, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel hyperpocket_tpu/ops/pallas_nn.py::_chamfer_loss_grad
// (_chamfer_loss_grad_kernel). For gts a (N points) and preds b (M points),
// with idx1 / idx2 the first argmins of nn_fused_planes.cu, it computes
//   loss    = sum_i dist1_i + sum_j dist2_j                     (per sample)
//   grad_a_i = 2 (a_i - b_idx1(i)) + sum_{j: idx2(j) = i} 2 (a_i - b_j)
//   grad_b_j = 2 (b_j - a_idx2(j)) + sum_{i: idx1(i) = j} 2 (b_j - a_i)
// the gradient of the summed Chamfer through the first argmins (the sums
// of pallas_nn.py:546-555 and of ops/chamfer.py::nn_backward with g = 1).
// chamfer_loss_fused's forward runs it once and its backward only scales.
//
// What bounds it on the H100: the distance sweep, as in nn_fused_planes.cu
// (~14 fp32 instructions a pair); the gathers and scatters are O(N + M).
// The TPU kernel gathered and scattered through one-hot MXU contractions
// that had to be fp32-exact; here they are plain loads and fp32 atomicAdds.
// Direction 1 is final only once every key split has merged into its words,
// so the gradients come after the sweep, in four launches:
//   1. the fill: the words to empty, grad_b and the loss to 0;
//   2. nn_fused.cuh's split sweep, which writes both word buffers;
//   3. one thread per gts point i: grad_a_i = 2 (a_i - b_idx1(i)), a plain
//      store (no other writer of grad_a runs before step 4); -2 (a_i -
//      b_idx1(i)) scattered into grad_b with atomicAdd, since any number of
//      points may share idx1; dist1 added into the loss;
//   4. one thread per pred point j: 2 (b_j - a_idx2(j)) added to grad_b_j
//      (thread j is the only writer of that row in this launch, and the
//      scatters of step 3 have landed), -2 (b_j - a_idx2(j)) scattered into
//      grad_a with atomicAdd; dist2 added into the loss.
// Atomic additions land in an order that changes from run to run, so the
// last bits of the loss and of the scattered gradient entries do too: hold
// them to a tolerance, not for equality.

#include <cuda_runtime.h>

#include "nn_fused.cuh"

namespace {

using namespace hpcd_nn;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) v += __shfl_xor_sync(0xffffffffu, v, w);
  return v;
}

// grid (ceil(n / 256), batch), 256 threads: thread i of cloud b owns gts
// point i, whose word is words[b * n + i]
__global__ void __launch_bounds__(256)
chamfer_direction1(const float* __restrict__ q, const float* __restrict__ k,
                   const unsigned long long* __restrict__ words, float* __restrict__ ga,
                   float* __restrict__ gb, float* __restrict__ loss, const int n, const int m) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float d = 0.f;
  if (i < n) {
    const unsigned long long p = words[(size_t)b * n + i];
    d = pair_dist(p);
    const float* ap = q + 3 * ((size_t)b * n + i);
    const float* bp = k + 3 * ((size_t)b * m + pair_index(p));
    float* g = ga + 3 * ((size_t)b * n + i);
    float* h = gb + 3 * ((size_t)b * m + pair_index(p));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float diff = 2.f * __fsub_rn(ap[c], bp[c]);
      g[c] = diff;
      atomicAdd(h + c, -diff);
    }
  }
  d = warp_sum(d);
  if ((threadIdx.x & 31) == 0) atomicAdd(loss + b, d);
}

// grid (ceil(m / 256), batch), 256 threads: thread j of cloud b owns pred
// point j, whose word is key_words[b * m + j]
__global__ void __launch_bounds__(256)
chamfer_direction2(const float* __restrict__ q, const float* __restrict__ k,
                   const unsigned long long* __restrict__ key_words, float* __restrict__ ga,
                   float* __restrict__ gb, float* __restrict__ loss, const int n, const int m) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  float d = 0.f;
  if (j < m) {
    const unsigned long long p = key_words[(size_t)b * m + j];
    d = pair_dist(p);
    const float* ap = q + 3 * ((size_t)b * n + pair_index(p));
    const float* bp = k + 3 * ((size_t)b * m + j);
    float* h = gb + 3 * ((size_t)b * m + j);
    float* g = ga + 3 * ((size_t)b * n + pair_index(p));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float diff = 2.f * __fsub_rn(bp[c], ap[c]);
      h[c] = __fadd_rn(h[c], diff);
      atomicAdd(g + c, -diff);
    }
  }
  d = warp_sum(d);
  if ((threadIdx.x & 31) == 0) atomicAdd(loss + b, d);
}

}  // namespace

// q = gts (batch, n, 3) and k = preds (batch, m, 3) fp32, contiguous; writes
// loss (batch,), ga (batch, n, 3) and gb (batch, m, 3) fp32, where `loss`
// directly follows gb in memory (gb_loss holds batch * (3 m + 1) floats);
// `words` is batch * (n + m) 64-bit scratch. The keys are swept in `splits`
// runs of `length` (ops/nn.py::nn_fused_split). Launches on `stream`, does
// not synchronise, returns cudaGetLastError().
extern "C" int hpcd_chamfer_loss_grad(const void* q, const void* k, void* ga, void* gb_loss,
                                      void* words, int batch, int n, int m, int splits,
                                      int length, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  auto* w = static_cast<unsigned long long*>(words);
  float* gaf = static_cast<float*>(ga);
  float* gbf = static_cast<float*>(gb_loss);
  float* lossf = gbf + 3 * (size_t)batch * m;
  cudaError_t err = launch_nn_fused(qf, kf, w, batch, n, m, splits, length, gbf,
                                    (long long)batch * (3LL * m + 1), s);
  if (err != cudaSuccess) return (int)err;
  chamfer_direction1<<<dim3((unsigned)((n + 255) / 256), (unsigned)batch), 256, 0, s>>>(
      qf, kf, w, gaf, gbf, lossf, n, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chamfer_direction2<<<dim3((unsigned)((m + 255) / 256), (unsigned)batch), 256, 0, s>>>(
      qf, kf, w + (size_t)batch * n, gaf, gbf, lossf, n, m);
  return (int)cudaGetLastError();
}
