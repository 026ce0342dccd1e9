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
// that had to be fp32-exact; here they are plain loads and fp32 atomicAdds:
//   1. nn_fused.cuh's kernel, whose epilogue writes grad_a's direction-1
//      term, scatter-adds -2 (a_i - b_idx1(i)) into grad_b and adds the
//      block's dist1 into the loss;
//   2. once idx2 is final, one thread per key adds 2 (b_j - a_idx2(j)) to
//      grad_b_j (it alone owns that row in this pass), scatter-adds its
//      negation into grad_a_idx2(j) and adds dist2 into the loss.
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

struct GradDirection1 {
  const float* k;
  float* ga;
  float* gb;
  float* loss;
  int n;
  int m;

  __device__ void operator()(const int b, const int tile, const float* qx, const float* qy,
                             const float* qz, const float* best, const int* arg) const {
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kQpt; ++s) {
      const int i = tile * kQueries + s * kThreads + (int)threadIdx.x;
      if (i < n) {
        const float* kp = k + 3 * ((size_t)b * m + arg[s]);
        const float dx = 2.f * __fsub_rn(qx[s], kp[0]);
        const float dy = 2.f * __fsub_rn(qy[s], kp[1]);
        const float dz = 2.f * __fsub_rn(qz[s], kp[2]);
        float* g = ga + 3 * ((size_t)b * n + i);
        g[0] = dx;
        g[1] = dy;
        g[2] = dz;
        float* h = gb + 3 * ((size_t)b * m + arg[s]);
        atomicAdd(h, -dx);
        atomicAdd(h + 1, -dy);
        atomicAdd(h + 2, -dz);
        sum += best[s];
      }
    }
    sum = warp_sum(sum);
    if ((threadIdx.x & 31) == 0) atomicAdd(loss + b, sum);
  }
};

// grid (ceil(m / 256), batch), 256 threads: thread j of cloud b owns key j
__global__ void __launch_bounds__(256)
chamfer_direction2(const float* __restrict__ q, const float* __restrict__ k,
                   const unsigned long long* __restrict__ pairs, float* __restrict__ ga,
                   float* __restrict__ gb, float* __restrict__ loss, const int n, const int m) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  float d = 0.f;
  if (j < m) {
    const unsigned long long p = pairs[(size_t)b * m + j];
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
// loss (batch,), ga (batch, n, 3) and gb (batch, m, 3) fp32; `pairs` is
// (batch, m) 64-bit scratch. Launches on `stream`, does not synchronise,
// returns cudaGetLastError().
extern "C" int hpcd_chamfer_loss_grad(const void* q, const void* k, void* loss, void* ga,
                                      void* gb, void* pairs, int batch, int n, int m,
                                      void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(gb, 0, sizeof(float) * 3 * (size_t)batch * m, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(loss, 0, sizeof(float) * (size_t)batch, s);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  auto* words = static_cast<unsigned long long*>(pairs);
  float* gaf = static_cast<float*>(ga);
  float* gbf = static_cast<float*>(gb);
  float* lossf = static_cast<float*>(loss);
  err = launch_nn_fused(qf, kf, words, batch, n, m,
                        GradDirection1{kf, gaf, gbf, lossf, n, m}, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + 255) / 256), (unsigned)batch);
  chamfer_direction2<<<grid, 256, 0, s>>>(qf, kf, words, gaf, gbf, lossf, n, m);
  return (int)cudaGetLastError();
}
