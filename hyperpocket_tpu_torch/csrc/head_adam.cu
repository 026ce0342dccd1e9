// Fused hypernetwork-head Adam update for Hopper (sm_90a): the head's weight
// gradient and the Adam step on weight and moments, in one pass over the head.
//
// Replaces the TPU kernel hyperpocket_tpu/ops/pallas_head_adam.py::
// head_adam_update (_head_adam_kernel). The head is an nn.Linear(K=2048,
// N=19011), so its weight p is (N, K), row-major, and the moments m, v have
// the same layout. From the trunk activations h (B, K) and the head-output
// cotangent dout (B, N), both in the compute dtype (bf16 or fp32), it forms
//   dw[n, k] = sum_b dout[b, n] * h[b, k]      (fp32 accumulation, b in order)
// and applies, with the six scalars lr, b1, b2, eps, bc1 = 1 - b1^t and
// bc2 = 1 - b2^t,
//   m = b1 m + (1 - b1) dw;  v = b2 v + (1 - b2) dw^2;
//   p -= lr (m / bc1) / (sqrt(v / bc2) + eps),
// with m and v in fp32 from the stored moments (fp32 or bf16) and rounded
// to the stored dtype on the way out, as the TPU kernel does.
//
// What bounds it on the H100: bytes. Every entry of p, m and v is read and
// written once: 16 bytes an entry with bf16 moments (24 with fp32), 623 MB
// for the 38.9 M entries of the head, ~0.19 ms at 3.35 TB/s; the 5 GFLOP of
// fp32 multiply-adds take ~0.07 ms at the fp32 rate. The design keeps dw out
// of device memory and touches p/m/v once:
//   * one block of 256 threads per (32 rows of n, 128 columns of k) tile;
//     each thread owns a 4 x 4 register tile of dw (4 rows, 4 adjacent k);
//   * h's and dout's slices of 32 batch rows at a time are staged in shared
//     memory as fp32 (20 KB); per batch row a thread reads one float4 of h
//     (lanes on adjacent words) and one float4 of dout (the same address in
//     a warp, a broadcast) for 16 multiply-adds;
//   * the epilogue reads p (float4) and m, v (float4 or 4 bf16) of the
//     thread's entries, which a warp reads as 512 contiguous bytes of p per
//     row, and writes them back in place.
// The last tile of n (19011 is odd) is partial: rows past N read zeros of
// dout and are never stored. K must be a multiple of 4. The sum over b runs
// in one thread in a fixed order, so two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kTileN = 32;
constexpr int kTileK = 128;
constexpr int kChunkB = 32;  // batch rows staged at a time
constexpr int kThreads = 256;

struct AdamScalars {
  float lr, b1, b2, eps, bc1, bc2;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load4(const float* p, float (&out)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}

__device__ __forceinline__ void load4(const bf16* p, float (&out)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  out[0] = __low2float(lo); out[1] = __high2float(lo);
  out[2] = __low2float(hi); out[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  uint2 q;
  *reinterpret_cast<__nv_bfloat162*>(&q.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&q.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = q;
}

template <typename T, typename M>
__global__ void __launch_bounds__(kThreads)
head_adam_kernel(const T* __restrict__ h, const T* __restrict__ dout, float* __restrict__ p,
                 M* __restrict__ m, M* __restrict__ v, AdamScalars sc, int batch, int n_dim,
                 int k_dim) {
  __shared__ __align__(16) float h_s[kChunkB][kTileK];
  __shared__ __align__(16) float d_s[kChunkB][kTileN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kTileN;
  const int k0 = blockIdx.y * kTileK;
  const int ng = tid >> 5;  // the warp: rows n0 + 4 ng .. + 3
  const int kg = tid & 31;  // columns k0 + 4 kg .. + 3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int b0 = 0; b0 < batch; b0 += kChunkB) {
    const int rows = min(kChunkB, batch - b0);
    __syncthreads();  // the previous chunk's reads are done
    for (int e = tid; e < kChunkB * kTileK; e += kThreads) {
      const int b = e / kTileK, kk = e % kTileK;
      h_s[b][kk] = (b < rows && k0 + kk < k_dim)
                       ? to_float(h[(size_t)(b0 + b) * k_dim + k0 + kk]) : 0.0f;
    }
    for (int e = tid; e < kChunkB * kTileN; e += kThreads) {
      const int b = e / kTileN, nn = e % kTileN;
      d_s[b][nn] = (b < rows && n0 + nn < n_dim)
                       ? to_float(dout[(size_t)(b0 + b) * n_dim + n0 + nn]) : 0.0f;
    }
    __syncthreads();
    for (int b = 0; b < rows; ++b) {
      const float4 hv = *reinterpret_cast<const float4*>(&h_s[b][4 * kg]);
      const float4 dv = *reinterpret_cast<const float4*>(&d_s[b][4 * ng]);
      const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
      const float ds[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ds[i], hs[j], acc[i][j]);
    }
  }

  const int k = k0 + 4 * kg;
  if (k >= k_dim) return;  // k_dim % 4 == 0: the thread's 4 columns are all in or all out
  const float one_b1 = 1.0f - sc.b1;
  const float one_b2 = 1.0f - sc.b2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 4 * ng + i;
    if (n >= n_dim) break;
    const size_t at = (size_t)n * k_dim + k;
    float pw[4], mw[4], vw[4];
    load4(p + at, pw);
    load4(m + at, mw);
    load4(v + at, vw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float dw = acc[i][j];
      mw[j] = sc.b1 * mw[j] + one_b1 * dw;
      vw[j] = sc.b2 * vw[j] + one_b2 * dw * dw;
      pw[j] = pw[j] - sc.lr * ((mw[j] / sc.bc1) / (sqrtf(vw[j] / sc.bc2) + sc.eps));
    }
    store4(p + at, pw);
    store4(m + at, mw);
    store4(v + at, vw);
  }
}

template <typename T, typename M>
int launch(const void* h, const void* dout, void* p, void* m, void* v, AdamScalars sc,
           int batch, int n_dim, int k_dim, cudaStream_t s) {
  const dim3 grid((n_dim + kTileN - 1) / kTileN, (k_dim + kTileK - 1) / kTileK);
  head_adam_kernel<T, M><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(dout), static_cast<float*>(p),
      static_cast<M*>(m), static_cast<M*>(v), sc, batch, n_dim, k_dim);
  return (int)cudaGetLastError();
}

}  // namespace

// h (batch, k) and dout (batch, n) in one dtype (in_bf16: bf16, else fp32);
// p (n, k) fp32; m, v (n, k) in one dtype (moments_bf16: bf16, else fp32);
// k a multiple of 4, p/m/v 16-byte aligned. p, m and v are updated in place.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int hpcd_head_adam(const void* h, const void* dout, void* p, void* m, void* v,
                              float lr, float b1, float b2, float eps, float bc1, float bc2,
                              int batch, int n_dim, int k_dim, int in_bf16, int moments_bf16,
                              void* stream) {
  if (batch <= 0 || n_dim <= 0 || k_dim <= 0 || k_dim % 4) return (int)cudaErrorInvalidValue;
  const AdamScalars sc{lr, b1, b2, eps, bc1, bc2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return moments_bf16 ? launch<bf16, bf16>(h, dout, p, m, v, sc, batch, n_dim, k_dim, s)
                        : launch<bf16, float>(h, dout, p, m, v, sc, batch, n_dim, k_dim, s);
  }
  return moments_bf16 ? launch<float, bf16>(h, dout, p, m, v, sc, batch, n_dim, k_dim, s)
                      : launch<float, float>(h, dout, p, m, v, sc, batch, n_dim, k_dim, s);
}
