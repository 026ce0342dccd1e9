// Adam with low-precision moments (the JAX package's scale_by_adam_lowp), one
// pass over a parameter tensor, for Hopper (sm_90a).
//
// Not a TPU kernel: in JAX, hyperpocket_tpu/train/optim.py::scale_by_adam_lowp
// runs inside the jitted train step, where XLA fuses it. The port's plain
// version (ops/adam_lowp.py::adam_lowp_update_reference) is about 20 torch
// elementwise kernels a tensor, each reading and writing the whole tensor.
// This kernel computes exactly their arithmetic, element by element, with
// the parameter p and its gradient g in one dtype P (fp32, bf16 or fp16) and
// the moments mu, nu in M (bf16, fp16, or fp32 as a config may ask):
//   g  = R_P(g + R_P(wd p))                          (coupled decay only)
//   mu = R_M(R_P(R_P(b1 R_P(mu)) + R_P((1 - b1) g)))
//   nu = R_M(R_P(R_P(b2 R_P(nu)) + R_P(R_P((1 - b2) g) g)))
//   u  = (mu / bc1) / (sqrt(nu / bc2) + eps)          (fp32, mu and nu as stored)
//   u  = u + R_P(wd p)                                (decoupled decay only)
//   p  = R_P(p + R_P(-lr u))
// where R_T rounds to T (to nearest even; the identity for fp32) and each
// operation is rounded on its own, as each torch kernel rounds its result:
// __fmul_rn, __fadd_rn, __fdiv_rn and __fsqrt_rn are never contracted into
// FMAs. The scalars come from the wrapper in fp32, as torch's CUDA kernels
// read a Python scalar for fp32, bf16 and fp16 tensors alike. bc1 = 1 - b1^t and bc2 = 1 - b2^t
// are fp32 device scalars from torch's own ops on the on-device count, read
// through pointers, so a CUDA graph that captures the step replays it with
// the count of each replay.
//
// What bounds it on the H100: bytes. Each element reads p, g, mu, nu and
// writes p, mu, nu once: 20 bytes an element for fp32 parameters with bf16
// moments. The ~30 flops an element are far below the card's rate. Each
// thread takes 4 adjacent elements with one vector load per tensor (16
// bytes of fp32, 8 of bf16) where every pointer is aligned to it, in a
// grid-stride loop; a scalar loop takes the tail and unaligned tensors.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kMaxBlocks = 132 * 16;

struct Scalars {
  float b1, one_b1, b2, one_b2, wd, eps, neg_lr;  // the Python scalars in fp32
  int coupled, decoupled;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// R_T: the fp32 value of v rounded to T
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

template <typename P, typename M>
__device__ __forceinline__ void adam_one(P& p, const P g_in, M& mu, M& nu, const Scalars& sc,
                                         const float bc1, const float bc2) {
  const float pf = to_f(p);
  float g = to_f(g_in);
  if (sc.coupled) g = rnd<P>(__fadd_rn(g, rnd<P>(__fmul_rn(pf, sc.wd))));
  const float m = rnd<P>(__fadd_rn(rnd<P>(__fmul_rn(rnd<P>(to_f(mu)), sc.b1)),
                                   rnd<P>(__fmul_rn(g, sc.one_b1))));
  const float gg = rnd<P>(__fmul_rn(rnd<P>(__fmul_rn(g, sc.one_b2)), g));
  const float v = rnd<P>(__fadd_rn(rnd<P>(__fmul_rn(rnd<P>(to_f(nu)), sc.b2)), gg));
  mu = from_f<M>(m);
  nu = from_f<M>(v);
  float u = __fdiv_rn(__fdiv_rn(to_f(mu), bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(to_f(nu), bc2)), sc.eps));
  if (sc.decoupled) u = __fadd_rn(u, rnd<P>(__fmul_rn(pf, sc.wd)));
  p = from_f<P>(__fadd_rn(pf, rnd<P>(__fmul_rn(u, sc.neg_lr))));
}

template <typename T>
struct alignas(sizeof(T) * kVec) Vec {
  T v[kVec];
};

template <typename P, typename M, bool kVectors>
__global__ void __launch_bounds__(kThreads)
adam_lowp_kernel(P* __restrict__ p, const P* __restrict__ g, M* __restrict__ mu,
                 M* __restrict__ nu, const float* __restrict__ bc1_ptr,
                 const float* __restrict__ bc2_ptr, const Scalars sc, const long long n) {
  const float bc1 = *bc1_ptr;
  const float bc2 = *bc2_ptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVectors) {
    const long long vecs = n / kVec;
    for (long long i = tid; i < vecs; i += stride) {
      Vec<P> pv = reinterpret_cast<Vec<P>*>(p)[i];
      const Vec<P> gv = reinterpret_cast<const Vec<P>*>(g)[i];
      Vec<M> mv = reinterpret_cast<Vec<M>*>(mu)[i];
      Vec<M> nv = reinterpret_cast<Vec<M>*>(nu)[i];
#pragma unroll
      for (int j = 0; j < kVec; ++j) adam_one(pv.v[j], gv.v[j], mv.v[j], nv.v[j], sc, bc1, bc2);
      reinterpret_cast<Vec<P>*>(p)[i] = pv;
      reinterpret_cast<Vec<M>*>(mu)[i] = mv;
      reinterpret_cast<Vec<M>*>(nu)[i] = nv;
    }
    done = vecs * kVec;
  }
  for (long long i = done + tid; i < n; i += stride) adam_one(p[i], g[i], mu[i], nu[i], sc, bc1, bc2);
}

template <typename T>
bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % (sizeof(T) * kVec) == 0;
}

template <typename P, typename M>
int launch(void* p, const void* g, void* mu, void* nu, const float* bc1, const float* bc2,
           const Scalars& sc, long long n, cudaStream_t s) {
  const bool vec = aligned<P>(p) && aligned<P>(g) && aligned<M>(mu) && aligned<M>(nu);
  const long long items = vec ? (n + kVec - 1) / kVec : n;
  const int blocks = (int)(items < (long long)kMaxBlocks * kThreads
                               ? (items + kThreads - 1) / kThreads : kMaxBlocks);
  P* pp = static_cast<P*>(p);
  const P* gp = static_cast<const P*>(g);
  M* mp = static_cast<M*>(mu);
  M* np_ = static_cast<M*>(nu);
  if (vec) {
    adam_lowp_kernel<P, M, true><<<blocks, kThreads, 0, s>>>(pp, gp, mp, np_, bc1, bc2, sc, n);
  } else {
    adam_lowp_kernel<P, M, false><<<blocks, kThreads, 0, s>>>(pp, gp, mp, np_, bc1, bc2, sc, n);
  }
  return (int)cudaGetLastError();
}

template <typename P>
int launch_p(int m_kind, void* p, const void* g, void* mu, void* nu, const float* bc1,
             const float* bc2, const Scalars& sc, long long n, cudaStream_t s) {
  if (m_kind == 0) return launch<P, float>(p, g, mu, nu, bc1, bc2, sc, n, s);
  if (m_kind == 1) return launch<P, bf16>(p, g, mu, nu, bc1, bc2, sc, n, s);
  if (m_kind == 2) return launch<P, __half>(p, g, mu, nu, bc1, bc2, sc, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One step of Adam with low-precision moments over n elements, in place:
// p and g of dtype p_kind (0 fp32, 1 bf16, 2 fp16), mu and nu of m_kind
// (the same codes), contiguous; bc1, bc2 point to fp32 device scalars. The
// scalars b1, 1 - b1, b2, 1 - b2, wd, eps and -lr are the Python floats
// in fp32; coupled / decoupled select the decay.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int hpcd_adam_lowp(void* p, const void* g, void* mu, void* nu, const void* bc1,
                              const void* bc2, float b1, float one_b1, float b2, float one_b2,
                              float wd, float eps, float neg_lr, int coupled, int decoupled,
                              long long n, int p_kind, int m_kind, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Scalars sc{b1, one_b1, b2, one_b2, wd, eps, neg_lr, coupled, decoupled};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c1 = static_cast<const float*>(bc1);
  const float* c2 = static_cast<const float*>(bc2);
  if (p_kind == 0) return launch_p<float>(m_kind, p, g, mu, nu, c1, c2, sc, n, s);
  if (p_kind == 1) return launch_p<bf16>(m_kind, p, g, mu, nu, c1, c2, sc, n, s);
  if (p_kind == 2) return launch_p<__half>(m_kind, p, g, mu, nu, c1, c2, sc, n, s);
  return (int)cudaErrorInvalidValue;
}
