// Fused PointNet trunk + global max-pool for Hopper (sm_90a), bf16 inference.
//
// Replaces the TPU kernel hyperpocket_tpu/ops/pallas_encoder.py::trunk_pooled
// (_trunk_pool_kernel, _trunk_pool_kernel_grouped). It computes, per cloud,
//   max over points of  L5(relu(L4(relu(L3(relu(L2(relu(L1(x)))))))))
// with widths 3 -> 64 -> 128 -> 256 -> 512 -> 512 and the TPU kernel's
// numerics: layer 1 is three fp32 multiply-adds starting from the bias,
// layers 2-5 are fp32-accumulated bf16 dots plus the fp32 bias, every layer's
// output is rounded to bf16, and the max is taken in fp32 of those bf16
// values (layer 5 has no ReLU, so the pooled values may be negative).
//
// What bounds it on the H100: about 0.87 GFLOP per 1024-point cloud against
// ~6 KB of input and 1 KB of output, so it is compute-bound; its ceiling is
// the bf16 tensor cores. The design keeps every (points, channels)
// activation out of device memory:
//   * one block per (cloud, 128-point tile): B=64, N=1024 gives 512 blocks,
//     about four waves over the 132 SMs (a block per cloud would leave half
//     of them idle);
//   * the tile's activations ping-pong between two bf16 buffers in shared
//     memory (~205 KB, opted in above 48 KB), one block per SM;
//   * products are mma.sync m16n8k16 bf16 -> fp32 on the tensor cores. Each
//     of the 8 warps computes a 128 x 32 strip of a layer's output, so a B
//     fragment serves 8 products and an A fragment (ldmatrix from shared
//     memory) 4; the accumulators stay in registers through the epilogue
//     (bias, ReLU, bf16 pack, or the column max);
//   * the 0.87 MB of bf16 weights stay L2-resident and are read straight
//     from global memory: mma's B operand (k-pairs of one output column) is
//     a 32-bit word of a row of the nn.Linear (out, in) weight; the next
//     16-deep step's words are loaded while the current step multiplies;
//   * tiles of one cloud merge their column maxima with a float atomicMax
//     (ordered-int trick) into an fp32 (B, 512) buffer set to -inf first;
//     max is order-independent, so the result is deterministic.
// Rows past N in the last tile are computed but never enter the max.
// On an H100 80GB HBM3 at its 700 W limit this kernel took 0.91 ms at B=256,
// N=1024, against 1.04 ms for the same layers as cuBLAS bf16 matmuls plus a
// max, and 1.33 ms for the same tiling through the WMMA API (PERF.md).
// wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kTile = 128;  // points per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;     // bf16 row padding: ldmatrix rows land on distinct banks
constexpr int kLd0 = 256 + kPad;  // buffer 0: layer-1 (64) and layer-3 (256) outputs
constexpr int kLd1 = 512 + kPad;  // buffer 1: layer-2 (128) and layer-4 (512) outputs
constexpr int kOut = 512;
constexpr int kMT = kTile / 16;  // 16-row mma tiles in a warp's strip
constexpr int kNT = 4;           // 8-column mma tiles in a warp's strip
constexpr int kStrip = 8 * kNT;  // strip width in columns

constexpr size_t kBuf0Bytes = sizeof(bf16) * kTile * kLd0;
constexpr size_t kBuf1Bytes = sizeof(bf16) * kTile * kLd1;
constexpr size_t kXBytes = sizeof(float) * kTile * 3;
constexpr size_t kSmemBytes = kBuf0Bytes + kBuf1Bytes + kXBytes;

struct Layers {
  const bf16* w[5];  // nn.Linear layout (out, in), row-major
  const bf16* b[5];  // (out,)
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Float max through integer atomics: non-negative floats order like signed
// ints, negative floats order inversely to their unsigned bit patterns. The
// sign-bit test (not v >= 0) sends -0.0 down the unsigned path.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// A's 16x16 bf16 fragment: lanes 0-15 address rows 0-15 at column k0,
// lanes 16-31 the same rows at k0 + 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load_pair(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// A warp's strip of a layer: the tile's (kTile, K) activations in shared
// memory times columns [col0, col0 + kStrip) of W^T (W is (n_out, K)).
// acc[i][j] holds rows 16 i + lane/4 (elements 0, 1) and 16 i + lane/4 + 8
// (elements 2, 3) of columns col0 + 8 j + 2 (lane % 4) (+1).
__device__ __forceinline__ void strip_product(float (&acc)[kMT][kNT][4], const bf16* in_s,
                                              int ld_in, int k_dim,
                                              const bf16* __restrict__ w, int col0, int lane) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  // this lane's B words: column col0 + 8 j + lane/4, k pairs 2 (lane%4) and +8
  const bf16* wl = w + (size_t)(col0 + (lane >> 2)) * k_dim + 2 * (lane & 3);
  uint32_t bc[kNT][2], bn[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    bc[j][0] = load_pair(wl + (size_t)j * 8 * k_dim);
    bc[j][1] = load_pair(wl + (size_t)j * 8 * k_dim + 8);
  }
  const bf16* a_lane = in_s + (lane & 15) * ld_in + (lane >> 4) * 8;
  for (int k0 = 0; k0 < k_dim; k0 += 16) {
    const int k1 = k0 + 16;
    if (k1 < k_dim) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        bn[j][0] = load_pair(wl + (size_t)j * 8 * k_dim + k1);
        bn[j][1] = load_pair(wl + (size_t)j * 8 * k_dim + k1 + 8);
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      uint32_t a[4];
      ldmatrix_x4(a, a_lane + i * 16 * ld_in + k0);
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], a, bc[j][0], bc[j][1]);
    }
    if (k1 < k_dim) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        bc[j][0] = bn[j][0];
        bc[j][1] = bn[j][1];
      }
    }
  }
}

// A hidden layer: the product, + bias in fp32, ReLU, round to bf16, store
// (kTile, n_out) to shared memory. Warps take strips in turn.
__device__ void dense_relu(const bf16* in_s, int ld_in, int k_dim,
                           const bf16* __restrict__ w, const bf16* __restrict__ b,
                           int n_out, bf16* out_s, int ld_out, int warp, int lane) {
  for (int nf = warp; nf < n_out / kStrip; nf += kWarps) {
    float acc[kMT][kNT][4];
    strip_product(acc, in_s, ld_in, k_dim, w, nf * kStrip, lane);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int c = nf * kStrip + j * 8 + 2 * (lane & 3);
      const float b0 = __bfloat162float(b[c]);
      const float b1 = __bfloat162float(b[c + 1]);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r = i * 16 + (lane >> 2);
        *reinterpret_cast<__nv_bfloat162*>(out_s + r * ld_out + c) = __floats2bfloat162_rn(
            fmaxf(acc[i][j][0] + b0, 0.0f), fmaxf(acc[i][j][1] + b1, 0.0f));
        *reinterpret_cast<__nv_bfloat162*>(out_s + (r + 8) * ld_out + c) = __floats2bfloat162_rn(
            fmaxf(acc[i][j][2] + b0, 0.0f), fmaxf(acc[i][j][3] + b1, 0.0f));
      }
    }
  }
}

// The last layer (no ReLU): the product, then the column max over the
// tile's valid rows, merged across tiles into pooled (fp32, set to -inf).
__device__ void dense_max(const bf16* in_s, int ld_in, int k_dim,
                          const bf16* __restrict__ w, const bf16* __restrict__ b,
                          float* __restrict__ pooled, int valid_rows, int warp, int lane) {
  for (int nf = warp; nf < kOut / kStrip; nf += kWarps) {
    float acc[kMT][kNT][4];
    strip_product(acc, in_s, ld_in, k_dim, w, nf * kStrip, lane);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int c = nf * kStrip + j * 8 + 2 * (lane & 3);
      const float b0 = __bfloat162float(b[c]);
      const float b1 = __bfloat162float(b[c + 1]);
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r = i * 16 + (lane >> 2);
        if (r < valid_rows) {
          m0 = fmaxf(m0, round_bf16(acc[i][j][0] + b0));
          m1 = fmaxf(m1, round_bf16(acc[i][j][1] + b1));
        }
        if (r + 8 < valid_rows) {
          m0 = fmaxf(m0, round_bf16(acc[i][j][2] + b0));
          m1 = fmaxf(m1, round_bf16(acc[i][j][3] + b1));
        }
      }
      // lanes with the same lane % 4 hold the same two columns
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
      if (lane < 4) {
        atomic_max_float(pooled + c, m0);
        atomic_max_float(pooled + c + 1, m1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
trunk_pool_kernel(const bf16* __restrict__ x, Layers p, float* __restrict__ pooled,
                  int n, int tiles_per_cloud) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = reinterpret_cast<bf16*>(smem + kBuf0Bytes);
  float* x_s = reinterpret_cast<float*>(smem + kBuf0Bytes + kBuf1Bytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int cloud = blockIdx.x / tiles_per_cloud;
  const int row0 = (blockIdx.x % tiles_per_cloud) * kTile;
  const int valid_rows = min(kTile, n - row0);
  const bf16* xc = x + ((size_t)cloud * n + row0) * 3;

  // stage the tile's points as fp32; rows past N read as zeros
  for (int e = tid; e < kTile * 3; e += kThreads) {
    x_s[e] = e < valid_rows * 3 ? __bfloat162float(xc[e]) : 0.0f;
  }
  __syncthreads();

  // layer 1 (K=3): bias + x0*w0 + x1*w1 + x2*w2, each step rounded like
  // separate fp32 multiplies and adds (no fused multiply-add)
  for (int e = tid; e < kTile * 64; e += kThreads) {
    const int r = e >> 6;
    const int c = e & 63;
    float acc = __bfloat162float(p.b[0][c]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      acc = __fadd_rn(acc, __fmul_rn(x_s[r * 3 + k], __bfloat162float(p.w[0][c * 3 + k])));
    }
    buf0[r * kLd0 + c] = __float2bfloat16(fmaxf(acc, 0.0f));
  }
  __syncthreads();
  dense_relu(buf0, kLd0, 64, p.w[1], p.b[1], 128, buf1, kLd1, warp, lane);
  __syncthreads();
  dense_relu(buf1, kLd1, 128, p.w[2], p.b[2], 256, buf0, kLd0, warp, lane);
  __syncthreads();
  dense_relu(buf0, kLd0, 256, p.w[3], p.b[3], 512, buf1, kLd1, warp, lane);
  __syncthreads();
  dense_max(buf1, kLd1, 512, p.w[4], p.b[4], pooled + (size_t)cloud * kOut, valid_rows,
            warp, lane);
}

__global__ void fill_neg_inf(float* __restrict__ a, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) a[i] = -INFINITY;
}

__global__ void cast_to_bf16(const float* __restrict__ a, bf16* __restrict__ out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = __float2bfloat16(a[i]);
}

}  // namespace

// x (batch, n, 3) bf16; w_i/b_i the five layers in nn.Linear layout, bf16,
// 4-byte aligned; pooled (batch, 512) fp32 scratch; out (batch, 512) bf16.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int hpcd_trunk_pool_bf16(const void* x,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* b2,
                                    const void* w3, const void* b3,
                                    const void* w4, const void* b4,
                                    const void* w5, const void* b5,
                                    void* pooled, void* out,
                                    int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(trunk_pool_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;

  Layers p;
  const void* ws[5] = {w1, w2, w3, w4, w5};
  const void* bs[5] = {b1, b2, b3, b4, b5};
  for (int i = 0; i < 5; ++i) {
    p.w[i] = static_cast<const bf16*>(ws[i]);
    p.b[i] = static_cast<const bf16*>(bs[i]);
  }
  const int count = batch * kOut;
  const int tiles = (n + kTile - 1) / kTile;
  float* pooled_f = static_cast<float*>(pooled);

  fill_neg_inf<<<(count + 255) / 256, 256, 0, s>>>(pooled_f, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  trunk_pool_kernel<<<batch * tiles, kThreads, kSmemBytes, s>>>(
      static_cast<const bf16*>(x), p, pooled_f, n, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cast_to_bf16<<<(count + 255) / 256, 256, 0, s>>>(pooled_f, static_cast<bf16*>(out), count);
  return (int)cudaGetLastError();
}
