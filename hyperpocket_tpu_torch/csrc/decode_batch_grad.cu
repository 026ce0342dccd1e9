// The gradient of the per-sample target-network decode with respect to the
// hypernetwork's flat weights, bf16, for Hopper (sm_90a): the backward of
// the training forward's decode.
//
// Replaces no TPU kernel: the JAX package trains through XLA's bmm chain
// (hyperpocket_tpu/models/target_network.py) and its Pallas decode
// (ops/pallas_decoder.py) is forward only. On the H100 the chain's backward
// is some fifty launches of generic elementwise, reduction and small-GEMM
// kernels over (B, N, C) activations; this kernel and its chunk sum replace
// them, and the forward is decode_batch_tc.cu's, so nothing (B, N, C)-sized
// is written to device memory.
//
// Each sample b has its own MLP 3 -> C1 -> ... -> Ck -> 3, sliced from its
// row of the flat weights (per layer a row-major (out, in) block, then the
// bias when there is one). Given the points x and the output's gradient g,
// it returns the row's gradient in the chain's arithmetic
// (models/target_network.py under autograd, bf16): with A_l the input of
// layer l (A_0 = x, A_{l+1} = relu(Z_l)) and dZ_{L-1} = g,
//   dW_l = dZ_l^T A_l and db_l = the sum over points of dZ_l, fp32 sums
//          rounded once to bf16;
//   dZ_{l-1} = bf16(dZ_l W_l) where A_l > 0, else 0.
// The forward is recomputed in the chain's rounding (the product rounded,
// the bias added and the sum rounded again, ReLU after every layer but the
// last), as decode_batch_tc.cu computes it with chain_rounding.
//
// What bounds it on the H100: arithmetic. At the chair widths a point takes
// 18,720 multiply-adds forward, as many for dW and about as many for dZ,
// ~15 GFLOP at B=64, N=2048: 0.015 ms at the bf16 peak. The design:
//   * one block of 8 warps per (sample, chunk of points); the wrapper cuts
//     each sample into as many chunks as keep the grid within one block an
//     SM (the shared memory holds one). The sample's weights are staged once
//     per block: layer 0 as fp32 (3, out) for its three FMAs a value, the
//     others as bf16 (out, in) blocks padded with zeros to multiples of 16
//     and to a row stride of in + 8 values (ldmatrix without bank
//     conflicts), every bias as fp32;
//   * the chunk is walked in tiles of 128 points, 16 a warp. Each warp
//     takes its 16 points through the forward and then back through dZ with
//     the activations in registers, as decode_batch_tc.cu does: mma.sync
//     m16n8k16 whose accumulators, rounded, are the next layer's A
//     fragments, the backward's B fragments read transposed by
//     ldmatrix.trans. On the way it writes each A_l and dZ_l of its points
//     to shared memory (bf16, stride + 8), and reads A_l back for the mask;
//   * then, after one barrier, the block's warps multiply dZ_l^T A_l over
//     the tile's 128 points for every layer, in 16 x 16 blocks of dW that
//     each warp owns for the whole chunk, the fp32 sums held in registers
//     (kSlots blocks a warp; the warp that owns a layer's first column
//     block also sums dZ_l's columns for db_l, into shared memory after
//     each tile); one more barrier and the next tile;
//   * no atomics: each block writes its chunk's fp32 partial once, in the
//     flat layout, and a second kernel sums the chunks in a fixed order and
//     rounds to bf16. Two runs are bit-equal.
// Widths with a hidden layer wider than 128 channels (the registers of the
// activations), more dW blocks than the warps' slots, or weights and a
// tile's activations beyond a block's shared memory are refused by the
// wrapper, which computes the layout (ops/decoder.py::grad_layout) and sends
// those widths to the bmm chain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kMaxLayers = 16;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;     // points a tile: 16 a warp
constexpr int kKF = 8;                 // k16 fragments of the widest hidden layer: 128 channels
constexpr int kSlots = 10;             // 16 x 16 blocks of dW a warp holds in registers
constexpr int kMaxUnits = kWarps * kSlots;
constexpr int kChunks = 2;             // 16-channel output chunks a warp computes together
constexpr int kMaxSmem = 227 * 1024;   // dynamic shared memory a block may have

// A launch's layout for some widths, computed by the wrapper
// (ops/decoder.py::grad_layout, which alone decides which widths the kernel
// takes) and passed as these ints in this order.
struct Layout {
  int n_layers;
  int in[kMaxLayers];
  int out[kMaxLayers];
  int npad[kMaxLayers];      // out rounded up to 16
  int kpad[kMaxLayers];      // in rounded up to 16
  int w_src[kMaxLayers];     // offsets in the flat row, in values
  int b_src[kMaxLayers];     // -1 without bias
  int w_dst[kMaxLayers];     // bytes: layer 0 fp32 (3, npad); the others bf16 (npad, kpad + 8)
  int b_dst[kMaxLayers];     // bytes: fp32 (npad)
  int a_dst[kMaxLayers];     // bytes: A_l bf16 (kTile, kpad + 8)
  int z_dst[kMaxLayers];     // bytes: dZ_l bf16 (kTile, npad + 8)
  int db_off[kMaxLayers];    // floats from db_dst: db_l, fp32 (npad)
  int db_dst;                // bytes
  int unit[kMaxUnits];       // dW block u (slot u / kWarps of warp u % kWarps): layer |
                             // row block << 8 | column block << 16, or -1
  int flat;
  int smem_bytes;
};

constexpr int kLayoutInts = 1 + 11 * kMaxLayers + 1 + kMaxUnits + 2;
static_assert(sizeof(Layout) == kLayoutInts * sizeof(int), "Layout is the wrapper's ints");

// lo, hi rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack(const float lo, const float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The chain's rounding of a pair: relu(round(round(acc) + bias)), the bias
// packed as bf16 (its values are bf16 already); one bf16x2 FMA by 1.0
// rounds the exact sum once (decode_batch_tc.cu's chain_relu)
__device__ __forceinline__ uint32_t chain_relu(const float lo, const float hi,
                                               const uint32_t bias2) {
  uint32_t d;
  asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(pack(lo, hi)), "r"(0x3f803f80u),
      "r"(bias2));
  return d;
}

// the values of d where the matching activation in a is above 0, else 0
__device__ __forceinline__ uint32_t relu_mask(const uint32_t d, const uint32_t a) {
  const bool lo = (int16_t)(a & 0xffffu) > 0, hi = (int16_t)(a >> 16) > 0;
  return (lo ? d & 0x0000ffffu : 0u) | (hi ? d & 0xffff0000u : 0u);
}

// the sum of a pair of bf16 values, in fp32
__device__ __forceinline__ float pair_sum(const uint32_t v) {
  return __uint_as_float(v << 16) + __uint_as_float(v & 0xffff0000u);
}

template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  if (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t b0,
                                         const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 16 points of a layer's activations (or their gradient) as m16k16
// A fragments: f[kf] holds channels 16 kf .. 16 kf + 15; register j holds
// row lane/4 (j even) or lane/4 + 8 (j odd) at channels 2 (lane % 4) + {0, 1}
// (j < 2) or those + 8 (j >= 2). Shared memory keeps the same values at
// [row][channel], bf16, row stride ld: frag_word is register j's word there.
__device__ __forceinline__ uint32_t* frag_word(bf16* base, const int ld, const int kf,
                                               const int j, const int lane) {
  const int row = (lane >> 2) + 8 * (j & 1), col = 16 * kf + 2 * (lane & 3) + 8 * (j >> 1);
  return reinterpret_cast<uint32_t*>(base + row * ld + col);
}

// One layer of the warp's forward: h = relu(round(round(a . W^T) + bias)),
// kChunks chunks of 16 output channels at a time; h is written to dst (the
// next layer's input, the warp's rows) too. W is (npad, kpad) with row
// stride ld in shared memory.
__device__ __forceinline__ void forward_layer(const uint32_t (&a)[kKF][4],
                                              uint32_t (&h)[kKF][4], const bf16* w,
                                              const float* bias, const int kfs, const int ncs,
                                              const int ld, bf16* dst, const int ldd,
                                              const int lane) {
  const int t = lane & 3;
  const bf16* wl = w + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nc0 = 0; nc0 < kKF; nc0 += kChunks) {
    if (nc0 >= ncs) break;
    float acc[kChunks][2][4];
#pragma unroll
    for (int u = 0; u < kChunks; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[u][0][j] = acc[u][1][j] = 0.f;
#pragma unroll
    for (int kf = 0; kf < kKF; ++kf) {
      if (kf >= kfs) break;
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        if (nc0 + u >= ncs) break;
        uint32_t b[4];
        ldmatrix_x4<false>(b, wl + 16 * (nc0 + u) * ld + 16 * kf);
        mma_bf16(acc[u][0], a[kf], b[0], b[1]);
        mma_bf16(acc[u][1], a[kf], b[2], b[3]);
      }
    }
    // a chunk's two m16n8 accumulators (channels 0-7, 8-15) are the next
    // layer's k16 A fragment: rows g and g + 8 of each
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int nc = nc0 + u;
      if (nc >= ncs) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 bs = *reinterpret_cast<const float2*>(bias + 16 * nc + 8 * half + 2 * t);
        const uint32_t b2 = pack(bs.x, bs.y);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int j = 2 * half + hr;
          h[nc][j] = chain_relu(acc[u][half][2 * hr], acc[u][half][2 * hr + 1], b2);
          *frag_word(dst, ldd, nc, j, lane) = h[nc][j];
        }
      }
    }
  }
}

// One layer of the warp's backward: d = round(dz . W) where the layer's
// input (A, the warp's rows in shared memory at src) is above 0, written to
// dst (dZ of the layer below) too. dz has kfs fragments (the layer's
// outputs); d has ncs (its inputs). W is (npad, kpad) with row stride ld,
// read transposed.
__device__ __forceinline__ void backward_layer(const uint32_t (&dz)[kKF][4],
                                               uint32_t (&d)[kKF][4], const bf16* w,
                                               const int kfs, const int ncs, const int ld,
                                               bf16* src, const int lds, bf16* dst, const int ldd,
                                               const int lane) {
  // ldmatrix.x4.trans rows: lanes 0-7 outputs k 0-7 at inputs n 0-7, lanes
  // 8-15 k 8-15 at n 0-7, lanes 16-31 the same at n 8-15
  const bf16* wl = w + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int nc0 = 0; nc0 < kKF; nc0 += kChunks) {
    if (nc0 >= ncs) break;
    float acc[kChunks][2][4];
#pragma unroll
    for (int u = 0; u < kChunks; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[u][0][j] = acc[u][1][j] = 0.f;
#pragma unroll
    for (int kf = 0; kf < kKF; ++kf) {
      if (kf >= kfs) break;
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        if (nc0 + u >= ncs) break;
        uint32_t b[4];
        ldmatrix_x4<true>(b, wl + 16 * kf * ld + 16 * (nc0 + u));
        mma_bf16(acc[u][0], dz[kf], b[0], b[1]);
        mma_bf16(acc[u][1], dz[kf], b[2], b[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int nc = nc0 + u;
      if (nc >= ncs) break;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int j = 2 * half + hr;
          d[nc][j] = relu_mask(pack(acc[u][half][2 * hr], acc[u][half][2 * hr + 1]),
                               *frag_word(src, lds, nc, j, lane));
          *frag_word(dst, ldd, nc, j, lane) = d[nc][j];
        }
    }
  }
}

// Stage the sample's row: layer 0 as fp32 (3, npad), the others as bf16
// (npad, kpad + 8), zero-padded; every bias as fp32. Four loads in flight
// a thread.
__device__ __forceinline__ void stage_weights(const bf16* __restrict__ row, unsigned char* sm,
                                              const Layout& L) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int li = 0; li < L.n_layers; ++li) {
    const int in = L.in[li], nout = L.out[li], np = L.npad[li];
    float* bias = reinterpret_cast<float*>(sm + L.b_dst[li]);
    for (int o = threadIdx.x; o < np; o += kThreads)
      bias[o] = o < nout && L.b_src[li] >= 0 ? __bfloat162float(row[L.b_src[li] + o]) : 0.f;
    if (li == 0) {  // w0[c][o] = W[o][c]
      float* w0 = reinterpret_cast<float*>(sm + L.w_dst[0]);
      for (int e = threadIdx.x; e < 3 * np; e += kThreads) {
        const int c = e / np, o = e % np;
        w0[e] = o < nout ? __bfloat162float(row[L.w_src[0] + 3 * o + c]) : 0.f;
      }
      continue;
    }
    bf16* w = reinterpret_cast<bf16*>(sm + L.w_dst[li]);
    const int ld = L.kpad[li] + 8, total = np * ld;
    for (int e0 = threadIdx.x; e0 < total; e0 += 4 * kThreads) {
      bf16 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads, o = e / ld, k = e % ld;
        v[u] = e < total && o < nout && k < in ? row[L.w_src[li] + o * in + k] : zero;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e0 + u * kThreads < total) w[e0 + u * kThreads] = v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
decode_batch_grad_kernel(const bf16* __restrict__ flat, const bf16* __restrict__ points,
                         const bf16* __restrict__ grad_out, float* __restrict__ partial,
                         const int n, const int chunks, const int chunk_points, const Layout L) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int b = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nl = L.n_layers;
  auto act = [&](const int li) { return reinterpret_cast<bf16*>(sm + L.a_dst[li]); };
  auto grd = [&](const int li) { return reinterpret_cast<bf16*>(sm + L.z_dst[li]); };
  float* dbs = reinterpret_cast<float*>(sm + L.db_dst);

  stage_weights(flat + (size_t)b * L.flat, sm, L);
  // A_0's pad columns (3 .. 15), which no tile writes, and db
  {
    bf16* a0 = act(0);
    const int ld0 = L.kpad[0] + 8;
    for (int e = threadIdx.x; e < kTile * ld0; e += kThreads) a0[e] = __float2bfloat16_rn(0.f);
    for (int e = threadIdx.x; e < L.db_off[nl - 1] + L.npad[nl - 1]; e += kThreads) dbs[e] = 0.f;
  }
  __syncthreads();

  float acc[kSlots][2][4];  // the warp's dW blocks: [slot][8-column half][m16n8 registers]
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[s][0][j] = acc[s][1][j] = 0.f;

  const bf16* pts = points + 3 * (size_t)b * n;
  const bf16* gout = grad_out + 3 * (size_t)b * n;
  const int first = chunk * chunk_points, last = min(n, first + chunk_points);
  const int r0 = 16 * warp;  // the warp's rows in a tile
  for (int p0 = first; p0 < last; p0 += kTile) {
    float x[2][3], gv[2][3];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = p0 + r0 + g + 8 * hr;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        x[hr][c] = p < last ? __bfloat162float(pts[3 * (size_t)p + c]) : 0.f;
        gv[hr][c] = p < last ? __bfloat162float(gout[3 * (size_t)p + c]) : 0.f;
      }
    }
    // A_0 (the points: channels 0-2 of fragment 0) and dZ_{L-1} (the
    // output's gradient) of the warp's rows, zero past n
    uint32_t dz[kKF][4], dn[kKF][4];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (t < 2)
        *frag_word(act(0) + r0 * (L.kpad[0] + 8), L.kpad[0] + 8, 0, hr, lane) =
            t == 0 ? pack(x[hr][0], x[hr][1]) : pack(x[hr][2], 0.f);
      dz[0][hr] = t == 0 ? pack(gv[hr][0], gv[hr][1]) : t == 1 ? pack(gv[hr][2], 0.f) : 0u;
      dz[0][2 + hr] = 0u;
    }

    // the forward in the chain's rounding: layer 0 on the CUDA cores,
    // straight into layer 1's A fragments
    if (nl > 1) {
      uint32_t fa[kKF][4], fb[kKF][4];
      const float* w0 = reinterpret_cast<const float*>(sm + L.w_dst[0]);
      const float* b0 = reinterpret_cast<const float*>(sm + L.b_dst[0]);
      const int np0 = L.npad[0];
      bf16* a1 = act(1) + r0 * (L.kpad[1] + 8);
#pragma unroll
      for (int kf = 0; kf < kKF; ++kf) {
        if (16 * kf >= np0) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 16 * kf + 2 * t + 8 * (j >> 1);
          const float2 bias = *reinterpret_cast<const float2*>(b0 + col);
          float v0 = 0.f, v1 = 0.f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float2 wc = *reinterpret_cast<const float2*>(w0 + c * np0 + col);
            v0 = fmaf(x[j & 1][c], wc.x, v0);
            v1 = fmaf(x[j & 1][c], wc.y, v1);
          }
          fa[kf][j] = chain_relu(v0, v1, pack(bias.x, bias.y));
          *frag_word(a1, L.kpad[1] + 8, kf, j, lane) = fa[kf][j];
        }
      }
      bool in_fa = true;
      for (int li = 1; li < nl - 1; ++li) {
        const bf16* w = reinterpret_cast<const bf16*>(sm + L.w_dst[li]);
        const float* bias = reinterpret_cast<const float*>(sm + L.b_dst[li]);
        const int kfs = L.kpad[li] / 16, ncs = L.npad[li] / 16, ld = L.kpad[li] + 8;
        bf16* dst = act(li + 1) + r0 * (L.kpad[li + 1] + 8);
        if (in_fa)
          forward_layer(fa, fb, w, bias, kfs, ncs, ld, dst, L.kpad[li + 1] + 8, lane);
        else
          forward_layer(fb, fa, w, bias, kfs, ncs, ld, dst, L.kpad[li + 1] + 8, lane);
        in_fa = !in_fa;
      }
    }

    // the backward: dZ_{L-1} = g into shared memory, then layer by layer
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *frag_word(grd(nl - 1) + r0 * (L.npad[nl - 1] + 8), L.npad[nl - 1] + 8, 0, j, lane) =
          dz[0][j];
    bool in_dz = true;
    for (int li = nl - 1; li >= 1; --li) {
      const bf16* w = reinterpret_cast<const bf16*>(sm + L.w_dst[li]);
      const int kfs = L.npad[li] / 16, ncs = L.kpad[li] / 16, ld = L.kpad[li] + 8;
      bf16* src = act(li) + r0 * (L.kpad[li] + 8);
      bf16* dst = grd(li - 1) + r0 * (L.npad[li - 1] + 8);
      if (in_dz)
        backward_layer(dz, dn, w, kfs, ncs, ld, src, L.kpad[li] + 8, dst,
                           L.npad[li - 1] + 8, lane);
      else
        backward_layer(dn, dz, w, kfs, ncs, ld, src, L.kpad[li] + 8, dst,
                           L.npad[li - 1] + 8, lane);
      in_dz = !in_dz;
    }
    __syncthreads();

    // [dW_l, db_l] += dZ_l^T A_l over the tile's points: each warp its blocks
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int code = L.unit[s * kWarps + warp];
      if (code < 0) break;
      const int li = code & 0xff, m0 = 16 * ((code >> 8) & 0xff), n0 = 16 * (code >> 16);
      const int ldz = L.npad[li] + 8, lda = L.kpad[li] + 8;
      // ldmatrix.x4.trans rows are points; the four matrices in the mma
      // fragments' order (A = dZ^T: rows m 0-7 / 8-15 at k 0-7, then at k
      // 8-15; B = A_l: k 0-7 / 8-15 at columns 0-7, then at columns 8-15)
      const bf16* zl = grd(li) + ((lane & 7) + ((lane >> 4) << 3)) * ldz + m0 +
                       ((lane >> 3) & 1) * 8;
      const bf16* al = act(li) + ((lane & 7) + (((lane >> 3) & 1) << 3)) * lda + n0 +
                       (lane >> 4) * 8;
      const bool sums = n0 == 0;
      // db of rows g and g + 8, summed by every block (a branch in the loop
      // costs more than the adds) and kept where the block is column 0
      const float fs = sums ? 1.f : 0.f;
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < kTile; k0 += 16) {
        uint32_t a[4], bb[4];
        ldmatrix_x4<true>(a, zl + k0 * ldz);
        ldmatrix_x4<true>(bb, al + k0 * lda);
        mma_bf16(acc[s][0], a, bb[0], bb[1]);
        mma_bf16(acc[s][1], a, bb[2], bb[3]);
        d0 = fmaf(fs, pair_sum(a[0]) + pair_sum(a[2]), d0);
        d1 = fmaf(fs, pair_sum(a[1]) + pair_sum(a[3]), d1);
      }
      if (sums) {  // the warp owns these rows of db_l
        d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
        d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
        d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
        d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
        if (t == 0) {
          dbs[L.db_off[li] + m0 + g] += d0;
          dbs[L.db_off[li] + m0 + g + 8] += d1;
        }
      }
    }
    __syncthreads();  // the next tile writes the activations and gradients
  }

  // the chunk's partial, in the flat layout: every value written once
  float* part = partial + (size_t)blockIdx.x * L.flat;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int code = L.unit[s * kWarps + warp];
    if (code < 0) break;
    const int li = code & 0xff, m0 = 16 * ((code >> 8) & 0xff), n0 = 16 * (code >> 16);
    const int in = L.in[li], nout = L.out[li];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + g + 8 * (j >> 1), k = n0 + 8 * h + 2 * t + (j & 1);
        if (m < nout && k < in) part[L.w_src[li] + m * in + k] = acc[s][h][j];
      }
  }
  // db, which the last tile's barrier leaves complete
  for (int li = 0; li < nl; ++li)
    if (L.b_src[li] >= 0)
      for (int m = threadIdx.x; m < L.out[li]; m += kThreads)
        part[L.b_src[li] + m] = dbs[L.db_off[li] + m];
}

// out[b][j] = bf16(the sum over chunks of the partials at j), in the
// chunks' order
__global__ void decode_batch_grad_sum_kernel(const float* __restrict__ partial,
                                             bf16* __restrict__ out, const int chunks,
                                             const int w) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= w) return;
  const float* p = partial + (size_t)b * chunks * w + j;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += p[(size_t)c * w];
  out[(size_t)b * w + j] = __float2bfloat16_rn(s);
}

int launch(const void* flat, const void* points, const void* grad_out, void* partial,
           const Layout& L, const int batch, const int n, const int chunks,
           const int chunk_points, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(decode_batch_grad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  decode_batch_grad_kernel<<<batch * chunks, kThreads, L.smem_bytes, s>>>(
      static_cast<const bf16*>(flat), static_cast<const bf16*>(points),
      static_cast<const bf16*>(grad_out), static_cast<float*>(partial), n, chunks, chunk_points,
      L);
  return (int)cudaGetLastError();
}

}  // namespace

// flat (batch, L.flat), points and grad_out (batch, n, 3), bf16,
// contiguous; partial: batch x chunks x L.flat fp32 scratch; writes
// grad_flat (batch, L.flat) bf16. `layout` holds `layout_ints` ints, the
// Layout in its order, and `tile` is the wrapper's points a tile. Each
// sample's points are cut into `chunks` chunks of chunk_points (a multiple
// of the tile), the last one ragged. Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (or cudaErrorInvalidValue for a
// layout or tile not this kernel's, or chunks that do not cover the points).
extern "C" int hpcd_decode_batch_grad_bf16(const void* flat, const void* points,
                                           const void* grad_out, void* grad_flat, void* partial,
                                           const int* layout, int layout_ints, int tile,
                                           int batch, int n, int chunks, int chunk_points,
                                           void* stream) {
  if (layout_ints != kLayoutInts || tile != kTile) return (int)cudaErrorInvalidValue;
  Layout L;
  memcpy(&L, layout, sizeof(Layout));
  if (L.n_layers < 1 || L.n_layers > kMaxLayers || L.flat <= 0 || L.smem_bytes <= 0 ||
      L.smem_bytes > kMaxSmem || batch <= 0 || n <= 0 || chunks <= 0 || chunk_points <= 0 ||
      chunk_points % kTile != 0 || (long long)chunks * chunk_points < n ||
      (long long)(chunks - 1) * chunk_points >= n || (long long)batch * chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (int li = 0; li + 1 < L.n_layers; ++li)
    if (L.npad[li] > 16 * kKF) return (int)cudaErrorInvalidValue;
  const int w = L.flat;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch(flat, points, grad_out, partial, L, batch, n, chunks, chunk_points, s);
  if (rc != 0) return rc;
  const dim3 grid((w + 255) / 256, batch);
  decode_batch_grad_sum_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(partial),
                                                    static_cast<bf16*>(grad_flat), chunks, w);
  return (int)cudaGetLastError();
}
