// Per-sample target-network decode from the hypernetwork's flat weights,
// fused, for Hopper (sm_90a): the bf16 case, on the tensor cores.
//
// Replaces the TPU kernel hyperpocket_tpu/ops/pallas_decoder.py::decode_batch
// (_decode_kernel) for bf16 points; decode_batch.cu keeps the fp32 case.
// Each sample b has its own MLP 3 -> C1 -> ... -> Ck -> 3, sliced from its
// row of the flat weight vector (per layer a row-major (out, in) block, then
// the bias when there is one), run on its N points, with the TPU kernel's
// arithmetic:
//   layer 0:  acc = x0 w0 + x1 w1 + x2 w2 in fp32 (bf16 products are exact
//             in fp32, so the FMAs give the plain version's bits);
//   others:   a bf16 dot with fp32 accumulation;
// then one of two roundings, chosen by the caller: the TPU kernel's (the
// accumulator starts from the bias, the sum is rounded once to bf16) or the
// JAX model's bmm chain (models/target_network.py: the accumulator rounded
// to bf16, the bias added, the sum rounded again); ReLU after every layer
// but the last.
//
// What bounds it on the H100: arithmetic. At the chair widths a point takes
// 18,720 multiply-adds (19,456 with the last layer's 3 outputs padded to 8)
// for 6 bytes in and 6 out, so the bytes are nothing; on the bf16 tensor
// cores the bound is 0.020 ms at B=256, N=2048. The design:
//   * one block of 4 warps per (sample, tile of points); the wrapper picks
//     the tile (a multiple of 128 points) so that the grid fills the card;
//   * the sample's row (38,022 bytes at the chair widths) comes in once per
//     block by cp.async in 16-byte pieces from the 16-byte boundary below
//     its start: a row starts only 2-byte aligned when the sample is odd, so
//     the copy is raw, and one pass inside shared memory shifts each layer
//     into place: layers 1.. as bf16 (out, in) blocks, padded with zeros to
//     a multiple of 16 (8 for the last layer's outputs) and to a row stride
//     of in + 8 values, so that ldmatrix reads them without bank conflicts;
//     layer 0's weights and every bias as fp32;
//   * each warp runs 32 points (two m16 row tiles) through all the layers
//     with the activations in registers: layer 0's FMAs write straight into
//     layer 1's A fragments, and every later layer is mma.sync.m16n8k16
//     (bf16 in, fp32 accumulators starting from the bias) over 16 output
//     channels at a time, whose accumulators are rounded with ReLU into the
//     next layer's A fragment of those 16 channels (the m16n8 accumulator
//     layout is the A layout, two column tiles making one k16 fragment). No
//     activation touches shared memory; each B fragment a warp loads from
//     shared memory (ldmatrix) serves both of its row tiles;
//   * a warp computes two such chunks together, 8 independent accumulator
//     chains: with 2 blocks of 4 warps an SM (~200 registers, 82 KB of
//     shared memory at the chair widths), one chunk at a time leaves the
//     MMAs waiting on each other (~10% slower, PERF.md);
//   * the A fragments of a layer's input and output live in two register
//     arrays sized for the widest layer the instantiation takes (128
//     channels with two row tiles a warp, or 256 with one).
// Widths the instantiations cannot hold (a hidden layer wider than 256
// channels), or whose weights need more shared memory than a block may have,
// go to decode_batch.cu's bf16 instantiation: the wrapper chooses from the
// widths alone, before any launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kMaxLayers = 16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 2;  // 16-channel output chunks a warp computes together (1 or 2)

struct Layout {
  int n_layers;
  int in[kMaxLayers];
  int out[kMaxLayers];
  int kpad[kMaxLayers];   // layers 1..: in rounded up to 16
  int npad[kMaxLayers];   // out rounded up to 16 (8 for the last layer, 4 for a lone layer 0)
  int w_src[kMaxLayers];  // offsets in the flat row, in values
  int b_src[kMaxLayers];  // -1 without bias
  int w_dst[kMaxLayers];  // byte offsets in shared memory
  int b_dst[kMaxLayers];
  int raw;                // byte offset of the row's raw copy
  int flat;               // the flat row's length
  int max_width;          // the widest hidden layer, rounded up to 16
  int smem_bytes;
};

int round_up(const long long v, const int to) { return (int)((v + to - 1) / to * to); }

// widths: n_layers + 1 channel counts (3, C1, ..., Ck, 3).
bool make_layout(const int* widths, const int n_layers, const bool use_bias, Layout* L) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  for (int i = 0; i <= n_layers; ++i)
    if (widths[i] <= 0 || widths[i] > 4096) return false;
  L->n_layers = n_layers;
  L->max_width = 0;
  long long src = 0, dst = 0;
  for (int li = 0; li < n_layers; ++li) {
    const int in = widths[li], out = widths[li + 1];
    const bool last = li == n_layers - 1;
    L->in[li] = in;
    L->out[li] = out;
    L->kpad[li] = round_up(in, 16);
    L->npad[li] = last ? (li == 0 ? 4 : 8) : round_up(out, 16);
    if (last && out > L->npad[li]) return false;
    if (!last) L->max_width = L->max_width > L->npad[li] ? L->max_width : L->npad[li];
    L->w_src[li] = (int)src;
    src += (long long)in * out;
    L->b_src[li] = use_bias ? (int)src : -1;
    if (use_bias) src += out;
    L->w_dst[li] = (int)dst;
    dst += li == 0 ? 4LL * 3 * L->npad[0]                               // fp32 (3, npad)
                   : 2LL * L->npad[li] * (L->kpad[li] + 8);             // bf16 (npad, kpad + 8)
    dst = round_up(dst, 16);
    L->b_dst[li] = (int)dst;
    dst = round_up(dst + 4LL * L->npad[li], 16);
    if (src > 0x7fffffffLL || dst > 0x7fffffffLL) return false;
  }
  L->flat = (int)src;
  L->raw = (int)dst;
  // the raw copy: the row plus the 14 bytes at most before its start, and 16
  // bytes that the shifts read past the last piece but never use
  const long long total = dst + round_up(2 * src + 16, 16) + 16;
  if (total > 0x7fffffffLL) return false;
  L->smem_bytes = (int)total;
  return true;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, const int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}

// bytes [m, m + 16) of the 32 bytes lo:hi, m even
__device__ __forceinline__ uint4 shifted(const uint4 lo, const uint4 hi, const int m) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = m >> 2;
  const uint32_t s = (m & 3) * 8;
  uint32_t r[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) r[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  return make_uint4(__funnelshift_r(r[0], r[1], s), __funnelshift_r(r[1], r[2], s),
                    __funnelshift_r(r[2], r[3], s), __funnelshift_r(r[3], r[4], s));
}

// relu(lo), relu(hi) rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_relu(const float lo, const float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// lo, hi rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack(const float lo, const float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The chain's rounding of a pair: relu(round(round(acc) + bias)), the bias
// packed as bf16 (its values are bf16 already); one bf16x2 FMA by 1.0
// rounds the exact sum once
__device__ __forceinline__ uint32_t chain_relu(const float lo, const float hi,
                                               const uint32_t bias2) {
  uint32_t d;
  asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(pack(lo, hi)), "r"(0x3f803f80u),
      "r"(bias2));
  return d;
}

// One output value without ReLU: the kernel's rounding has summed from the
// bias already; the chain's rounds, adds the bias and rounds again
__device__ __forceinline__ bf16 round_out(const float acc, const float b, const bool chain) {
  return chain ? __hadd(__float2bfloat16_rn(acc), __float2bfloat16_rn(b))
               : __float2bfloat16_rn(acc);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&b)[4], const bf16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&b)[2], const bf16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
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

// The fragments of a layer's activations for the warp's MT row tiles of 16
// points: f[kf][mt] is the m16k16 A fragment of channels 16 kf .. 16 kf + 15.
// Register j holds row lane/4 (j even) or lane/4 + 8 (j odd) at channels
// 2 (lane % 4) + {0, 1} (j < 2) or those + 8 (j >= 2).

// One hidden layer: h = relu(a . W^T + bias) rounded to bf16, kChunks
// chunks of 16 output channels at a time, whose accumulator chains the warp
// interleaves. W is (npad, kpad) with row stride ld in shared memory.
template <int KF, int MT>
__device__ __forceinline__ void hidden_layer(const uint32_t (&a)[KF][MT][4],
                                             uint32_t (&h)[KF][MT][4], const bf16* w,
                                             const float* bias, const int kfs, const int ncs,
                                             const int ld, const int lane, const bool chain) {
  const int t = lane & 3;
  // ldmatrix.x4 rows: lanes 0-7 channels 0-7 at k 0-7, lanes 8-15 the same
  // channels at k 8-15, lanes 16-31 channels 8-15 likewise
  const bf16* wl = w + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nc0 = 0; nc0 < KF; nc0 += kChunks) {
    if (nc0 >= ncs) break;
    // one flag for the second chunk, fixed across the k loop: the compiler
    // then keeps a copy of the loop with both chunks' chains interleaved
    const bool two = kChunks == 2 && nc0 + 1 < ncs;
    float acc[2][2][MT][4];
    float2 bs[2][2];  // the bias of channels 2t, 2t + 1 and those + 8, per chunk
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
      const int nc = nc0 + u;
      bs[u][0] = *reinterpret_cast<const float2*>(bias + 16 * nc + 2 * t);
      bs[u][1] = *reinterpret_cast<const float2*>(bias + 16 * nc + 8 + 2 * t);
      const float2 b_lo = chain ? make_float2(0.f, 0.f) : bs[u][0];
      const float2 b_hi = chain ? make_float2(0.f, 0.f) : bs[u][1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[u][0][mt][0] = acc[u][0][mt][2] = b_lo.x;
        acc[u][0][mt][1] = acc[u][0][mt][3] = b_lo.y;
        acc[u][1][mt][0] = acc[u][1][mt][2] = b_hi.x;
        acc[u][1][mt][1] = acc[u][1][mt][3] = b_hi.y;
      }
    }
#pragma unroll
    for (int kf = 0; kf < KF; ++kf) {
      if (kf >= kfs) break;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
        uint32_t b[4];
        ldmatrix_x4(b, wl + 16 * (nc0 + u) * ld + 16 * kf);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[u][0][mt], a[kf][mt], b[0], b[1]);
          mma_bf16(acc[u][1][mt], a[kf][mt], b[2], b[3]);
        }
      }
    }
    // a chunk's two m16n8 accumulators (channels 0-7, 8-15) are the next
    // layer's k16 A fragment: rows g and g + 8 of each
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
      const int nc = nc0 + u;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (chain) {
            const uint32_t b2 = pack(bs[u][half].x, bs[u][half].y);
            h[nc][mt][2 * half] = chain_relu(acc[u][half][mt][0], acc[u][half][mt][1], b2);
            h[nc][mt][2 * half + 1] = chain_relu(acc[u][half][mt][2], acc[u][half][mt][3], b2);
          } else {
            h[nc][mt][2 * half] = pack_relu(acc[u][half][mt][0], acc[u][half][mt][1]);
            h[nc][mt][2 * half + 1] = pack_relu(acc[u][half][mt][2], acc[u][half][mt][3]);
          }
        }
      }
    }
  }
}

// The last layer (Ck -> 3, outputs padded to 8): a . W^T + bias, rounded to
// bf16 and stored for the rows below n.
template <int KF, int MT>
__device__ __forceinline__ void last_layer(const uint32_t (&a)[KF][MT][4], const bf16* w,
                                           const float* bias, const int kfs, const int ld,
                                           const int lane, bf16* out, const int p0,
                                           const int n, const bool chain) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* wl = w + (lane & 7) * ld + ((lane >> 3) & 1) * 8;
  const float2 b = *reinterpret_cast<const float2*>(bias + 2 * t);
  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    acc[mt][0] = acc[mt][2] = chain ? 0.f : b.x;
    acc[mt][1] = acc[mt][3] = chain ? 0.f : b.y;
  }
#pragma unroll
  for (int kf = 0; kf < KF; ++kf) {
    if (kf >= kfs) break;
    uint32_t bb[2];
    ldmatrix_x2(bb, wl + 16 * kf);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt], a[kf][mt], bb[0], bb[1]);
  }
  if (t > 1) return;  // lanes 0-1 of a quad hold channels 0-3; 3 is padding
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = p0 + 16 * mt + g + 8 * half;
      if (row >= n) continue;
      bf16* o = out + 3 * (size_t)row + 2 * t;
      o[0] = round_out(acc[mt][2 * half], b.x, chain);
      if (t == 0) o[1] = round_out(acc[mt][2 * half + 1], b.y, chain);
    }
  }
}

// The coordinates of the warp's rows p0 + 16 mt + g (+ 8), zero past n.
template <int MT>
__device__ __forceinline__ void load_points(float (&x)[MT][2][3], const bf16* __restrict__ pts,
                                            const int p0, const int n, const int g) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = p0 + 16 * mt + g + 8 * half;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        x[mt][half][c] = row < n ? __bfloat162float(pts[3 * (size_t)row + c]) : 0.f;
    }
}

// Stage the sample's row: raw copy by cp.async, then each layer into place.
__device__ __forceinline__ void stage_weights(const bf16* __restrict__ row, unsigned char* sm,
                                              const Layout& L) {
  const int m0 = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const unsigned char* base = reinterpret_cast<const unsigned char*>(row) - m0;
  const int bytes = m0 + 2 * L.flat;
  unsigned char* raw = sm + L.raw;
  for (int c = threadIdx.x; 16 * c < bytes; c += kThreads)
    cp_async16(raw + 16 * c, base + 16 * c, min(16, bytes - 16 * c));
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const bf16* rv = reinterpret_cast<const bf16*>(raw + m0);  // 2-byte aligned: the row
  for (int li = 0; li < L.n_layers; ++li) {
    const int in = L.in[li], nout = L.out[li], np = L.npad[li];
    float* bias = reinterpret_cast<float*>(sm + L.b_dst[li]);
    for (int o = threadIdx.x; o < np; o += kThreads)
      bias[o] = o < nout && L.b_src[li] >= 0 ? __bfloat162float(rv[L.b_src[li] + o]) : 0.f;
    if (li == 0) {  // fp32 (3, npad): w0[c][o] = W[o][c]
      float* w0 = reinterpret_cast<float*>(sm + L.w_dst[0]);
      for (int e = threadIdx.x; e < 3 * np; e += kThreads) {
        const int c = e / np, o = e % np;
        w0[e] = o < nout ? __bfloat162float(rv[L.w_src[0] + 3 * o + c]) : 0.f;
      }
      continue;
    }
    bf16* w = reinterpret_cast<bf16*>(sm + L.w_dst[li]);
    const int ld = L.kpad[li] + 8;
    if (in % 8 == 0) {  // 16-byte pieces, all at one offset from the 16-byte grid
      const int pieces = ld / 8;
      const int mis = (m0 + 2 * L.w_src[li]) & 15;
      for (int e = threadIdx.x; e < np * pieces; e += kThreads) {
        const int o = e / pieces, k0 = 8 * (e % pieces);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (o < nout && k0 < in) {
          const int off = m0 + 2 * (L.w_src[li] + o * in + k0);
          const uint4* p = reinterpret_cast<const uint4*>(raw + off - mis);
          v = mis ? shifted(p[0], p[1], mis) : p[0];
        }
        *reinterpret_cast<uint4*>(w + o * ld + k0) = v;
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int e = threadIdx.x; e < np * ld; e += kThreads) {
        const int o = e / ld, k = e % ld;
        w[e] = o < nout && k < in ? rv[L.w_src[li] + o * in + k] : zero;
      }
    }
  }
  __syncthreads();
}

template <int KF, int MT>
__global__ void __launch_bounds__(kThreads, 2)
decode_batch_tc_kernel(const bf16* __restrict__ flat, const bf16* __restrict__ points,
                       bf16* __restrict__ out, const int n, const int tiles,
                       const int tile_points, const int chain_rounding, const Layout L) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const bool chain = chain_rounding != 0;
  stage_weights(flat + (size_t)b * L.flat, sm, L);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* pts = points + 3 * (size_t)b * n;
  bf16* dst = out + 3 * (size_t)b * n;
  const float* w0 = reinterpret_cast<const float*>(sm + L.w_dst[0]);
  const float* b0 = reinterpret_cast<const float*>(sm + L.b_dst[0]);
  const int np0 = L.npad[0];
  const int last = min(n, (tile + 1) * tile_points);
  for (int p0 = tile * tile_points + 16 * MT * warp; p0 < last; p0 += 16 * MT * kWarps) {
    float x[MT][2][3];
    load_points(x, pts, p0, n, g);

    if (L.n_layers == 1) {  // 3 -> 3, no ReLU: lanes 0-2 of a quad take a channel each
      if (t < 3) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = p0 + 16 * mt + g + 8 * half;
            float v = chain ? 0.f : b0[t];
#pragma unroll
            for (int c = 0; c < 3; ++c) v = fmaf(x[mt][half][c], w0[c * np0 + t], v);
            if (row < n) dst[3 * (size_t)row + t] = round_out(v, b0[t], chain);
          }
      }
      continue;
    }

    // layer 0 on the CUDA cores, straight into layer 1's A fragments
    uint32_t fa[KF][MT][4], fb[KF][MT][4];
#pragma unroll
    for (int kf = 0; kf < KF; ++kf) {
      if (16 * kf >= np0) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 16 * kf + 2 * t + 8 * (j >> 1);
        const float2 bias = *reinterpret_cast<const float2*>(b0 + col);
        float2 wc[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) wc[c] = *reinterpret_cast<const float2*>(w0 + c * np0 + col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float v0 = chain ? 0.f : bias.x, v1 = chain ? 0.f : bias.y;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            v0 = fmaf(x[mt][j & 1][c], wc[c].x, v0);
            v1 = fmaf(x[mt][j & 1][c], wc[c].y, v1);
          }
          fa[kf][mt][j] = chain ? chain_relu(v0, v1, pack(bias.x, bias.y)) : pack_relu(v0, v1);
        }
      }
    }

    bool in_fa = true;
    for (int li = 1; li < L.n_layers - 1; ++li) {
      const bf16* w = reinterpret_cast<const bf16*>(sm + L.w_dst[li]);
      const float* bias = reinterpret_cast<const float*>(sm + L.b_dst[li]);
      const int kfs = L.kpad[li] / 16, ncs = L.npad[li] / 16, ld = L.kpad[li] + 8;
      if (in_fa)
        hidden_layer<KF, MT>(fa, fb, w, bias, kfs, ncs, ld, lane, chain);
      else
        hidden_layer<KF, MT>(fb, fa, w, bias, kfs, ncs, ld, lane, chain);
      in_fa = !in_fa;
    }
    const int li = L.n_layers - 1;
    const bf16* w = reinterpret_cast<const bf16*>(sm + L.w_dst[li]);
    const float* bias = reinterpret_cast<const float*>(sm + L.b_dst[li]);
    const int kfs = L.kpad[li] / 16, ld = L.kpad[li] + 8;
    if (in_fa)
      last_layer<KF, MT>(fa, w, bias, kfs, ld, lane, dst, p0, n, chain);
    else
      last_layer<KF, MT>(fb, w, bias, kfs, ld, lane, dst, p0, n, chain);
  }
}

// KF k16 fragments (16 KF channels) and MT row tiles a warp
template <int KF, int MT>
int launch(const void* flat, const void* points, void* out, const Layout& L, const int batch,
           const int n, const int tile_points, const int chain, cudaStream_t s) {
  if (tile_points <= 0 || tile_points % (16 * MT * kWarps) != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(decode_batch_tc_kernel<KF, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + tile_points - 1) / tile_points;
  if ((long long)batch * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  decode_batch_tc_kernel<KF, MT><<<batch * tiles, kThreads, L.smem_bytes, s>>>(
      static_cast<const bf16*>(flat), static_cast<const bf16*>(points), static_cast<bf16*>(out),
      n, tiles, tile_points, chain, L);
  return (int)cudaGetLastError();
}

}  // namespace

// Points a block's tile must be a multiple of for these widths (128 or
// 64), or -1 when the kernel cannot take them (more than 16 layers, or a
// hidden layer wider than 256).
extern "C" int hpcd_decode_batch_bf16_tile_quantum(const int* widths, int n_layers,
                                                   int use_bias) {
  Layout L;
  if (!make_layout(widths, n_layers, use_bias != 0, &L) || L.max_width > 256) return -1;
  return L.max_width <= 128 ? 16 * 2 * kWarps : 16 * kWarps;
}

// Shared memory (bytes) the kernel needs for these widths, or -1.
extern "C" long long hpcd_decode_batch_bf16_smem_bytes(const int* widths, int n_layers,
                                                       int use_bias) {
  Layout L;
  if (!make_layout(widths, n_layers, use_bias != 0, &L) || L.max_width > 256) return -1;
  return L.smem_bytes;
}

// flat (batch, w) and points (batch, n, 3), bf16, contiguous; writes out
// (batch, n, 3) bf16. A block takes tile_points points of one sample (a
// multiple of hpcd_decode_batch_bf16_tile_quantum); chain_rounding selects
// the chain's rounding. Launches on `stream`,
// does not synchronise, returns cudaGetLastError() (or
// cudaErrorInvalidValue when the widths do not consume exactly w values or
// the kernel cannot take them).
extern "C" int hpcd_decode_batch_bf16(const void* flat, const void* points, void* out,
                                      const int* widths, int n_layers, int use_bias, int batch,
                                      int n, int w, int tile_points, int chain_rounding,
                                      void* stream) {
  Layout L;
  if (batch <= 0 || n <= 0 || !make_layout(widths, n_layers, use_bias != 0, &L) ||
      L.flat != w || L.max_width > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return L.max_width <= 128
             ? launch<8, 2>(flat, points, out, L, batch, n, tile_points, chain_rounding, s)
             : launch<16, 1>(flat, points, out, L, batch, n, tile_points, chain_rounding, s);
}
