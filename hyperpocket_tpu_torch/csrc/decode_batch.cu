// Per-sample target-network decode from the hypernetwork's flat weights,
// fused, for Hopper (sm_90a): the fp32 case, on the CUDA cores.
//
// Replaces the TPU kernel hyperpocket_tpu/ops/pallas_decoder.py::decode_batch
// (_decode_kernel) for fp32 points; decode_batch_tc.cu takes bf16 points on
// the tensor cores. Each sample b has its own MLP 3 -> C1 -> ... -> Ck -> 3,
// sliced from its row of the flat weight vector (per layer a row-major
// (out, in) block, then the bias when there is one), run on its N points:
//   layer 0:  acc = bias + x0 w0 + x1 w1 + x2 w2, in fp32;
//   others:   acc = h . w in fp32, then + bias;
// ReLU after every layer but the last, as the TPU kernel does.
//
// What bounds it on the H100: arithmetic. At the chair widths a point takes
// 18,720 multiply-adds for 12 bytes in and 12 out, so the bytes are nothing;
// the products run as fp32 FMAs on the CUDA cores. The design keeps every
// activation on chip:
//   * one block per (sample, tile of 512 points); the sample's weights and
//     biases go to shared memory once, transposed to (in, out) with each
//     row padded to a multiple of 8, as fp32 (77 KB at the chair widths);
//   * the tile runs as 4 sub-tiles of 128 points; a layer's input and
//     output activations live in two shared buffers laid out (channel,
//     point), so that a warp reads 32 neighbouring points of one channel
//     and no two lanes meet in a bank;
//   * each of the 256 threads holds two points and 8 output channels in
//     registers: per input channel two activation loads and two broadcast
//     float4 loads of weights feed 16 FMAs. The four warp pairs take turns
//     over the layer's 8-channel chunks.
// Widths whose weights and buffers need more shared memory than a block may
// have are refused (the wrapper raises).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kPoints = 128;                   // points of a sub-tile
constexpr int kPairs = kPoints / 2;            // each thread holds two points
constexpr int kGroups = 4;                     // thread groups over output chunks
constexpr int kThreads = kPairs * kGroups;     // 256
constexpr int kChunk = 8;                      // output channels per thread per pass
constexpr int kTilePoints = 4 * kPoints;       // points per block

struct Layout {
  int n_layers;
  int in[kMaxLayers];
  int out[kMaxLayers];
  int pad[kMaxLayers];     // out rounded up to kChunk
  int w_src[kMaxLayers];   // offsets in the flat row
  int b_src[kMaxLayers];   // -1 without bias
  int w_dst[kMaxLayers];   // offsets in shared memory, in floats
  int b_dst[kMaxLayers];
  int buf[2];              // the two activation buffers' offsets
  int flat;                // the flat row's length
  int smem_floats;
};

int round_up(const int v, const int to) { return (v + to - 1) / to * to; }

// widths: n_layers + 1 channel counts (3, C1, ..., Ck, 3). False when there
// are too many layers or a width is not positive.
bool make_layout(const int* widths, const int n_layers, const bool use_bias, Layout* L) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  for (int i = 0; i <= n_layers; ++i)
    if (widths[i] <= 0) return false;
  L->n_layers = n_layers;
  long long src = 0, dst = 0;
  int width[2] = {3, 0};  // buffer 0 holds the points, then odd layers' outputs
  for (int li = 0; li < n_layers; ++li) {
    L->in[li] = widths[li];
    L->out[li] = widths[li + 1];
    L->pad[li] = round_up(widths[li + 1], kChunk);
    L->w_src[li] = (int)src;
    src += (long long)widths[li] * widths[li + 1];
    L->b_src[li] = use_bias ? (int)src : -1;
    if (use_bias) src += widths[li + 1];
    L->w_dst[li] = (int)dst;
    dst += (long long)widths[li] * L->pad[li];
    L->b_dst[li] = (int)dst;
    dst += L->pad[li];
    if (li < n_layers - 1) {
      int& w = width[(li + 1) & 1];
      w = w > widths[li + 1] ? w : widths[li + 1];
    }
    if (src > 0x7fffffffLL || dst > 0x7fffffffLL) return false;
  }
  L->flat = (int)src;
  L->buf[0] = (int)dst;
  L->buf[1] = (int)dst + width[0] * kPoints;
  const long long total = dst + (long long)(width[0] + width[1]) * kPoints;
  if (total > 0x7fffffffLL / 4) return false;
  L->smem_floats = (int)total;
  return true;
}

__global__ void __launch_bounds__(kThreads, 1)
decode_batch_kernel(const float* __restrict__ flat, const float* __restrict__ points,
                    float* __restrict__ out, const int n, const int tiles, const Layout L) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const float* row = flat + (size_t)b * L.flat;

  // the sample's weights, transposed to (in, pad) and zero-padded, and biases
  for (int li = 0; li < L.n_layers; ++li) {
    const int in = L.in[li], nout = L.out[li], pad = L.pad[li];
    float* w = sm + L.w_dst[li];
    for (int e = threadIdx.x; e < nout * in; e += blockDim.x)  // coalesced in the row
      w[(e % in) * pad + e / in] = row[L.w_src[li] + e];
    for (int e = threadIdx.x; e < in * (pad - nout); e += blockDim.x)
      w[(e / (pad - nout)) * pad + nout + e % (pad - nout)] = 0.f;
    for (int o = threadIdx.x; o < pad; o += blockDim.x) {
      const bool given = o < nout && L.b_src[li] >= 0;
      sm[L.b_dst[li] + o] = given ? row[L.b_src[li] + o] : 0.f;
    }
  }

  const int pair = threadIdx.x % kPairs;
  const int group = threadIdx.x / kPairs;
  const int last = min(n, (tile + 1) * kTilePoints);
  for (int p0 = tile * kTilePoints; p0 < last; p0 += kPoints) {
    __syncthreads();  // weights staged, or the previous sub-tile's buffers consumed
    float* xs = sm + L.buf[0];
    for (int e = threadIdx.x; e < 3 * kPoints; e += blockDim.x) {
      const int i = p0 + e / 3;
      const float v = i < n ? points[3 * ((size_t)b * n + i) + e % 3] : 0.f;
      xs[(e % 3) * kPoints + e / 3] = v;
    }
    __syncthreads();
    for (int li = 0; li < L.n_layers; ++li) {
      const float* hin = sm + L.buf[li & 1];
      float* hout = sm + L.buf[(li + 1) & 1];
      const bool final_layer = li == L.n_layers - 1;
      const int in = L.in[li], nout = L.out[li], pad = L.pad[li];
      const float* w = sm + L.w_dst[li];
      const float* bias = sm + L.b_dst[li];
      for (int c0 = group * kChunk; c0 < pad; c0 += kGroups * kChunk) {
        float a0[kChunk], a1[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) a0[j] = a1[j] = li == 0 ? bias[c0 + j] : 0.f;
        for (int i = 0; i < in; ++i) {
          const float h0 = hin[i * kPoints + pair];
          const float h1 = hin[i * kPoints + pair + kPairs];
          const float4 wa = *reinterpret_cast<const float4*>(w + i * pad + c0);
          const float4 wb = *reinterpret_cast<const float4*>(w + i * pad + c0 + 4);
          const float wv[kChunk] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            a0[j] = fmaf(h0, wv[j], a0[j]);
            a1[j] = fmaf(h1, wv[j], a1[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int c = c0 + j;
          if (c >= nout) break;
          float v0 = li == 0 ? a0[j] : __fadd_rn(a0[j], bias[c]);
          float v1 = li == 0 ? a1[j] : __fadd_rn(a1[j], bias[c]);
          if (!final_layer) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          if (final_layer) {
            const int i0 = p0 + pair, i1 = p0 + pair + kPairs;
            if (i0 < n) out[3 * ((size_t)b * n + i0) + c] = v0;
            if (i1 < n) out[3 * ((size_t)b * n + i1) + c] = v1;
          } else {
            hout[c * kPoints + pair] = v0;
            hout[c * kPoints + pair + kPairs] = v1;
          }
        }
      }
      __syncthreads();
    }
  }
}

int launch(const float* flat, const float* points, float* out, const Layout& L, const int batch,
           const int n, cudaStream_t s) {
  const size_t bytes = sizeof(float) * (size_t)L.smem_floats;
  cudaError_t err = cudaFuncSetAttribute(decode_batch_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kTilePoints - 1) / kTilePoints;
  if ((long long)batch * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  decode_batch_kernel<<<batch * tiles, kThreads, bytes, s>>>(flat, points, out, n, tiles, L);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) the kernel needs for these widths (n_layers + 1
// channel counts, 3 first and last), or -1 if it cannot take them.
extern "C" long long hpcd_decode_batch_smem_bytes(const int* widths, int n_layers, int use_bias) {
  Layout L;
  if (!make_layout(widths, n_layers, use_bias != 0, &L)) return -1;
  return (long long)sizeof(float) * L.smem_floats;
}

// flat (batch, w) and points (batch, n, 3), fp32, contiguous; writes out
// (batch, n, 3) fp32. Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (or cudaErrorInvalidValue when the widths do not
// consume exactly w values).
extern "C" int hpcd_decode_batch(const void* flat, const void* points, void* out,
                                 const int* widths, int n_layers, int use_bias, int batch, int n,
                                 int w, void* stream) {
  Layout L;
  if (batch <= 0 || n <= 0 || !make_layout(widths, n_layers, use_bias != 0, &L) || L.flat != w)
    return (int)cudaErrorInvalidValue;
  return launch(static_cast<const float*>(flat), static_cast<const float*>(points),
                static_cast<float*>(out), L, batch, n, static_cast<cudaStream_t>(stream));
}
