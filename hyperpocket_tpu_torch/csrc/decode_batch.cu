// Per-sample target-network decode from the hypernetwork's flat weights,
// fused, for Hopper (sm_90a), on the CUDA cores: the fp32 case, and the
// bf16 widths that decode_batch_tc.cu cannot hold.
//
// Replaces the TPU kernel hyperpocket_tpu/ops/pallas_decoder.py::decode_batch
// (_decode_kernel). Each sample b has its own MLP 3 -> C1 -> ... -> Ck -> 3,
// sliced from its row of the flat weight vector (per layer a row-major
// (out, in) block, then the bias when there is one), run on its N points,
// with ReLU after every layer but the last. The values are stored as T
// (fp32, or bf16 for the wide bf16 widths); the math is fp32 FMAs, no TF32.
// Two roundings, chosen by the caller:
//   kernel (chain = 0): the TPU kernel's. Layer 0 sums from the bias, the
//     others add it to the fp32 dot; each layer's output is rounded once to T.
//   chain (chain = 1): the JAX model's bmm chain (models/target_network.py):
//     every layer's fp32 dot rounded to T, the bias added, rounded again.
// In fp32 the two differ only in where layer 0 adds its bias.
//
// What bounds it on the H100: arithmetic. At the chair widths a point takes
// 18,720 multiply-adds for 12 bytes in and 12 out, so the bytes are nothing:
// the bound is the fp32 FMA rate. The design:
//   * one block of 8 warps per (sample, tile of points); the wrapper cuts a
//     sample into tiles only when the batch leaves SMs idle, so at large B a
//     sample's weights are staged once;
//   * resident weights (when a sample's weights fit beside the activations,
//     77 KB at the chair widths): the row comes in once per block by
//     cp.async in 16-byte pieces from the 16-byte boundary below its start
//     (an fp32 row is 76,044 bytes, so it starts only 4-byte aligned) into
//     the activation buffers, which are free until the first points arrive;
//     one pass inside shared memory transposes each layer to (in, out) with
//     the outputs padded to a multiple of 8 and a row stride of pad + 4;
//   * the block's four teams of 2 warps take turns over the tile's
//     sub-tiles of P points (32 at the chair widths; fewer for wider
//     layers, so that each team's two activation buffers of the widest
//     layer fit), each team with its own buffers and named barrier: one SM
//     holds one block (its weights and buffers take 173 KB at the chair
//     widths), and while a team waits at a layer's barrier the others
//     compute. Activations live in shared memory as (channel, point), fp32;
//   * register tiles of 8 points x 8 channels: per input channel two float4
//     of activations (the thread's 8 points) and two float4 of weights feed
//     64 FMAs. Layers whose 8 x 8 tiles do not give each thread of a team
//     one (64 channels at 32 points) take 4 x 8 tiles (32 FMAs for three
//     loads), and where even those do not (the first layer, K = 3), the
//     lanes of a warp that share a tile split its input channels and add
//     their sums by shuffles. Sed variants of these choices
//     (tests/card_decode_variants.sh) moved the time by 3% at most, PERF.md;
//   * the thin last layer (Ck -> 3) has its own mapping: each thread takes
//     4 points and a slice of the input channels (all 256 threads busy),
//     and the partial sums are added in shared memory in a fixed order;
//   * streamed weights (wider widths, up to 4096 channels a layer): per
//     sub-tile and layer, the output channels go in rounds of one 4 x 8 tile
//     a thread, and each round's weights go through two shared buffers in
//     chunks of input channels: a thread loads its share of the next chunk
//     into registers while it computes on the current one.
// Widths beyond 4096 channels or 16 layers are refused (the wrapper raises).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxWidth = 4096;
constexpr int kThreads = 256;
constexpr int kMaxPoints = 128;          // points of a sub-tile
constexpr int kStreamValues = 16;        // values a thread stages per streamed chunk
constexpr int kChunkFloats = kStreamValues * kThreads;
constexpr long long kSmemLimit = 232448;  // dynamic shared memory a block may have
constexpr int kTeams = 4;                // teams of a block when the weights are resident
static_assert(3 * kMaxPoints <= 2 * kThreads, "a team's sub-tile's coordinates: two a thread");

struct Layout {
  int n_layers;
  int in[kMaxLayers];
  int out[kMaxLayers];
  int pad[kMaxLayers];    // out rounded up to 8
  int w_src[kMaxLayers];  // offsets in the flat row, in values
  int b_src[kMaxLayers];  // -1 without bias
  int w_dst[kMaxLayers];  // resident: float offsets in shared memory, row stride pad + 4
  int b_dst[kMaxLayers];
  int points;             // P, points of a sub-tile (a power of 2, 4..128)
  int teams;              // thread teams of a block, each on its own sub-tiles (1 or kTeams)
  int buf[2];             // float offsets of team 0's two activation buffers
  int team_floats;        // floats between one team's buffers and the next's
  int chunks;             // streamed: float offset of the two chunk buffers
  int stream;             // 1 when the weights are streamed
  int flat;               // the flat row's length
  int smem_bytes;
};

long long round_up(const long long v, const long long to) { return (v + to - 1) / to * to; }
long long larger(const long long a, const long long b) { return a > b ? a : b; }

// widths: n_layers + 1 channel counts (3, C1, ..., Ck, 3); elem: bytes a value
// takes in the row. False when the kernel cannot take them.
bool make_layout(const int* widths, const int n_layers, const bool use_bias, const int elem,
                 Layout* L) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  for (int i = 0; i <= n_layers; ++i)
    if (widths[i] <= 0 || widths[i] > kMaxWidth) return false;
  L->n_layers = n_layers;
  long long src = 0, dst = 0;
  long long width[2] = {3, 1};  // buffer 0 holds the points, then odd layers' outputs
  for (int li = 0; li < n_layers; ++li) {
    const int in = widths[li], out = widths[li + 1];
    L->in[li] = in;
    L->out[li] = out;
    L->pad[li] = (int)round_up(out, 8);
    L->w_src[li] = (int)src;
    src += (long long)in * out;
    L->b_src[li] = use_bias ? (int)src : -1;
    if (use_bias) src += out;
    L->w_dst[li] = (int)dst;
    dst += (long long)in * (L->pad[li] + 4);
    L->b_dst[li] = (int)dst;
    dst += L->pad[li];
    if (li < n_layers - 1) {
      long long& w = width[(li + 1) & 1];
      w = w > out ? w : out;
    }
    if (src > 0x7fffffffLL) return false;
  }
  L->flat = (int)src;
  // the raw copy of the row: the bytes before its start on the 16-byte grid, and one piece more
  const long long raw_floats = round_up(16 + (long long)elem * src + 16, 16) / 4;
  // resident weights: kTeams teams of kThreads / kTeams, each with its own
  // buffers of up to kMaxPoints / kTeams points; else streamed, one team of
  // kThreads
  for (int stream = 0; stream <= 1; ++stream) {
    const int teams = stream ? 1 : kTeams;
    for (int p = kMaxPoints / teams; p >= 4; p /= 2) {
      // the last layer's partial sums take 16 floats a thread of its output buffer
      const long long last = n_layers > 1 ? (16LL * kThreads / teams + p - 1) / p : 0;
      long long w0 = width[0], w1 = width[1];
      long long& wl = (n_layers & 1) ? w1 : w0;
      wl = wl > last ? wl : last;
      const long long acts = (w0 + w1) * p;
      const long long need =
          stream ? acts + 2LL * kChunkFloats : dst + larger(teams * acts, raw_floats);
      if (4 * need > kSmemLimit) continue;
      const long long base = stream ? 0 : dst;
      L->stream = stream;
      L->teams = teams;
      L->points = p;
      L->buf[0] = (int)base;
      L->buf[1] = (int)(base + w0 * p);
      L->team_floats = (int)acts;
      L->chunks = (int)(base + acts);
      L->smem_bytes = (int)(4 * need);
      return true;
    }
  }
  return false;
}

template <typename T>
__device__ __forceinline__ float to_f(const T v);
template <>
__device__ __forceinline__ float to_f<float>(const float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(const bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(const float v);
template <>
__device__ __forceinline__ float from_f<float>(const float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(const float v) { return __float2bfloat16_rn(v); }

// v rounded to T, as fp32
template <typename T>
__device__ __forceinline__ float rnd(const float v) { return to_f<T>(from_f<T>(v)); }

// A layer's output from its fp32 sum and its bias, in the selected rounding
// (layer 0 of the kernel's rounding already summed from the bias), with
// ReLU on hidden layers.
template <typename T>
__device__ __forceinline__ float finish(const float acc, const float b, const bool first,
                                        const bool chain, const bool relu) {
  const float v = chain ? rnd<T>(__fadd_rn(rnd<T>(acc), b)) : rnd<T>(first ? acc : __fadd_rn(acc, b));
  return relu ? fmaxf(v, 0.f) : v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, const int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}

// acc[p][j] += h[k][p] w[k][j] over k in [k0, k1), for the thread's NP
// points (4 or 8) and 8 channels: h and w point at the thread's first point
// and channel, with row strides hs and ws.
template <int NP>
__device__ __forceinline__ void tile_fma(float (&acc)[NP][8], const float* __restrict__ h,
                                         const int hs, const float* __restrict__ w, const int ws,
                                         const int k0, const int k1) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    float av[NP];
#pragma unroll
    for (int p = 0; p < NP; p += 4) {
      const float4 a = *reinterpret_cast<const float4*>(h + k * hs + p);
      av[p] = a.x, av[p + 1] = a.y, av[p + 2] = a.z, av[p + 3] = a.w;
    }
    const float4 wa = *reinterpret_cast<const float4*>(w + k * ws);
    const float4 wb = *reinterpret_cast<const float4*>(w + k * ws + 4);
    const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[p][j] = fmaf(av[p], wv[j], acc[p][j]);
  }
}

// Where a layer writes: the next layer's buffer (channel, point), or, for
// the last layer, the output points p0.. of the sample, below n; and the
// team of threads that computes it (thread tid of size, with named barrier
// bar, or 0 for the whole block).
template <typename T>
struct Sink {
  float* hout;
  T* out;  // the sample's (n, 3) output, or nullptr for a hidden layer
  int points, p0, n, width;
  int tid, size, bar;
};

template <typename T>
__device__ __forceinline__ void team_sync(const Sink<T>& s) {
  if (s.bar)
    asm volatile("bar.sync %0, %1;\n" ::"r"(s.bar), "r"(s.size) : "memory");
  else
    __syncthreads();
}

// A tile's NP x 8 outputs (points pt.., channels c0..) finished and stored.
template <typename T, int NP>
__device__ __forceinline__ void store_tile(const float (&acc)[NP][8], const float (&bias)[8],
                                           const int pt, const int c0, const int nout,
                                           const bool first, const bool chain,
                                           const Sink<T>& s) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + j;
    if (c >= nout) break;
    float v[NP];
    if constexpr (std::is_same_v<T, float>) {
      // fp32: both roundings add the bias once, at the start or here
      const float b = first && !chain ? 0.f : bias[j];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        v[p] = __fadd_rn(acc[p][j], b);
        if (!s.out) v[p] = fmaxf(v[p], 0.f);
      }
    } else {
#pragma unroll
      for (int p = 0; p < NP; ++p) v[p] = finish<T>(acc[p][j], bias[j], first, chain, !s.out);
    }
    if (s.out) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int i = s.p0 + pt + p;
        if (i < s.n) s.out[(size_t)i * s.width + c] = from_f<T>(v[p]);
      }
    } else {
#pragma unroll
      for (int p = 0; p < NP; p += 4)
        *reinterpret_cast<float4*>(s.hout + c * s.points + pt + p) =
            make_float4(v[p], v[p + 1], v[p + 2], v[p + 3]);
    }
  }
}

// One layer on resident weights w (in, pad) with row stride pad + 4, in
// tiles of NP points x 8 channels: per input channel NP / 4 + 2 float4
// loads feed 8 NP FMAs. Where the tiles do not give every thread one, the
// lanes of a warp that share a tile split its input channels and add their
// sums by shuffles.
template <typename T, int NP>
__device__ __forceinline__ void layer_tiles(const float* __restrict__ hin, const float* w,
                                            const float* bias, const int in, const int nout,
                                            const int pad, const bool first, const bool chain,
                                            const Sink<T>& s) {
  const int cols = s.points / NP;
  const int tiles = cols * (pad / 8);
  int split = 1;  // lanes sharing a tile: 1, 2, 4, ... 32
  while (split < 32 && 2 * split * tiles <= s.size) split *= 2;
  const int lane = s.tid % 32, group = 32 / split;
  const int part = lane / group;
  const int slot = group * (s.tid / 32) + lane % group;
  const int per = (in + split - 1) / split;
  const int k0 = min(in, part * per), k1 = min(in, k0 + per);
  // every lane runs the same rounds, so the shuffles see the whole warp
  for (int base = 0; base < tiles; base += s.size / split) {
    const int u = base + slot;
    const bool mine = u < tiles;
    const int pt = NP * (u % cols), c0 = 8 * (u / cols);
    float acc[NP][8], b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      b[j] = mine ? bias[c0 + j] : 0.f;
#pragma unroll
      for (int p = 0; p < NP; ++p) acc[p][j] = first && !chain && part == 0 ? b[j] : 0.f;
    }
    if (mine) tile_fma(acc, hin + pt, s.points, w + c0, pad + 4, k0, k1);
    for (int off = 16; off >= group; off /= 2) {
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[p][j] += __shfl_xor_sync(0xffffffffu, acc[p][j], off);
    }
    if (mine && part == 0) store_tile(acc, b, pt, c0, nout, first, chain, s);
  }
}

// A layer on resident weights: tiles of 8 x 8 (64 FMAs for four float4
// loads a channel) where they give every thread one, else of 4 x 8 (32 for
// three).
template <typename T>
__device__ __forceinline__ void layer_resident(const float* __restrict__ hin, const float* w,
                                               const float* bias, const int in, const int nout,
                                               const int pad, const bool first, const bool chain,
                                               const Sink<T>& s) {
  if ((s.points / 8) * (pad / 8) >= s.size)
    layer_tiles<T, 8>(hin, w, bias, in, nout, pad, first, chain, s);
  else
    layer_tiles<T, 4>(hin, w, bias, in, nout, pad, first, chain, s);
}

// The last layer (Ck -> at most 4 outputs) on resident weights: thread t
// takes the (t % (P/4))-th 4 points and the (t / (P/4))-th slice of the
// input channels, 16 FMAs for two float4 loads a channel; the slices' sums
// meet in the layer's free output buffer and are added in slice order.
// Not for layer 0.
template <typename T>
__device__ __forceinline__ void last_layer_split(const float* __restrict__ hin, const float* w,
                                                 const float* bias, const int in, const int nout,
                                                 const int ld, const bool chain, float* scratch,
                                                 const Sink<T>& s) {
  const int P = s.points, q = P / 4, slices = s.size / q;
  const int quad = s.tid % q, slice = s.tid / q;
  const int per = (in + slices - 1) / slices;
  const int k0 = slice * per, k1 = min(in, k0 + per);
  float a[4][4] = {};
  for (int k = k0; k < k1; ++k) {
    const float4 h = *reinterpret_cast<const float4*>(hin + k * P + 4 * quad);
    const float4 wk = *reinterpret_cast<const float4*>(w + k * ld);
    const float hv[4] = {h.x, h.y, h.z, h.w}, wv[4] = {wk.x, wk.y, wk.z, wk.w};
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[p][c] = fmaf(hv[p], wv[c], a[p][c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<float4*>(scratch + (4 * slice + c) * P + 4 * quad) =
        make_float4(a[0][c], a[1][c], a[2][c], a[3][c]);
  team_sync(s);
  if (s.tid >= P) return;
  const int p = s.tid, i = s.p0 + p;
  for (int c = 0; c < nout; ++c) {
    float acc = 0.f;
    for (int sl = 0; sl < slices; ++sl) acc += scratch[(4 * sl + c) * P + p];
    const float v = finish<T>(acc, bias[c], false, chain, false);
    if (i < s.n) s.out[(size_t)i * s.width + c] = from_f<T>(v);
  }
}

// One layer with its weights streamed from the row: the output channels in
// rounds of one 4 x 8 unit a thread, each round's weights through the two
// chunk buffers, kc input channels at a time.
template <typename T>
__device__ void layer_streamed(const T* __restrict__ row, const float* __restrict__ hin,
                               float* chunks, const Layout& L, const int li, const bool chain,
                               const Sink<T>& s) {
  const int in = L.in[li], nout = L.out[li], pad = L.pad[li];
  const bool first = li == 0;
  const int q = s.points / 4;
  const int round_cols = 8 * (kThreads / q);
  const int quad = threadIdx.x % q, col = 8 * (threadIdx.x / q);
  for (int o0 = 0; o0 < pad; o0 += round_cols) {
    const int ncols = min(round_cols, pad - o0);
    const int kc = min(in, max(1, kChunkFloats / ncols));
    const int n_chunks = (in + kc - 1) / kc;
    const bool mine = col < ncols;
    float acc[4][8], b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = o0 + col + j;
      b[j] = mine && c < nout && L.b_src[li] >= 0 ? to_f<T>(row[L.b_src[li] + c]) : 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[p][j] = first && !chain ? b[j] : 0.f;
    }
    // value e of a chunk: column e / kc, input channel e % kc (along the row)
    float v[kStreamValues];
    auto load = [&](const int k0) {
#pragma unroll
      for (int r = 0; r < kStreamValues; ++r) {
        const int e = threadIdx.x + kThreads * r, c = e / kc, k = k0 + e % kc;
        v[r] = e < ncols * kc && o0 + c < nout && k < in
                   ? to_f<T>(row[L.w_src[li] + (size_t)(o0 + c) * in + k])
                   : 0.f;
      }
    };
    auto store = [&](float* cb) {
#pragma unroll
      for (int r = 0; r < kStreamValues; ++r) {
        const int e = threadIdx.x + kThreads * r;
        if (e < ncols * kc) cb[(e % kc) * ncols + e / kc] = v[r];
      }
    };
    load(0);
    store(chunks);
    __syncthreads();
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int k0 = ch * kc;
      const bool more = ch + 1 < n_chunks;
      if (more) load(k0 + kc);
      if (mine)
        tile_fma(acc, hin + k0 * s.points + 4 * quad, s.points,
                 chunks + (ch & 1) * kChunkFloats + col, ncols, 0, min(kc, in - k0));
      if (more) store(chunks + ((ch + 1) & 1) * kChunkFloats);
      __syncthreads();
    }
    if (mine) store_tile(acc, b, 4 * quad, o0 + col, nout, first, chain, s);
  }
}

// Stage the sample's row as resident weights: raw copy by cp.async into the
// activation buffers, then each layer transposed into place as fp32.
template <typename T>
__device__ void stage_resident(const T* __restrict__ row, float* sm, const Layout& L) {
  const int m0 = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const unsigned char* base = reinterpret_cast<const unsigned char*>(row) - m0;
  const int bytes = m0 + (int)sizeof(T) * L.flat;
  unsigned char* raw = reinterpret_cast<unsigned char*>(sm + L.buf[0]);
  for (int c = threadIdx.x; 16 * c < bytes; c += kThreads)
    cp_async16(raw + 16 * c, base + 16 * c, min(16, bytes - 16 * c));
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const T* rv = reinterpret_cast<const T*>(raw + m0);
  for (int li = 0; li < L.n_layers; ++li) {
    const int in = L.in[li], nout = L.out[li], pad = L.pad[li], ld = pad + 4;
    float* w = sm + L.w_dst[li];
    float* bias = sm + L.b_dst[li];
    for (int c = threadIdx.x; c < pad; c += kThreads)
      bias[c] = c < nout && L.b_src[li] >= 0 ? to_f<T>(rv[L.b_src[li] + c]) : 0.f;
    // e runs along the row: k fastest, so the reads are contiguous
    for (int e = threadIdx.x; e < in * pad; e += kThreads) {
      const int c = e / in, k = e % in;
      w[k * ld + c] = c < nout ? to_f<T>(rv[L.w_src[li] + c * in + k]) : 0.f;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
decode_batch_kernel(const T* __restrict__ flat, const T* __restrict__ points, T* __restrict__ out,
                    const int n, const int tiles, const int tile_points, const int chain_rounding,
                    const Layout L) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const T* row = flat + (size_t)b * L.flat;
  const bool chain = chain_rounding != 0;
  if (!L.stream) stage_resident(row, sm, L);

  // teams of threads take turns over the tile's sub-tiles, each with its
  // own activation buffers: a team's barriers wait while the others compute
  const int size = kThreads / L.teams, team = threadIdx.x / size;
  const int tid = threadIdx.x % size, bar = L.teams > 1 ? 1 + team : 0;
  const int P = L.points;
  float* bufs = sm + L.buf[0] + team * L.team_floats;
  const int buf1 = L.buf[1] - L.buf[0];
  const T* pts = points + 3 * (size_t)b * n;
  T* dst = out + 3 * (size_t)b * n;
  const int last = min(n, (tile + 1) * tile_points);
  const int stride = L.teams * P;
  // a sub-tile's 3 P coordinates, two a thread at most; the next
  // sub-tile's are loaded while the layers run
  float x[2];
  auto load_points = [&](const int p0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + size * r;
      x[r] = e < 3 * P && p0 + e / 3 < n ? to_f<T>(pts[3 * (size_t)p0 + e]) : 0.f;
    }
  };
  const int first_p0 = tile * tile_points + team * P;
  load_points(first_p0);
  for (int p0 = first_p0; p0 < last; p0 += stride) {
    const Sink<T> sync{nullptr, nullptr, P, p0, n, 3, tid, size, bar};
    team_sync(sync);  // the previous sub-tile's buffers consumed
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + size * r;
      if (e < 3 * P) bufs[(e % 3) * P + e / 3] = x[r];
    }
    team_sync(sync);
    if (p0 + stride < last) load_points(p0 + stride);
    for (int li = 0; li < L.n_layers; ++li) {
      const float* hin = bufs + (li & 1) * buf1;
      float* hout = bufs + ((li + 1) & 1) * buf1;
      const bool final_layer = li == L.n_layers - 1;
      const Sink<T> s{hout, final_layer ? dst : nullptr, P, p0, n, L.out[li], tid, size, bar};
      if (L.stream)
        layer_streamed(row, hin, sm + L.chunks, L, li, chain, s);
      else if (final_layer && li > 0 && L.out[li] <= 4)
        last_layer_split(hin, sm + L.w_dst[li], sm + L.b_dst[li], L.in[li], L.out[li],
                         L.pad[li] + 4, chain, hout, s);
      else
        layer_resident(hin, sm + L.w_dst[li], sm + L.b_dst[li], L.in[li], L.out[li], L.pad[li],
                       li == 0, chain, s);
      team_sync(s);
    }
  }
}

template <typename T>
int launch(const void* flat, const void* points, void* out, const Layout& L, const int batch,
           const int n, const int tile_points, const int chain, cudaStream_t s) {
  if (tile_points <= 0 || tile_points % (L.teams * L.points) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(decode_batch_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + tile_points - 1) / tile_points;
  if ((long long)batch * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  decode_batch_kernel<T><<<batch * tiles, kThreads, L.smem_bytes, s>>>(
      static_cast<const T*>(flat), static_cast<const T*>(points), static_cast<T*>(out), n, tiles,
      tile_points, chain, L);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan for these widths (n_layers + 1 channel counts, 3 first and last)
// with values of `elem` bytes (4: fp32, 2: bf16): the shared memory a block
// needs (bytes), or -1 when the kernel cannot take them (more than 16 layers
// or a width above 4096). Writes the points of a sub-tile, which a block's
// tile must be a multiple of.
extern "C" long long hpcd_decode_batch_plan(const int* widths, int n_layers, int use_bias,
                                            int elem, int* sub_tile) {
  Layout L;
  if ((elem != 4 && elem != 2) || !make_layout(widths, n_layers, use_bias != 0, elem, &L))
    return -1;
  *sub_tile = L.teams * L.points;
  return L.smem_bytes;
}

// flat (batch, w) and points (batch, n, 3), contiguous, fp32 (elem 4) or
// bf16 (elem 2); writes out (batch, n, 3) in the same type. A block takes
// tile_points points of one sample (a multiple of the plan's sub-tile);
// chain_rounding selects the chain's rounding. Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (or cudaErrorInvalidValue when the
// widths do not consume exactly w values or the kernel cannot take them).
extern "C" int hpcd_decode_batch(const void* flat, const void* points, void* out,
                                 const int* widths, int n_layers, int use_bias, int batch, int n,
                                 int w, int elem, int tile_points, int chain_rounding,
                                 void* stream) {
  Layout L;
  if (batch <= 0 || n <= 0 || (elem != 4 && elem != 2) ||
      !make_layout(widths, n_layers, use_bias != 0, elem, &L) || L.flat != w)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem == 4 ? launch<float>(flat, points, out, L, batch, n, tile_points, chain_rounding, s)
                   : launch<bf16>(flat, points, out, L, batch, n, tile_points, chain_rounding, s);
}
