// Fused PointNet trunk + global max-pool for Hopper (sm_90a), bf16: K4, the
// inference trunk, and K8, the training forward that also returns the
// pool's first argmax.
//
// K4 replaces the TPU kernel hyperpocket_tpu/ops/pallas_encoder.py::trunk_pooled
// (_trunk_pool_kernel, _trunk_pool_kernel_grouped); K8 replaces
// pallas_encoder.py::trunk_pooled_argmax (_trunk_pool_argmax_kernel[_grouped]).
// Both compute, per cloud,
//   max over points of  L5(relu(L4(relu(L3(relu(L2(relu(L1(x)))))))))
// with widths 3 -> 64 -> 128 -> 256 -> 512 -> 512 and the TPU kernel's
// numerics: layer 1 is three fp32 multiply-adds starting from the bias,
// layers 2-5 are fp32-accumulated bf16 dots plus the fp32 bias, every layer's
// output is rounded to bf16, and the max is taken in fp32 of those bf16
// values (layer 5 has no ReLU, so the pooled values may be negative).
//
// What bounds it on the H100: 0.87 GFLOP per 1024-point cloud against ~6 KB
// of input and 1 KB of output, so operations: at 989 TFLOP/s (bf16 tensor
// cores) 0.232 ms at B=256 and 0.058 ms at B=64, N=1024. A 128-point tile
// does 111 MFLOP against all 0.87 MB of weights (128 FLOP a weight byte), so
// the weights must reach the tensor cores from shared memory, fed from L2 at
// a few TB/s, while the activations never leave the SM.
//
// The design:
//   * a persistent grid of clusters of two CTAs, one CTA an SM; a cluster
//     walks over pairs of 128-point tiles (cloud, tile), one tile a CTA. The
//     tile count may be odd: a CTA without a tile runs the whole pipeline on
//     zeros (its partner needs its weight loads and its barrier arrivals)
//     and merges nothing;
//   * warp specialisation, 384 threads: two consumer warpgroups own 64 rows
//     of the tile each (224 registers a thread, by setmaxnreg), one thread
//     of the producer warpgroup (56 registers) streams the weights. The
//     consumer warpgroups share nothing but the ring;
//   * layers 2-5 are wgmma.mma_async m64n128k16 (bf16 -> fp32) over column
//     blocks of 128 (64 fp32 accumulators a thread); B (the weights) is read
//     from shared memory, K-major with the 128-byte swizzle;
//   * the weights arrive by TMA (tensor maps over the nn.Linear (out, in)
//     weights, encoded on the host for every call, so K8's per-step weights
//     need no repacking) in chunks of 64 deep x 128 columns (16 KB) into a
//     ring of six stages on mbarriers. Each CTA of a cluster loads half a
//     chunk and multicasts it to both, so every weight byte leaves L2 once
//     per tile pair in full 128-byte lines; a stage is refilled when the
//     four consumer warpgroups of the cluster have released it. With two
//     stages every chunk's load was exposed (0.93 ms at B=256, as slow as
//     the mma.sync kernel this one replaces); with six, taking the loads
//     out changes nothing measurable (PERF.md);
//   * A (the activations): layers 2, 3 and 5 read it from shared memory in
//     the swizzled K-major layout of the wgmma descriptor, which the
//     previous layer's epilogue (bias, ReLU, bf16) writes straight into.
//     Layer 3's epilogue instead packs its output into layer 4's A
//     fragments in registers (64 a thread), so that no 64 KB buffer holds
//     it while layer 4 writes its 128 KB: that is the room of the ring;
//   * layer 5's epilogue takes the column max in registers (K8: of 32-bit
//     keys, the value's bf16 bits made order-preserving above the inverted
//     row, so one integer max keeps the first row of equal values), a
//     reduce-scatter over the warp's rows by shuffles, across the
//     warpgroup's 4 warps through shared memory, then one atomic per
//     (cloud, column) and warpgroup;
//   * what is left of the time is the epilogues and the barrier traffic
//     (the kernel with its wgmmas taken out runs ~0.2 ms at B=256), which
//     two consumer warps a scheduler cannot hide behind each other; the
//     loops over chunks and layer-5 blocks stay loops to keep the code
//     small.
// Shared memory, 232,032 of the 232,448 bytes a block may use (with 1 KB of
// slack to align the base to 1024 bytes, as the swizzle needs):
//   [0, 128K)       activations, 8 slabs of 64 columns: layer 1's output in
//                   slab 0, layer 2's in slabs 1-2, then layer 4's in 0-7;
//                   after layer 5, the 8 warps' partial maxima (each
//                   warpgroup in its own rows' bytes)
//   [128K, 224K)    the weight ring, 6 stages of 16 KB
//   [224K, +1.5K)   the tile's points as fp32
//   then            the ring's full and empty mbarriers.
// A slab holds 128 rows x 128 bytes (16 KB); inside it, row r's 16-byte
// chunk c sits at r * 128 + ((c ^ (r % 8)) * 16).
// Rows past N in the last tile are computed but never enter the max; every
// row's values depend on that row alone (the same instructions, in the same
// order, for every row), which the exact checks of K8 rely on.
//
// K8 is the same kernel with another epilogue (a template parameter). Its
// values are bf16, so equal maxima across points are common, and the index
// must be the first, as torch.max and the sparse max-pool backward route ties:
//   * of a thread's two rows the later wins only where strictly larger;
//     lanes, warps and warpgroups merge 32-bit keys (value bits above
//     0xFFFF - row), so equal values keep the smaller row;
//   * across the tiles of a cloud, one 64-bit atomic max per column and
//     warpgroup on (ordered bits of the value << 32) | (0xFFFFFFFF - row):
//     the larger value wins, then the smaller row. -0.0 is keyed as +0.0,
//     so the two zeros tie as they do in torch.max. The key buffer starts
//     at 0, below every real value's key; a last kernel unpacks value and row.
// K8 moves 8 more bytes per (cloud, column): its bound is K4's.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kTile = 128;           // points per CTA
constexpr int kRowsPerGroup = 64;    // rows of a consumer warpgroup
constexpr int kConsumerThreads = 256;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kOut = 512;
constexpr int kBlockN = 128;         // columns of a wgmma block
constexpr int kChunkK = 64;          // depth of a weight chunk (128 bytes)
constexpr int kStages = 6;
constexpr int kClusterSize = 2;

constexpr uint32_t kSlabBytes = kTile * 128;              // 64 columns of the tile
constexpr uint32_t kChunkBytes = kBlockN * kChunkK * 2;   // 16 KB
constexpr uint32_t kHalfChunkBytes = kChunkBytes / kClusterSize;
constexpr uint32_t kAct = 0;  // 8 slabs: 512 columns
constexpr uint32_t kRing = kAct + 8 * kSlabBytes;
constexpr uint32_t kXs = kRing + kStages * kChunkBytes;
constexpr uint32_t kBars = kXs + kTile * 3 * sizeof(float);
constexpr uint32_t kUsedBytes = kBars + 2 * kStages * sizeof(uint64_t);
constexpr uint32_t kSmemBytes = kUsedBytes + 1024;  // slack to align the base to 1024
static_assert(kSmemBytes <= 232448, "more shared memory than a block may use");

struct Params {
  CUtensorMap w[4];   // layers 2-5: (out, in) bf16, boxes of 64 x 64
  const bf16* x;      // (batch, n, 3)
  const bf16* w1;     // (64, 3)
  const bf16* b[5];   // (out,)
  float* pooled;      // K4: (batch, 512) fp32, set to -inf
  unsigned long long* keys;  // K8: (batch, 512), set to 0
  int n;
  int tiles_per_cloud;
  int tiles;          // batch * tiles_per_cloud
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The float's bits as an unsigned key that orders like the float
// (-0.0 and +0.0 map to one key), and back.
__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);  // -0.0 + 0.0 == +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered_bits(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A 64-bit atomic max whose old value nobody waits for (atomicMax's
// returns it, and the thread would stall on the round trip).
__device__ __forceinline__ void red_max_u64(unsigned long long* addr, unsigned long long v) {
  asm volatile("red.global.max.u64 [%0], %1;\n" ::"l"(addr), "l"(v) : "memory");
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

// Byte offset of (row, column) in a buffer of 64-column swizzled slabs.
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  const int cc = col & 63;
  return (col >> 6) * kSlabBytes + row * 128 + ((((cc >> 3) ^ (row & 7)) << 4) | ((cc & 7) << 1));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Wait for the barrier's phase of this parity to complete. A wait of
// seconds means a pipeline that can never complete (a missing arrival or
// load): trap, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 33)) __trap();
  }
}

// Arrive on the barrier at the same offset in CTA `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// A box of the tensor map at (c0 along K, c1 along the output columns) into
// the same shared offset of every CTA in `mask`, completing on their
// barriers at offset `bar`.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused for this layout).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous wgmma's issue and wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]));
}

// d (64 x 128, fp32) = (accumulate ? d : 0) + A (64 x 16) * B (16 x 128)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, fp32) = (accumulate ? d : 0) + A (64 x 16, this thread's
// bf16 pairs in registers, mma's A fragment layout) * B (16 x 128)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void advance(uint32_t& stage, uint32_t& phase) {
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1u;
  }
}

// A warpgroup is done with a ring stage: tell both CTAs' producers (each
// multicasts half of the stage into this CTA).
__device__ __forceinline__ void release(uint32_t empty_bar, int wg_tid) {
  if (wg_tid < kClusterSize) mbar_arrive_cluster(empty_bar, wg_tid);
}

// One chunk of a block product: wait for the weight chunk, issue its four
// 16-deep wgmmas, and release the previous chunk once they are issued (one
// group stays in flight).
template <bool kRegA>
__device__ __forceinline__ void chunk_product(float (&acc)[64], uint32_t a_addr,
                                              const uint32_t (*frag)[4], int kc, uint32_t ring,
                                              uint32_t full, uint32_t empty, uint32_t& stage,
                                              uint32_t& phase, uint32_t& prev, int wg_tid) {
  mbar_wait(full + 8 * stage, phase);
  wgmma_fence();
  // computed here, not hoisted out of the layers' loops into spills
  uint32_t a_kc = a_addr + kc * kSlabBytes;
  asm volatile("" : "+r"(a_kc));
  const uint64_t da = smem_desc(a_kc);
  const uint64_t db = smem_desc(ring + stage * kChunkBytes);
#pragma unroll
  for (int j = 0; j < kChunkK / 16; ++j) {  // 16 deep (32 bytes) a step
    const int accumulate = (kc > 0 || j > 0) ? 1 : 0;
    if constexpr (kRegA) {
      wgmma_m64n128k16_rs(acc, frag[kc * (kChunkK / 16) + j], db + 2 * j, accumulate);
    } else {
      wgmma_m64n128k16(acc, da + 2 * j, db + 2 * j, accumulate);
    }
  }
  wgmma_commit();
  if (kc > 0) {
    wgmma_wait<1>();
    release(empty + 8 * prev, wg_tid);
  }
  prev = stage;
  advance(stage, phase);
}

// One 128-column block of a layer for this warpgroup's 64 rows:
// acc = A (64 x kK) * W^T, the weight chunks taken from the ring in order.
// A is read from swizzled slabs at a_addr, or (kRegA) from the fragments
// frag[k-step][4], whose indices unroll the loop; the shared-memory form
// stays a loop, which keeps the kernel's code small enough for the
// instruction cache.
template <int kK, bool kRegA>
__device__ __forceinline__ void block_product(float (&acc)[64], uint32_t a_addr,
                                              const uint32_t (*frag)[4], uint32_t ring,
                                              uint32_t full, uint32_t empty, uint32_t& stage,
                                              uint32_t& phase, int wg_tid) {
  uint32_t prev = 0;
  fence_acc(acc);
  if constexpr (kRegA) {
#pragma unroll
    for (int kc = 0; kc < kK / kChunkK; ++kc) {
      chunk_product<true>(acc, a_addr, frag, kc, ring, full, empty, stage, phase, prev, wg_tid);
    }
  } else {
#pragma unroll 1
    for (int kc = 0; kc < kK / kChunkK; ++kc) {
      chunk_product<false>(acc, a_addr, frag, kc, ring, full, empty, stage, phase, prev, wg_tid);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  release(empty + 8 * prev, wg_tid);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A hidden layer's epilogue: + bias in fp32, ReLU, round to bf16, stored
// into the next layer's swizzled A layout. The thread holds rows row and
// row + 8 of columns cb * 128 + 8 j + 2 (lane % 4) (+1).
__device__ __forceinline__ void store_hidden(const float (&acc)[64], uint8_t* out,
                                             const bf16* __restrict__ bias, int cb, int row,
                                             int lane) {
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    const int c = cb * kBlockN + 8 * j + 2 * (lane & 3);
    const float2 b = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(bias + c)));
    *reinterpret_cast<__nv_bfloat162*>(out + swizzled(row, c)) = __floats2bfloat162_rn(
        fmaxf(acc[4 * j] + b.x, 0.0f), fmaxf(acc[4 * j + 1] + b.y, 0.0f));
    *reinterpret_cast<__nv_bfloat162*>(out + swizzled(row + 8, c)) = __floats2bfloat162_rn(
        fmaxf(acc[4 * j + 2] + b.x, 0.0f), fmaxf(acc[4 * j + 3] + b.y, 0.0f));
  }
}

// Layer 3's epilogue, + bias, ReLU, bf16, straight into layer 4's A
// fragments (mma's A layout: the accumulator's, in bf16 pairs): column
// block cb is layer 4's k-steps 8 cb .. 8 cb + 7, frag[s] = {row, row + 8}
// x {k 2 (lane % 4), k 2 (lane % 4) + 8} of k-step s.
__device__ __forceinline__ void to_fragments(const float (&acc)[64], uint32_t (*frag)[4],
                                             const bf16* __restrict__ bias, int cb, int lane) {
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {  // n8 group j: k-step j / 2, half j % 2
    const int c = cb * kBlockN + 8 * j + 2 * (lane & 3);
    const float2 b = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(bias + c)));
    frag[j / 2][2 * (j % 2)] =
        pack_bf16(fmaxf(acc[4 * j] + b.x, 0.0f), fmaxf(acc[4 * j + 1] + b.y, 0.0f));
    frag[j / 2][2 * (j % 2) + 1] =
        pack_bf16(fmaxf(acc[4 * j + 2] + b.x, 0.0f), fmaxf(acc[4 * j + 3] + b.y, 0.0f));
  }
}

// K8's (value, row) as one 32-bit key that orders as (the larger value,
// then the smaller row): the value's bf16 bits (the value is bf16, so they
// are its top half) made order-preserving, -0.0 as +0.0, above 0xFFFF - row.
// 0 is below the key of every real row.
__device__ __forceinline__ uint32_t row_key(float v, int row) {
  const uint32_t u = __float_as_uint(v + 0.0f);  // -0.0 + 0.0 == +0.0
  // every bit of a negative value flipped, only the sign of another
  const uint32_t o = u ^ ((uint32_t)((int32_t)u >> 31) | 0x80000000u);
  return (o & 0xFFFF0000u) | (0xFFFFu - (uint32_t)row);
}

__device__ __forceinline__ float row_key_value(uint32_t key) {
  const uint32_t o = key >> 16;
  return __uint_as_float(((o & 0x8000u) ? (o & 0x7FFFu) : (~o & 0xFFFFu)) << 16);
}

__device__ __forceinline__ int row_key_row(uint32_t key) { return 0xFFFF - (int)(key & 0xFFFFu); }

__device__ __forceinline__ float take_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ uint32_t take_max(uint32_t a, uint32_t b) { return max(a, b); }

// Halve the groups a lane keeps: lanes with `upper` keep the upper half,
// merged with the partner's (lane ^ off) copy of it.
template <typename T, int kGroups>
__device__ __forceinline__ void keep_half(const T (&m)[kGroups][2], T (&mo)[kGroups / 2][2],
                                          bool upper, int off) {
  constexpr int kHalf = kGroups / 2;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const T keep = upper ? m[j + kHalf][e] : m[j][e];
      const T give = upper ? m[j][e] : m[j + kHalf][e];
      mo[j][e] = take_max(keep, __shfl_xor_sync(0xffffffffu, give, off));
    }
  }
}

// What layer 5's epilogue keeps a column: K4 the max (fp32), K8 the key.
template <bool kArgmax>
using MaxT = typename std::conditional<kArgmax, uint32_t, float>::type;

// Layer 5's epilogue for one column block (no ReLU): + bias, bf16, the max
// over the thread's two rows (K8: the key, so the first row of equal values
// wins), then a reduce-scatter over the warp's 8 row groups: lane l ends
// with the warp's max of columns cb * 128 + 16 (l / 4) + 8 jj + 2 (l % 4) + e
// in v[2 jj + e].
template <bool kArgmax>
__device__ __forceinline__ void max_block(const float (&acc)[64], MaxT<kArgmax> (&v)[4],
                                          const bf16* __restrict__ bias, int cb, int row,
                                          int valid_rows, int lane) {
  using T = MaxT<kArgmax>;
  const bool lo_ok = row < valid_rows;
  const bool hi_ok = row + 8 < valid_rows;  // implies lo_ok
  T m[16][2];
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    const int c = cb * kBlockN + 8 * j + 2 * (lane & 3);
    const float2 b = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(bias + c)));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v0 = round_bf16(acc[4 * j + e] + (e ? b.y : b.x));      // row
      const float v1 = round_bf16(acc[4 * j + 2 + e] + (e ? b.y : b.x));  // row + 8
      if constexpr (kArgmax) {
        // the later row wins only where it is larger: ties keep the first
        const bool later = hi_ok && v1 > v0;
        m[j][e] = lo_ok ? row_key(later ? v1 : v0, later ? row + 8 : row) : 0u;
      } else {
        m[j][e] = hi_ok ? fmaxf(v0, v1) : (lo_ok ? v0 : -INFINITY);
      }
    }
  }
  T m8[8][2], m4[4][2], m2[2][2];
  keep_half<T, 16>(m, m8, lane & 16, 16);
  keep_half<T, 8>(m8, m4, lane & 8, 8);
  keep_half<T, 4>(m4, m2, lane & 4, 4);
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) v[2 * jj + e] = m2[jj][e];
  }
}

// Depth and width of layer l + 2 (l = 0..3).
__device__ __forceinline__ constexpr int layer_k(int l) { return 64 << l; }
__device__ __forceinline__ constexpr int layer_n(int l) { return l < 3 ? 128 << l : 512; }

// The 1024-byte aligned base of the dynamic shared memory.
__device__ __forceinline__ uint32_t smem_base() {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  return (raw + 1023u) & ~1023u;
}

__device__ __forceinline__ uint8_t* smem_ptr(uint32_t base) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  return smem_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)));
}

// The producer warpgroup: one thread streams every tile's weight chunks in
// the consumers' order (layers 2-5, each by 128-column blocks, each block
// by 64-deep chunks), its half of each chunk multicast to both CTAs.
__device__ __forceinline__ void produce(const Params& p, uint32_t base) {
  if (threadIdx.x != kConsumerThreads) return;
  const uint32_t full = base + kBars;
  const uint32_t empty = full + kStages * sizeof(uint64_t);
  const uint32_t rank = cluster_rank();
  const int pairs = (p.tiles + kClusterSize - 1) / kClusterSize;
  uint32_t stage = 0, phase = 0;
  for (int pair = blockIdx.x / kClusterSize; pair < pairs; pair += gridDim.x / kClusterSize) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      for (int cb = 0; cb < layer_n(l) / kBlockN; ++cb) {
        for (int kc = 0; kc < layer_k(l) / kChunkK; ++kc) {
          mbar_wait(empty + 8 * stage, phase ^ 1u);
          mbar_expect_tx(full + 8 * stage, kChunkBytes);
          tma_load_multicast(base + kRing + stage * kChunkBytes + rank * kHalfChunkBytes, &p.w[l],
                             full + 8 * stage, kc * kChunkK,
                             cb * kBlockN + rank * (kBlockN / kClusterSize),
                             (uint16_t)((1u << kClusterSize) - 1u));
          advance(stage, phase);
        }
      }
    }
  }
}

// A consumer warpgroup: its 64 rows of every tile of the CTA through the
// five layers and the max. The two warpgroups share nothing but the ring.
template <bool kArgmax>
__device__ __forceinline__ void consume(const Params& p, uint32_t base) {
  using T = MaxT<kArgmax>;
  const int tid = threadIdx.x;
  const int g = tid / 128;  // rows 64 g .. 64 g + 63 of the tile
  const int wg_tid = tid % 128;
  const int lane = tid % 32;
  const int warp = wg_tid / 32;
  const int row = kRowsPerGroup * g + 16 * warp + lane / 4;  // this thread's first row
  const int group_bar = 1 + g;
  const uint32_t full = base + kBars;
  const uint32_t empty = full + kStages * sizeof(uint64_t);
  const uint32_t ring = base + kRing;
  uint8_t* act = smem_ptr(base) + kAct;
  float* x_s = reinterpret_cast<float*>(smem_ptr(base) + kXs);
  const uint32_t a_rows = kRowsPerGroup * g * 128;  // the warpgroup's rows in a slab
  const uint32_t rank = cluster_rank();
  const int pairs = (p.tiles + kClusterSize - 1) / kClusterSize;
  uint32_t stage = 0, phase = 0;
  float acc[64];

  for (int pair = blockIdx.x / kClusterSize; pair < pairs; pair += gridDim.x / kClusterSize) {
    const int tile = kClusterSize * pair + (int)rank;
    int cloud = 0, row0 = 0, valid_rows = 0;  // a CTA without a tile: zeros, no merge
    if (tile < p.tiles) {
      cloud = tile / p.tiles_per_cloud;
      row0 = (tile % p.tiles_per_cloud) * kTile;
      valid_rows = min(kTile, p.n - row0);
    }

    // stage the warpgroup's points as fp32; rows past N read as zeros
    const bf16* xc = p.x + ((size_t)cloud * p.n + row0) * 3;
    for (int e = kRowsPerGroup * 3 * g + wg_tid; e < kRowsPerGroup * 3 * (g + 1); e += 128) {
      x_s[e] = e < valid_rows * 3 ? __bfloat162float(xc[e]) : 0.0f;
    }
    named_sync(group_bar, 128);

    // layer 1 (K=3) into slab 0: bias + x0*w0 + x1*w1 + x2*w2, each step
    // rounded like separate fp32 multiplies and adds (no fused multiply-add)
    for (int e = wg_tid; e < kRowsPerGroup * 32; e += 128) {
      const int r = kRowsPerGroup * g + e / 32;
      const int c = 2 * (e % 32);
      float a0 = __bfloat162float(p.b[0][c]);
      float a1 = __bfloat162float(p.b[0][c + 1]);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        a0 = __fadd_rn(a0, __fmul_rn(x_s[r * 3 + k], __bfloat162float(p.w1[c * 3 + k])));
        a1 = __fadd_rn(a1, __fmul_rn(x_s[r * 3 + k], __bfloat162float(p.w1[(c + 1) * 3 + k])));
      }
      *reinterpret_cast<__nv_bfloat162*>(act + swizzled(r, c)) =
          __floats2bfloat162_rn(fmaxf(a0, 0.0f), fmaxf(a1, 0.0f));
    }
    fence_proxy_async();  // the generic stores, visible to the wgmmas
    named_sync(group_bar, 128);

    // layer 2: 64 -> 128, slab 0 -> slabs 1-2
    block_product<64, false>(acc, base + kAct + a_rows, nullptr, ring, full, empty, stage, phase,
                             wg_tid);
    store_hidden(acc, act + kSlabBytes, p.b[1], 0, row, lane);
    fence_proxy_async();
    named_sync(group_bar, 128);
    // layer 3: 128 -> 256, slabs 1-2 -> layer 4's A fragments in registers
    uint32_t frag[256 / 16][4];
#pragma unroll
    for (int cb = 0; cb < 256 / kBlockN; ++cb) {
      block_product<128, false>(acc, base + kAct + kSlabBytes + a_rows, nullptr, ring, full,
                                empty, stage, phase, wg_tid);
      to_fragments(acc, frag + (kBlockN / 16) * cb, p.b[2], cb, lane);
    }
    // layer 4: 256 -> 512, registers -> slabs 0-7 (slabs 0-2 are dead)
#pragma unroll 1
    for (int cb = 0; cb < 512 / kBlockN; ++cb) {
      block_product<256, true>(acc, 0, frag, ring, full, empty, stage, phase, wg_tid);
      store_hidden(acc, act, p.b[3], cb, row, lane);
    }
    fence_proxy_async();
    named_sync(group_bar, 128);
    // layer 5: 512 -> 512 and the column max, the warp's in registers;
    // each block's maxima shift in at the end of res, so that the loop
    // needs no unrolling: after it, res[cb] holds block cb's
    T res[kOut / kBlockN][4] = {};
#pragma unroll 1
    for (int cb = 0; cb < kOut / kBlockN; ++cb) {
      block_product<512, false>(acc, base + kAct + a_rows, nullptr, ring, full, empty, stage,
                                phase, wg_tid);
      T v[4];
      max_block<kArgmax>(acc, v, p.b[4], cb, row, valid_rows, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int k = 0; k + 1 < kOut / kBlockN; ++k) res[k][i] = res[k + 1][i];
        res[kOut / kBlockN - 1][i] = v[i];
      }
    }
    // the warpgroup's rows of the slabs are free now: warp w leaves its
    // partials in those of slab w
    T* part = reinterpret_cast<T*>(act + warp * kSlabBytes + a_rows);
#pragma unroll
    for (int cb = 0; cb < kOut / kBlockN; ++cb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[cb * kBlockN + 16 * (lane / 4) + 8 * (i / 2) + 2 * (lane & 3) + (i & 1)] = res[cb][i];
      }
    }
    named_sync(group_bar, 128);
    // merge the warpgroup's 4 warps, then the warpgroups and tiles of the cloud
    if (valid_rows > kRowsPerGroup * g) {
      for (int c = wg_tid; c < kOut; c += 128) {
        T m = reinterpret_cast<const T*>(act + a_rows)[c];
#pragma unroll
        for (int w = 1; w < 4; ++w) {
          m = take_max(m, reinterpret_cast<const T*>(act + w * kSlabBytes + a_rows)[c]);
        }
        if constexpr (kArgmax) {
          // some row of the warpgroup is valid, so the key is a real row's
          red_max_u64(p.keys + (size_t)cloud * kOut + c,
                      ((unsigned long long)ordered_bits(row_key_value(m)) << 32) |
                          (0xFFFFFFFFu - (unsigned)(row0 + row_key_row(m))));
        } else {
          atomic_max_float(p.pooled + (size_t)cloud * kOut + c, m);
        }
      }
    }
    named_sync(group_bar, 128);  // partials read before slab 0 is written again
  }
}

template <bool kArgmax>
__global__ void __launch_bounds__(kThreads, 1)
trunk_pool_kernel(const __grid_constant__ Params p) {
  const uint32_t base = smem_base();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + kBars + 8 * s, 1);  // full: the producer's arrival and the bytes
      // empty: both warpgroups of both CTAs read each stage
      mbar_init(base + kBars + 8 * (kStages + s), 2 * kClusterSize);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // the partner's barriers exist before any multicast or remote arrival

  // the roles never reconverge, so that ptxas gives each its registers:
  // 2 x 128 x 224 + 128 x 56 = 384 x 168
  if (threadIdx.x >= kConsumerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    produce(p, base);
    cluster_sync();  // no CTA leaves while its partner may still arrive on its barriers
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    consume<kArgmax>(p, base);
    cluster_sync();
  }
}

__global__ void fill_neg_inf(float* __restrict__ a, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) a[i] = -INFINITY;
}

__global__ void cast_to_bf16(const float* __restrict__ a, bf16* __restrict__ out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = __float2bfloat16(a[i]);
}

__global__ void fill_zero_keys(unsigned long long* __restrict__ a, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) a[i] = 0ull;
}

__global__ void unpack_keys(const unsigned long long* __restrict__ keys, bf16* __restrict__ out,
                            int* __restrict__ idx, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) {
    const unsigned long long k = keys[i];
    out[i] = __float2bfloat16(unordered_bits((unsigned)(k >> 32)));
    idx[i] = (int)(0xFFFFFFFFu - (unsigned)(k & 0xFFFFFFFFull));
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, fetched through the runtime: the library
// links no libcuda.
cudaError_t tensor_map_encoder(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// A tensor map over an (n_out, k_in) bf16 weight: boxes of 64 deep x 64
// columns (half a chunk), 128-byte swizzle, as the wgmma B descriptor reads.
cudaError_t weight_map(CUtensorMap* map, const void* w, int n_out, int k_in) {
  EncodeTiled encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)k_in, (cuuint64_t)n_out};
  const cuuint64_t strides[1] = {(cuuint64_t)k_in * sizeof(bf16)};
  const cuuint32_t box[2] = {kChunkK, kBlockN / kClusterSize};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t make_params(Params* p, const void* x, const void* const* ws, const void* const* bs,
                        int batch, int n) {
  const int widths[6] = {3, 64, 128, 256, 512, 512};
  for (int l = 0; l < 4; ++l) {
    const cudaError_t err = weight_map(&p->w[l], ws[l + 1], widths[l + 2], widths[l + 1]);
    if (err != cudaSuccess) return err;
  }
  p->x = static_cast<const bf16*>(x);
  p->w1 = static_cast<const bf16*>(ws[0]);
  for (int i = 0; i < 5; ++i) p->b[i] = static_cast<const bf16*>(bs[i]);
  p->pooled = nullptr;
  p->keys = nullptr;
  p->n = n;
  p->tiles_per_cloud = (n + kTile - 1) / kTile;
  p->tiles = batch * p->tiles_per_cloud;
  return cudaSuccess;
}

// The persistent grid: as many clusters as fit on the card at once (asked
// once per device), and no more than there are tile pairs.
template <bool kArgmax>
cudaError_t launch_trunk(const Params& p, cudaStream_t s) {
  auto kernel = trunk_pool_kernel<kArgmax>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterSize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  static int max_clusters[64] = {0};
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (max_clusters[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cfg.gridDim = dim3(kClusterSize * (sms / kClusterSize));
    err = cudaOccupancyMaxActiveClusters(&max_clusters[device], kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (max_clusters[device] <= 0) return cudaErrorInvalidConfiguration;  // nothing fits
  }
  const int pairs = (p.tiles + kClusterSize - 1) / kClusterSize;
  cfg.gridDim = dim3(kClusterSize * (pairs < max_clusters[device] ? pairs : max_clusters[device]));
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x (batch, n, 3) bf16; w_i/b_i the five layers in nn.Linear layout, bf16,
// contiguous; w2-w5 16-byte aligned (TMA), the biases 4-byte aligned;
// pooled (batch, 512) fp32 scratch; out (batch, 512) bf16.
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
  const void* ws[5] = {w1, w2, w3, w4, w5};
  const void* bs[5] = {b1, b2, b3, b4, b5};
  Params p;
  cudaError_t err = make_params(&p, x, ws, bs, batch, n);
  if (err != cudaSuccess) return (int)err;
  const int count = batch * kOut;
  p.pooled = static_cast<float*>(pooled);

  fill_neg_inf<<<(count + 255) / 256, 256, 0, s>>>(p.pooled, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_trunk<false>(p, s);
  if (err != cudaSuccess) return (int)err;
  cast_to_bf16<<<(count + 255) / 256, 256, 0, s>>>(p.pooled, static_cast<bf16*>(out), count);
  return (int)cudaGetLastError();
}

// K8: as hpcd_trunk_pool_bf16, plus the first argmax over points of every
// (cloud, channel). keys (batch, 512) uint64 scratch; out (batch, 512) bf16;
// idx (batch, 512) int32. Launches on `stream`, does not synchronise,
// returns cudaGetLastError().
extern "C" int hpcd_trunk_pool_argmax_bf16(const void* x,
                                           const void* w1, const void* b1,
                                           const void* w2, const void* b2,
                                           const void* w3, const void* b3,
                                           const void* w4, const void* b4,
                                           const void* w5, const void* b5,
                                           void* keys, void* out, void* idx,
                                           int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ws[5] = {w1, w2, w3, w4, w5};
  const void* bs[5] = {b1, b2, b3, b4, b5};
  Params p;
  cudaError_t err = make_params(&p, x, ws, bs, batch, n);
  if (err != cudaSuccess) return (int)err;
  const int count = batch * kOut;
  p.keys = static_cast<unsigned long long*>(keys);

  fill_zero_keys<<<(count + 255) / 256, 256, 0, s>>>(p.keys, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_trunk<true>(p, s);
  if (err != cudaSuccess) return (int)err;
  unpack_keys<<<(count + 255) / 256, 256, 0, s>>>(p.keys, static_cast<bf16*>(out),
                                                  static_cast<int*>(idx), count);
  return (int)cudaGetLastError();
}
