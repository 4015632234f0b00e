// K-fused: one explicit adaptive Runge-Kutta step of the tanh MLP field
// f(y) = tanh(y @ W1 + b1) @ W2 + b2, every stage in one kernel.
//
// Replaces the TPU kernel benchmarks/fused_field.py:69 (`fused_stage_step`,
// pallas_call at :202), which keeps a batch tile's state, f32 slopes and
// field activations in VMEM and the whole MLP resident per tile.  At the
// bench's width (B=4096, D=256, H=1024) W1 and W2 take 2 MB in float32 and
// 1 MB in bfloat16, far above the 227 KB of shared memory a Hopper block
// has, so:
//
// - a block owns a tile of kRows=32 rows of the batch and runs every stage
//   of the step for it (B=4096 gives 128 blocks for 132 SMs, one block an
//   SM), with two warpgroups (and in bfloat16 one producer warp);
// - the stage input (kRows x D, in the state dtype) sits in shared memory;
//   the hidden layer is made kChunk=128 units at a time (tanh(y @ W1[:,
//   chunk] + b1), rounded to the state dtype, into shared memory) and
//   folded straight into the (kRows x D) float32 output sums in registers;
// - W1 and W2 stream from L2 in 32 KB tiles (a W1 tile: kRows1 rows of D
//   by the chunk's 128 columns; a W2 tile: kRows2 of the chunk's rows by D)
//   through a ring of 4 slots in shared memory, across chunk and stage
//   boundaries (the weights do not change within a step).  float32: every
//   thread copies its share of a tile by cp.async (LDGSTS), three tiles in
//   flight while one is multiplied.  bfloat16: a producer warp (one
//   thread of it) issues TMA copies (UTMALDG) of 64-column boxes, each box
//   multicast to both blocks of a cluster of two, so each tile is read
//   from L2 once for two blocks; a full mbarrier per slot counts the bytes
//   landed, an empty one the consumer warps of both blocks done with it,
//   so the producer runs up to four tiles ahead, and a tile's wgmma group
//   runs on while the next tile is waited for;
// - the float32 slopes k_1..k_n go to a global scratch that the wrapper
//   allocates (n_alpha x B x D float32: 24 MiB written and, by the stage,
//   output, error and midpoint sums, about 130 MiB read per dopri5 step at
//   the bench width, mostly from L2), four elements a load.
//
// The two products, by dtype:
// - bfloat16: on the tensor cores, by wgmma (m64n32k16, float32
//   accumulators), in the transposed form h^T = W1^T y^T and out^T = W2^T
//   h^T, so that the 32 batch rows are the N side and a 32-row tile keeps
//   128 blocks on the card.  W1 (D x H) and W2 (H x D) are row-major, so
//   W1^T and W2^T are M-major A operands (the transpose bit); y^T and h^T
//   are K-major B operands.  The weight tiles sit in shared memory in
//   wgmma's 128-byte swizzle, which the tile loader writes a whole 128-byte
//   row at a time (no bank conflict, whole L2 lines); y^T and h^T, written
//   by the threads, in the no-swizzle core-matrix layout (8 x 8 blocks of
//   128 contiguous bytes).  D=32 is one M tile of 64 (its W2 tile
//   unswizzled) whose rows 32..63 read the rest of the slot and are
//   discarded.  A bfloat16 product is exact in float32, so only the
//   summation order differs from the plain version, as
//   `ops/fused_field.kernel_bounds` allows.
// - float32: on the float32 pipes (TF32 would keep 10 mantissa bits, far
//   outside KERNEL_F32_SLOPE), as __fmaf_rn with each output's sum taken
//   in order inside one thread (no split-K): the order of the first
//   version, which kernel_bounds was set for.  A thread holds a 4 x 4 tile
//   of the hidden pre-activations and a 4 x D/32 tile of the outputs (see
//   `Acc`), read from conflict-free shared memory.
//
// Arithmetic otherwise follows the JAX kernel (fused_field.py:119-184) and
// its plain version `fused_stage_step_ref` (ops/fused_field.py): a stage
// input is y0 + sum((c*dt32)*k) in float32, the coefficients c*dt32 rounded
// in float32 on the host, zero coefficients skipped, then rounded to the
// state dtype; tanh and the bias adds are float32; hidden units and slopes
// are rounded to the state dtype.  The build's --fmad=false keeps each
// stage sum's multiply and add rounded apart, as in JAX.  bfloat16 values
// are read and written with __bfloat162float and __float2bfloat16 (round
// to nearest even).
//
// What bounds it on an H100.  A dopri5 step at the bench width does 6 field
// evaluations of two products of 2*B*D*H operations: 25.8 GFLOP, about
// 0.39 ms at the 67 TFLOP/s of float32 outside the tensor cores and 0.026
// ms at the 989 TFLOP/s of the bfloat16 tensor cores.  What the kernel
// takes instead (kernel_variants.py on an H100, PERF.md):
// - float32, about 1.0 ms: the FMAs at about 40% of their peak, nearly as
//   slow with the weight copies taken out, so neither the stream nor the
//   slope scratch but the FMA loop's own issue and latency;
// - bfloat16, about 0.16 ms: the work around the tensor cores (waiting
//   for each tile, storing the hidden chunk, the stage sums) about as long
//   as the whole without the copies (0.14 ms); the weight stream alone
//   about 0.12 ms.  The blocks of a cluster share each tile, which halves
//   the L2 reads (384 MiB a step for the 64 clusters) and measured faster
//   than a block alone (0.18 ms); clusters of four are slower (a W1 tile
//   has two boxes, so two of four blocks copy nothing of it).  More rows
//   a block (a wider wgmma N) is the next step.
// - then the slope scratch (a few hundredths of a ms a step) and host
//   dispatch.
#include <cuda.h>   // CUtensorMap (cuTensorMapEncodeTiled is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;        // batch rows per block (the wgmma N)
constexpr int kChunk = 128;      // hidden units per chunk
constexpr int kMaxStages = 7;    // slopes k_0..k_6 (dopri5, tsit5, ...)
constexpr int kCoefRows = kMaxStages + 2;   // beta rows 0..5, c_sol, c_err, c_mid
constexpr int kSolRow = kMaxStages - 1, kErrRow = kMaxStages, kMidRow = kMaxStages + 1;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <typename T> constexpr bool kTensorCores = sizeof(T) == 2;
// consumer threads a block: two warpgroups, so that each scheduler has two
// warps to hide latency with; in bfloat16 each warpgroup takes its own M
// tiles, and one more warp produces the weight tiles
constexpr int kThreads = 256;
template <typename T> constexpr int kBlock = kTensorCores<T> ? kThreads + 32 : kThreads;

// The tiling of one dtype and width (mirrored by ops/fused_field.py
// `fused_plan`): a ring of 32 KB slots, and the stage input (kRows x D)
// and hidden chunk (kRows x kChunk), whose float32 rows are padded by 4
// words (so the 8 rows a warp reads at once fall on distinct banks).
template <typename T, int D>
struct Plan {
  static constexpr int kTileBytes = 32768;
  static constexpr int kStages = 4;
  static constexpr int kElems = kTileBytes / (int)sizeof(T);   // a slot's elements
  static constexpr int kRows1 = cmin(D, kElems / kChunk);     // W1 tile: rows of D
  static constexpr int kRows2 = cmin(kChunk, kElems / D);     // W2 tile: rows of the chunk
  static constexpr int kTiles1 = D / kRows1;
  static constexpr int kTiles = kTiles1 + kChunk / kRows2;    // tiles a chunk
  static constexpr int kPad = kTensorCores<T> ? 0 : 4;
  // bfloat16: a full and an empty barrier for each slot, after s_h
  static constexpr size_t kSmem = (size_t)kStages * kTileBytes +
                                  (size_t)kRows * (D + kChunk + 2 * kPad) * sizeof(T) +
                                  (kTensorCores<T> ? 2 * kStages * sizeof(uint64_t) : 0);
};

// bfloat16: the blocks of a cluster share each weight tile (TMA multicast)
constexpr int kCluster = 2;

// The step's coefficients times dt32 (rounded in float32 on the host) and
// a bit mask of the nonzero ones per row; passed by value.
struct Coefs {
  float c[kCoefRows][kMaxStages];
  int mask[kCoefRows];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the state dtype, as float32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Four consecutive elements of the state dtype, as float32, in one load
// (the state rows are 16-byte aligned and D a multiple of 32), and back.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a, b;
  a.x = __float2bfloat16(v[0]); a.y = __float2bfloat16(v[1]);
  b.x = __float2bfloat16(v[2]); b.y = __float2bfloat16(v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const uint32_t*>(&a);
  x.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = x;
}

// For elements idx..idx+3: the sum over the nonzero coefficients of row
// `row` among k_0..k_{nk-1} of (c*dt32)*k, in order: the first term, then
// total + term (fused_field.py `_comb`); 0 when every coefficient is zero.
// k_0 is f0; k_q (q >= 1) is the scratch slab q-1.
template <typename T>
__device__ __forceinline__ void comb4(const Coefs& cf, int row, int nk,
                                      const T* __restrict__ f0,
                                      const float* kbuf,   // written by the kernel too
                                      size_t BD, size_t idx, float (&total)[4]) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) total[i] = 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxStages; ++q) {
    if (q < nk && ((cf.mask[row] >> q) & 1)) {
      float kv[4];
      if (q == 0)
        load4(f0 + idx, kv);
      else
        load4(kbuf + (size_t)(q - 1) * BD + idx, kv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float term = cf.c[row][q] * kv[i];
        total[i] = any ? total[i] + term : term;
      }
      any = true;
    }
  }
}

// ---- shared-memory layouts ----------------------------------------------
// float32: row-major, as in device memory (the stage input and the hidden
// chunk with rows padded by 4 words).
// bfloat16, an M-major A tile (k rows of width W, m contiguous): for W a
// multiple of 64, wgmma's 128-byte swizzle as TMA writes it: each group of
// 64 columns is `rows` rows of 128 bytes whose eight 16-byte chunks are
// permuted by chunk ^ (row % 8), the groups rows*128 bytes apart (LBO) and
// the 8-row atoms 1024 bytes apart along K (SBO).  For W=32 (half a
// group), no swizzle: core matrices of 8 x 8 elements (128 contiguous
// bytes), core (m/8, k/8) at ((m/8)*(rows/8) + k/8)*64 elements, k%8
// selecting its 16-byte row: LBO (along K) 128 bytes, SBO (along M)
// rows*16 bytes.  A K-major B operand (n rows, k contiguous: y and h, n
// the batch row), written by the threads, puts core (n/8, k/8) at
// ((n/8)*(K/8) + k/8)*64, n%8 selecting its 16-byte row: LBO 128 bytes,
// SBO K*16 bytes.
template <typename T, int W> constexpr bool kSwizzled = kTensorCores<T> && W % 64 == 0;

template <typename T>
__device__ __forceinline__ int b_offset(int n, int k, int K) {
  if constexpr (kTensorCores<T>)
    return ((n >> 3) * (K >> 3) + (k >> 3)) * 64 + (n & 7) * 8 + (k & 7);
  else
    return n * (K + 4) + k;   // rows padded by 4 words (Plan::kPad)
}

// C consecutive float32 words (C = 1, 2 or a multiple of 4, aligned to
// C words, or 4)
template <int C>
__device__ __forceinline__ void load_words(const float* p, float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int j = 0; j < C; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + j);
      v[j] = x.x; v[j + 1] = x.y; v[j + 2] = x.z; v[j + 3] = x.w;
    }
  } else if constexpr (C == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

// ---- asynchronous copies, wgmma -----------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// layout: 0 no swizzle, 1 the 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout = 0) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// The descriptor of the A operand's M tile mt (64 columns) and K step ks
// (16 rows) in a tile of `rows` rows of width W.
template <typename T, int W>
__device__ __forceinline__ uint64_t a_desc(const T* slot, int rows, int mt, int ks) {
  if constexpr (kSwizzled<T, W>)
    return smem_desc(slot + mt * rows * 64 + ks * 16 * 64, rows * 128, 1024, 1);
  else
    return smem_desc(slot + (8 * mt * (rows / 8) + 2 * ks) * 64, 128, rows * 16);
}

// the accumulators are ordered after the asm that last touched them
__device__ __forceinline__ void fence_regs(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, M-major: the transpose bit) * B (16 x 32, K-major)
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// at most N committed groups still run
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---- bfloat16 weight tiles: TMA multicast to the cluster, mbarriers -----
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// this thread's arrival, and `bytes` more for the copies to bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
}
// one arrival on `bar` in every block of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar) {
  const uint32_t a = smem_u32(bar);
#pragma unroll
  for (uint32_t r = 0; r < kCluster; ++r)
    asm volatile(
        "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
        "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(a), "r"(r)
        : "memory");
}
// the box at (x, y) of `map` into `dst` of every block of the cluster, each
// block's `bar` counting its bytes
__device__ __forceinline__ void tma_multicast(void* dst, const CUtensorMap* map, int x, int y,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(x), "r"(y), "r"(smem_u32(bar)), "h"((uint16_t)((1 << kCluster) - 1))
      : "memory");
}

// A wgmma m64n32 accumulator element i of this thread: its M index (of
// 64) and its N index (of 32).
__device__ __forceinline__ int acc_m(int i) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int warpgroup() { return threadIdx.x >> 7; }
__device__ __forceinline__ int acc_n(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// float32, every thread: tile g of the weight stream into `slot` by
// cp.async, row-major, consecutive copies along a row.  The stream is, for
// each field evaluation, each chunk's W1 tiles then its W2 tiles.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* slot, int g, const T* __restrict__ w1,
                                          const T* __restrict__ w2, int H, int n_chunks) {
  using P = Plan<T, D>;
  constexpr int kVec = 16 / (int)sizeof(T);   // elements a copy
  const int t = g % P::kTiles, h0 = (g / P::kTiles) % n_chunks * kChunk;
  if (t < P::kTiles1) {
    const int k0 = t * P::kRows1;
    for (int q = threadIdx.x; q < P::kRows1 * kChunk / kVec; q += kThreads) {
      const int k = q / (kChunk / kVec), m = q % (kChunk / kVec) * kVec;
      cp_async16(slot + k * kChunk + m, w1 + (size_t)(k0 + k) * H + h0 + m);
    }
  } else {   // rows of W2 are whole, so the tile is one contiguous run
    const T* src = w2 + (size_t)(h0 + (t - P::kTiles1) * P::kRows2) * D;
    for (int q = threadIdx.x; q < P::kRows2 * D / kVec; q += kThreads)
      cp_async16(slot + q * kVec, src + q * kVec);
  }
}

// bfloat16, the producer thread of each block of the cluster: tile g of
// the weight stream into its slot, once the slot's last tile is done with
// in every block.  The block of rank r copies boxes r, r + kCluster, ... of the tile
// (64 columns by the tile's rows, in the 128-byte swizzle; 8 columns,
// unswizzled, for W2 at D=32) to every block; each block's full barrier
// expects the whole tile.
template <typename T, int D>
__device__ __forceinline__ void issue_tile(T* ring, uint64_t* full, uint64_t* empty, int g,
                                           const CUtensorMap* m1, const CUtensorMap* m2,
                                           int n_chunks, uint32_t rank) {
  using P = Plan<T, D>;
  const int slot = g % P::kStages, use = g / P::kStages;
  if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
  T* dst = ring + slot * P::kElems;
  const int t = g % P::kTiles, h0 = (g / P::kTiles) % n_chunks * kChunk;
  if (t < P::kTiles1) {
    mbar_expect_tx(&full[slot], P::kRows1 * kChunk * (uint32_t)sizeof(T));
    for (int b = rank; b < kChunk / 64; b += kCluster)
      tma_multicast(dst + b * P::kRows1 * 64, m1, h0 + 64 * b, t * P::kRows1, &full[slot]);
  } else {
    constexpr int bw = kSwizzled<T, D> ? 64 : 8;
    mbar_expect_tx(&full[slot], P::kRows2 * D * (uint32_t)sizeof(T));
    for (int b = rank; b < D / bw; b += kCluster)
      tma_multicast(dst + b * P::kRows2 * bw, m2, bw * b,
                    h0 + (t - P::kTiles1) * P::kRows2, &full[slot]);
  }
}

// The accumulators of one thread, by dtype.  bfloat16: the wgmma fragments
// of its warpgroup's M tile of the chunk's hidden pre-activations (64
// units) and of its output M tiles (D/128 of 64 columns; for D <= 64 the
// first warpgroup's one).  float32: lane l of warp w takes the rows l%8 +
// 8i (i < 4) by the chunk's hidden units 16w + 4(l/8) + j (j < 4) and by
// the output columns (D/8)w + (D/32)(l/8) + j (j < D/32).  A warp's loads
// of a row operand then hit 8 rows (distinct banks, the rows being padded)
// and of a weight row 4 neighbouring vectors: 8 bank wavefronts for 64
// FMAs a thread in the first product, 4 + D/8 for 16 * D/32 in the second.
template <typename T, int D, bool TC = kTensorCores<T>>
struct Acc;

template <typename T, int D>
struct Acc<T, D, true> {
  static constexpr int kMT = D >= 64 ? D / 64 : 1;      // output M tiles
  static constexpr int kMW = kMT > 1 ? kMT / 2 : 1;     // ... a warpgroup
  float pre[16];        // the chunk's units 64 * warpgroup() ..
  float out[kMW][16];   // output M tiles kMW * warpgroup() ..
  // whether this warpgroup has output M tiles (for D <= 64 the second
  // has none)
  static __device__ __forceinline__ bool has_out() { return kMT > 1 || warpgroup() == 0; }
  __device__ __forceinline__ void zero_pre() {
#pragma unroll
    for (int i = 0; i < 16; ++i) pre[i] = 0.0f;
  }
  __device__ __forceinline__ void zero_out() {
#pragma unroll
    for (int mt = 0; mt < kMW; ++mt)
#pragma unroll
      for (int i = 0; i < 16; ++i) out[mt][i] = 0.0f;
  }
};

template <typename T, int D>
struct Acc<T, D, false> {
  static constexpr int kC = D / 32;   // output columns a thread
  float pre[4][4];
  float out[4][kC];
  static __device__ __forceinline__ int row(int i) { return (threadIdx.x & 7) + 8 * i; }
  static __device__ __forceinline__ int unit(int j) {
    return 16 * (threadIdx.x >> 5) + 4 * ((threadIdx.x >> 3) & 3) + j;
  }
  static __device__ __forceinline__ int col(int j) {
    return (D / 8) * (threadIdx.x >> 5) + kC * ((threadIdx.x >> 3) & 3) + j;
  }
  __device__ __forceinline__ void zero_pre() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pre[i][j] = 0.0f;
  }
  __device__ __forceinline__ void zero_out() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) out[i][j] = 0.0f;
  }
};

// pre += y[:, tile t's rows of D] @ W1 tile (the slot)
template <typename T, int D>
__device__ __forceinline__ void first_product(Acc<T, D>& a, const T* slot, const T* s_y, int t) {
  using P = Plan<T, D>;
  if constexpr (kTensorCores<T>) {
    // each warpgroup its M tile of 64 units; the group stays in flight
    // (the caller waits)
    fence_regs(a.pre);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < P::kRows1 / 16; ++ks) {
      const int k16 = t * (P::kRows1 / 16) + ks;
      wgmma_m64n32k16(a.pre, a_desc<T, kChunk>(slot, P::kRows1, warpgroup(), ks),
                      smem_desc(s_y + 2 * k16 * 64, 128, D * 16));
    }
    wgmma_commit();
    fence_regs(a.pre);
  } else {
    using A = Acc<T, D>;
    const int k0 = t * P::kRows1;
#pragma unroll 2
    for (int kk = 0; kk < P::kRows1; kk += 4) {
      float y[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_words<4>(&s_y[b_offset<T>(A::row(i), k0 + kk, D)], y[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float wv[4];
        load_words<4>(&slot[(kk + q) * kChunk + A::unit(0)], wv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a.pre[i][j] = __fmaf_rn(y[i][q], wv[j], a.pre[i][j]);
      }
    }
  }
}

// out += h[:, tile t's rows of the chunk] @ W2 tile (the slot)
template <typename T, int D>
__device__ __forceinline__ void second_product(Acc<T, D>& a, const T* slot, const T* s_h, int t) {
  using P = Plan<T, D>;
  if constexpr (kTensorCores<T>) {
    using A = Acc<T, D>;
    if (!A::has_out()) return;
#pragma unroll
    for (int j = 0; j < A::kMW; ++j) fence_regs(a.out[j]);
    wgmma_fence();
    // this warpgroup's M tiles alternate, so consecutive wgmmas do not
    // wait on one accumulator
#pragma unroll
    for (int ks = 0; ks < P::kRows2 / 16; ++ks)
#pragma unroll
      for (int j = 0; j < A::kMW; ++j) {
        const int k16 = t * (P::kRows2 / 16) + ks;
        wgmma_m64n32k16(a.out[j], a_desc<T, D>(slot, P::kRows2, A::kMW * warpgroup() + j, ks),
                        smem_desc(s_h + 2 * k16 * 64, 128, kChunk * 16));
      }
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < A::kMW; ++j) fence_regs(a.out[j]);
  } else {
    using A = Acc<T, D>;
    const int k0 = t * P::kRows2;
#pragma unroll 2
    for (int kk = 0; kk < P::kRows2; kk += 4) {
      float h[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        load_words<4>(&s_h[b_offset<T>(A::row(i), k0 + kk, kChunk)], h[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float wv[A::kC];
        load_words<A::kC>(&slot[(kk + q) * D + A::col(0)], wv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < A::kC; ++j) a.out[i][j] = __fmaf_rn(h[i][q], wv[j], a.out[i][j]);
      }
    }
  }
}

// The hidden chunk: h = tanh(pre + b1) rounded to the state dtype, into
// shared memory as the B operand (bfloat16) or row-major (float32).
template <typename T, int D>
__device__ __forceinline__ void store_hidden(Acc<T, D>& a, T* s_h,
                                             const T* __restrict__ b1, int h0) {
  if constexpr (kTensorCores<T>) {
    wgmma_wait<0>();
    fence_regs(a.pre);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = 64 * warpgroup() + acc_m(i);
      s_h[b_offset<T>(acc_n(i), k, kChunk)] = from_f32<T>(tanhf(a.pre[i] + to_f32(b1[h0 + k])));
    }
  } else {
    using A = Acc<T, D>;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bias = to_f32(b1[h0 + A::unit(j)]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s_h[b_offset<T>(A::row(i), A::unit(j), kChunk)] = from_f32<T>(tanhf(a.pre[i][j] + bias));
    }
  }
}

// The slope k_{s+1} (or f1 of a non-FSAL tableau), in the state dtype;
// kept as float32, which holds it exactly.
template <typename T, int D>
__device__ __forceinline__ void store_slope(Acc<T, D>& a, const T* __restrict__ b2,
                                            int row0, int B, int s, int n_alpha,
                                            bool last, float* __restrict__ kbuf,
                                            T* __restrict__ f1_out) {
  const size_t BD = (size_t)B * D;
  auto put = [&](int r, int c, float v) {
    const int g = row0 + r;
    if (g >= B || c >= D) return;
    const size_t idx = (size_t)g * D + c;
    const float kv = round_to<T>(v + to_f32(b2[c]));
    if (s < n_alpha) kbuf[(size_t)s * BD + idx] = kv;
    if (last) f1_out[idx] = from_f32<T>(kv);
  };
  if constexpr (kTensorCores<T>) {
    using A = Acc<T, D>;
    if (!A::has_out()) return;
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < A::kMW; ++j) fence_regs(a.out[j]);
#pragma unroll
    for (int j = 0; j < A::kMW; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i)
        put(acc_n(i), 64 * (A::kMW * warpgroup() + j) + acc_m(i), a.out[j][i]);
  } else {
    using A = Acc<T, D>;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < A::kC; ++j) put(A::row(i), A::col(j), a.out[i][j]);
  }
}

// the consumer threads' barrier (in bfloat16 the producer warp is not in
// it; in float32 it is the whole block)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// The consumers' part of the step (every thread of a float32 block; the
// two warpgroups of a bfloat16 block): the stage sums, the two products
// tile by tile, the slopes and the step's outputs.
template <typename T, int D>
__device__ __forceinline__ void run_step(const T* __restrict__ y0, const T* __restrict__ f0,
                                         const T* __restrict__ w1, const T* __restrict__ b1,
                                         const T* __restrict__ w2, const T* __restrict__ b2,
                                         int B, int H, const Coefs& cf, int n_alpha, int fsal,
                                         float* __restrict__ kbuf, T* __restrict__ y1_out,
                                         T* __restrict__ f1_out, float* __restrict__ err_out,
                                         float* __restrict__ dmid_out, T* ring, T* s_y, T* s_h,
                                         uint64_t* full, uint64_t* empty) {
  using P = Plan<T, D>;
  const int row0 = blockIdx.x * kRows;
  const size_t BD = (size_t)B * D;
  const int n_eval = n_alpha + (fsal ? 0 : 1);
  const int n_chunks = H / kChunk;
  const int n_tiles = n_eval * n_chunks * P::kTiles;

  // float32: the ring less one slot in flight ahead of the tile multiplied
  constexpr int kAhead = P::kStages - 1;
  if constexpr (!kTensorCores<T>) {
#pragma unroll
    for (int g = 0; g < kAhead; ++g) {
      if (g < n_tiles)
        load_tile<T, D>(ring + (g % P::kStages) * P::kElems, g, w1, w2, H, n_chunks);
      cp_async_commit();
    }
  }

  Acc<T, D> acc;
  int g = 0;   // the next tile of the stream
  for (int s = 0; s < n_eval; ++s) {
    // 1. the stage input: beta row s over k_0..k_s, or (the extra field
    //    evaluation of a non-FSAL tableau) y1 from c_sol over k_0..k_n
    const int crow = s < n_alpha ? s : kSolRow;
    const int nk = s < n_alpha ? s + 1 : n_alpha + 1;
#pragma unroll 4
    for (int e = 4 * threadIdx.x; e < kRows * D; e += 4 * kThreads) {
      const int r = e / D, c = e % D, gr = row0 + r;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (gr < B) {
        const size_t idx = (size_t)gr * D + c;
        float y[4], sum[4];
        load4(y0 + idx, y);
        comb4<T>(cf, crow, nk, f0, kbuf, BD, idx, sum);
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = y[i] + sum[i];
      }
      store4(s_y + b_offset<T>(r, c, D), v);   // c % 8 is 0 or 4
    }
    if constexpr (kTensorCores<T>) {
      fence_proxy_async();   // s_y for wgmma
      consumer_sync();
    }

    // 2. the field, one hidden chunk at a time, one weight tile at a time
    acc.zero_out();
    for (int c = 0; c < n_chunks; ++c) {
      acc.zero_pre();
      for (int t = 0; t < P::kTiles; ++t, ++g) {
        if constexpr (kTensorCores<T>) {
          mbar_wait(&full[g % P::kStages], (g / P::kStages) & 1);   // tile g landed
        } else {
          // tile g has landed, and every thread is done with tile g-1,
          // whose slot takes tile g+kAhead
          cp_async_wait<kAhead - 1>();
          consumer_sync();
          if (g + kAhead < n_tiles)
            load_tile<T, D>(ring + ((g + kAhead) % P::kStages) * P::kElems, g + kAhead, w1, w2,
                            H, n_chunks);
          cp_async_commit();
        }
        const T* slot = ring + (g % P::kStages) * P::kElems;
        if (t < P::kTiles1) {
          first_product<T, D>(acc, slot, s_y, t);
        } else {
          if (t == P::kTiles1) {
            // bfloat16: both warpgroups are past the last chunk's final
            // wgmma group (waited for at a W1 tile), which read s_h
            if constexpr (kTensorCores<T>) consumer_sync();
            store_hidden<T, D>(acc, s_h, b1, c * kChunk);
            if constexpr (kTensorCores<T>) fence_proxy_async();
            consumer_sync();
          }
          second_product<T, D>(acc, slot, s_h, t - P::kTiles1);
        }
        if constexpr (kTensorCores<T>) {
          // the tile's wgmma group runs on into the next tile; the one
          // before is done, so each warp gives tile g-1's slot back to
          // the producers of the cluster
          wgmma_wait<1>();
          if ((threadIdx.x & 31) == 0 && g >= 1) mbar_arrive_cluster(&empty[(g - 1) % P::kStages]);
        }
      }
    }

    // 3. the slope, then every thread sees every slope written so far
    store_slope<T, D>(acc, b2, row0, B, s, n_alpha, s == n_eval - 1, kbuf, f1_out);
    consumer_sync();
  }

  // 4. y1, the embedded error and the dense-output midpoint increment
  const int nk_sol = fsal ? n_alpha : n_alpha + 1;
#pragma unroll 2
  for (int e = 4 * threadIdx.x; e < kRows * D; e += 4 * kThreads) {
    const int gr = row0 + e / D;
    if (gr >= B) continue;
    const size_t idx = (size_t)gr * D + e % D;
    float y[4], sum[4];
    load4(y0 + idx, y);
    comb4<T>(cf, kSolRow, nk_sol, f0, kbuf, BD, idx, sum);
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = y[i] + sum[i];
    store4(y1_out + idx, y);
    comb4<T>(cf, kErrRow, n_alpha + 1, f0, kbuf, BD, idx, sum);
    store4(err_out + idx, sum);
    comb4<T>(cf, kMidRow, n_alpha + 1, f0, kbuf, BD, idx, sum);
    store4(dmid_out + idx, sum);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlock<T>, 1)
fused_step_kernel(const T* __restrict__ y0, const T* __restrict__ f0,
                  const T* __restrict__ w1, const T* __restrict__ b1,
                  const T* __restrict__ w2, const T* __restrict__ b2, int B,
                  int H, Coefs cf, int n_alpha, int fsal,
                  float* __restrict__ kbuf, T* __restrict__ y1_out,
                  T* __restrict__ f1_out, float* __restrict__ err_out,
                  float* __restrict__ dmid_out, const __grid_constant__ CUtensorMap tm_w1,
                  const __grid_constant__ CUtensorMap tm_w2) {
  using P = Plan<T, D>;
  extern __shared__ __align__(1024) unsigned char smem[];   // swizzle atoms
  T* ring = reinterpret_cast<T*>(smem);
  T* s_y = reinterpret_cast<T*>(smem + (size_t)P::kStages * P::kTileBytes);   // kRows x D
  T* s_h = s_y + kRows * (D + P::kPad);                                       // kRows x kChunk
  uint64_t* full = reinterpret_cast<uint64_t*>(s_h + kRows * (kChunk + P::kPad));
  uint64_t* empty = full + P::kStages;
  if constexpr (kTensorCores<T>) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < P::kStages; ++i) {
        mbar_init(&full[i], 1);                               // the producer
        mbar_init(&empty[i], kThreads / 32 * kCluster);       // every consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_sync();   // every block's barriers exist before a copy signals them
    if (threadIdx.x >= kThreads) {   // the producer warp: one thread issues every tile
      if (threadIdx.x == kThreads) {
        const int n_tiles = (n_alpha + (fsal ? 0 : 1)) * (H / kChunk) * P::kTiles;
        const uint32_t rank = cluster_rank();
        for (int g = 0; g < n_tiles; ++g)
          issue_tile<T, D>(ring, full, empty, g, &tm_w1, &tm_w2, H / kChunk, rank);
      }
    } else {
      run_step<T, D>(y0, f0, w1, b1, w2, b2, B, H, cf, n_alpha, fsal, kbuf, y1_out, f1_out,
                     err_out, dmid_out, ring, s_y, s_h, full, empty);
    }
    cluster_sync();   // no block leaves while the other may still signal or copy into it
  } else {
    run_step<T, D>(y0, f0, w1, b1, w2, b2, B, H, cf, n_alpha, fsal, kbuf, y1_out, f1_out,
                   err_out, dmid_out, ring, s_y, s_h, full, empty);
  }
}

// cuTensorMapEncodeTiled, from libcuda by the runtime's entry-point lookup
// (the library does not link libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bfloat16 row-major (rows x cols) matrix, read in boxes of box_rows x
// box_cols, with the 128-byte swizzle or none.
cudaError_t encode_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                       int box_cols, bool swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int D>
int launch(int B, int H, const void* y0, const void* f0, const void* w1,
           const void* b1, const void* w2, const void* b2, const Coefs& cf,
           int n_alpha, int fsal, void* kbuf, void* y1, void* f1, void* err,
           void* dmid, cudaStream_t st) {
  using P = Plan<T, D>;
  auto kernel = fused_step_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)P::kSmem);
  if (e != cudaSuccess) return (int)e;
  int blocks = (B + kRows - 1) / kRows;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster;
  CUtensorMap m1 = {}, m2 = {};
  if constexpr (kTensorCores<T>) {
    blocks = (blocks + kCluster - 1) / kCluster * kCluster;   // whole clusters
    e = encode_map(&m1, w1, D, H, P::kRows1, 64, true);
    if (e == cudaSuccess)
      e = encode_map(&m2, w2, H, D, P::kRows2, kSwizzled<T, D> ? 64 : 8, kSwizzled<T, D>);
    if (e != cudaSuccess) return (int)e;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = kCluster;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
  }
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kBlock<T>);
  cfg.dynamicSmemBytes = P::kSmem;
  cfg.stream = st;
  e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(y0), static_cast<const T*>(f0),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), B, H, cf, n_alpha, fsal, static_cast<float*>(kbuf),
      static_cast<T*>(y1), static_cast<T*>(f1), static_cast<float*>(err),
      static_cast<float*>(dmid), m1, m2);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int B, int D, int H, const void* y0, const void* f0, const void* w1,
             const void* b1, const void* w2, const void* b2, const Coefs& cf,
             int n_alpha, int fsal, void* kbuf, void* y1, void* f1, void* err,
             void* dmid, cudaStream_t st) {
#define TDT_LAUNCH_FUSED(DD)                                                     \
  return launch<T, DD>(B, H, y0, f0, w1, b1, w2, b2, cf, n_alpha, fsal, kbuf, y1, \
                       f1, err, dmid, st)
  switch (D) {
    case 32: TDT_LAUNCH_FUSED(32);
    case 64: TDT_LAUNCH_FUSED(64);
    case 128: TDT_LAUNCH_FUSED(128);
    case 256: TDT_LAUNCH_FUSED(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TDT_LAUNCH_FUSED
}

template <typename T, int D>
void plan_of(int* out) {
  using P = Plan<T, D>;
  const int v[] = {P::kRows1, P::kRows2, P::kStages, kBlock<T>,
                   kTensorCores<T> ? kCluster : 1, (int)P::kSmem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

}  // namespace

// The launch plan the kernel was built with, for the host's mirror
// (ops/fused_field.py `fused_plan`): out[6] = W1 tile rows, W2 tile rows,
// ring slots, threads a block, cluster size, shared bytes.  Returns 0, or
// cudaErrorInvalidValue for a (dtype, D) with no instance.
extern "C" int tdt_fused_plan(int dtype, int D, int* out) {
#define TDT_PLAN(TT, DD) \
  if (D == DD) return plan_of<TT, DD>(out), 0
  if (dtype == 0) {
    TDT_PLAN(float, 32); TDT_PLAN(float, 64); TDT_PLAN(float, 128); TDT_PLAN(float, 256);
  } else if (dtype == 1) {
    TDT_PLAN(__nv_bfloat16, 32); TDT_PLAN(__nv_bfloat16, 64);
    TDT_PLAN(__nv_bfloat16, 128); TDT_PLAN(__nv_bfloat16, 256);
  }
#undef TDT_PLAN
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16.  y0, f0, y1, f1 are (B, D) in the state
// dtype; w1 (D, H), b1 (H), w2 (H, D), b2 (D) too, w1 and w2 16-byte
// aligned.  coefs (9 x 7 float32) and masks (9 int32) are HOST arrays in
// the layout of ops/fused_field.py `_packed_coefs`, copied into the
// launch's arguments.  kbuf is float32 scratch of (n_alpha, B, D); err and
// dmid are (B, D) float32.  D is one of 32, 64, 128 and 256, H a multiple
// of 128, 1 <= n_alpha <= 6.  Returns a CUDA error code (0 when the launch
// was accepted).
extern "C" int tdt_fused_step(int dtype, int B, int D, int H, const void* y0,
                              const void* f0, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* coefs,
                              const void* masks, int n_alpha, int fsal,
                              void* kbuf, void* y1, void* f1, void* err,
                              void* dmid, void* stream) {
  if (n_alpha < 1 || n_alpha > kMaxStages - 1 || H <= 0 || H % kChunk != 0 || B <= 0 ||
      (reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Coefs cf;
  const float* c = static_cast<const float*>(coefs);
  const int* m = static_cast<const int*>(masks);
  for (int r = 0; r < kCoefRows; ++r) {
    for (int q = 0; q < kMaxStages; ++q) cf.c[r][q] = c[r * kMaxStages + q];
    cf.mask[r] = m[r];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(B, D, H, y0, f0, w1, b1, w2, b2, cf, n_alpha, fsal, kbuf, y1,
                           f1, err, dmid, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(B, D, H, y0, f0, w1, b1, w2, b2, cf, n_alpha, fsal,
                                   kbuf, y1, f1, err, dmid, st);
  return (int)cudaErrorInvalidValue;
}
