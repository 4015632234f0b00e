// K-fused: one explicit adaptive Runge-Kutta step of the tanh MLP field
// f(y) = tanh(y @ W1 + b1) @ W2 + b2, every stage in one kernel.
//
// Replaces the TPU kernel benchmarks/fused_field.py:69 (`fused_stage_step`,
// pallas_call at :202), which keeps a batch tile's state, f32 slopes and
// field activations in VMEM and the whole MLP resident per tile.  At the
// bench's width (D=256, H=1024) W1 and W2 take 2 MB in float32, far above
// the 227 KB of shared memory a Hopper block has, so the design differs:
//
// - a block owns a tile of kRows=32 rows of the batch and runs every stage
//   of the step for it;
// - the stage input (kRows x D, float32 copies of the state-dtype values)
//   sits in shared memory; the hidden layer is computed kChunk=128 units at
//   a time (tanh(y @ W1[:, chunk] + b1), rounded to the state dtype) and
//   folded straight into the (kRows x D) float32 output sums, held in
//   registers, so the (kRows x H) hidden layer is never stored whole;
// - W1 and W2 are read from device memory (through L2, where all blocks
//   find them) in tiles of kDepth=32 rows staged in shared memory;
// - the float32 slopes k_1..k_n go to a global scratch that the wrapper
//   allocates; each thread reads back only the elements it wrote.
//
// Arithmetic follows the JAX kernel (fused_field.py:119-184) and its plain
// version `fused_stage_step_ref` (ops/fused_field.py): a stage input is
// y0 + sum((c*dt32)*k) in float32, the coefficients c*dt32 rounded in
// float32 on the host, zero coefficients skipped, then rounded to the state
// dtype; each product accumulates in float32; tanh and the bias adds are
// float32.  Only the summation order of the two products and tanhf's last
// ULP differ from the plain version.  The build's --fmad=false keeps each
// stage sum's multiply and add rounded apart, as in JAX; the products' inner
// loops call __fmaf_rn, which the flag does not touch.  bfloat16 values are
// read and written with __bfloat162float and __float2bfloat16 (round to
// nearest even).
//
// What bounds it on an H100: operations.  A dopri5 step at B=4096, D=256,
// H=1024 does 6 field evaluations of two products of 2*B*D*H operations:
// 25.8 GFLOP, against about 26 MB of inputs and outputs.  That is about
// 0.385 ms at the 67 TFLOP/s of float32 outside the tensor cores, and
// about 0.026 ms at the 989 TFLOP/s of the bf16 tensor cores, which this
// simple version does not use: it runs both dtypes as float32 FMAs on the
// SIMT cores, loads each weight tile without overlapping the next, and
// reads all of W1 and W2 from L2 once per stage per block.  Tensor-core
// products (mma or wgmma), TMA loads into a ring of tiles and a persistent
// schedule are the later work that would move it towards the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;        // batch rows per block
constexpr int kChunk = 128;      // hidden units per chunk
constexpr int kDepth = 32;       // rows of a staged weight tile
constexpr int kThreads = 256;    // 8 row groups of 4 rows, x 32 column lanes
constexpr int kMaxStages = 7;    // slopes k_0..k_6 (dopri5, tsit5, ...)
constexpr int kCoefRows = kMaxStages + 2;   // beta rows 0..5, c_sol, c_err, c_mid
constexpr int kSolRow = kMaxStages - 1, kErrRow = kMaxStages, kMidRow = kMaxStages + 1;

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

// sum over the nonzero coefficients of row `row` among k_0..k_{nk-1} of
// (c*dt32)*k, in order: the first term, then total + term (fused_field.py
// `_comb`); 0 when every coefficient is zero.  k_0 is f0; k_q (q >= 1) is
// the scratch slab q-1.
template <typename T>
__device__ __forceinline__ float comb(const Coefs& cf, int row, int nk,
                                      const T* __restrict__ f0,
                                      const float* __restrict__ kbuf,
                                      size_t BD, size_t idx) {
  float total = 0.0f;
  bool any = false;
#pragma unroll
  for (int q = 0; q < kMaxStages; ++q) {
    if (q < nk && ((cf.mask[row] >> q) & 1)) {
      const float kv = q == 0 ? to_f32(f0[idx]) : kbuf[(size_t)(q - 1) * BD + idx];
      const float term = cf.c[row][q] * kv;
      total = any ? total + term : term;
      any = true;
    }
  }
  return total;
}

// One block of kThreads a multiprocessor is the plan (B=4096 gives 128
// blocks for 132 SMs), so a thread may take up to 255 registers: the
// (4 x NJ) output sums, the (4 x 4) hidden pre-activations and the operands
// of the inner loops then stay out of local memory.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 1)
fused_step_kernel(const T* __restrict__ y0, const T* __restrict__ f0,
                  const T* __restrict__ w1, const T* __restrict__ b1,
                  const T* __restrict__ w2, const T* __restrict__ b2, int B,
                  int H, Coefs cf, int n_alpha, int fsal,
                  float* __restrict__ kbuf, T* __restrict__ y1_out,
                  T* __restrict__ f1_out, float* __restrict__ err_out,
                  float* __restrict__ dmid_out) {
  constexpr int D = 32 * NJ;
  extern __shared__ __align__(16) float smem[];
  float* s_y = smem;                    // kRows x D: the stage input
  float* s_h = s_y + kRows * D;         // kRows x kChunk: a hidden chunk
  float* s_w = s_h + kRows * kChunk;    // kDepth x max(kChunk, D): a weight tile

  // this thread's elements: rows 4*ty + i of the tile, columns tx + 32*j
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const size_t BD = (size_t)B * D;
  const int n_eval = n_alpha + (fsal ? 0 : 1);

  for (int s = 0; s < n_eval; ++s) {
    // 1. the stage input: beta row s over k_0..k_s, or (the extra field
    //    evaluation of a non-FSAL tableau) y1 from c_sol over k_0..k_n
    const int crow = s < n_alpha ? s : kSolRow;
    const int nk = s < n_alpha ? s + 1 : n_alpha + 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, g = row0 + r;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 32 * j;
        float v = 0.0f;
        if (g < B) {
          const size_t idx = (size_t)g * D + c;
          v = round_to<T>(to_f32(y0[idx]) + comb<T>(cf, crow, nk, f0, kbuf, BD, idx));
        }
        s_y[r * D + c] = v;
      }
    }

    // 2. the field, one hidden chunk at a time
    float acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

    for (int h0 = 0; h0 < H; h0 += kChunk) {
      float pre[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pre[i][j] = 0.0f;
      for (int k0 = 0; k0 < D; k0 += kDepth) {
        __syncthreads();   // s_y written; the last tile of s_w consumed
        for (int e = threadIdx.x; e < kDepth * kChunk; e += kThreads) {
          const int kk = e / kChunk, cc = e % kChunk;
          s_w[kk * kChunk + cc] = to_f32(w1[(size_t)(k0 + kk) * H + h0 + cc]);
        }
        __syncthreads();
#pragma unroll 2
        for (int kk = 0; kk < kDepth; kk += 4) {
          float a[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(&s_y[(4 * ty + i) * D + k0 + kk]);
            a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float w = s_w[(kk + q) * kChunk + tx + 32 * j];
#pragma unroll
              for (int i = 0; i < 4; ++i) pre[i][j] = __fmaf_rn(a[i][q], w, pre[i][j]);
            }
          }
        }
      }
      __syncthreads();   // every thread is done with s_h and s_w
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tx + 32 * j;
        const float bias = to_f32(b1[h0 + cc]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s_h[(4 * ty + i) * kChunk + cc] = round_to<T>(tanhf(pre[i][j] + bias));
      }
      for (int k0 = 0; k0 < kChunk; k0 += kDepth) {
        __syncthreads();   // s_h written; the last tile of s_w consumed
        for (int e = threadIdx.x; e < kDepth * D; e += kThreads) {
          const int kk = e / D, c = e % D;
          s_w[kk * D + c] = to_f32(w2[(size_t)(h0 + k0 + kk) * D + c]);
        }
        __syncthreads();
#pragma unroll 2
        for (int kk = 0; kk < kDepth; kk += 4) {
          float hv[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(&s_h[(4 * ty + i) * kChunk + k0 + kk]);
            hv[i][0] = v.x; hv[i][1] = v.y; hv[i][2] = v.z; hv[i][3] = v.w;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const float w = s_w[(kk + q) * D + tx + 32 * j];
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[i][j] = __fmaf_rn(hv[i][q], w, acc[i][j]);
            }
          }
        }
      }
    }

    // 3. the slope k_{s+1} (or f1 of a non-FSAL tableau), in the state
    //    dtype; kept as float32, which holds it exactly
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = row0 + 4 * ty + i;
      if (g >= B) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 32 * j;
        const size_t idx = (size_t)g * D + c;
        const float kv = round_to<T>(acc[i][j] + to_f32(b2[c]));
        if (s < n_alpha) kbuf[(size_t)s * BD + idx] = kv;
        if (s == n_eval - 1) f1_out[idx] = from_f32<T>(kv);
      }
    }
  }

  // 4. y1, the embedded error and the dense-output midpoint increment
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = row0 + 4 * ty + i;
    if (g >= B) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const size_t idx = (size_t)g * D + tx + 32 * j;
      const int nk_sol = fsal ? n_alpha : n_alpha + 1;
      y1_out[idx] = from_f32<T>(to_f32(y0[idx]) +
                                comb<T>(cf, kSolRow, nk_sol, f0, kbuf, BD, idx));
      err_out[idx] = comb<T>(cf, kErrRow, n_alpha + 1, f0, kbuf, BD, idx);
      dmid_out[idx] = comb<T>(cf, kMidRow, n_alpha + 1, f0, kbuf, BD, idx);
    }
  }
}

template <typename T, int NJ>
int launch(int B, int H, const void* y0, const void* f0, const void* w1,
           const void* b1, const void* w2, const void* b2, const Coefs& cf,
           int n_alpha, int fsal, void* kbuf, void* y1, void* f1, void* err,
           void* dmid, cudaStream_t st) {
  constexpr int D = 32 * NJ;
  constexpr int kWide = D > kChunk ? D : kChunk;
  const size_t smem = (size_t)(kRows * D + kRows * kChunk + kDepth * kWide) * sizeof(float);
  auto kernel = fused_step_kernel<T, NJ>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, smem, st>>>(
      static_cast<const T*>(y0), static_cast<const T*>(f0), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<const T*>(b2), B, H,
      cf, n_alpha, fsal, static_cast<float*>(kbuf), static_cast<T*>(y1), static_cast<T*>(f1),
      static_cast<float*>(err), static_cast<float*>(dmid));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int B, int D, int H, const void* y0, const void* f0, const void* w1,
             const void* b1, const void* w2, const void* b2, const Coefs& cf,
             int n_alpha, int fsal, void* kbuf, void* y1, void* f1, void* err,
             void* dmid, cudaStream_t st) {
#define TDT_LAUNCH_FUSED(NJ)                                                     \
  return launch<T, NJ>(B, H, y0, f0, w1, b1, w2, b2, cf, n_alpha, fsal, kbuf, y1, \
                       f1, err, dmid, st)
  switch (D) {
    case 32: TDT_LAUNCH_FUSED(1);
    case 64: TDT_LAUNCH_FUSED(2);
    case 128: TDT_LAUNCH_FUSED(4);
    case 256: TDT_LAUNCH_FUSED(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TDT_LAUNCH_FUSED
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  y0, f0, y1, f1 are (B, D) in the state
// dtype; w1 (D, H), b1 (H), w2 (H, D), b2 (D) too.  coefs (9 x 7 float32)
// and masks (9 int32) are HOST arrays in the layout of ops/fused_field.py
// `_packed_coefs`, copied into the launch's arguments.  kbuf is float32
// scratch of (n_alpha, B, D); err and dmid are (B, D) float32.  D is a
// one of 32, 64, 128 and 256, H a multiple of 128, 1 <= n_alpha <= 6.
// Returns a CUDA error code (0 when the launch was accepted).
extern "C" int tdt_fused_step(int dtype, int B, int D, int H, const void* y0,
                              const void* f0, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* coefs,
                              const void* masks, int n_alpha, int fsal,
                              void* kbuf, void* y1, void* f1, void* err,
                              void* dmid, void* stream) {
  if (n_alpha < 1 || n_alpha > kMaxStages - 1 || H <= 0 || H % kChunk != 0 || B <= 0)
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
