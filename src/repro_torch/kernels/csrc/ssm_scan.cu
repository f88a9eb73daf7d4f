// Mamba2 (SSD) chunked scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssm_scan.py:84 (ssm_scan, the Pallas body
// _ssd_kernel).  Same function, same contract:
//
//   x (B, S, nh, P), dt (B, S, nh), a (nh,), bm and cm (B, S, N), n_groups 1
//   y (B, S, nh, P) in x's dtype: the state-space mixing only (gating, the
//   D skip and the normalisation stay in the caller)
//   per chunk of L steps and head h, in float32 (the four products at
//   float32 accuracy through 3xTF32, below):
//     cum_t = sum_{s<=t} dt_s a        (inclusive, within the chunk)
//     y_t   = sum_{s<=t} (c_t . b_s) exp(cum_t - cum_s) dt_s x_s
//             + exp(cum_t) c_t . state
//     state <- state exp(cum_{L-1}) + sum_s b_s (x) x_s dt_s exp(cum_{L-1} - cum_s)
//   with the (N, P) float32 state of each head carried from chunk to chunk
//   and zero at the start.
//
// Chunking is exact in arithmetic, so the kernel takes its own chunk,
// kL = 64, whatever chunk the caller names (the wrapper keeps the
// reference's chunk and head_block arguments for its signature only).  A
// sequence that kL does not divide ends in a ragged chunk whose missing
// steps are zero (dt = 0 there, so cum and the state are unchanged by
// them); nothing past S is stored.  For s > t, cum_t - cum_s is positive
// and exp may overflow: the weight is selected to 0 there, never
// multiplied by a 0/1 mask (inf * 0 = NaN).  The cumulative sum is a warp
// scan in a fixed order: lane l adds steps 2l and 2l + 1, then a
// Hillis-Steele scan over the lanes.  No sum uses atomics and every sum
// runs in a fixed order, so y is bitwise the same from call to call.
//
// Types: x, bm, cm float32 or bfloat16 (one type); dt float32 or x's type;
// a float32.  Each is converted to float32 as it is read; y is rounded to
// x's type once, when it is stored.
//
// 3xTF32 (tf32.cuh).  Every product operand v is split into two TF32
// values, v_hi = rna(v) and v_lo = rna(v - v_hi), where rna rounds to 10
// mantissa bits, ties away from zero: the bits of cvt.rna.tf32.f32,
// computed on the integer units ((bits + 0x1000) & ~0x1fff), which issue at
// full rate where the conversion does not.  Each product a b then runs as
// three mma.sync.m16n8k8 TF32 products with float32 sums, a_lo b_hi +
// a_hi b_lo into one accumulator and a_hi b_hi into another; a_lo b_lo
// (~2^-22 relative) is dropped.  No product runs as plain TF32 (one mma, ~2^-11
// relative).  The weights stay on the float32 units: dt, the cumsum, the
// causal select, and the exponentials (exp2 on the special-function unit
// of (cum_t - cum_s) log2(e) inside W, relative error ~2^-21 for the
// exponents that matter; expf for u, exp(cum) and the decay).
//
// Design: two kernels a call, on the caller's stream.
//  1. ssd_gram_kernel, one block a (chunk, batch): the chunk's record,
//     G = C B^T (kL x kL, the causal lower triangle, zero above it) once
//     for every head, as n_groups = 1 makes it, with C and B in float32,
//     each zero-padded to kL x kD and to the row strides the scan's
//     fragment reads need (68, 68, 72 floats: 53,248 bytes), into a
//     scratch the wrapper allocates (6.8 MB at Zamba2-7B's prefill).
//  2. ssd_scan_kernel, one block of 8 warps a (head, batch): 448 blocks at
//     Zamba2-7B's prefill (B 4, nh 112), one resident a SM (219,152 bytes
//     of shared memory), so 3.39 rounds of the 132 SMs.  A block walks its
//     head's chunks in order.  Warp w owns a 16-row band (bands i and
//     3 - i share a scheduler, so the causal W X is even across the
//     schedulers) and 32 columns of P, both for y (rows t) and for the
//     state (rows n), which it keeps in registers as mma C fragments.
//     Loads go through the copy engine (cp.async.bulk, completing on an
//     mbarrier per buffer), a whole chunk ahead into double buffers: one
//     thread copies the chunk's record whole, 64 threads a row of X each
//     (zero-filled past S); bf16 X stays bf16 in shared memory.  X whose
//     rows are not 16-byte multiples or not 16-byte aligned takes
//     synchronous loads spread over the previous chunk's k-steps.  Warp 0
//     scans the next chunk's dt a (loaded a chunk ahead) while the others
//     compute; one barrier a chunk.  Then one pass over the chunk's 8
//     k-steps of 8 keys runs, for the warp's rows and columns,
//       C . state, from the state's hi and lo planes (split when stored);
//       W X, while the k-step is in the band's causal range, W built in
//       the A fragments from G, exp2 and dt, never stored;
//       (u B)^T X for the next state, u folded into the A fragments;
//     each k-step's X fragment split once for both products.  y =
//     exp(cum_t) (C state) + W X is stored from the fragments.  Fragment
//     reads are conflict-free: row strides of 68 floats for the A operands
//     read (row, k) and of 72 for the B operands read (k, column).
//
// Bound, at one Zamba2-7B layer's prefill (B 4, S 2048, nh 112, P 64,
// N 64; x, bm and cm in float32 as ssm_forward passes them): the least
// operations the function needs are those of the chunked form at L = 8 (G
// once per chunk and batch, the causal W X, C state, the state update and
// its decay), 1.60e10 FLOP; the kernels execute 1.98e10 (kL = 64, W X
// over whole 16-row bands).  On the float32 units that is 0.238 ms at 67
// TFLOP/s; as three TF32 products each it is 0.097 ms at 495 TFLOP/s.
// The 478 MB read and written take 0.143 ms at 3.35 TB/s.  Under the
// 3xTF32 contract the bound is bytes, 0.143 ms.
//
// What the design leaves on the table: mma.sync, not wgmma, runs the
// products; 448 chains of 32 chunks fill 3.39 rounds of the SMs, so the
// last round is 61 % empty; the operand splits cost integer work on every
// k-step (only the state is stored split); the two warps of a band both
// build its W; the record moves 53 KB a chunk through L2 for every head of
// a batch.
//
// Plain C interface, bound with ctypes (see repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32.cuh"   // rna_tf32, split, split4, mma_tf32

namespace {

constexpr int kL = 64;           // the kernel's chunk
constexpr int kD = 64;           // the widest N and P; tiles zero-padded to it
constexpr int kThreads = 256;    // 8 warps: a 16-row band x 32 columns each
constexpr int kLdG = kL + 4;     // row stride of G and of C (floats)
constexpr int kLdB = kD + 8;     // row stride of B, X and the state

// A chunk's record, written by ssd_gram_kernel and copied whole into a
// scan block's shared memory: G (t, s), C (t, n) and B (s, n) in float32,
// zero-padded to kL x kD and to the row strides below (floats).
constexpr int kRecG = 0;
constexpr int kRecC = kRecG + kL * kLdG;
constexpr int kRecB = kRecC + kL * kLdG;
constexpr int kRec = kRecB + kL * kLdB;
constexpr int kTileX = kL * kLdB;               // X (s, p) or the state (n, p)

// shared memory of a scan block, in floats: the record, X and the state
// (split into TF32 hi and lo planes as it is stored) twice each, for chunks
// of even and odd index
constexpr int kOffR = 0;
constexpr int kOffX = kOffR + 2 * kRec;
constexpr int kOffS = kOffX + 2 * kTileX;       // the state's TF32 hi plane
constexpr int kOffSl = kOffS + 2 * kTileX;      // and its lo plane
constexpr int kOffV = kOffSl + 2 * kTileX;      // cum, dt, u, exp(cum)
constexpr int kOffBar = kOffV + 2 * 4 * kL;     // 2 mbarriers (8 bytes each)
constexpr int kSmemFloats = kOffBar + 4;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
constexpr int kXThreads = kL;                   // threads that copy X's rows

constexpr int kGramThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// arrive on bar, first adding `bytes` to the transfer it waits for
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait for the completion of bar's phase of the given parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the copy engine, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// A quarter (part 0..3) of X's kL x kD tile by synchronous loads into
// shared memory with row stride ld (elements): element (r, k) from
// src[r * stride + k] for r < rows and k < valid, zero elsewhere; four
// elements a thread.
template <typename T>
__device__ __forceinline__ void load_x_part(T* dst, int ld, const T* src,
                                            long long stride, int rows,
                                            int valid, int tid, int part) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = tid + (4 * part + e) * kThreads;
    const int r = i >> 6;
    const int k = i & (kD - 1);
    dst[r * ld + k] =
        r < rows && k < valid ? src[r * stride + k] : from_f32<T>(0.0f);
  }
}

// One k-step (8) of a warp's 16 x 32 product in 3xTF32: A's fragment
// given as hi/lo, B's as hi and lo planes of one layout (row stride ld),
// read at rows k0 + t4 and k0 + t4 + 4, columns col + 8j (j < 4).
// big += a_hi b_hi; small += a_lo b_hi + a_hi b_lo (a_lo b_lo, ~2^-22
// relative, is dropped).
__device__ __forceinline__ void mma3_pre(float (&big)[4][4],
                                         float (&small)[4][4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const float* bh, const float* bl,
                                         int ld) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t bh0 = __float_as_uint(bh[8 * j]);
    const uint32_t bh1 = __float_as_uint(bh[4 * ld + 8 * j]);
    const uint32_t bl0 = __float_as_uint(bl[8 * j]);
    const uint32_t bl1 = __float_as_uint(bl[4 * ld + 8 * j]);
    mma_tf32(small[j], al, bh0, bh1);
    mma_tf32(small[j], ah, bl0, bl1);
    mma_tf32(big[j], ah, bh0, bh1);
  }
}

// The record of every (chunk, batch): G = C B^T (rows t, columns s, n
// summed in order; zero above the diagonal), C and B, each zero past the
// sequence, past N and in the row padding.
template <typename T>
__global__ void __launch_bounds__(kGramThreads)
ssd_gram_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
                float* __restrict__ rec, int S, int N) {
  __shared__ float4 raw4[2 * kD * (kL + 4) / 4];
  float* ct = reinterpret_cast<float*>(raw4);   // [kD][kL + 4]  C^T (n, t)
  float* bt = ct + kD * (kL + 4);               // [kD][kL + 4]  B^T (n, s)
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int nc = gridDim.x;
  const int lo = c * kL;
  const int len = S - lo < kL ? S - lo : kL;
  const int tid = threadIdx.x;
  float* out = rec + (static_cast<long long>(b) * nc + c) * kRec;
  for (int i = tid; i < kL * kD; i += kGramThreads) {
    const int t = i / kD;
    const int n = i % kD;
    float bv = 0.0f, cv = 0.0f;
    if (t < len && n < N) {
      const long long off = (static_cast<long long>(b) * S + lo + t) * N + n;
      bv = to_f32(bm[off]);
      cv = to_f32(cm[off]);
    }
    ct[n * (kL + 4) + t] = cv;
    bt[n * (kL + 4) + t] = bv;
    out[kRecC + t * kLdG + n] = cv;
    out[kRecB + t * kLdB + n] = bv;
  }
  for (int i = tid; i < kL * 8; i += kGramThreads) {   // the row padding
    const int t = i >> 3;
    const int k = i & 7;
    if (k < 4) {
      out[kRecG + t * kLdG + kL + k] = 0.0f;
      out[kRecC + t * kLdG + kD + k] = 0.0f;
    }
    out[kRecB + t * kLdB + kD + k] = 0.0f;
  }
  __syncthreads();
  const int r0 = (tid >> 4) * 4;
  const int c0 = (tid & 15) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  if (c0 <= r0 + 3) {
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float4 cv = lds4(ct + n * (kL + 4) + r0);
      const float4 bv = lds4(bt + n * (kL + 4) + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(comp(cv, i), comp(bv, j), acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = r0 + i;
    *reinterpret_cast<float4*>(out + kRecG + t * kLdG + c0) = make_float4(
        c0 <= t ? acc[i][0] : 0.0f, c0 + 1 <= t ? acc[i][1] : 0.0f,
        c0 + 2 <= t ? acc[i][2] : 0.0f, c0 + 3 <= t ? acc[i][3] : 0.0f);
  }
}

template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ rec,
                T* __restrict__ y, int S, int NH, int P, int vec) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nc = (S + kL - 1) / kL;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;          // fragment row (and B column) group
  const int t4 = lane & 3;           // fragment k (and C column pair)
  // warp w: the 16-row band of y and of the state, and a 32-column half of
  // P; warps w and w + 4 share a scheduler and take bands i and 3 - i, so
  // the causal W X is even across the schedulers
  const int band = warp < 4 ? warp : 7 - warp;
  const int pc = 32 * (warp >> 2);
  const int r0 = 16 * band + gq;     // fragment rows r0 and r0 + 8
  const int wx_steps = 2 * (band + 1);   // k-steps of 8 keys the band sees
  const bool vin = vec != 0;
  const float ah = a[h];
  const long long xrow = static_cast<long long>(NH) * P;
  const T* xb = x + static_cast<long long>(b) * S * xrow +
                static_cast<long long>(h) * P;
  const float* rb = rec + static_cast<long long>(b) * nc * kRec;
  T* yb = y + static_cast<long long>(b) * S * xrow +
          static_cast<long long>(h) * P;

  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + kOffBar);
  // X's tile holds x's own type: row stride kLdX elements (kLdB floats)
  constexpr int kLdX = kLdB * static_cast<int>(sizeof(float) / sizeof(T));
  // Chunk c's loads into buffer buf, by the copy engine: thread 0 copies
  // the chunk's record (G, C, B) whole; with vec, threads 0..kL-1 each copy
  // a row of X (P elements), or zero-fill it past S.  Each of them arrives
  // on the buffer's barrier, adding the bytes it asked for.
  auto issue = [&](int c, int buf) {
    if (tid >= kXThreads) return;
    const int lo = c * kL;
    uint64_t* bar = &bars[buf];
    uint32_t bytes = 0;
    float* xrow_dst = sm + kOffX + buf * kTileX + tid * kLdB;
    const bool copy_x = vin && lo + tid < S;
    if (vin && !copy_x) {
#pragma unroll
      for (int k = 0; k < kD; k += 4) {
        *reinterpret_cast<float4*>(xrow_dst + k) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if (copy_x) bytes += sizeof(T) * P;
    if (tid == 0) bytes += sizeof(float) * kRec;
    mbar_arrive_tx(bar, bytes);
    if (tid == 0) {
      bulk_load(sm + kOffR + buf * kRec,
                rb + static_cast<long long>(c) * kRec, sizeof(float) * kRec,
                bar);
    }
    if (copy_x) {
      bulk_load(xrow_dst, xb + (lo + tid) * xrow, sizeof(T) * P, bar);
    }
  };
  // !vec: part q (0..3) of chunk c's X by synchronous loads into buffer buf
  auto load_x = [&](int c, int buf, int q) {
    const int lo = c * kL;
    load_x_part<T>(reinterpret_cast<T*>(sm + kOffX + buf * kTileX), kLdX,
                   xb + lo * xrow, xrow, S - lo, P, tid, q);
  };
  // warp 0: the inclusive cumsum of dt a over a chunk (lane l holds steps
  // 2l and 2l + 1 in d0, d1), then cum, dt, u = dt exp(cum_end - cum) and
  // exp(cum) into v
  auto scan_dt = [&](float* v, float d0, float d1) {
    const int s0 = 2 * lane;
    const float v0 = d0 * ah;
    const float pair = v0 + d1 * ah;
    float incl = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    const float cum0 = excl + v0;
    const float cum_end = __shfl_sync(0xffffffffu, incl, 31);
    v[s0] = cum0;
    v[s0 + 1] = incl;
    v[kL + s0] = d0;
    v[kL + s0 + 1] = d1;
    v[2 * kL + s0] = d0 * expf(cum_end - cum0);
    v[2 * kL + s0 + 1] = d1 * expf(cum_end - incl);
    v[3 * kL + s0] = expf(cum0);
    v[3 * kL + s0 + 1] = expf(incl);
  };
  auto load_dt = [&](int c, float& d0, float& d1) {   // warp 0: 2 steps a lane
    const int lo = c * kL;
    const int s0 = 2 * lane;
    const long long row = static_cast<long long>(b) * S + lo + s0;
    d0 = lo + s0 < S ? to_f32(dt[row * NH + h]) : 0.0f;
    d1 = lo + s0 + 1 < S ? to_f32(dt[(row + 1) * NH + h]) : 0.0f;
  };

  // zero X's and the state's buffers once: X's columns past P are never
  // written again, and chunk 0's state is zero
  for (int i = kOffX + tid; i < kOffV; i += kThreads) sm[i] = 0.0f;
  if (tid == 0) {
    mbar_init(&bars[0], kXThreads);
    mbar_init(&bars[1], kXThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the zeros are ordered before the copy engine's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float st[4][4];   // the state: rows r0 (0, 1) and r0 + 8 (2, 3), columns
                    // pc + 8j + 2t4 (+1), as an mma's C fragment
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) st[j][i] = 0.0f;
  }
  issue(0, 0);
  if (!vin) {
#pragma unroll 1
    for (int q = 0; q < 4; ++q) load_x(0, 0, q);
  }
  float d0 = 0.0f, d1 = 0.0f;   // warp 0: dt of the next chunk to scan
  if (warp == 0) {
    load_dt(0, d0, d1);
    scan_dt(sm + kOffV, d0, d1);
    if (nc > 1) load_dt(1, d0, d1);
  }

#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    const int lo = c * kL;
    const int len = S - lo < kL ? S - lo : kL;
    const int buf = c & 1;
    const bool next = c + 1 < nc;
    const float* gs = sm + kOffR + buf * kRec + kRecG;
    const float* cs = sm + kOffR + buf * kRec + kRecC;
    const float* bc = sm + kOffR + buf * kRec + kRecB;
    const float* xc = sm + kOffX + buf * kTileX;
    const float* ss = sm + kOffS + buf * kTileX;        // read: chunk c's state
    float* ss_next = sm + kOffS + (buf ^ 1) * kTileX;   // written: chunk c + 1's
    const float* cum = sm + kOffV + buf * 4 * kL;
    const float* dts = cum + kL;
    const float* us = dts + kL;
    const float* ecum = us + kL;

    mbar_wait(&bars[buf], (c >> 1) & 1);
    // the one barrier of a chunk: chunk c's tiles landed, its cum written,
    // its state stored; every read of the other buffers (chunk c - 1) done
    __syncthreads();
    if (next) issue(c + 1, buf ^ 1);
    if (warp == 0 && next) {   // chunk c + 1's cum, off the barrier's path
      scan_dt(sm + kOffV + (buf ^ 1) * 4 * kL, d0, d1);
      if (c + 2 < nc) load_dt(c + 2, d0, d1);
    }
    const float decay = expf(cum[kL - 1]);

    // One pass over the chunk's 8 k-steps of 8 computes, for rows r0 and
    // r0 + 8 and this warp's 32 columns,
    //   y = W X + exp(cum_t) C state, W = G exp(cum_t - cum_s) dt_s (s <= t,
    //   selected 0 above) built in the A fragments and never stored;
    //   state' = state exp(cum_end) + (u B)^T X (rows n = r0, r0 + 8; u B's
    //   rows past the chunk's end are zero), u folded into the A fragments;
    // each k-step's X fragment is split once for both products.  Without
    // the copy engine, chunk c + 1's X loads go a part every other k-step.
    float wb[4][4], ws[4][4], cb4[4][4], cs4[4][4];
    float sb[4][4], sl[4][4], sh[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wb[j][i] = 0.0f;
        ws[j][i] = 0.0f;
        cb4[j][i] = 0.0f;
        cs4[j][i] = 0.0f;
        sb[j][i] = st[j][i] * decay;
        sl[j][i] = 0.0f;
        sh[j][i] = 0.0f;
      }
    }
    {
      const float cr0 = cum[r0];
      const float cr1 = cum[r0 + 8];
      const float* grow = gs + r0 * kLdG + t4;
      const float* crow = cs + r0 * kLdG + t4;
      const float* bcol = bc + t4 * kLdB + r0;
      const T* xcol = reinterpret_cast<const T*>(xc) + t4 * kLdX + pc + gq;
      const float* scol = ss + t4 * kLdB + pc + gq;   // hi; lo kOffSl - kOffS on
#pragma unroll
      for (int ks = 0; ks < kL / 8; ++ks) {
        const int k0 = 8 * ks;
        if (next && !vin && (ks & 1)) load_x(c + 1, buf ^ 1, ks >> 1);
        {
          float cv[4] = {crow[k0], crow[8 * kLdG + k0], crow[k0 + 4],
                         crow[8 * kLdG + k0 + 4]};
          uint32_t ahi[4], alo[4];
          split4(cv, ahi, alo);
          mma3_pre(cb4, cs4, ahi, alo, scol + k0 * kLdB,
                   scol + (kOffSl - kOffS) + k0 * kLdB, kLdB);
        }
        uint32_t xh[4][2], xl[4][2];   // X rows k0 + t4 (+4), columns + 8j
        {
          const T* xk = xcol + k0 * kLdX;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            split(to_f32(xk[8 * j]), xh[j][0], xl[j][0]);
            split(to_f32(xk[4 * kLdX + 8 * j]), xh[j][1], xl[j][1]);
          }
        }
        if (ks < wx_steps) {
          const int s0 = k0 + t4;
          const int s1 = s0 + 4;
          const float e00 = ex2(kLog2e * (cr0 - cum[s0]));
          const float e10 = ex2(kLog2e * (cr1 - cum[s0]));
          const float e01 = ex2(kLog2e * (cr0 - cum[s1]));
          const float e11 = ex2(kLog2e * (cr1 - cum[s1]));
          float wv[4];
          wv[0] = s0 <= r0 ? grow[k0] * e00 * dts[s0] : 0.0f;
          wv[1] = s0 <= r0 + 8 ? grow[8 * kLdG + k0] * e10 * dts[s0] : 0.0f;
          wv[2] = s1 <= r0 ? grow[k0 + 4] * e01 * dts[s1] : 0.0f;
          wv[3] = s1 <= r0 + 8 ? grow[8 * kLdG + k0 + 4] * e11 * dts[s1]
                               : 0.0f;
          uint32_t ahi[4], alo[4];
          split4(wv, ahi, alo);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma_tf32(ws[j], alo, xh[j][0], xh[j][1]);
            mma_tf32(ws[j], ahi, xl[j][0], xl[j][1]);
            mma_tf32(wb[j], ahi, xh[j][0], xh[j][1]);
          }
        }
        {
          const float u0 = us[k0 + t4];
          const float u1 = us[k0 + t4 + 4];
          const float* bk = bcol + k0 * kLdB;
          float bv[4] = {bk[0] * u0, bk[8] * u0, bk[4 * kLdB] * u1,
                         bk[4 * kLdB + 8] * u1};
          uint32_t ahi[4], alo[4];
          split4(bv, ahi, alo);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma_tf32(sl[j], alo, xh[j][0], xh[j][1]);
            mma_tf32(sh[j], ahi, xl[j][0], xl[j][1]);
            mma_tf32(sb[j], ahi, xh[j][0], xh[j][1]);
          }
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = r0 + 8 * half;
      if (t >= len) continue;
      const float e = ecum[t];
      T* dst = yb + (lo + t) * xrow;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = pc + 8 * j + 2 * t4;
        const int i0 = 2 * half;
        const float o0 = fmaf(e, cb4[j][i0] + cs4[j][i0],
                              wb[j][i0] + ws[j][i0]);
        const float o1 = fmaf(e, cb4[j][i0 + 1] + cs4[j][i0 + 1],
                              wb[j][i0 + 1] + ws[j][i0 + 1]);
        if (p + 1 < P && (P & 1) == 0) {
          if constexpr (std::is_same<T, float>::value) {
            *reinterpret_cast<float2*>(dst + p) = make_float2(o0, o1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst + p) =
                __floats2bfloat162_rn(o0, o1);
          }
        } else {
          if (p < P) dst[p] = from_f32<T>(o0);
          if (p + 1 < P) dst[p + 1] = from_f32<T>(o1);
        }
      }
    }
    // the state for chunk c + 1, stored split into its hi and lo planes
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st[j][i] = sb[j][i] + (sl[j][i] + sh[j][i]);
        split(st[j][i], hi[i], lo[i]);
      }
      const int p = pc + 8 * j + 2 * t4;
      float* sh0 = ss_next + r0 * kLdB + p;
      float* sh1 = ss_next + (r0 + 8) * kLdB + p;
      constexpr int kLo = kOffSl - kOffS;
      *reinterpret_cast<float2*>(sh0) =
          make_float2(__uint_as_float(hi[0]), __uint_as_float(hi[1]));
      *reinterpret_cast<float2*>(sh1) =
          make_float2(__uint_as_float(hi[2]), __uint_as_float(hi[3]));
      *reinterpret_cast<float2*>(sh0 + kLo) =
          make_float2(__uint_as_float(lo[0]), __uint_as_float(lo[1]));
      *reinterpret_cast<float2*>(sh1 + kLo) =
          make_float2(__uint_as_float(lo[2]), __uint_as_float(lo[3]));
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, typename TD>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* g, void* y, int B, int S, int NH, int P,
           int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + kL - 1) / kL;
  ssd_gram_kernel<T><<<dim3(static_cast<unsigned>(nc),
                            static_cast<unsigned>(B)),
                       kGramThreads, 0, st>>>(
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<float*>(g), S, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = ssd_scan_kernel<T, TD>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (P * sizeof(T)) % 16 == 0 && aligned16(x);
  const dim3 grid(static_cast<unsigned>(NH), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const T*>(x), static_cast<const TD*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(g),
      static_cast<T*>(y), S, NH, P, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (x, bm, cm, y) and dt_dtype: 0 = float32, 1 = bfloat16; dt is
// float32 or x's type; a is float32.  Tensors are contiguous: x and y
// (B, S, NH, P), dt (B, S, NH), a (NH,), bm and cm (B, S, N); g a float32
// scratch of B * ceil(S / 64) * 13,312 floats (a record a chunk), 16-byte
// aligned; y 16-byte aligned; P, N <= 64;
// B <= 65535.  Returns the first CUDA error of the launches or the
// attribute call (0 = cudaSuccess).
extern "C" int ssm_scan(int dtype, int dt_dtype, const void* x, const void* dt,
                        const void* a, const void* bm, const void* cm, void* g,
                        void* y, int B, int S, int NH, int P, int N,
                        void* stream) {
  if (P < 1 || P > kD || N < 1 || N > kD || S < 1 || B < 1 || NH < 1 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0 && dt_dtype == 0) {
    return launch<float, float>(x, dt, a, bm, cm, g, y, B, S, NH, P, N,
                                stream);
  }
  if (dtype == 1 && dt_dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, a, bm, cm, g, y, B, S,
                                                NH, P, N, stream);
  }
  if (dtype == 1 && dt_dtype == 0) {
    return launch<__nv_bfloat16, float>(x, dt, a, bm, cm, g, y, B, S, NH, P,
                                        N, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}


// dynamic shared memory of a scan block, in bytes
extern "C" int ssm_scan_smem_bytes() { return static_cast<int>(kSmemBytes); }

// scan blocks resident on one SM for dtype / dt_dtype (as ssm_scan takes
// them), or -(CUDA error)
extern "C" int ssm_scan_blocks_per_sm(int dtype, int dt_dtype) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  auto occ = [&](auto kernel) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, kThreads, kSmemBytes);
    }
  };
  if (dtype == 0 && dt_dtype == 0) occ(ssd_scan_kernel<float, float>);
  if (dtype == 1 && dt_dtype == 1) {
    occ(ssd_scan_kernel<__nv_bfloat16, __nv_bfloat16>);
  }
  if (dtype == 1 && dt_dtype == 0) occ(ssd_scan_kernel<__nv_bfloat16, float>);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
