// Mamba2 (SSD) chunked scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssm_scan.py:84 (ssm_scan, the Pallas body
// _ssd_kernel).  Same function, same contract:
//
//   x (B, S, nh, P), dt (B, S, nh), a (nh,), bm and cm (B, S, N), n_groups 1
//   y (B, S, nh, P) in x's dtype: the state-space mixing only (gating, the
//   D skip and the normalisation stay in the caller)
//   per chunk of L steps and head h, all arithmetic in float32:
//     cum_t = sum_{s<=t} dt_s a        (inclusive, within the chunk)
//     y_t   = sum_{s<=t} (c_t . b_s) exp(cum_t - cum_s) dt_s x_s
//             + exp(cum_t) c_t . state
//     state <- state exp(cum_{L-1}) + sum_s b_s (x) x_s dt_s exp(cum_{L-1} - cum_s)
//   with the (N, P) float32 state of each head carried from chunk to chunk
//   and zero at the start.
//
// Chunking is exact in arithmetic, so the kernel takes its own chunk,
// kL = 64, whatever chunk the caller names (the wrapper keeps the
// reference's argument for its signature).  A sequence that kL does not
// divide ends in a ragged chunk whose missing steps are zero (dt = 0 there,
// so cum and the state are unchanged by them); nothing past S is stored.
// For s > t, cum_t - cum_s is positive and exp may overflow: the weight is
// selected to 0 there, never multiplied by a 0/1 mask (inf * 0 = NaN).
// The cumulative sum is a warp scan in a fixed order: lane l adds steps 2l
// and 2l + 1, then a Hillis-Steele scan over the lanes.
//
// Types: x, bm, cm float32 or bfloat16 (one type); dt float32 or x's type;
// a float32.  Each is converted to float32 as it is read; y is rounded to
// x's type once, when it is stored.
//
// Design.  One block of 256 threads per (head block of HB heads, batch); a
// loop over chunks inside the block takes the place of the TPU's sequential
// chunk grid axis, so the HB states stay in shared memory for the block's
// life.  Per chunk the block stages C^T, B^T and B in shared memory and each
// thread computes its 4x4 tile of G = C B^T into registers once, shared by
// the block's heads, as the TPU kernel shares it across head_block.  Per
// head: X and the chunk's cum, dt, dt exp(cum_end - cum) and exp(cum) go to
// shared memory; W = G . exp(cum_t - cum_s) . dt_s (s <= t) is written
// once; each thread then owns a 4x4 tile of y (rows t, columns p) and of
// the state (rows n, columns p).  Thread (ty, tx) = (tid / 16, tid % 16)
// owns rows 4ty.. and columns 4tx..; a warp's rows are 8w..8w+7, so its
// W X product stops at key 8w+8 (the causal half, warp-uniform).  Every
// shared-memory read of the inner loops is a float4 that at most 16 lanes
// of a warp ask for distinct values of.  Tiles are 64 wide: N and P up to 64
// (the wrapper raises above), zero-padded below.  Shared memory: 86 KB +
// 16 KB a head of the block; the wrapper picks HB (a divisor of nh, at
// most its head_block) so that the grid keeps two blocks on every SM where
// it can: HB = 1 at Zamba2-7B's prefill, 448 blocks of 102 KB, two a SM.
//
// Bound, at one Zamba2-7B layer's prefill (B 4, S 2048, nh 112, P 64,
// N 64; x, bm and cm in float32 as ssm_forward passes them): the least
// operations the function needs are those of the chunked form at L = 8 (G
// once per chunk and batch, the causal W X, C state, the state update and
// its decay), 1.60e10 FLOP, 0.238 ms at the 67 TFLOP/s float32 SIMT peak;
// this kernel, at kL = 64, executes 1.90e10.  The 478 MB read and written
// take 0.143 ms at 3.35 TB/s.  So the bound is operations, on the float32
// units.
//
// What the design leaves on the table: the products could run on tensor
// cores (TF32 or bf16x3 mma, at the cost of the exact float32 contract); G
// is recomputed per head when HB = 1; the loads are synchronous, not
// overlapped with the products; the grid is 1.7 waves of blocks at the
// Zamba2 shape, and chunks of one head run in sequence where a two-pass
// scan (chunk states in parallel, then a short sequential pass) would fill
// the card.
//
// Plain C interface, bound with ctypes (see repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;           // the kernel's chunk
constexpr int kD = 64;           // the widest N and P; tiles zero-padded to it
constexpr int kThreads = 256;    // 16 x 16 threads, a 4 x 4 tile each
constexpr int kLdT = kL + 4;     // row stride of C^T, B^T and W (floats)

constexpr size_t kBaseFloats = size_t(2) * kD * kLdT   // C^T, B^T
                               + size_t(kL) * kD       // B
                               + size_t(kL) * kLdT     // W
                               + size_t(kL) * kD       // X
                               + size_t(4) * kL;       // cum, dt, u, exp(cum)

size_t smem_bytes(int hb) {
  return sizeof(float) * (kBaseFloats + size_t(hb) * kD * kD);
}

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

__device__ __forceinline__ void load4(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y, int S, int NH,
                int P, int N, int HB) {
  extern __shared__ float4 smem4[];
  float* ct = reinterpret_cast<float*>(smem4);   // [kD][kLdT]  C^T (n, t)
  float* bt = ct + kD * kLdT;                    // [kD][kLdT]  B^T (n, s)
  float* bs = bt + kD * kLdT;                    // [kL][kD]    B (s, n)
  float* w = bs + kL * kD;                       // [kL][kLdT]  W (t, s)
  float* xs = w + kL * kLdT;                     // [kL][kD]    X (s, p)
  float* cum = xs + kL * kD;                     // [kL]
  float* dts = cum + kL;                         // [kL]  dt
  float* us = dts + kL;                          // [kL]  dt exp(cum_end - cum)
  float* ecum = us + kL;                         // [kL]  exp(cum)
  float* st = ecum + kL;                         // [HB][kD][kD]  states (n, p)

  const int b = blockIdx.y;
  const int h0 = blockIdx.x * HB;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 4;    // rows: t of G, W and y; n of the state
  const int c0 = (tid & 15) * 4;    // columns: s of G and W; p of y, state
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s_end = 8 * warp + 8;   // the keys this warp's rows can see

  for (int i = tid; i < HB * kD * kD; i += kThreads) st[i] = 0.0f;

  for (int c_lo = 0; c_lo < S; c_lo += kL) {
    const int len = S - c_lo < kL ? S - c_lo : kL;
    __syncthreads();   // the last chunk's C and B read (the states zeroed)
    for (int idx = tid; idx < kL * kD; idx += kThreads) {
      const int t = idx / kD;
      const int n = idx % kD;
      float bv = 0.0f, cv = 0.0f;
      if (t < len && n < N) {
        const long long off =
            (static_cast<long long>(b) * S + c_lo + t) * N + n;
        bv = to_f32(bm[off]);
        cv = to_f32(cm[off]);
      }
      ct[n * kLdT + t] = cv;
      bt[n * kLdT + t] = bv;
      bs[t * kD + n] = bv;
    }
    __syncthreads();

    // G = C B^T, rows t = r0.., columns s = c0..; a tile wholly above the
    // diagonal is never used
    float g[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
    }
    if (c0 <= r0 + 3) {
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
        load4(ct + n * kLdT + r0, cv);
        load4(bt + n * kLdT + c0, bv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
        }
      }
    }

    for (int hh = 0; hh < HB; ++hh) {
      const int h = h0 + hh;
      float* state = st + hh * kD * kD;
      __syncthreads();   // the last head's X, W and cum read
      for (int idx = tid; idx < kL * kD; idx += kThreads) {
        const int s = idx / kD;
        const int p = idx % kD;
        float v = 0.0f;
        if (s < len && p < P) {
          v = to_f32(
              x[((static_cast<long long>(b) * S + c_lo + s) * NH + h) * P + p]);
        }
        xs[idx] = v;
      }
      if (warp == 0) {
        // inclusive cumsum of dt a: lane l holds steps 2l and 2l + 1
        const float ah = a[h];
        const int s0 = 2 * lane;
        const long long row = static_cast<long long>(b) * S + c_lo + s0;
        const float d0 = s0 < len ? to_f32(dt[row * NH + h]) : 0.0f;
        const float d1 = s0 + 1 < len ? to_f32(dt[(row + 1) * NH + h]) : 0.0f;
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
        cum[s0] = cum0;
        cum[s0 + 1] = incl;
        dts[s0] = d0;
        dts[s0 + 1] = d1;
        us[s0] = d0 * expf(cum_end - cum0);
        us[s0 + 1] = d1 * expf(cum_end - incl);
        ecum[s0] = expf(cum0);
        ecum[s0 + 1] = expf(incl);
      }
      __syncthreads();

      // W = G exp(cum_t - cum_s) dt_s where s <= t; selected 0 elsewhere
      {
        float cs[4], ds[4];
        load4(cum + c0, cs);
        load4(dts + c0, ds);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = r0 + i;
          const float cmt = cum[t];
          float wv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wv[j] = c0 + j <= t ? g[i][j] * expf(cmt - cs[j]) * ds[j] : 0.0f;
          }
          store4(w + t * kLdT + c0, wv);
        }
      }
      __syncthreads();

      // y = W X + exp(cum_t) C state: rows t = r0.., columns p = c0..
      float acc[4][4], inter[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[i][k] = 0.0f;
          inter[i][k] = 0.0f;
        }
      }
      for (int s = 0; s < s_end; s += 4) {
        float wr[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load4(w + (r0 + i) * kLdT + s, wr[i]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float xv[4];
          load4(xs + (s + jj) * kD + c0, xv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc[i][k] = fmaf(wr[i][jj], xv[k], acc[i][k]);
            }
          }
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
        load4(ct + n * kLdT + r0, cv);
        load4(state + n * kD + c0, sv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            inter[i][k] = fmaf(cv[i], sv[k], inter[i][k]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + i;
        if (t >= len) continue;
        const float e = ecum[t];
        T* dst = y + ((static_cast<long long>(b) * S + c_lo + t) * NH + h) * P;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c0 + k < P) dst[c0 + k] = from_f32<T>(fmaf(e, inter[i][k], acc[i][k]));
        }
      }
      __syncthreads();   // every read of this head's state done

      // state <- state exp(cum_end) + sum_s b_s (x) x_s u_s: rows n = r0..,
      // columns p = c0..
      {
        const float decay = expf(cum[kL - 1]);
        float sa[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          load4(state + (r0 + i) * kD + c0, sa[i]);
#pragma unroll
          for (int k = 0; k < 4; ++k) sa[i][k] *= decay;
        }
#pragma unroll 4
        for (int s = 0; s < len; ++s) {
          float bv[4], xv[4];
          load4(bs + s * kD + r0, bv);
          load4(xs + s * kD + c0, xv);
          const float u = us[s];
#pragma unroll
          for (int k = 0; k < 4; ++k) xv[k] *= u;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int k = 0; k < 4; ++k) sa[i][k] = fmaf(bv[i], xv[k], sa[i][k]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) store4(state + (r0 + i) * kD + c0, sa[i]);
      }
    }
  }
}

template <typename T, typename TD>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, int B, int S, int NH, int P, int N, int HB,
           void* stream) {
  const size_t smem = smem_bytes(HB);
  auto kernel = ssm_scan_kernel<T, TD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(NH / HB), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const TD*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), S, NH, P, N, HB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (x, bm, cm, y) and dt_dtype: 0 = float32, 1 = bfloat16; dt is
// float32 or x's type; a is float32.  Tensors are contiguous: x and y
// (B, S, NH, P), dt (B, S, NH), a (NH,), bm and cm (B, S, N); P, N <= 64;
// HB divides NH.  Returns the first CUDA error of the attribute call or the
// launch (0 = cudaSuccess).
extern "C" int ssm_scan(int dtype, int dt_dtype, const void* x, const void* dt,
                        const void* a, const void* bm, const void* cm, void* y,
                        int B, int S, int NH, int P, int N, int HB,
                        void* stream) {
  if (P < 1 || P > kD || N < 1 || N > kD || HB < 1 || NH % HB) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0 && dt_dtype == 0) {
    return launch<float, float>(x, dt, a, bm, cm, y, B, S, NH, P, N, HB,
                                stream);
  }
  if (dtype == 1 && dt_dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, a, bm, cm, y, B, S, NH,
                                                P, N, HB, stream);
  }
  if (dtype == 1 && dt_dtype == 0) {
    return launch<__nv_bfloat16, float>(x, dt, a, bm, cm, y, B, S, NH, P, N,
                                        HB, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
