// Fused masked trajectory tick for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ddpm_step.py::traj_masked_step (the Pallas
// body _masked_step_kernel): the serving engine's whole denoise tick over a
// slot array in ONE pass.  Per lane:
//
//   col  = clamp(cols[lane], 0, C - 1)
//   (c_eps, ar, sigma, keep) = tables[0..3, col]
//   active: out = clip((x - c_eps * eps) / sqrtf(ar) + (keep * sigma) * z, +-clip)
//   else:   out = x, bit for bit (any column, any dtype)
//
// The division is the reference's plain expression (repro/diffusion/
// backend.py StepBackend.index_step), not the TPU kernel's x * rsqrt(ar).
// Built with -fmad=false, so every product and sum rounds on its own, as the
// separate PyTorch kernels of the plain version do: the f32 output can equal
// repro_torch/kernels/ref.py::traj_masked_step_ref bit for bit.
//
// Bound.  By bytes, an active lane reads x, eps and z and writes out once (4
// passes of D elements), an inactive one reads x and writes it (2 passes);
// 8 flops per element against 16 bytes (f32).  At the serving shape (S = 8
// lanes of 128x128x1, ~2.1 MB a tick in f32) those bytes take 0.55 us at
// 3.35 TB/s, but an empty kernel on the same grid takes 1.1 us and one round
// trip to device memory most of another: the kernel is bound by launch and
// by the latency of its loads, and every load that waits on another adds a
// round trip (the flag, the column, the table entries and the vectors make
// a chain of three, unless each is read without the others).
//
// Design.  Every global read is issued at kernel entry and none waits on
// another: this thread's 16-byte vectors of x, eps and z (4 f32 or 8 bf16),
// rows 0-3 of the table copied whole into shared memory by the block's
// threads together with cp.async (16 bytes a column, no registers held; the
// counterpart of the Pallas kernel's SMEM staging), and the lane's column
// and flag.  Then one barrier; each thread clamps the column, reads its four
// coefficients from shared memory and takes sqrtf(ar) once (the lane's one
// value: handing it from one thread to the others would cost a second
// barrier), computes, selects, and stores its vector in one 16-byte store.
// Inactive lanes read eps and z too (design (a)), and the select drops
// their bits.  Loading them after the flag (b) saves an inactive lane's two
// passes but puts a second round trip on every active lane.  Inside the
// engine's tick, where eps was just written by the U-Net and about 3 of 8
// lanes are active a launch, (a) is ~0.3 us faster than (b) on an H100 at
// 8 slots and 0-0.15 us at 32 (tools/step_variants.py, PERF.md).
//
// Staging budget: 32 KB of shared memory, C <= 2048 columns (a 1000-step
// dense chain with its DDIM menu fits), and a table 16-byte aligned.  Past
// it the kernel gathers the lane's four entries from device memory after the
// column (a second round trip), chosen at launch; both paths are tested.
//
// Grid: (blocks, lanes), one 16-byte vector a thread.  A block takes 512
// elements (128 threads in f32, 64 in bf16), or 1024 where that still gives
// every SM two blocks.  S = 8 lanes of 16,384 elements launch 256 blocks in
// either dtype, so every one of the H100's 132 SMs has loads in flight and
// the whole read set is in flight at once; S = 32 launches 512 blocks of
// 1024.  A launch costs ~1.0 us + 0.5 ns a block (an empty kernel), so
// smaller blocks cost more than they gain, and larger ones at S = 8 would
// leave SMs idle.
// What remains above the stream floor (the same loads and store alone) is
// the coefficients' path and the arithmetic, the IEEE division and square
// root on one or two warps a scheduler (tools/step_variants.py).
// Plain C interface, bound with ctypes (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using Vec = uint4;                     // a thread's bits of one stream
constexpr int kVecBytes = sizeof(Vec);
constexpr long long kStageBytes = 32 << 10;   // shared memory for rows 0-3

// Elements a thread.
template <typename T> __host__ __device__ constexpr int vec_of() {
  return kVecBytes / static_cast<int>(sizeof(T));
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a[j] / b for each j: the reference's division, correctly rounded.
template <int N>
__device__ __forceinline__ void divide(float (&a)[N], float b) {
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = a[j] / b;
}

// This thread's kVecBytes at p: one vector load, or element by element
// where the lane's rows are not 16-byte aligned, the first n elements (the
// ragged tail; zeros past it).
template <typename T>
__device__ __forceinline__ Vec load_vec(const T* __restrict__ p, long long n,
                                        int vec_ok) {
  constexpr int VEC = vec_of<T>();
  if (vec_ok) return *reinterpret_cast<const Vec*>(p);
  Vec v{};
  T* s = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (j < n) s[j] = p[j];
  }
  return v;
}

// The store of load_vec's bytes: one vector store (st.global.v4 for 16
// bytes: left to itself the compiler splits it into 4-byte stores).
template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, Vec v,
                                          long long n, int vec_ok) {
  constexpr int VEC = vec_of<T>();
  if (vec_ok) {
    __stwb(reinterpret_cast<Vec*>(p), v);
    return;
  }
  const T* s = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (j < n) p[j] = s[j];
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

template <typename T, int ELEMS>     // ELEMS: elements a block
__global__ void __launch_bounds__(ELEMS / vec_of<T>())
traj_masked_step_kernel(const T* __restrict__ x, const T* __restrict__ eps,
                        const T* __restrict__ z, T* __restrict__ out,
                        const int32_t* __restrict__ cols,
                        const uint8_t* __restrict__ active,
                        const float* __restrict__ tables, int C, long long D,
                        float clip, int vec_ok, int staged) {
  constexpr int VEC = vec_of<T>();
  constexpr int kThreads = ELEMS / VEC;
  extern __shared__ __align__(16) float stage[];   // rows 0-3, (4, C)
  const long long lane = blockIdx.y;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  const long long n = D - i0;          // elements left from i0 (<= 0: none)
  const long long off = lane * D + i0;

  // -- every global read at entry, none waiting on another ------------------
  Vec xv{}, ev{}, zv{};
  if (n > 0) {
    xv = load_vec<T>(x + off, n, vec_ok);
    ev = load_vec<T>(eps + off, n, vec_ok);
    zv = load_vec<T>(z + off, n, vec_ok);
  }
  if (staged) {            // rows 0-3 are 4C floats: C chunks of 16 bytes
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(stage));
    for (int c = threadIdx.x; c < C; c += kThreads) {
      cp_async16(base + 16u * c, tables + 4 * c);
    }
  }
  int col = cols[lane];
  const bool act = active[lane] != 0;

  // -- one barrier, then the lane's coefficients ----------------------------
  col = col < 0 ? 0 : (col > C - 1 ? C - 1 : col);
  float c_eps, ar, sigma, keep;
  if (staged) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    c_eps = stage[col];
    ar = stage[C + col];
    sigma = stage[2 * C + col];
    keep = stage[3 * C + col];
  } else {         // past the budget: a second round trip, after the column
    c_eps = tables[col];
    ar = tables[C + col];
    sigma = tables[2 * C + col];
    keep = tables[3 * C + col];
  }
  if (n <= 0) return;

  // -- compute, select, store -----------------------------------------------
  Vec ov = xv;                 // inactive: x's own bits
  if (act) {
    const T* xs = reinterpret_cast<const T*>(&xv);
    const T* es = reinterpret_cast<const T*>(&ev);
    const T* zs = reinterpret_cast<const T*>(&zv);
    T* os = reinterpret_cast<T*>(&ov);
    const float ks = keep * sigma;
    float v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32<T>(xs[j]) - c_eps * to_f32<T>(es[j]);
    divide<VEC>(v, sqrtf(ar));
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float r = v[j] + ks * to_f32<T>(zs[j]);
      if (clip != 0.0f) {
        // comparisons keep a NaN as it is, as torch.clamp does
        r = r < -clip ? -clip : (r > clip ? clip : r);
      }
      os[j] = from_f32<T>(r);
    }
  }
  store_vec<T>(out + off, ov, n, vec_ok);
}

// Elements a block: 1024 where that still gives every SM two blocks, else
// 512 (S = 8 lanes of 16,384 elements: 256 blocks).  Fewer, larger blocks
// launch faster; too few leave SMs without loads in flight.
int elems_of(long long S, long long D) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return (D + 1023) / 1024 * S >= 2LL * sms ? 1024 : 512;
}

template <typename T, int ELEMS>
void run(const void* x, const void* eps, const void* z, void* out,
         const void* cols, const void* active, const void* tables, int C,
         long long S, long long D, float clip, int vec_ok, int staged,
         cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((D + ELEMS - 1) / ELEMS),
                  static_cast<unsigned>(S));
  const size_t smem = staged ? 16 * static_cast<size_t>(C) : 0;
  traj_masked_step_kernel<T, ELEMS><<<grid, ELEMS / vec_of<T>(), smem,
                                      stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(eps),
      static_cast<const T*>(z), static_cast<T*>(out),
      static_cast<const int32_t*>(cols), static_cast<const uint8_t*>(active),
      static_cast<const float*>(tables), C, D, clip, vec_ok, staged);
}

template <typename T>
int launch(const void* x, const void* eps, const void* z, void* out,
           const void* cols, const void* active, const void* tables, int C,
           long long S, long long D, float clip, int vec_ok, void* stream) {
  const int staged = 16LL * C <= kStageBytes &&
                     reinterpret_cast<uintptr_t>(tables) % 16 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (elems_of(S, D) == 1024) {
    run<T, 1024>(x, eps, z, out, cols, active, tables, C, S, D, clip, vec_ok,
                 staged, st);
  } else {
    run<T, 512>(x, eps, z, out, cols, active, tables, C, S, D, clip, vec_ok,
                staged, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
extern "C" int traj_masked_step(int dtype, const void* x, const void* eps,
                                const void* z, void* out, const void* cols,
                                const void* active, const void* tables, int C,
                                long long S, long long D, float clip,
                                int vec_ok, void* stream) {
  if (dtype == 0) {
    return launch<float>(x, eps, z, out, cols, active, tables, C, S, D, clip,
                         vec_ok, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, eps, z, out, cols, active, tables, C, S,
                                 D, clip, vec_ok, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

