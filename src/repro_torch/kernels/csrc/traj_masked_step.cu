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
// Bound: memory.  An active lane reads x, eps and z and writes out once
// (4 passes of S*D elements), an inactive lane reads x and writes it back
// (2 passes); 7 flops per element against ~16 bytes.  At the serving shapes
// (S = 8 lanes of 128x128x1 f32, ~2.1 MB a tick) the bytes take well under a
// microsecond at 3.35 TB/s, so launch overhead dominates.  The design keeps
// that one launch: each block loads its lane's column, flag and four table
// entries as scalars, threads stream 16-byte vectors (4 f32 or 8 bf16),
// inactive lanes never read eps or z, and the ragged tail is masked here.
//
// Grid: (pixel blocks, lanes); 256 threads, one 16-byte vector each.
// Plain C interface, bound with ctypes (see repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ float update(float x, float e, float z, float c_eps,
                                        float sqrt_ar, float ks, float clip) {
  const float mean = (x - c_eps * e) / sqrt_ar;
  float v = mean + ks * z;
  if (clip != 0.0f) {
    // comparisons keep a NaN as it is, as torch.clamp does
    v = v < -clip ? -clip : (v > clip ? clip : v);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
traj_masked_step_kernel(const T* __restrict__ x, const T* __restrict__ eps,
                        const T* __restrict__ z, T* __restrict__ out,
                        const int32_t* __restrict__ cols,
                        const uint8_t* __restrict__ active,
                        const float* __restrict__ tables, int C, long long D,
                        float clip, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const long long lane = blockIdx.y;
  const long long base = lane * D;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (i0 >= D) return;
  const bool act = active[lane] != 0;

  if (!act) {  // inactive: copy the input bits, never touch eps or z
    if (vec_ok) {
      *reinterpret_cast<uint4*>(out + base + i0) =
          *reinterpret_cast<const uint4*>(x + base + i0);
    } else {
      for (int j = 0; j < VEC && i0 + j < D; ++j) out[base + i0 + j] = x[base + i0 + j];
    }
    return;
  }

  int col = cols[lane];
  col = col < 0 ? 0 : (col > C - 1 ? C - 1 : col);
  const float c_eps = tables[col];
  const float sqrt_ar = sqrtf(tables[C + col]);
  const float ks = tables[3 * C + col] * tables[2 * C + col];  // keep * sigma

  if (vec_ok) {
    const uint4 xv = *reinterpret_cast<const uint4*>(x + base + i0);
    const uint4 ev = *reinterpret_cast<const uint4*>(eps + base + i0);
    const uint4 zv = *reinterpret_cast<const uint4*>(z + base + i0);
    const T* xs = reinterpret_cast<const T*>(&xv);
    const T* es = reinterpret_cast<const T*>(&ev);
    const T* zs = reinterpret_cast<const T*>(&zv);
    uint4 ov;
    T* os = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      os[j] = from_f32<T>(update(to_f32<T>(xs[j]), to_f32<T>(es[j]),
                                 to_f32<T>(zs[j]), c_eps, sqrt_ar, ks, clip));
    }
    *reinterpret_cast<uint4*>(out + base + i0) = ov;
  } else {
    for (int j = 0; j < VEC && i0 + j < D; ++j) {
      const long long i = base + i0 + j;
      out[i] = from_f32<T>(update(to_f32<T>(x[i]), to_f32<T>(eps[i]),
                                  to_f32<T>(z[i]), c_eps, sqrt_ar, ks, clip));
    }
  }
}

template <typename T>
int launch(const void* x, const void* eps, const void* z, void* out,
           const void* cols, const void* active, const void* tables, int C,
           long long S, long long D, float clip, int vec_ok, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const long long vecs = (D + VEC - 1) / VEC;
  const dim3 grid(static_cast<unsigned>((vecs + kThreads - 1) / kThreads),
                  static_cast<unsigned>(S));
  traj_masked_step_kernel<T><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(eps),
      static_cast<const T*>(z), static_cast<T*>(out),
      static_cast<const int32_t*>(cols), static_cast<const uint8_t*>(active),
      static_cast<const float*>(tables), C, D, clip, vec_ok);
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
