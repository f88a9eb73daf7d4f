// Per-lane standard normals for the serving engine's window, drawn on the
// card (sm_90a).
//
// Not a TPU kernel: it replaces the reference's on-device draw inside its
// jitted tick, jax.random.normal at src/repro/diffusion/backend.py:214
// (no pallas_call there).  The port's draws are its own: each element is a
// pure function of (seed, image, role, step, element), so a lane can be
// replayed alone and a window of k ticks draws what k windows of one draw.
//
//   out[s, e] = active[s] ? normal(seed[s], image[s], role, step[s], e) : 0
//
// Generator.  Philox4x32-10 (Salmon et al., SC'11), keyed by the 64-bit
// request seed (k0 = low word, k1 = high word), counter (e / 4, step, image,
// role): one call gives the four uniforms of one element quad.
//
// Transform.  Box-Muller on the pairs (x0, x1) and (x2, x3):
//   u = ((x0 >> 8) + 1) * 2^-24 in (0, 1];  r = sqrt(-2 ln u)
//   the top 2 of x1's 24 kept bits pick the quadrant, the low 22 the angle
//   a in [0, pi/2);  (z0, z1) = r * (cos, sin)(quadrant * pi/2 + a)
// with ln, sin and cos as fixed polynomials (ln: the exponent split off, m
// in [sqrt(1/2), sqrt(2)), 2 atanh((m-1)/(m+1)) to s^9; sin to a^13, cos to
// a^14, Taylor), every operation a round-to-nearest intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), never contracted, in the order
// repro_torch/kernels/ref.py::lane_noise_ref takes them: the two are equal
// bit for bit.  The constants are float32 bit patterns, the same in both.
//
// Bound.  It writes S * D floats and reads 25 bytes a lane: at S = 8 lanes
// of 128x128x1, 512 KB, 0.16 us at 3.35 TB/s, under the card's ~1.1 us
// launch floor.  About 25 integer and 30 float operations an element (the
// ten Philox rounds shared by four elements, the transform by two) take
// less.  One thread a quad, one 16-byte store; 256 threads a block, grid
// (quads / 256, lanes).  Inactive lanes store zeros without drawing.
// Launches on the caller's stream, allocates nothing, so a CUDA graph can
// capture it.  Plain C interface, bound with ctypes
// (repro_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

// the transform's constants (float32 bit patterns; ref.py LANE_NOISE_BITS)
#define S1 0xbe2aaaabu
#define S2 0x3c088889u
#define S3 0xb9500d01u
#define S4 0x3638ef1du
#define S5 0xb2d7322bu
#define S6 0x2f309231u
#define C1 0xbf000000u
#define C2 0x3d2aaaabu
#define C3 0xbab60b61u
#define C4 0x37d00d01u
#define C5 0xb493f27eu
#define C6 0x310f76c7u
#define C7 0xad49cba5u
#define L0 0x40000000u
#define L1 0x3f2aaaabu
#define L2 0x3ecccccdu
#define L3 0x3e924925u
#define L4 0x3e638e39u
#define LN2_HI 0x3f317200u
#define LN2_LO 0x35bfbe8eu
#define SQRT2 0x3fb504f3u
#define HALF_PI 0x3fc90fdbu

__device__ __forceinline__ float k(uint32_t bits) { return __uint_as_float(bits); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ void philox(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c[0]), lo0 = kM0 * c[0];
    const uint32_t hi1 = __umulhi(kM1, c[2]), lo1 = kM1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// r * (cos, sin) of one pair of Philox words
__device__ __forceinline__ void box_muller(uint32_t xu, uint32_t xa, float* z0,
                                           float* z1) {
  // ln u, u = n * 2^-24 with n in [1, 2^24]
  const float u = mul(static_cast<float>((xu >> 8) + 1u), 0x1p-24f);
  const int b = __float_as_int(u);
  int e = (b >> 23) - 127;
  float m = __int_as_float((b & 0x7FFFFF) | 0x3F800000);
  if (m > k(SQRT2)) {
    m = mul(m, 0.5f);
    e += 1;
  }
  const float s = __fdiv_rn(add(m, -1.0f), add(m, 1.0f));
  const float s2 = mul(s, s);
  float p = add(k(L3), mul(s2, k(L4)));
  p = add(k(L2), mul(s2, p));
  p = add(k(L1), mul(s2, p));
  p = add(k(L0), mul(s2, p));
  const float lnm = mul(s, p);
  const float ef = static_cast<float>(e);
  const float lnu = add(mul(ef, k(LN2_HI)), add(mul(ef, k(LN2_LO)), lnm));
  const float r = __fsqrt_rn(mul(lnu, -2.0f));
  // the angle: quadrant and a in [0, pi/2)
  const uint32_t n = xa >> 8;
  const uint32_t q = n >> 22;
  const float a = mul(mul(static_cast<float>(n & 0x3FFFFFu), 0x1p-22f),
                      k(HALF_PI));
  const float a2 = mul(a, a);
  float sp = add(k(S5), mul(a2, k(S6)));
  sp = add(k(S4), mul(a2, sp));
  sp = add(k(S3), mul(a2, sp));
  sp = add(k(S2), mul(a2, sp));
  sp = add(k(S1), mul(a2, sp));
  const float sn = add(a, mul(a, mul(a2, sp)));
  float cp = add(k(C6), mul(a2, k(C7)));
  cp = add(k(C5), mul(a2, cp));
  cp = add(k(C4), mul(a2, cp));
  cp = add(k(C3), mul(a2, cp));
  cp = add(k(C2), mul(a2, cp));
  cp = add(k(C1), mul(a2, cp));
  const float cs = add(1.0f, mul(a2, cp));
  float c, si;
  switch (q) {
    case 0: c = cs; si = sn; break;
    case 1: c = -sn; si = cs; break;
    case 2: c = -cs; si = -sn; break;
    default: c = sn; si = -cs; break;
  }
  *z0 = mul(r, c);
  *z1 = mul(r, si);
}

__global__ void __launch_bounds__(kThreads)
lane_noise_kernel(float* __restrict__ out, const long long* __restrict__ seed,
                  const long long* __restrict__ image,
                  const long long* __restrict__ step,
                  const uint8_t* __restrict__ active, uint32_t role,
                  long long D, int vec_ok) {
  const long long lane = blockIdx.y;
  const long long quad = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long e0 = quad * 4;
  if (e0 >= D) return;
  float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (active[lane]) {
    const uint64_t key = static_cast<uint64_t>(seed[lane]);
    uint32_t c[4] = {static_cast<uint32_t>(quad),
                     static_cast<uint32_t>(step[lane]),
                     static_cast<uint32_t>(image[lane]), role};
    philox(c, static_cast<uint32_t>(key), static_cast<uint32_t>(key >> 32));
    box_muller(c[0], c[1], &z[0], &z[1]);
    box_muller(c[2], c[3], &z[2], &z[3]);
  }
  float* row = out + lane * D;
  if (vec_ok) {
    reinterpret_cast<float4*>(row)[quad] = make_float4(z[0], z[1], z[2], z[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e0 + j < D) row[e0 + j] = z[j];
    }
  }
}

}  // namespace

// out: (S, D) float32; seed, image, step: (S,) int64; active: (S,) bool.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int lane_noise(void* out, const void* seed, const void* image,
                          const void* step, const void* active,
                          unsigned role, long long S, long long D, int vec_ok,
                          void* stream) {
  const long long quads = (D + 3) / 4;
  const dim3 grid(static_cast<unsigned>((quads + kThreads - 1) / kThreads),
                  static_cast<unsigned>(S));
  lane_noise_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const long long*>(seed),
      static_cast<const long long*>(image), static_cast<const long long*>(step),
      static_cast<const uint8_t*>(active), role, D, vec_ok);
  return static_cast<int>(cudaGetLastError());
}
