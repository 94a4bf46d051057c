// Hopper (sm_90a) kernels for the OTA round tail of the fleet engine.
//
// Two kernels, each with a leading cell axis so that one launch covers the
// whole [K scheme x S seed] fleet (the reference vmaps its pallas_call over
// cells instead):
//
//   K1  ota_round_step   out[c,d] = p[c,d] - eta[c] * (sum_m (g[c,m,d]*qs[c,m])*s[c,m]
//                                                      + ns[c]*z[c,d])
//       replaces src/repro/kernels/round_step.py::ota_round_step_pallas
//   K2  ota_aggregate    out[c,d] = sum_m g[c,m,d]*s[c,m] + ns[c]*z[c,d]
//       replaces src/repro/kernels/ota_aggregate.py::ota_aggregate_pallas
//
// Bound: bytes.  Each reads g once (N wire elements per output element) and
// z (and p) once, and writes the output once; the arithmetic is 2N+3 flops
// per output element, well under one flop per byte, so both sit on the
// device-memory roofline.
//
// Design (simple and correct first): a 2-D grid, blocks over D and one
// grid row per cell; one thread per output element, so a warp's loads of
// one device row are 32 neighbouring elements (coalesced).  The ragged tail
// of D is masked; nothing is padded, unlike the TPU's 1024-element tiles.
// The per-device coefficients of the block's cell are staged in shared
// memory.  Every thread runs an f32 loop over the N devices with the
// reference's association -- (g*qs)*s summed over m, then + ns*z, then
// p - eta*ghat -- written with the _rn intrinsics so the compiler cannot
// contract it into FMAs.  No vector loads: a cell row of D f32 values is
// not 16-byte aligned when D is odd (D = 814,090 at full width).
// Vectorised loads, TMA and a persistent grid are left to a later change.
//
// Plain C interface for ctypes: every pointer and the stream are void*,
// and each entry returns cudaGetLastError() as an int (0 = launched).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// Copies this block's cell's [n] coefficient rows into shared memory.
__device__ __forceinline__ void stage_rows(float* sh, const float* a,
                                           const float* b, int c, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sh[i] = a[static_cast<int64_t>(c) * n + i];
    if (b != nullptr) sh[n + i] = b[static_cast<int64_t>(c) * n + i];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
round_step_kernel(const T* __restrict__ g, const float* __restrict__ qs,
                  const float* __restrict__ s, const float* __restrict__ z,
                  const float* __restrict__ ns, const float* __restrict__ p,
                  const float* __restrict__ eta, float* __restrict__ out,
                  int n, int64_t d) {
  extern __shared__ float coef[];  // [0, n): qs, [n, 2n): s
  const int c = blockIdx.y;
  stage_rows(coef, qs, s, c, n);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= d) return;
  const T* gc = g + static_cast<int64_t>(c) * n * d + j;
  float acc = 0.f;
#pragma unroll 4
  for (int m = 0; m < n; ++m) {
    const float gm = __fmul_rn(to_f32(gc[static_cast<int64_t>(m) * d]), coef[m]);
    acc = __fadd_rn(acc, __fmul_rn(gm, coef[n + m]));
  }
  const int64_t o = static_cast<int64_t>(c) * d + j;
  const float ghat = __fadd_rn(acc, __fmul_rn(ns[c], z[o]));
  out[o] = __fsub_rn(p[o], __fmul_rn(eta[c], ghat));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const T* __restrict__ g, const float* __restrict__ s,
                 const float* __restrict__ z, const float* __restrict__ ns,
                 T* __restrict__ out, int n, int64_t d) {
  extern __shared__ float coef[];  // [0, n): s
  const int c = blockIdx.y;
  stage_rows(coef, s, nullptr, c, n);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= d) return;
  const T* gc = g + static_cast<int64_t>(c) * n * d + j;
  float acc = 0.f;
#pragma unroll 4
  for (int m = 0; m < n; ++m) {
    acc = __fadd_rn(acc, __fmul_rn(to_f32(gc[static_cast<int64_t>(m) * d]), coef[m]));
  }
  const int64_t o = static_cast<int64_t>(c) * d + j;
  store(out + o, __fadd_rn(acc, __fmul_rn(ns[c], z[o])));
}

dim3 grid_of(int c, int64_t d) {
  return dim3(static_cast<unsigned>((d + kThreads - 1) / kThreads),
              static_cast<unsigned>(c));
}

template <typename T>
int launch_round_step(const void* g, const void* qs, const void* s,
                      const void* z, const void* ns, const void* p,
                      const void* eta, void* out, int c, int n, int64_t d,
                      void* stream) {
  if (c > 0 && d > 0) {
    round_step_kernel<T><<<grid_of(c, d), kThreads, 2 * n * sizeof(float),
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(g), static_cast<const float*>(qs),
        static_cast<const float*>(s), static_cast<const float*>(z),
        static_cast<const float*>(ns), static_cast<const float*>(p),
        static_cast<const float*>(eta), static_cast<float*>(out), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_aggregate(const void* g, const void* s, const void* z,
                     const void* ns, void* out, int c, int n, int64_t d,
                     void* stream) {
  if (c > 0 && d > 0) {
    aggregate_kernel<T><<<grid_of(c, d), kThreads, n * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(g), static_cast<const float*>(s),
        static_cast<const float*>(z), static_cast<const float*>(ns),
        static_cast<T*>(out), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ota_round_step_f32(const void* g, const void* qs, const void* s,
                       const void* z, const void* ns, const void* p,
                       const void* eta, void* out, int c, int n, long long d,
                       void* stream) {
  return launch_round_step<float>(g, qs, s, z, ns, p, eta, out, c, n, d, stream);
}

int ota_round_step_bf16(const void* g, const void* qs, const void* s,
                        const void* z, const void* ns, const void* p,
                        const void* eta, void* out, int c, int n, long long d,
                        void* stream) {
  return launch_round_step<__nv_bfloat16>(g, qs, s, z, ns, p, eta, out, c, n,
                                          d, stream);
}

int ota_round_step_int8(const void* g, const void* qs, const void* s,
                        const void* z, const void* ns, const void* p,
                        const void* eta, void* out, int c, int n, long long d,
                        void* stream) {
  return launch_round_step<int8_t>(g, qs, s, z, ns, p, eta, out, c, n, d,
                                   stream);
}

int ota_aggregate_f32(const void* g, const void* s, const void* z,
                      const void* ns, void* out, int c, int n, long long d,
                      void* stream) {
  return launch_aggregate<float>(g, s, z, ns, out, c, n, d, stream);
}

int ota_aggregate_bf16(const void* g, const void* s, const void* z,
                       const void* ns, void* out, int c, int n, long long d,
                       void* stream) {
  return launch_aggregate<__nv_bfloat16>(g, s, z, ns, out, c, n, d, stream);
}

}  // extern "C"
