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
// Arithmetic: every thread runs an f32 loop over the N devices in order --
// (g*qs)*s summed over m, then + ns*z, then p - eta*ghat -- written with
// the _rn intrinsics so the compiler cannot contract it into FMAs.  The
// plain versions (kernels/ref.py) take the same order, so the two agree
// bit for bit.
//
// Design: 16-byte loads and stores on rows that are not 16-byte aligned.
// A cell row of D values is not aligned when D is not a multiple of the
// vector (D = 814,090 at full width), and each device row of g starts at
// its own misalignment, (c*N + m)*D elements in.  So the output row sets
// the tiling: after a scalar head of fewer than one vector, a thread owns a
// run of 16 / sizeof(wire) output elements (one 16-byte vector of g: 4 f32,
// 8 bf16 or 16 int8) whose output starts 16-byte aligned, and a warp owns a
// span of 31 runs.  Every stream is read by 16-byte ld.global.nc loads at
// the aligned address at or below the data and realigned in registers: the
// bytes past a lane's vector are the next lane's vector, fetched by
// __shfl_sync, and the stream's offset (its address & 15, the same for every
// lane of the grid row, so no lane branches on it) picks words by two
// selects and bytes by a funnel shift; lane 31 of a g row only lends its
// vector.  The f32 streams (z, p, out) are read and written in slots, lane
// l taking the span's vectors l, 32 + l, ..., so that each load and store
// instruction covers 512 contiguous bytes; on the narrow wires (a run of 2
// or 4 of their vectors) the sums go from runs to slots (K1) or z from
// slots to runs (K2) through shared memory.  A thread issues its loads of
// kRows device rows before it consumes any; K1's z and p wait for the sum,
// as holding an int8 run's (4 vectors each) through it would cost a block
// per SM, and K2's z is loaded with the rows.  int8 converts to f32 by
// integer ops and one exact subtraction (no conversion instruction).  Each
// loaded vector holds a byte of the row it serves, so no load leaves the
// row's memory.  The ragged ends (fewer than
// one vector before the first aligned output and after the last whole run)
// are done one element a thread by the cell's first block.  The grid is
// (D blocks, C), one span per warp; the coefficients of a block's cell are
// staged in shared memory.  (A grid of resident blocks walking the spans,
// loads of the next span issued during this one's sum, streaming stores
// and caps on registers were each timed and gained nothing: PERF.md.)
//
// Plain C interface for ctypes: every pointer and the stream are void*,
// and each entry returns cudaGetLastError() as an int (0 = launched).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRuns = 31;    // runs a warp computes; lane 31 lends its vector
// device rows whose loads a thread issues before it consumes any: the
// fleet's N; more go in groups of kRows (more would cost occupancy)
constexpr int kRows = 10;

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

// Element k of a run held as 32-bit words: the same value as to_f32.
__device__ __forceinline__ float word_elem(const uint32_t* w, int k, float) {
  return __uint_as_float(w[k]);
}
__device__ __forceinline__ float word_elem(const uint32_t* w, int k,
                                           __nv_bfloat16) {
  const uint32_t v = w[k / 2];
  return __uint_as_float(k % 2 ? v & 0xffff0000u : v << 16);
}
// int8 without a conversion instruction: the byte with its sign bit
// flipped (b + 128) as the low mantissa byte of 2^23, minus 2^23 + 128;
// exact, so equal to static_cast<float>(b).
__device__ __forceinline__ float word_elem(const uint32_t* w, int k, int8_t) {
  const uint32_t v = __byte_perm(w[k / 4] ^ 0x80808080u, 0x4b000000u,
                                 0x7440u | (k % 4));
  return __fsub_rn(__uint_as_float(v), 8388736.f);
}

// 32-bit word holding the output value(s) of element k (and k + 1 in bf16).
__device__ __forceinline__ uint32_t out_word(const float* v, int k, float) {
  return __float_as_uint(v[k]);
}
__device__ __forceinline__ uint32_t out_word(const float* v, int k,
                                             __nv_bfloat16) {
  return static_cast<uint32_t>(
             __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]))) |
         static_cast<uint32_t>(
             __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1])))
             << 16;
}

__device__ __forceinline__ uint4 load16(const char* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One 16-byte store.  Written as PTX: a uint4 assignment is a struct copy,
// which the compiler may split into 4- and 8-byte stores.
__device__ __forceinline__ void store16(void* p, uint4 v) {
  asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t offset16(const void* p) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p) & 15);
}

// The vector of lane + 1 (lane 31 gets lane 0's).
__device__ __forceinline__ uint4 from_next_lane(uint4 v, int lane) {
  const int src = (lane + 1) & 31;
  return make_uint4(__shfl_sync(0xffffffffu, v.x, src),
                    __shfl_sync(0xffffffffu, v.y, src),
                    __shfl_sync(0xffffffffu, v.z, src),
                    __shfl_sync(0xffffffffu, v.w, src));
}

// The 16 bytes that start `sh` bytes into v and run on into nx, as four
// words: two selects pick the words, a funnel shift the bytes.  sh is the
// same on every lane of the warp.  A stream of S-byte elements has sh a
// multiple of S, so 4-byte ones need no byte shift.
template <int S>
__device__ __forceinline__ void shift_down(uint32_t* r, uint4 v, uint4 nx,
                                           uint32_t sh) {
  const uint32_t u[8] = {v.x, v.y, v.z, v.w, nx.x, nx.y, nx.z, nx.w};
  const bool two = sh & 8, one = sh & 4;
  const uint32_t bits = S == 4 ? 0 : 8 * (sh & 3);
  uint32_t t[6], q[5];
#pragma unroll
  for (int j = 0; j < 6; ++j) t[j] = two ? u[j + 2] : u[j];
#pragma unroll
  for (int j = 0; j < 5; ++j) q[j] = one ? t[j + 1] : t[j];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    r[j] = S == 4 ? q[j] : __funnelshift_r(q[j], q[j + 1], bits);
}

// A warp's span of an f32 stream: the 31 runs r0 .. r0+30, W 16-byte
// vectors each, from `a`, the aligned address at or below the span's first
// element (sh bytes below it).  Lane l holds slots k = 0 .. W-1, vector
// 32k + l of the span: consecutive lanes load consecutive vectors, and the
// vector past a slot is lane + 1's (lane 0's next slot for lane 31), so the
// span's one extra vector is slot 31W.  A vector is loaded only if it holds
// a byte of a whole run, or of the last whole run when the stream is
// offset.
template <int W>
__device__ __forceinline__ void load_span(uint4* v, const char* a,
                                          uint32_t sh, int lane, int64_t r0,
                                          int64_t nb) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = 32 * k + lane;
    const int64_t run = r0 + j / W;
    v[k] = make_uint4(0u, 0u, 0u, 0u);
    if (j <= kRuns * W &&
        (run < nb || (run == nb && j % W == 0 && sh != 0)))
      v[k] = load16(a + 16 * j);
  }
}

// The span's slots realigned: words r[4k .. 4k+3] are elements
// 4(32k + l) .. +3 of the span.  Every lane of the warp calls this.
template <int W>
__device__ __forceinline__ void realign_span(uint32_t* r, const uint4* v,
                                             uint32_t sh, int lane) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (sh == 0) {
      r[4 * k] = v[k].x;
      r[4 * k + 1] = v[k].y;
      r[4 * k + 2] = v[k].z;
      r[4 * k + 3] = v[k].w;
    } else {
      // lane 0 hands its next slot to lane 31
      const uint4 nx = from_next_lane(lane == 0 && k + 1 < W ? v[k + 1]
                                                              : v[k],
                                      lane);
      shift_down<4>(r + 4 * k, v[k], nx, sh);
    }
  }
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

// Output elements of a row before its first 16-byte aligned one (at most d).
template <typename O>
__device__ __forceinline__ int64_t head_of(const O* row, int64_t d) {
  const int64_t h = ((16 - offset16(row)) & 15) / sizeof(O);
  return h < d ? h : d;
}

// sum_m (g_m*qs_m)*s_m of one element (K1, kScaled), or sum_m g_m*s_m (K2).
template <typename T, bool kScaled>
__device__ __forceinline__ float sum_scalar(const T* gj, int64_t d, int n,
                                            const float* qs, const float* s) {
  float acc = 0.f;
  for (int m = 0; m < n; ++m) {
    float gm = to_f32(gj[static_cast<int64_t>(m) * d]);
    if (kScaled) gm = __fmul_rn(gm, qs[m]);
    acc = __fadd_rn(acc, __fmul_rn(gm, s[m]));
  }
  return acc;
}

// Device rows m0 .. m0 + kRows-1 (those below n) of a lane's run r of E =
// 16 / sizeof(T) elements: one 16-byte vector each, loaded at the aligned
// address at or below the run, whose first element lies at `ga` in device
// row 0; device rows are `row` bytes apart.  Lane 31 (run r0 + 31) only
// lends its vector to lane 30.
template <typename T>
__device__ __forceinline__ void load_rows(uint4* gv, const char* ga,
                                          int64_t row, int n, int m0,
                                          int64_t r, int64_t nb) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const char* a = ga + (m0 + i) * row;
    const uint32_t sh = offset16(a);
    gv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + i < n && (r < nb || (r == nb && sh != 0)))
      gv[i] = load16(a - sh);
  }
}

// acc[e] += (g_m * qs_m) * s_m (K1, kScaled) or g_m * s_m (K2) over those
// rows, in order, each row realigned first.  Every lane of the warp calls
// this.
template <typename T, bool kScaled>
__device__ __forceinline__ void add_rows(float* acc, const uint4* gv,
                                         const char* ga, int64_t row, int n,
                                         int m0, const float* qs,
                                         const float* s, int lane) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int m = m0 + i;
    if (m >= n) break;
    const uint32_t sh = offset16(ga + m * row);
    uint32_t w[4] = {gv[i].x, gv[i].y, gv[i].z, gv[i].w};
    if (sh != 0)
      shift_down<sizeof(T)>(w, gv[i], from_next_lane(gv[i], lane), sh);
    const float q = kScaled ? qs[m] : 1.f;
    const float sm = s[m];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float gm = word_elem(w, e, T());
      if (kScaled) gm = __fmul_rn(gm, q);
      acc[e] = __fadd_rn(acc[e], __fmul_rn(gm, sm));
    }
  }
}

// The sum over all n rows of run r, kRows rows at a time.
template <typename T, bool kScaled>
__device__ __forceinline__ void sum_run(float* acc, const char* ga,
                                        int64_t row, int n, const float* qs,
                                        const float* s, int lane, int64_t r,
                                        int64_t nb) {
#pragma unroll
  for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e) acc[e] = 0.f;
  for (int m0 = 0; m0 < n; m0 += kRows) {
    uint4 gv[kRows];
    load_rows<T>(gv, ga, row, n, m0, r, nb);
    add_rows<T, kScaled>(acc, gv, ga, row, n, m0, qs, s, lane);
  }
}

__device__ __forceinline__ float step(float acc, float ns, float z, float p,
                                      float eta) {
  return __fsub_rn(p, __fmul_rn(eta, __fadd_rn(acc, __fmul_rn(ns, z))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
round_step_kernel(const T* __restrict__ g, const float* __restrict__ qs,
                  const float* __restrict__ s, const float* __restrict__ z,
                  const float* __restrict__ ns, const float* __restrict__ p,
                  const float* __restrict__ eta, float* __restrict__ out,
                  int n, int64_t d) {
  constexpr int E = 16 / sizeof(T);  // a run: one 16-byte vector of g
  constexpr int W = E / 4;           // its 16-byte vectors of z, p and out
  extern __shared__ float coef[];    // [0, n): qs, [n, 2n): s
  __shared__ float4 xs[kWarps][32 * W];  // sums from runs to slots
  const int c = blockIdx.y;
  stage_rows(coef, qs, s, c, n);
  const T* gc = g + static_cast<int64_t>(c) * n * d;
  const float* zc = z + static_cast<int64_t>(c) * d;
  const float* pc = p + static_cast<int64_t>(c) * d;
  float* oc = out + static_cast<int64_t>(c) * d;
  const float nsc = ns[c], etac = eta[c];
  const int64_t h = head_of(oc, d);
  const int64_t nb = (d - h) / E;  // whole runs
  if (blockIdx.x == 0) {           // the ragged ends
    const int64_t tail = h + nb * E;
    for (int64_t i = threadIdx.x; i < h + d - tail; i += blockDim.x) {
      const int64_t j = i < h ? i : tail + (i - h);
      oc[j] = step(sum_scalar<T, true>(gc + j, d, n, coef, coef + n), nsc,
                   zc[j], pc[j], etac);
    }
  }
  const int lane = threadIdx.x & 31;
  float4* x = xs[threadIdx.x / 32];
  const char* za = reinterpret_cast<const char*>(zc + h);
  const char* pa = reinterpret_cast<const char*>(pc + h);
  const char* ga = reinterpret_cast<const char*>(gc + h);
  char* oa = reinterpret_cast<char*>(oc + h);
  const uint32_t zsh = offset16(za), psh = offset16(pa);
  const int64_t row = d * static_cast<int64_t>(sizeof(T));
  const int64_t r0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32) * kRuns;
  if (r0 >= nb) return;  // the whole warp
  float acc[E];
  sum_run<T, true>(acc, ga + (r0 + lane) * 16, row, n, coef, coef + n, lane,
                   r0 + lane, nb);
  // z and p wait for the sum: held through it, an int8 run's 4 vectors of
  // each would cost a block per SM
  uint4 zv[W], pv[W];
  load_span<W>(zv, za - zsh + r0 * 16 * W, zsh, lane, r0, nb);
  load_span<W>(pv, pa - psh + r0 * 16 * W, psh, lane, r0, nb);
  uint32_t zw[4 * W], pw[4 * W];
  realign_span<W>(zw, zv, zsh, lane);
  realign_span<W>(pw, pv, psh, lane);
  // the sums in slot order: run l's E sums are slots W*l .. W*l + W-1
  float a[4 * W];
  if (W == 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) a[e] = acc[e];
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      x[W * lane + i] = make_float4(acc[4 * i], acc[4 * i + 1],
                                    acc[4 * i + 2], acc[4 * i + 3]);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float4 t = x[32 * k + lane];
      a[4 * k] = t.x;
      a[4 * k + 1] = t.y;
      a[4 * k + 2] = t.z;
      a[4 * k + 3] = t.w;
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = 32 * k + lane;
    if (j >= kRuns * W || r0 + j / W >= nb) continue;
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = __float_as_uint(step(a[4 * k + i], nsc,
                                  __uint_as_float(zw[4 * k + i]),
                                  __uint_as_float(pw[4 * k + i]), etac));
    store16(oa + (r0 * W + j) * 16, make_uint4(o[0], o[1], o[2], o[3]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const T* __restrict__ g, const float* __restrict__ s,
                 const float* __restrict__ z, const float* __restrict__ ns,
                 T* __restrict__ out, int n, int64_t d) {
  constexpr int E = 16 / sizeof(T);  // a run: one 16-byte vector of g, out
  constexpr int W = E / 4;           // its 16-byte vectors of z
  extern __shared__ float coef[];    // [0, n): s
  __shared__ float4 xs[kWarps][32 * W];  // z from slots to runs
  const int c = blockIdx.y;
  stage_rows(coef, s, nullptr, c, n);
  const T* gc = g + static_cast<int64_t>(c) * n * d;
  const float* zc = z + static_cast<int64_t>(c) * d;
  T* oc = out + static_cast<int64_t>(c) * d;
  const float nsc = ns[c];
  const int64_t h = head_of(oc, d);
  const int64_t nb = (d - h) / E;
  if (blockIdx.x == 0) {
    const int64_t tail = h + nb * E;
    for (int64_t i = threadIdx.x; i < h + d - tail; i += blockDim.x) {
      const int64_t j = i < h ? i : tail + (i - h);
      store(oc + j,
            __fadd_rn(sum_scalar<T, false>(gc + j, d, n, nullptr, coef),
                      __fmul_rn(nsc, zc[j])));
    }
  }
  const int lane = threadIdx.x & 31;
  float4* x = xs[threadIdx.x / 32];
  const char* za = reinterpret_cast<const char*>(zc + h);
  const char* ga = reinterpret_cast<const char*>(gc + h);
  const uint32_t zsh = offset16(za);
  const int64_t row = d * static_cast<int64_t>(sizeof(T));
  const int64_t r0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32) * kRuns;
  if (r0 >= nb) return;  // the whole warp
  const int64_t r = r0 + lane;
  uint4 zv[W];
  load_span<W>(zv, za - zsh + r0 * 16 * W, zsh, lane, r0, nb);
  float acc[E];
  sum_run<T, false>(acc, ga + r * 16, row, n, nullptr, coef, lane, r, nb);
  uint32_t zw[4 * W];
  realign_span<W>(zw, zv, zsh, lane);
  // z in run order: slots W*l .. W*l + W-1 are run l's
  float zr[E];
  if (W == 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) zr[e] = __uint_as_float(zw[e]);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k)
      x[32 * k + lane] = make_float4(
          __uint_as_float(zw[4 * k]), __uint_as_float(zw[4 * k + 1]),
          __uint_as_float(zw[4 * k + 2]), __uint_as_float(zw[4 * k + 3]));
    __syncwarp();
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float4 t = x[W * lane + i];
      zr[4 * i] = t.x;
      zr[4 * i + 1] = t.y;
      zr[4 * i + 2] = t.z;
      zr[4 * i + 3] = t.w;
    }
  }
  if (lane >= kRuns || r >= nb) return;
  float v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = __fadd_rn(acc[e], __fmul_rn(nsc, zr[e]));
  store16(reinterpret_cast<char*>(oc + h) + r * 16,
          make_uint4(out_word(v, 0, T()), out_word(v, 1, T()),
                     out_word(v, 2, T()), out_word(v, 3, T())));
}

// (D blocks, C): enough warps of kRuns runs for a row's whole runs.
template <typename T>
dim3 grid_of(int c, int64_t d) {
  const int64_t runs = d / (16 / static_cast<int64_t>(sizeof(T)));
  const int64_t warps = (runs + kRuns - 1) / kRuns;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  return dim3(static_cast<unsigned>(blocks > 0 ? blocks : 1),
              static_cast<unsigned>(c));
}

template <typename T>
int launch_round_step(const void* g, const void* qs, const void* s,
                      const void* z, const void* ns, const void* p,
                      const void* eta, void* out, int c, int n, int64_t d,
                      void* stream) {
  if (c > 0 && d > 0) {
    round_step_kernel<T><<<grid_of<T>(c, d), kThreads, 2 * n * sizeof(float),
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
    aggregate_kernel<T><<<grid_of<T>(c, d), kThreads, n * sizeof(float),
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
