// Hopper (sm_90a) kernel K4: the Mamba-2 SSD chunk scan, for every layer of
// a mamba2 prefill, with the state in and out.
//
//   S_t = exp(dt_t a) S_{t-1} + dt_t x_t (x) B_t        S [P, N], S_0 = state0
//   y_t = S_t C_t
//   per (batch b, head h), with B_t, C_t of group h / (H / G).
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan_pallas (body _ssd_kernel)
// and computes what it computes, in the chunked (state-space duality) form:
// within a tile of rows the masked C B^T with decay exp(cum_i - cum_j), times
// dt-weighted x, plus exp(cum_i) C S_in; across tiles the [P, N] state.  The
// Pallas kernel starts from zero and returns y only; this one also takes
// state0 and writes the final state, which the model's prefill stashes for
// decode.  Layouts are the reference's: x, y [B, S, H, P]; dt [B, S, H];
// a_neg [H] f32; B, C [B, S, G, N]; state0, state [B, H, P, N] f32.
//
// Bound: at the main-path shape (B 8, S 1024, H 64, P 64, N 128, G 1, f32,
// no state in) the chunked form needs 17.9 GFLOP at the tile length that
// needs fewest, 13 rows (C B^T once per group, the lower triangles only,
// C S_in, the state's decay and update), 0.27 ms at the f32 FMA peak of
// 67 TFLOP/s, and moves 295.7 MB (x and y dominate), 0.088 ms at
// 3.35 TB/s: operations bound it.  TF32 or bf16 products would miss the f32 tolerance, so the
// simple design computes on the f32 FMA units.
//
// What this design does about it: every product stays on chip and the
// state never goes back to device memory until the end.
//   - one block per (head, batch) walks the sequence in tiles of kQ = 64
//     rows (the Pallas body uses the chunk, 128; the SSD form is exact for
//     any tile, so the tile length changes rounding only) with the state in
//     shared memory;
//   - per tile: B, C (row stride N + 1 against bank conflicts) and dt-weighted
//     x are staged in shared memory; one warp scans dt a; then one pass over
//     N computes C B^T (the decay applied only inside the causal triangle,
//     where exp(cum_i - cum_j) <= 1; above it the difference may overflow)
//     and C S_in together; then att (dt x) over the triangle only, and the
//     state update exp(seg) S + B^T diag(exp(seg - cum_j)) (dt x);
//   - 256 threads, each owning 4 rows x P/16 columns of y, 4 x 4 scores and
//     P/16 x N/16 elements of the state;
//   - rows past S read as zero with dt = 0, as the reference's padding: the
//     state is exact and no y row past S is written;
//   - head h reads group h / (H / G) in place (no repeated copies).
// Tensor cores (mma.sync, then wgmma) are later work.
//
// Plain C interface for ctypes: every pointer and the stream are void*,
// and each entry returns a cudaError_t as an int (0 = launched).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 64;            // rows per tile
constexpr int kThreads = 256;
constexpr int kLanes = 16;        // threads across columns
constexpr int kRows = 4;          // y and score rows per thread
constexpr int kJc = kQ / kLanes;  // score columns per thread
constexpr int kLdA = kQ + 1;      // row stride of the att tile

static_assert(kQ == kRows * (kThreads / kLanes), "row groups cover a tile");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// Shared-memory layout, in floats.
template <int P, int N>
struct Smem {
  static constexpr int kLdN = N + 1;
  static constexpr int c = 0;                    // C tile [kQ][N + 1]
  static constexpr int b = c + kQ * kLdN;        // B tile [kQ][N + 1]
  static constexpr int xw = b + kQ * kLdN;       // dt x   [kQ][P]
  static constexpr int att = xw + kQ * P;        // masked scores [kQ][kQ + 1]
  static constexpr int s = att + kQ * kLdA;      // state  [P][N + 1]
  static constexpr int cum = s + P * kLdN;       // running sum of dt a [kQ]
  static constexpr int ecum = cum + kQ;          // exp(cum_i)
  static constexpr int win = ecum + kQ;          // exp(seg - cum_j)
  static constexpr int total = win + kQ;
  static constexpr size_t bytes = sizeof(float) * total;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ a_neg, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ state0,
                T* __restrict__ y, float* __restrict__ state_out, int seq,
                int h, int g) {
  using L = Smem<P, N>;
  constexpr int kLdN = L::kLdN;
  constexpr int kPc = P / kLanes;   // y columns; state rows per thread
  constexpr int kNc = N / kLanes;   // state columns per thread
  extern __shared__ float smem[];
  float* c_s = smem + L::c;
  float* b_s = smem + L::b;
  float* xw_s = smem + L::xw;
  float* att_s = smem + L::att;
  float* s_s = smem + L::s;
  float* cum_s = smem + L::cum;
  float* ecum_s = smem + L::ecum;
  float* win_s = smem + L::win;

  const int tid = threadIdx.x;
  const int ty = tid / kLanes;
  const int tx = tid % kLanes;
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = head / (h / g);
  const float a = a_neg[head];

  const int64_t x_row = static_cast<int64_t>(h) * P;    // one x / y row
  const int64_t bc_row = static_cast<int64_t>(g) * N;   // one B / C row
  const T* xb = x + (static_cast<int64_t>(b) * seq * h + head) * P;
  T* yb = y + (static_cast<int64_t>(b) * seq * h + head) * P;
  const T* dtb = dt + static_cast<int64_t>(b) * seq * h + head;
  const T* bb = bm + (static_cast<int64_t>(b) * seq * g + grp) * N;
  const T* cb = cm + (static_cast<int64_t>(b) * seq * g + grp) * N;
  const int64_t st_off = (static_cast<int64_t>(b) * h + head) * P * N;

  for (int e = tid; e < P * N; e += kThreads)
    s_s[(e / N) * kLdN + e % N] = state0 ? state0[st_off + e] : 0.f;

  for (int t0 = 0; t0 < seq; t0 += kQ) {
    __syncthreads();  // the state is staged; the last tile's readers are done
    // stage the tile; rows past S are zero with dt = 0
    if (tid < kQ) {
      const int t = t0 + tid;
      cum_s[tid] = t < seq ? to_f32(dtb[t * static_cast<int64_t>(h)]) * a
                           : 0.f;
    }
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int r = e / N, n = e % N, t = t0 + r;
      float bv = 0.f, cv = 0.f;
      if (t < seq) {
        bv = to_f32(bb[t * bc_row + n]);
        cv = to_f32(cb[t * bc_row + n]);
      }
      b_s[r * kLdN + n] = bv;
      c_s[r * kLdN + n] = cv;
    }
    for (int e = tid; e < kQ * P; e += kThreads) {
      const int r = e / P, p = e % P, t = t0 + r;
      xw_s[e] = t < seq ? to_f32(xb[t * x_row + p]) *
                              to_f32(dtb[t * static_cast<int64_t>(h)])
                        : 0.f;
    }
    __syncthreads();

    // running sum of dt a over the tile (one warp, two rows a lane), then
    // exp(cum_i) and exp(seg - cum_j), seg = cum of the tile's last row
    if (tid < 32) {
      const float v0 = cum_s[2 * tid], v1 = cum_s[2 * tid + 1];
      float incl = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) before = 0.f;
      const float c0 = before + v0, c1 = c0 + v1;
      const float seg = __shfl_sync(0xffffffffu, c1, 31);
      cum_s[2 * tid] = c0;
      cum_s[2 * tid + 1] = c1;
      ecum_s[2 * tid] = expf(c0);
      ecum_s[2 * tid + 1] = expf(c1);
      win_s[2 * tid] = expf(seg - c0);
      win_s[2 * tid + 1] = expf(seg - c1);
    }
    __syncthreads();

    // one pass over N: scores C_i . B_j and the inter-tile term C_i . S[p]
    float sc[kRows][kJc], yacc[kRows][kPc];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kJc; ++j) sc[r][j] = 0.f;
#pragma unroll
      for (int c = 0; c < kPc; ++c) yacc[r][c] = 0.f;
    }
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[kRows], bv[kJc], sv[kPc];
#pragma unroll
      for (int r = 0; r < kRows; ++r) cv[r] = c_s[(ty * kRows + r) * kLdN + n];
#pragma unroll
      for (int j = 0; j < kJc; ++j) bv[j] = b_s[(tx + kLanes * j) * kLdN + n];
#pragma unroll
      for (int c = 0; c < kPc; ++c) sv[c] = s_s[(tx + kLanes * c) * kLdN + n];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int j = 0; j < kJc; ++j) sc[r][j] = fmaf(cv[r], bv[j], sc[r][j]);
#pragma unroll
        for (int c = 0; c < kPc; ++c)
          yacc[r][c] = fmaf(cv[r], sv[c], yacc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = ty * kRows + r;
      const float ci = cum_s[i], ei = ecum_s[i];
#pragma unroll
      for (int j = 0; j < kJc; ++j) {
        const int jj = tx + kLanes * j;
        att_s[i * kLdA + jj] =
            jj <= i ? sc[r][j] * expf(ci - cum_s[jj]) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < kPc; ++c) yacc[r][c] *= ei;
    }
    __syncthreads();

    // intra-tile term att (dt x), over the triangle only: a warp's rows end
    // at ((ty | 1) + 1) * kRows - 1
    const int j_end = ((ty | 1) + 1) * kRows;
    for (int jj = 0; jj < j_end; ++jj) {
      float xv[kPc];
#pragma unroll
      for (int c = 0; c < kPc; ++c) xv[c] = xw_s[jj * P + tx + kLanes * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float av = att_s[(ty * kRows + r) * kLdA + jj];
#pragma unroll
        for (int c = 0; c < kPc; ++c) yacc[r][c] = fmaf(av, xv[c], yacc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + ty * kRows + r;
      if (t >= seq) continue;
#pragma unroll
      for (int c = 0; c < kPc; ++c)
        store(&yb[t * x_row + tx + kLanes * c], yacc[r][c]);
    }

    // state update: S[p][n] = exp(seg) S[p][n] + sum_j w_j xw[j][p] B[j][n];
    // no thread reads S in this phase, each writes only its own elements
    float acc[kPc][kNc];
#pragma unroll
    for (int q = 0; q < kPc; ++q)
#pragma unroll
      for (int c = 0; c < kNc; ++c) acc[q][c] = 0.f;
#pragma unroll 2
    for (int jj = 0; jj < kQ; ++jj) {
      const float w = win_s[jj];
      float xv[kPc], bv[kNc];
#pragma unroll
      for (int q = 0; q < kPc; ++q) xv[q] = xw_s[jj * P + ty + kLanes * q] * w;
#pragma unroll
      for (int c = 0; c < kNc; ++c) bv[c] = b_s[jj * kLdN + tx + kLanes * c];
#pragma unroll
      for (int q = 0; q < kPc; ++q)
#pragma unroll
        for (int c = 0; c < kNc; ++c) acc[q][c] = fmaf(xv[q], bv[c], acc[q][c]);
    }
    const float seg_decay = expf(cum_s[kQ - 1]);
#pragma unroll
    for (int q = 0; q < kPc; ++q)
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        float* sp = &s_s[(ty + kLanes * q) * kLdN + tx + kLanes * c];
        *sp = fmaf(*sp, seg_decay, acc[q][c]);
      }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads)
    state_out[st_off + e] = s_s[(e / N) * kLdN + e % N];
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* a_neg, const void* bm,
           const void* cm, const void* state0, void* y, void* state_out,
           int batch, int seq, int h, int g, void* stream) {
  constexpr size_t smem = Smem<P, N>::bytes;
  auto kernel = ssd_scan_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, batch);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(a_neg), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(state0),
      static_cast<T*>(y), static_cast<float*>(state_out), seq, h, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int dispatch_n(int n, const void* x, const void* dt, const void* a_neg,
               const void* bm, const void* cm, const void* state0, void* y,
               void* state_out, int batch, int seq, int h, int g,
               void* stream) {
  switch (n) {
    case 32: return launch<T, P, 32>(x, dt, a_neg, bm, cm, state0, y,
                                     state_out, batch, seq, h, g, stream);
    case 64: return launch<T, P, 64>(x, dt, a_neg, bm, cm, state0, y,
                                     state_out, batch, seq, h, g, stream);
    case 96: return launch<T, P, 96>(x, dt, a_neg, bm, cm, state0, y,
                                     state_out, batch, seq, h, g, stream);
    case 128: return launch<T, P, 128>(x, dt, a_neg, bm, cm, state0, y,
                                       state_out, batch, seq, h, g, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* a_neg, const void* bm,
             const void* cm, const void* state0, void* y, void* state_out,
             int batch, int seq, int h, int g, int p, int n, void* stream) {
  if (batch < 1 || seq < 1 || h < 1 || g < 1 || h % g)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (p) {
    case 32: return dispatch_n<T, 32>(n, x, dt, a_neg, bm, cm, state0, y,
                                      state_out, batch, seq, h, g, stream);
    case 64: return dispatch_n<T, 64>(n, x, dt, a_neg, bm, cm, state0, y,
                                      state_out, batch, seq, h, g, stream);
    case 96: return dispatch_n<T, 96>(n, x, dt, a_neg, bm, cm, state0, y,
                                      state_out, batch, seq, h, g, stream);
    case 128: return dispatch_n<T, 128>(n, x, dt, a_neg, bm, cm, state0, y,
                                        state_out, batch, seq, h, g, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// state0 may be null (a zero state).
int ssd_scan_f32(const void* x, const void* dt, const void* a_neg,
                 const void* bm, const void* cm, const void* state0, void* y,
                 void* state_out, int batch, int seq, int h, int g, int p,
                 int n, void* stream) {
  return dispatch<float>(x, dt, a_neg, bm, cm, state0, y, state_out, batch,
                         seq, h, g, p, n, stream);
}

int ssd_scan_bf16(const void* x, const void* dt, const void* a_neg,
                  const void* bm, const void* cm, const void* state0, void* y,
                  void* state_out, int batch, int seq, int h, int g, int p,
                  int n, void* stream) {
  return dispatch<__nv_bfloat16>(x, dt, a_neg, bm, cm, state0, y, state_out,
                                 batch, seq, h, g, p, n, stream);
}

}  // extern "C"
