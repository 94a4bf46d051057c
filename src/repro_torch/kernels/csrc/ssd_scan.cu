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
// C S_in, the state's decay and update), and moves 295.7 MB (x and y
// dominate), 0.088 ms at 3.35 TB/s.  On the f32 FMA units (67 TFLOP/s)
// the operations take 0.267 ms; as three TF32 products on the tensor cores
// (495 TFLOP/s dense) 0.108 ms, which is the bound.
//
// Precision: the products run on mma.sync m16n8k8 TF32 with f32
// accumulators.  TF32 keeps 11 bits of the significand, and one pass
// misses the f32 tolerance the port holds K4 to (1e-4 of the largest
// output plus 2e-4 relative) two- to threefold.  So each operand is split
// in registers as it leaves shared memory, big = v rounded to TF32 and
// small = v - big rounded to TF32 (cvt.rna.tf32.f32's rounding), and each
// product is small.big + big.small + big.big (3xTF32; small.small, ~2^-22
// relative, is dropped): that carries the operands to ~2^-22, as near to
// f32 as its own rounding (tests/test_torch_ssm.py emulates both on the
// CPU).  TF32 rounding enters only there: the running sums of dt a, the
// exps, the mask and the decays stay in f32 on the FMA units.
//
// What this design does about it: every product stays on chip and the
// state never goes back to device memory until the end.
//   - one block per (head, batch) walks the sequence in tiles of kQ = 64
//     rows (the Pallas body uses the chunk, 128; the SSD form is exact for
//     any tile, so the tile length changes rounding only) with the state in
//     shared memory;
//   - per tile, 8 warps: B, C and dt-weighted x are staged in shared memory
//     (16-byte loads, all of a thread's issued before its stores; rows
//     padded so that fragment loads hit 32 banks); one warp scans dt a;
//     then three products on the tensor cores:
//       1. C [64 x N] times [B_tile; S]^T, one pass over N that gives the
//          scores C B^T and C S_in^T together (each warp 16 rows, half the
//          columns), the scores masked and decayed only inside the causal
//          triangle (where exp(cum_i - cum_j) <= 1; above it the difference
//          may overflow), C S_in^T scaled by exp(cum_i) in the registers;
//       2. att [64 x 64] times (dt x) [64 x P] onto those same fragments,
//          skipping k-steps above a warp's rows; y leaves from them;
//       3. the state update S = exp(seg) S + (w o dt x)^T B_tile [P x N],
//          w_j = exp(seg - cum_j), its accumulator started as exp(seg) S
//          and written back for the next tile's pass;
//   - rows past S read as zero with dt = 0, as the reference's padding: the
//     state is exact and no y row past S is written;
//   - head h reads group h / (H / G) in place (no repeated copies).
// wgmma, two blocks per SM, cp.async staging and strided loads are later
// work.
//
// Plain C interface for ctypes: every pointer and the stream are void*,
// and each entry returns a cudaError_t as an int (0 = launched).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 64;            // rows per tile
constexpr int kThreads = 256;     // 8 warps

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive inputs as f32: 16 bytes of f32, 8 of bf16
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// two adjacent outputs (an accumulator fragment's column pair)
__device__ __forceinline__ void store2(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float v0,
                                       float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// TF32 operand halves: big = v rounded to TF32, small = the rounding of
// v - big (exact in f32); big + small carries v to ~2^-22 relative.  The
// rounding is cvt.rna.tf32.f32's (to nearest on the 13 dropped bits, ties
// away from zero), written as integer operations: for a finite v it is the
// same, and ptxas expands cvt.rna into a NaN/inf test and a predicated add
// besides (three instructions a value, on the operands of every product).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// d += a b, one m16n8k8 TF32 product with an f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: small.big and big.small into the accumulator first, then
// big.big; small.small (~2^-22 relative) is dropped
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big[0], b_big[1]);
  mma_tf32(d, a_big, b_small[0], b_small[1]);
  mma_tf32(d, a_big, b_big[0], b_big[1]);
}

// Shared-memory layout, in floats.  Tiles are row-major with padded rows.
// An m16n8k8 fragment load reads an 8 x 4 patch: 8 rows (lane / 4) by 4
// columns (lane % 4) of C, [B; S] and att, or 4 rows by 8 columns of dt x
// (and of B in the state update).  A row stride of 4 mod 32 words puts the
// first kind on 32 banks, one of 8 mod 32 the second; B, read both ways,
// takes 4, and its loads in the state update fall two lanes to a bank.
template <int P, int N>
struct Smem {
  static constexpr int ldn = N + 4;              // C, B and S rows
  static constexpr int ldx = P + 8;              // dt x rows
  static constexpr int lda = kQ + 4;             // att rows
  static constexpr int c = 0;                    // C tile [kQ][N]
  static constexpr int bs = c + kQ * ldn;        // B tile [kQ][N], then the
                                                 // state S [P][N]
  static constexpr int xw = bs + (kQ + P) * ldn; // dt x   [kQ][P]
  static constexpr int att = xw + kQ * ldx;      // masked scores [kQ][kQ]
  static constexpr int cum = att + kQ * lda;     // running sum of dt a [kQ]
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
  constexpr int kLdN = L::ldn, kLdX = L::ldx, kLdA = L::lda;
  // C [B; S]^T and att (dt x): each warp takes 16 rows and half the
  // columns, 4 score n-tiles of 8 and P / 16 y n-tiles (the same for both
  // products, so att (dt x) accumulates onto C S^T)
  constexpr int kScoreTiles = kQ / 16;
  constexpr int kYTiles = P / 16;
  constexpr int kTiles1 = kScoreTiles + kYTiles;
  // the state update [P x N]: each warp takes P / 32 m-tiles of 16 rows
  // and N / 32 n-tiles of 8
  constexpr int kSm = P / 32;
  constexpr int kSn = N / 32;
  // staging: float4s of B (and of C) and of x per thread
  constexpr int kStage = kQ * N / 4 / kThreads;
  constexpr int kStageX = kQ * P / 4 / kThreads;
  extern __shared__ float smem[];
  float* c_s = smem + L::c;
  float* bs_s = smem + L::bs;       // rows 0..kQ-1: B tile; kQ..: the state
  float* s_s = bs_s + kQ * kLdN;
  float* xw_s = smem + L::xw;
  float* att_s = smem + L::att;
  float* cum_s = smem + L::cum;
  float* ecum_s = smem + L::ecum;
  float* win_s = smem + L::win;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int grp = lane / 4;         // fragment row (A) / column (B)
  const int tig = lane % 4;         // fragment column (A) / row (B)
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int group = head / (h / g);
  const float a = a_neg[head];

  const int64_t x_row = static_cast<int64_t>(h) * P;    // one x / y row
  const int64_t bc_row = static_cast<int64_t>(g) * N;   // one B / C row
  const T* xb = x + (static_cast<int64_t>(b) * seq * h + head) * P;
  T* yb = y + (static_cast<int64_t>(b) * seq * h + head) * P;
  const T* dtb = dt + static_cast<int64_t>(b) * seq * h + head;
  const T* bb = bm + (static_cast<int64_t>(b) * seq * g + group) * N;
  const T* cb = cm + (static_cast<int64_t>(b) * seq * g + group) * N;
  const int64_t st_off = (static_cast<int64_t>(b) * h + head) * P * N;

  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    s_s[p * kLdN + n] = state0 ? state0[st_off + e] : 0.f;
  }

  // this warp's rows and columns: of the tile's rows and [scores | y]
  // (row0, half), and of the state (p_base, n_base)
  const int row0 = (warp / 2) * 16;
  const int half = warp % 2;
  const int p_base = (warp / 4) * (P / 2);
  const int n_base = (warp % 4) * (N / 4);

  for (int t0 = 0; t0 < seq; t0 += kQ) {
    __syncthreads();  // the state is staged; the last tile's readers are done
    // stage the tile; rows past S are zero with dt = 0
    if (tid < kQ) {
      const int t = t0 + tid;
      cum_s[tid] = t < seq ? to_f32(dtb[t * static_cast<int64_t>(h)]) * a
                           : 0.f;
    }
    // four elements a load, every load of the tile issued before the first
    // store to shared memory
    float4 bv[kStage], cv[kStage], xv[kStageX];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int v = tid + u * kThreads, r = v / (N / 4), t = t0 + r;
      const int n = 4 * (v % (N / 4));
      bv[u] = cv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < seq) {
        bv[u] = load4(bb + t * bc_row + n);
        cv[u] = load4(cb + t * bc_row + n);
      }
    }
#pragma unroll
    for (int u = 0; u < kStageX; ++u) {
      const int v = tid + u * kThreads, r = v / (P / 4), t = t0 + r;
      const int p = 4 * (v % (P / 4));
      xv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < seq) {
        const float d = to_f32(dtb[t * static_cast<int64_t>(h)]);
        const float4 xr = load4(xb + t * x_row + p);
        xv[u] = make_float4(xr.x * d, xr.y * d, xr.z * d, xr.w * d);
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int v = tid + u * kThreads, r = v / (N / 4);
      const int at = r * kLdN + 4 * (v % (N / 4));
      *reinterpret_cast<float4*>(&bs_s[at]) = bv[u];
      *reinterpret_cast<float4*>(&c_s[at]) = cv[u];
    }
#pragma unroll
    for (int u = 0; u < kStageX; ++u) {
      const int v = tid + u * kThreads, r = v / (P / 4);
      *reinterpret_cast<float4*>(&xw_s[r * kLdX + 4 * (v % (P / 4))]) = xv[u];
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

    // one pass over N on the tensor cores: C [kQ x N] times the B tile and
    // the state stacked, [kQ + P x N]^T, gives the scores C_i . B_j and
    // the inter-tile term C_i . S[p] together
    float acc[kTiles1][4];
#pragma unroll
    for (int q = 0; q < kTiles1; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < N; k0 += 8) {
      uint32_t a_big[4], a_small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + grp + 8 * (e & 1);
        const int k = k0 + tig + 4 * (e >> 1);
        split_tf32(c_s[r * kLdN + k], a_big[e], a_small[e]);
      }
#pragma unroll
      for (int q = 0; q < kTiles1; ++q) {
        const int j = (q < kScoreTiles
                           ? half * (kQ / 2) + 8 * q
                           : kQ + half * (P / 2) + 8 * (q - kScoreTiles)) +
                      grp;
        uint32_t b_big[2], b_small[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + tig + 4 * e;
          split_tf32(bs_s[j * kLdN + k], b_big[e], b_small[e]);
        }
        mma_3xtf32(acc[q], a_big, a_small, b_big, b_small);
      }
    }
    __syncthreads();  // cum, ecum and win are written; S is read
    // scores: masked, decayed only inside the causal triangle (where
    // exp(cum_i - cum_j) <= 1; above it the difference may overflow);
    // C S^T scaled by exp(cum_i) in the registers
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = row0 + grp + 8 * hi;
      const float ci = cum_s[i], ei = ecum_s[i];
#pragma unroll
      for (int q = 0; q < kScoreTiles; ++q) {
        const int j = half * (kQ / 2) + 8 * q + 2 * tig;
        float2 v;
        v.x = j <= i ? acc[q][2 * hi] * expf(ci - cum_s[j]) : 0.f;
        v.y = j + 1 <= i ? acc[q][2 * hi + 1] * expf(ci - cum_s[j + 1])
                         : 0.f;
        *reinterpret_cast<float2*>(&att_s[i * kLdA + j]) = v;
      }
#pragma unroll
      for (int q = kScoreTiles; q < kTiles1; ++q) {
        acc[q][2 * hi] *= ei;
        acc[q][2 * hi + 1] *= ei;
      }
    }
    __syncthreads();  // att is written

    // intra-tile term: y += att (dt x) onto the C S^T fragments, over the
    // causal triangle only (k-steps past this warp's last row are zero)
    for (int k0 = 0; k0 < row0 + 16; k0 += 8) {
      uint32_t a_big[4], a_small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + grp + 8 * (e & 1);
        const int k = k0 + tig + 4 * (e >> 1);
        split_tf32(att_s[r * kLdA + k], a_big[e], a_small[e]);
      }
#pragma unroll
      for (int q = kScoreTiles; q < kTiles1; ++q) {
        const int p = half * (P / 2) + 8 * (q - kScoreTiles) + grp;
        uint32_t b_big[2], b_small[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + tig + 4 * e;
          split_tf32(xw_s[k * kLdX + p], b_big[e], b_small[e]);
        }
        mma_3xtf32(acc[q], a_big, a_small, b_big, b_small);
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int t = t0 + row0 + grp + 8 * hi;
      if (t >= seq) continue;
#pragma unroll
      for (int q = kScoreTiles; q < kTiles1; ++q) {
        const int p = half * (P / 2) + 8 * (q - kScoreTiles) + 2 * tig;
        store2(&yb[t * x_row + p], acc[q][2 * hi], acc[q][2 * hi + 1]);
      }
    }

    // state update: S = exp(seg) S + (w o dt x)^T B_tile [P x N], w_j =
    // exp(seg - cum_j); the accumulator starts as exp(seg) S.  Every
    // reader of S passed the last barrier, and each thread reads and
    // writes only its own fragment's elements
    const float seg_decay = expf(cum_s[kQ - 1]);
    float sacc[kSm][kSn][4];
#pragma unroll
    for (int mt = 0; mt < kSm; ++mt)
#pragma unroll
      for (int nt = 0; nt < kSn; ++nt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int p = p_base + 16 * mt + grp + 8 * hi;
          const int n = n_base + 8 * nt + 2 * tig;
          const float2 v =
              *reinterpret_cast<const float2*>(&s_s[p * kLdN + n]);
          sacc[mt][nt][2 * hi] = v.x * seg_decay;
          sacc[mt][nt][2 * hi + 1] = v.y * seg_decay;
        }
#pragma unroll 4
    for (int k0 = 0; k0 < kQ; k0 += 8) {
      uint32_t a_big[kSm][4], a_small[kSm][4];
#pragma unroll
      for (int mt = 0; mt < kSm; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p_base + 16 * mt + grp + 8 * (e & 1);
          const int k = k0 + tig + 4 * (e >> 1);
          split_tf32(xw_s[k * kLdX + p] * win_s[k], a_big[mt][e],
                     a_small[mt][e]);
        }
#pragma unroll
      for (int nt = 0; nt < kSn; ++nt) {
        const int n = n_base + 8 * nt + grp;
        uint32_t b_big[2], b_small[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + tig + 4 * e;
          split_tf32(bs_s[k * kLdN + n], b_big[e], b_small[e]);
        }
#pragma unroll
        for (int mt = 0; mt < kSm; ++mt)
          mma_3xtf32(sacc[mt][nt], a_big[mt], a_small[mt], b_big, b_small);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kSm; ++mt)
#pragma unroll
      for (int nt = 0; nt < kSn; ++nt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int p = p_base + 16 * mt + grp + 8 * hi;
          const int n = n_base + 8 * nt + 2 * tig;
          *reinterpret_cast<float2*>(&s_s[p * kLdN + n]) =
              make_float2(sacc[mt][nt][2 * hi], sacc[mt][nt][2 * hi + 1]);
        }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    state_out[st_off + e] = s_s[p * kLdN + n];
  }
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
