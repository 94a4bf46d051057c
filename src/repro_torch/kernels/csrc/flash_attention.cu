// Hopper (sm_90a) kernel K3: blocked online-softmax GQA attention with
// causal and sliding-window masks, for every prefill of the dense decoders.
//
//   o[b, i, h, :] = sum_j softmax_j(q[b,i,h,:] . k[b,j,h/G,:] / sqrt(Dqk)) v[b,j,h/G,:]
//   over the keys j that i may see: j <= i (causal), j > i - window (window);
//   positions start at 0 for q and for k.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _attn_kernel) and keeps its semantics: masked scores are -1e30, a
// key past Sk gets no weight, the running (m, l, acc) state is f32, and the
// output is acc / max(l, 1e-30) cast to q's dtype.  Layouts are the
// reference's: q [B, Sq, H, Dqk]; k [B, Sk, KH, Dqk]; v [B, Sk, KH, Dv];
// o [B, Sq, H, Dv], H = KH * G.  Instances (Dqk, Dv): (64, 64), (128, 128),
// (256, 256) and MLA's prefill, (192, 128) (deepseek-v3: q and k carry 128
// nope + 64 rope columns, v 128); every kernel is templated on the pair, and
// Dh below stands for both widths of the first three.
//
// MLA's instance (B 8, S 1024, H = KH = 128, causal): 343.6 GFLOP
// (2 B H pairs (Dqk + Dv)), 0.3474 ms at 989 TFLOP/s, against 1.342 GB of
// q, k, v and o, 0.4006 ms at 3.35 TB/s: bound by bytes in bf16; in f32 by
// its 3xTF32 products, ~2.08 ms.
//   bf16: q and k tiles are 3 panels of 64 columns, v and o 2; S = Q.K^T
//   takes 12 k-steps of 16, O += P.V one n128 product a k-step; 64-key
//   tiles in a ring of 3: 48 KB of q (128 rows) + 3 x (24 + 16) KB of K and
//   V = 168 KB, one block per SM; a thread holds the O accumulator (64
//   registers) and a 64-key S tile (32), as the Dh-128 instance with
//   64-key tiles.  The output (128 columns) is staged in the q tile's
//   first two panels.
//   f32: 32-key tiles, as Dh 128 (64-key tiles spill there): q 64 rows x
//   (192 + 16) floats = 53 KB, a ring of two K tiles of 32 x 208 floats
//   and V tiles of 32 x 132, 137 KB in all (a ring of two 64-key tiles
//   would take 222 KB, within 5 KB of the 227 KB limit, and the S tile's
//   32 more registers); one block per SM.
//
// Bound: at the main-path shape (B 8, S 1024, H = KH = 16, Dh 64, bf16,
// causal) bytes and tensor-core operations about equally: 17.2 GFLOP (the
// causal half of 4 B H S^2 Dh), 0.0174 ms at the 989 TFLOP/s bf16 peak,
// against 67.1 MB of q, k, v and o read or written once, 0.0200 ms at
// 3.35 TB/s.  At qwen3's Dh 128 the operations bound (0.0348 ms), and at
// recurrentgemma's Dh 256 (B 8, S 1024, H 16 over KH 1) too: 68.8 GFLOP,
// 0.0695 ms, against 142.6 MB, 0.0426 ms.  Beside the products, each score
// needs one exp: at Dh 64 the SM's 16 exps a clock take as long as its
// tensor cores take for the two products.
//
// bf16 (flash_attention_bf16): wgmma on the tensor cores, fed by TMA.
//   - one block of two warpgroups per (q tile of 128 rows, head, batch);
//     warpgroup cw owns rows 64 cw .. 64 cw + 63; the heaviest causal q
//     tiles are launched first;
//   - thread 0 loads the q tile and a ring of kStages K and V tiles into
//     shared memory by cp.async.bulk.tensor against 4-D tensor maps over
//     [B, S, heads, Dh] (boxes of 64 columns = one 128-byte swizzle atom;
//     Dh 128 is two boxes, Dh 256 four; rows past Sq or Sk read as zero;
//     GQA reads KV head h / G in place); mbarriers count the bytes in;
//   - S = Q.K^T on the unscaled bf16 q and k (exact products, f32 sums;
//     both operands K-major in shared memory), then scaled by 1/sqrt(Dh) in
//     f32, the plain version's order; masks only on tiles that cross the
//     diagonal, the window's edge or Sk; the online softmax in f32
//     registers; P rounded to bf16 in registers is the A operand of
//     O += P.V, V's [keys, Dh] tile the B operand through wgmma's transpose
//     bit (no transposing copy); the accumulator is f32;
//   - the two warpgroups take turns at the tensor cores (named barriers),
//     so one's products overlap the other's softmax; each turn issues
//     P_{t-1}.V_{t-1} and then S_t, and each product group sits between one
//     wgmma fence and one commit with no branch, or the compiler
//     serializes the wgmmas;
//   - key tiles wholly above the causal diagonal or outside the window are
//     never loaded; the output is staged in the q tile's rows and written
//     by a TMA store (rows past Sq are not written);
//   - Dh 64: 64-key tiles, 120 registers, two blocks per SM (one hides the
//     other's start and end); Dh 128: 128-key tiles, one block per SM;
//     Dh 256: 64-key tiles in a ring of two, 240 registers, one block per
//     SM (192 KB of shared memory), P.V as two n128 products per k-step.
//   Precision: bf16 enters where P is rounded for the P.V product (2^-9
//   relative per weight; l sums the f32 p) and in the bf16 output; the
//   plain version rounds only the output.  The rounding of P averages out
//   over the keys, so the two agree within ATTN_BF16_TOL (rtol 1.6e-2,
//   atol 1e-2); tests/test_torch_attention.py emulates it on the CPU.
//
// f32 (flash_attention_f32): both products on the tensor cores, mma.sync
// m16n8k8 TF32 with f32 accumulators, as 3xTF32 (one TF32 pass misses the
// f32 tolerance, 2e-5; tests/test_torch_attention.py emulates both): each
// operand is split in registers into big = v rounded to TF32 and small =
// the rounding of v - big, and each product is small.big + big.small +
// big.big.  Bound at the main shape in f32: 51.6 GFLOP of TF32 products
// (3 x 17.2) at 495 TFLOP/s, 0.1043 ms (on the f32 FMA units 0.2567 ms).
//   - one block of four warps per (q tile of 64 rows, head, batch), each
//     warp 16 rows (one m16 tile); the heaviest causal q tiles first;
//   - K and V tiles of 64 keys (Dh 64) or 32 (Dh 128, 256) come in by
//     cp.async into a double-buffered ring; tiles wholly above the
//     diagonal or outside the window are never loaded;
//   - at Dh 256 two blocks share a q tile and head, each computing S over
//     the whole head dimension and P.V for 128 of the output's columns
//     (1.5x the products of one block, the registers of Dh 128);
//   - q is scaled by log2(e)/sqrt(Dh) in f32 before the product (the
//     plain version scales the product by 1/sqrt(Dh)), read once into
//     shared memory; the softmax takes 2^x (ex2.approx, ~2 ulp) of the
//     f32 scores in base 2, the same weights as exp in base e;
//   - P goes from the score registers into P.V with the keys relabelled
//     within each 8-key slab (see the kernel), never through shared
//     memory;
//   - the tensor cores' accumulator truncates, so each tile's P.V is
//     summed from zero there and added to the running output in f32 (one
//     rounding a tile): the error does not grow with the number of tiles.
// wgmma cannot take this product: it reads TF32 operands from shared
// memory only K-major, and V's [keys, Dh] tile is MN-major as P.V's B.

// Plain C interface for ctypes: every pointer and the stream are void*,
// and each entry returns a cudaError_t as an int (0 = launched).  The
// tensor maps are built in the entry from the pointers and sizes, with
// cuTensorMapEncodeTiled fetched from the driver through the runtime, so
// the library links no more than the runtime.

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; the driver is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's masked score

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, ~2 ulp; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- f32 ----

namespace tf32 {

constexpr int kBQ = 64;           // query rows per block: 4 warps of 16
constexpr int kThreads = 128;
constexpr int kStages = 2;        // K/V tiles in flight

// 16 bytes from global into shared memory, or 16 zero bytes when `in` is
// false (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// TF32 operand halves, K4's rounding (ssd_scan.cu): big = v rounded to
// TF32, small = the rounding of v - big (exact in f32); big + small carries
// v to ~2^-22 relative.  The rounding is cvt.rna.tf32.f32's (to nearest on
// the 13 dropped bits, ties away from zero) for a finite v: add 0x1000 to
// the bit pattern.  The tensor cores read a TF32 operand's top 19 bits and
// ignore the low 13 (CUTLASS's round_half_ulp_truncate leaves them too), so
// the low bits are cleared only where the value itself is needed, v - big:
// four operations a value instead of five.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(v) + 0x1000u;
  small = __float_as_uint(v - __uint_as_float(big & 0xffffe000u)) + 0x1000u;
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

// component i (a constant after unrolling) of a float4
__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The A operand of the k-steps 2j + hk of S = Q.K^T from the q slab
// qv[j] = (row g, row g + 8) x columns 16 j + 4 t .. + 3: A's column t is
// column 16 j + 4 t + 2 hk, its column t + 4 the next one
__device__ __forceinline__ void split_q(const float4 (&qv)[2], int hk,
                                        uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
  split_tf32(part(qv[0], 2 * hk), big[0], small[0]);
  split_tf32(part(qv[1], 2 * hk), big[1], small[1]);
  split_tf32(part(qv[0], 2 * hk + 1), big[2], small[2]);
  split_tf32(part(qv[1], 2 * hk + 1), big[3], small[3]);
}

// Keys per K/V tile, output columns per block and shared-memory row
// strides (floats).  K and q rows of D + 16 floats put a quad's 16-byte
// reads of 8 rows (K[g][16 j + 4 t]) on 32 banks; V rows of DV + 4 put both
// 16-byte reads (V[2 t][32 c + 4 g] and V[2 t + 1][...]) on 32 banks; every
// row stays 16-byte aligned for cp.async.  Two blocks share an SM (94 KB
// and 106 KB of shared memory; 175 and 234 registers).  At Dh 128, 64-key
// tiles spill and leave one block per SM.  At Dh 256 a warp's 16 x 256
// output alone would take 128 registers a lane, so the output's columns
// are split over two blocks (kSplit): each computes S over the whole head
// dimension and P.V for its 128 columns (1.5x the products), with the
// registers of Dh 128 (235); its 173 KB of shared memory leave one block
// per SM.  MLA's (192, 128): q and K rows of 208 floats (the same banks as
// D + 16), 32-key tiles, 137 KB, one block per SM.
template <int DQK, int DV>
struct Tile {
  static constexpr int kKeys = DQK == 64 ? 64 : 32;
  static constexpr int kDV = DV > 128 ? 128 : DV;  // output columns a block
  static constexpr int kSplit = DV / kDV;          // blocks per q tile and head
  static constexpr int kLdK = DQK + 16;
  static constexpr int kLdV = kDV + 4;
  // one cp.async loop fills a K row and the V row beside it
  static constexpr bool kFused = DV == DQK && kDV == DV;
  static constexpr size_t kBytes =
      sizeof(float) * (kStages * kKeys * (kLdK + kLdV) + kBQ * kLdK);
  static_assert(kKeys * DQK / 4 % kThreads == 0, "whole 16-byte chunks a thread");
  static_assert(kKeys * kDV / 4 % kThreads == 0, "whole 16-byte chunks a thread");
  static_assert(kBytes <= 232448, "over the 227 KB of shared memory a block");
};

// Four warps, each owning 16 of the block's 64 q rows (one m16 tile), walk
// the key tiles from the last (the diagonal) down.  Per tile:
//   S = Q.K^T on mma.sync m16n8k8 in 3xTF32.  The head dimension is the
//     product's depth, relabelled within each 16-column slab so that one
//     16-byte read gives a lane the operands of two k-steps: k-step 2 j +
//     hk takes columns 16 j + 4 t + 2 hk (A's column t) and + 1 (column
//     t + 4), for q (the A operand) and K[key][d] (the .col B operand),
//     both in shared memory and split as they are read;
//   the online softmax on the f32 score fragments (row max and sum over a
//     quad by __shfl_xor_sync), masks only on edge tiles;
//   O = alpha O + P.V with P straight from the score registers: in the
//     accumulator lane (g, t) holds keys 2 t and 2 t + 1 of each 8-key
//     slab, so A's column t is key 2 t and column t + 4 key 2 t + 1, and
//     V's B fragment is read in the same order (rows 2 t, 2 t + 1).  The
//     tile's P.V is summed from zero on the tensor cores and added to O
//     in f32.  The output columns are relabelled within each 32-column
//     group: n-tile u's column g is 32 c + 4 g + u, so one 16-byte read of
//     a V row feeds four n-tiles and a lane's 8 outputs of a row land on
//     8 adjacent columns.
// K and V tiles come in by cp.async into a ring of kStages, the next tile
// in flight while this one computes; tiles wholly above the diagonal or
// outside the window are never loaded; rows past Sk read as zero.  At Dh
// 256 a block owns the output columns kDV ch .. kDV ch + kDV - 1 and loads
// only those columns of V.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel_f32(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int nb, int sq, int sk, int h, int kh, int causal,
                           int window, float scale) {
  using T = Tile<DQK, DV>;
  constexpr int kBK = T::kKeys;
  constexpr int kDV = T::kDV;
  constexpr int kLdK = T::kLdK, kLdV = T::kLdV;
  constexpr int kNT = kBK / 8;  // n8 tiles of S; k-steps of P.V
  constexpr int kJ = DQK / 16;  // 16-column slabs of q and K
  constexpr int kC = kDV / 32;  // 32-column groups of V and o
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                          // [kStages][kBK][kLdK]
  float* v_s = smem + kStages * kBK * kLdK;   // [kStages][kBK][kLdV]
  float* q_s = v_s + kStages * kBK * kLdV;    // [kBQ][kLdK]

  // heaviest causal q tiles first: blocks start in order of their index;
  // the kSplit blocks of one q tile and head are neighbours
  const int n_bh = nb * h;
  const int ch = blockIdx.x % T::kSplit;      // this block's output columns
  const int bid = blockIdx.x / T::kSplit;
  const int q0 = ((sq + kBQ - 1) / kBQ - 1 - bid / n_bh) * kBQ;
  const int head = bid % n_bh % h;
  const int b = bid % n_bh / h;
  const int kv_head = head / (h / kh);
  const int64_t q_stride = static_cast<int64_t>(h) * DQK;   // one q row
  const int64_t o_stride = static_cast<int64_t>(h) * DV;    // one o row
  const int64_t k_stride = static_cast<int64_t>(kh) * DQK;  // one k row
  const int64_t v_stride = static_cast<int64_t>(kh) * DV;   // one v row
  const float* qb = q + (static_cast<int64_t>(b) * sq * h + head) * DQK;
  float* ob = o + (static_cast<int64_t>(b) * sq * h + head) * DV + ch * kDV;
  const float* kb = k + (static_cast<int64_t>(b) * sk * kh + kv_head) * DQK;
  const float* vb =
      v + (static_cast<int64_t>(b) * sk * kh + kv_head) * DV + ch * kDV;

  // the key tiles that some query row of this tile may see; tile r of the
  // walk starts at key (t_last - r) * kBK
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_last = (k_end - 1) / kBK;
  const int n_tiles = t_last - k_begin / kBK + 1;

  const int tid = threadIdx.x;
  auto load_tile = [&](int r) {
    // the thread index read anew: else the compiler keeps every chunk's
    // offsets live through the loop (Dh 128 then spills at 255 registers)
    int thread;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(thread));
    const int k0 = (t_last - r) * kBK;
    float* kd = k_s + (r % kStages) * kBK * kLdK;
    float* vd = v_s + (r % kStages) * kBK * kLdV;
#pragma unroll
    for (int u = 0; u < kBK * DQK / 4 / kThreads; ++u) {
      const int e = thread + u * kThreads;
      const int row = e / (DQK / 4), c = 4 * (e % (DQK / 4));
      const bool in = k0 + row < sk;
      const int64_t src = (in ? k0 + row : 0) * k_stride + c;
      cp_async16(kd + row * kLdK + c, kb + src, in);
      if constexpr (T::kFused) cp_async16(vd + row * kLdV + c, vb + src, in);
    }
    if constexpr (!T::kFused) {  // this block's columns of V
#pragma unroll
      for (int u = 0; u < kBK * kDV / 4 / kThreads; ++u) {
        const int e = thread + u * kThreads;
        const int row = e / (kDV / 4), c = 4 * (e % (kDV / 4));
        const bool in = k0 + row < sk;
        cp_async16(vd + row * kLdV + c,
                   vb + (in ? k0 + row : 0) * v_stride + c, in);
      }
    }
    cp_async_commit();
  };
  load_tile(0);

  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + 16 * warp + g;  // this lane's rows: row, row + 8

  // q scaled by log2(e)/sqrt(Dqk) in f32 before the product (rows past Sq
  // zero) into q_s: the lane's rows, columns 16 j + 4 t .. + 3, which the
  // same lane reads back (the loop's first barrier orders them)
  float* q_row = q_s + (16 * warp + g) * kLdK + 4 * t;  // rows g, g + 8
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row + 8 * i < sq)
        x = *reinterpret_cast<const float4*>(qb + (row + 8 * i) * q_stride +
                                             16 * j + 4 * t);
      *reinterpret_cast<float4*>(q_row + 8 * i * kLdK + 16 * j) =
          make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }

  float acc[kDV / 8][4];
#pragma unroll
  for (int n = 0; n < kDV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int r = 0; r < n_tiles; ++r) {
    if (r + 1 < n_tiles) {
      load_tile(r + 1);  // into the slot tile r - 1 left (all warps are done)
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile r is in shared memory for every warp
    const float* kt = k_s + (r % kStages) * kBK * kLdK;
    const float* vt = v_s + (r % kStages) * kBK * kLdV;

    // S = Q.K^T
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float4 qx[2] = {
          *reinterpret_cast<const float4*>(q_row + 16 * j),
          *reinterpret_cast<const float4*>(q_row + 8 * kLdK + 16 * j)};
      uint32_t a_big[2][4], a_small[2][4];
      split_q(qx, 0, a_big[0], a_small[0]);
      split_q(qx, 1, a_big[1], a_small[1]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float4 kx = *reinterpret_cast<const float4*>(
            kt + (8 * n + g) * kLdK + 16 * j + 4 * t);
        uint32_t b_big[2][2], b_small[2][2];
        split_tf32(kx.x, b_big[0][0], b_small[0][0]);
        split_tf32(kx.y, b_big[0][1], b_small[0][1]);
        split_tf32(kx.z, b_big[1][0], b_small[1][0]);
        split_tf32(kx.w, b_big[1][1], b_small[1][1]);
        mma_3xtf32(s[n], a_big[0], a_small[0], b_big[0], b_small[0]);
        mma_3xtf32(s[n], a_big[1], a_small[1], b_big[1], b_small[1]);
      }
    }

    // masks (only on a tile that crosses the diagonal, the window's edge
    // or Sk), then the online softmax in base 2 (q carries log2(e)): s
    // becomes p = 2^(s - m_new), and alpha = 2^(m - m_new) rescales the
    // running sums
    const int k0 = (t_last - r) * kBK;
    if (k0 + kBK > sk || (causal && k0 + kBK - 1 > q0) ||
        (window > 0 && k0 <= q_last - window)) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * n + 2 * t + (e & 1);
          const int qp = row + 8 * (e >> 1);
          if (kp >= sk)
            s[n][e] = __int_as_float(0xff800000);  // past Sk: -inf, no weight
          else if ((causal && kp > qp) || (window > 0 && kp <= qp - window))
            s[n][e] = kNegInf;
        }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = ex2(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[n][e] = ex2(s[n][e] - m_new);
          rs += s[n][e];
        }
      l[i] = l[i] * alpha[i] + rs;  // this lane's part; the quad's at the end
    }

    // O = alpha O + P.V.  The tensor cores' accumulator truncates, so the
    // tile's P.V is summed from zero there (k-step n covers keys 8 n ..
    // 8 n + 7) and added to O in f32: one rounding a tile, however long the
    // walk.  At Dh 128 (and in a Dh 256 block's 128 columns) in two
    // 64-column halves, to stay within 255 registers.
#pragma unroll
    for (int hc = 0; hc < kDV / 64; ++hc) {
      float pv[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t p_big[4], p_small[4];
        split_tf32(s[n][0], p_big[0], p_small[0]);  // row g,     key 2 t
        split_tf32(s[n][2], p_big[1], p_small[1]);  // row g + 8, key 2 t
        split_tf32(s[n][1], p_big[2], p_small[2]);  // row g,     key 2 t + 1
        split_tf32(s[n][3], p_big[3], p_small[3]);  // row g + 8, key 2 t + 1
        const float* v0 = vt + (8 * n + 2 * t) * kLdV + 64 * hc + 4 * g;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float4 x0 = *reinterpret_cast<const float4*>(v0 + 32 * c);
          const float4 x1 =
              *reinterpret_cast<const float4*>(v0 + kLdV + 32 * c);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            uint32_t b_big[2], b_small[2];
            split_tf32(part(x0, u), b_big[0], b_small[0]);
            split_tf32(part(x1, u), b_big[1], b_small[1]);
            mma_3xtf32(pv[4 * c + u], p_big, p_small, b_big, b_small);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[8 * hc + n][e] =
              fmaf(acc[8 * hc + n][e], alpha[e >> 1], pv[n][e]);
    }
    __syncthreads();  // every warp is done with tile r's slot
  }

  // o = acc / max(l, 1e-30): a lane's row holds columns 32 c + 8 t .. + 7
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qp = row + 8 * i;
    if (qp >= sq) continue;
    const float denom = fmaxf(li, 1e-30f);
    float* dst = ob + qp * o_stride + 8 * t;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      *reinterpret_cast<float4*>(dst + 32 * c) = make_float4(
          acc[4 * c][2 * i] / denom, acc[4 * c + 1][2 * i] / denom,
          acc[4 * c + 2][2 * i] / denom, acc[4 * c + 3][2 * i] / denom);
      *reinterpret_cast<float4*>(dst + 32 * c + 4) = make_float4(
          acc[4 * c][2 * i + 1] / denom, acc[4 * c + 1][2 * i + 1] / denom,
          acc[4 * c + 2][2 * i + 1] / denom,
          acc[4 * c + 3][2 * i + 1] / denom);
    }
  }
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int h, int kh, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem = Tile<DQK, DV>::kBytes;
  auto kernel = flash_attention_kernel_f32<DQK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks =
      static_cast<int64_t>((sq + kBQ - 1) / kBQ) * h * b *
      Tile<DQK, DV>::kSplit;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // 1/sqrt(Dqk) and log2(e): the softmax runs in base 2
  const float scale = 1.4426950408889634f / sqrtf(static_cast<float>(DQK));
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), b, sq, sk, h, kh,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32

// --------------------------------------------------------------- bf16 ----

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;          // query rows per block: 2 consumer warpgroups
constexpr int kThreads = 256;     // 2 warpgroups of 64 q rows each
constexpr int kPanel = 64;        // bf16 columns of one 128-byte swizzle atom
constexpr float kLog2e = 1.4426950408889634f;

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Waits for the phase of parity `parity` to complete.  A wait that has not
// ended after ~2^34 cycles (several seconds) traps, so a fault in the
// pipeline ends the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// ---- TMA: one box of a 4-D tensor map into shared memory ----
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// ...and one box of shared memory out to a 4-D tensor map (rows past the
// end are not written); the smem must stay until the copy has read it
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- wgmma ----
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).  K-major tiles (q, K): rows of
// 128 bytes, SBO = 1024 bytes between 8-row groups, LBO unused.  MN-major
// tiles (V as the B of P.V): LBO = bytes between 64-column panels, SBO =
// 1024 bytes between 8-key groups.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins a wgmma's registers: nothing computed on them moves across the
// wgmma fence or wait beside which this stands.
template <int NB>
__device__ __forceinline__ void fence_regs(float (&d)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int NB>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e])::"memory");
}

// ---- named barriers: the consumer warpgroups take turns at issuing ----
constexpr int kTurn = 1;   // barrier kTurn + cw: warpgroup cw may issue
constexpr int kStore = 3;  // barrier kStore + cw: cw's output is staged
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d = A . B (+ d when `accumulate`) over m64 n64 k16, A and B K-major in
// shared memory (B's rows are the n index)
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A . B (+ d when `accumulate`) over m64 n128 k16, A and B K-major
// in shared memory (B's rows are the n index)
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B over m64 n64 k16, A in registers, B MN-major in shared
// memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B over m64 n128 k16, A in registers, B MN-major in shared
// memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One tile of the online softmax on a score fragment: s holds, per n8
// block j, (row r, keys 2c, 2c+1) in s[j][0..1] and (row r + 8, the same
// keys) in s[j][2..3] (r = lane / 4, c = lane % 4: the wgmma accumulator's
// layout within a warp).  Scales, masks when `edge`, turns s into
// p = exp(s - m_new), folds the tile into (m, l) and returns the factor
// alpha by which the output accumulator's rows must be rescaled.  l is this
// thread's partial row sum; the quad's sum is taken at the end.
template <int NB>
__device__ __forceinline__ void softmax_tile(float (&s)[NB][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int row, int sk,
                                             int causal, int window,
                                             float scale, bool edge) {
  const int c = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale;
  if (edge) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * c + (e & 1);
        const int qp = row + 8 * (e >> 1);
        if (kp >= sk)
          s[j][e] = __int_as_float(0xff800000);  // past Sk: -inf, no weight
        else if ((causal && kp > qp) || (window > 0 && kp <= qp - window))
          s[j][e] = kNegInf;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    alpha[i] = ex2((m[i] - m_new) * kLog2e);
    m[i] = m_new;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        s[j][e] = ex2((s[j][e] - m_new) * kLog2e);
        rs += s[j][e];
      }
    l[i] = l[i] * alpha[i] + rs;
  }
}

// Keys per K/V tile, K/V tiles in flight and blocks per SM.  At Dh 64 a
// 64-key tile keeps a thread under 128 registers, so two blocks share an SM
// and each hides the other's start and end; at Dh 128 one block per SM
// with 128-key tiles is faster (its products, not its softmax, set the
// pace).  At Dh 256 the q tile alone takes 64 KB and a 64-key K or V tile
// 32 KB, so the ring holds two of each (192 KB in all), and the output
// accumulator takes 128 registers a thread beside the 64-key S tile's 32.
// MLA's (192, 128): 64-key tiles in a ring of three (168 KB), one block per
// SM.
template <int DQK, int DV>
struct Tile {
  static constexpr int kKeys = DQK == 128 && DV == 128 ? 128 : 64;
  static constexpr int kStages = DQK == 256 ? 2 : 3;
  static constexpr int kBlocksPerSM = DQK == 64 ? 2 : 1;
};

// Shared memory, every tile 1024-byte aligned (the swizzle atom): the q
// tile, then kStages K tiles and kStages V tiles, then the mbarriers.  A
// tile of R rows and D columns is D / 64 panels of R rows x 128 bytes: q
// and K tiles Dqk columns wide, V tiles Dv.
template <int DQK, int DV>
struct Smem {
  using T = Tile<DQK, DV>;
  static constexpr uint32_t kQ = kBQ * DQK * 2;
  static constexpr uint32_t kKT = T::kKeys * DQK * 2;  // one K tile
  static constexpr uint32_t kVT = T::kKeys * DV * 2;   // one V tile
  static constexpr uint32_t kK = kQ;
  static constexpr uint32_t kV = kK + T::kStages * kKT;
  static constexpr uint32_t kBar = kV + T::kStages * kVT;
  // q_full, then k_full and v_full for each stage
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * T::kStages);
  static_assert(kBytes + 1024 <= 232448, "over 227 KB of shared memory");
  static_assert(DV <= DQK, "the output is staged in the q tile");
};

// Two warpgroups, each owning 64 rows of the block's 128 q rows, walk the
// key tiles from the last (the diagonal) down.  Round r of a warpgroup
// runs O += P_{r-1} . V_{r-1} and S_r = Q . K_r^T on the tensor cores, then
// tile r's softmax; the warpgroups take turns at the tensor cores, so one's
// products run while the other's softmax has the exp units to itself.
// Thread 0 issues every TMA copy: the q tile and the first kStages K and V
// tiles up front, then, at the start of warpgroup 0's round r, K_{r-1+S}
// and V_{r-2+S} into the slots that K_{r-1} and V_{r-2} left (both
// warpgroups are done with them: the turn order says so).
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, Tile<DQK, DV>::kBlocksPerSM)
flash_attention_kernel_bf16(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap to, int nb,
                            int sq, int sk, int h, int kh, int causal,
                            int window, float scale) {
  using S = Smem<DQK, DV>;
  constexpr int kPanelsQK = DQK / kPanel;  // of q and K
  constexpr int kPanelsV = DV / kPanel;    // of V and o
  constexpr int kBK = Tile<DQK, DV>::kKeys;
  constexpr int kStages = Tile<DQK, DV>::kStages;
  constexpr int kNB = kBK / 8;  // n8 blocks of a score row pair
  extern __shared__ uint8_t shm[];
  const uint32_t base = (smem_u32(shm) + 1023) & ~1023u;
  const uint32_t q_full = base + S::kBar;
  auto k_full = [&](int t) { return q_full + 8 + 16 * (t % kStages); };
  auto v_full = [&](int t) { return q_full + 16 + 16 * (t % kStages); };

  // heaviest causal q tiles first: blocks start in order of their index
  const int n_bh = nb * h;
  const int q0 = ((sq + kBQ - 1) / kBQ - 1 - blockIdx.x / n_bh) * kBQ;
  const int head = blockIdx.x % n_bh % h;
  const int b = blockIdx.x % n_bh / h;
  const int kv_head = head / (h / kh);

  // the key tiles that some query row of this tile may see; tile t of the
  // walk starts at key (t_last - t) * kBK
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_last = (k_end - 1) / kBK;
  const int n_tiles = t_last - k_begin / kBK + 1;

  const bool loader = threadIdx.x == 0;
  auto load_kv = [&](const CUtensorMap* map, uint32_t bar, uint32_t dst,
                     uint32_t bytes, int panels, int t) {
    mbar_expect_tx(bar, bytes);
    for (int p = 0; p < panels; ++p)
      tma_load(dst + p * (kBK * 128), map, p * kPanel, kv_head,
               (t_last - t) * kBK, b, bar);
  };
  auto load_k = [&](int t) {
    load_kv(&tk, k_full(t), base + S::kK + (t % kStages) * S::kKT, S::kKT,
            kPanelsQK, t);
  };
  auto load_v = [&](int t) {
    load_kv(&tv, v_full(t), base + S::kV + (t % kStages) * S::kVT, S::kVT,
            kPanelsV, t);
  };
  if (loader) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, S::kQ);
    for (int p = 0; p < kPanelsQK; ++p)
      tma_load(base + p * (kBQ * 128), &tq, p * kPanel, head, q0, b, q_full);
    for (int t = 0; t < min(n_tiles, kStages); ++t) {
      load_k(t);
      load_v(t);
    }
  }
  __syncthreads();

  const int cw = threadIdx.x / 128;  // this warpgroup: q rows 64 cw + 0..63
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32 % 4;
  const int row = q0 + 64 * cw + 16 * warp + lane / 4;  // and row + 8
  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[kBK / 16][4];  // P of the last tile in bf16: P.V's A operand
  const uint32_t q_tile = base + cw * 64 * 128;

  // The products of a round are issued between a wgmma fence and a commit
  // with no branch in between (a branch there makes the compiler serialize
  // them), so rounds 0 and n_tiles are peeled off the loop.
  auto issue_pv = [&](int t) {  // O += P_t . V_t, V through the transpose bit
    const uint32_t v_tile = base + S::kV + (t % kStages) * S::kVT;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t v_k = v_tile + kk * 16 * 128;
      if constexpr (DV == 256) {  // two n128 products, two panels each
        wgmma_rs(*reinterpret_cast<float(*)[16][4]>(&acc[0]), pa[kk],
                 desc(v_k, kBK * 128, 1024));
        wgmma_rs(*reinterpret_cast<float(*)[16][4]>(&acc[16]), pa[kk],
                 desc(v_k + 2 * kBK * 128, kBK * 128, 1024));
      } else {
        wgmma_rs(acc, pa[kk], desc(v_k, kBK * 128, 1024));
      }
    }
  };
  auto issue_s = [&](float (&s)[kNB][4], int t) {  // S_t = Q . K_t^T
    const uint32_t k_tile = base + S::kK + (t % kStages) * S::kKT;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // k16 step in the atom
      wgmma_ss(s, desc(q_tile + (kk / 4) * (kBQ * 128) + off, 16, 1024),
               desc(k_tile + (kk / 4) * (kBK * 128) + off, 16, 1024),
               kk > 0);
    }
  };
  auto softmax = [&](float (&s)[kNB][4], int t) {  // then P_t in bf16
    const int k0 = (t_last - t) * kBK;
    const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && k0 <= q_last - window);
    softmax_tile<kNB>(s, m, l, alpha, k0, row, sk, causal, window, scale,
                      edge);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {  // P rounded to bf16
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  };
  auto pv = [&](int t) {
    mbar_wait(v_full(t), (t / kStages) & 1);
    fence_regs(acc);  // the rescale and P's packing stay before the fence
    fence_regs(pa);
    wgmma_fence();
    issue_pv(t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  };
  auto scores = [&](float (&s)[kNB][4], int t) {
    mbar_wait(k_full(t), (t / kStages) & 1);
    wgmma_fence();
    issue_s(s, t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
  };
  auto refill = [&](int r) {  // warpgroup 0's thread 0, at round r's start
    if (loader) {
      if (r - 1 + kStages < n_tiles) load_k(r - 1 + kStages);
      if (r >= 2 && r - 2 + kStages < n_tiles) load_v(r - 2 + kStages);
    }
    __syncwarp();
  };

  mbar_wait(q_full, 0);
  if (cw == 1) named_arrive(kTurn, 256);  // warpgroup 0 goes first
  {  // round 0: S_0
    float s[kNB][4];
    named_sync(kTurn + cw, 256);
    scores(s, 0);
    named_arrive(kTurn + 1 - cw, 256);
    softmax(s, 0);
  }
  for (int r = 1; r < n_tiles; ++r) {  // round r: P_{r-1} . V_{r-1}, S_r
    float s[kNB][4];
    named_sync(kTurn + cw, 256);
    refill(r);
    mbar_wait(v_full(r - 1), ((r - 1) / kStages) & 1);
    mbar_wait(k_full(r), (r / kStages) & 1);
    fence_regs(acc);  // the rescale and P's packing stay before the fence
    fence_regs(pa);
    wgmma_fence();
    issue_pv(r - 1);
    issue_s(s, r);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(s);
    named_arrive(kTurn + 1 - cw, 256);
    softmax(s, r);
  }
  {  // round n_tiles: P_{n-1} . V_{n-1}
    named_sync(kTurn + cw, 256);
    pv(n_tiles - 1);
    if (cw == 0) named_arrive(kTurn + 1, 256);  // every sync has its arrive
  }
  // o = acc / max(l, 1e-30) in bf16, staged in this warpgroup's rows of
  // the q tile (its last S is done) in the TMA layout, then one TMA store
  const int c = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.f / fmaxf(li, 1e-30f);
    const int r = 16 * warp + lane / 4 + 8 * i;  // row in this warpgroup's 64
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const uint32_t dst = q_tile + (j / 8) * (kBQ * 128) + r * 128 +
                           (((j % 8) ^ (r % 8)) << 4) + 4 * c;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                   "r"(pack_bf16(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv))
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(kStore + cw, 128);
  if (threadIdx.x % 128 == 0) {
    for (int p = 0; p < kPanelsV; ++p)
      tma_store(&to, q_tile + p * (kBQ * 128), p * kPanel, head,
                q0 + 64 * cw, b);
    tma_store_drain();
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a [batch, rows, heads, D] bf16 tensor, as dimensions
// (D, heads, rows, batch) from the innermost: boxes of 64 columns x 1 head
// x `box_rows` rows, 128-byte swizzled; rows past the end read as zero.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d,
              int rows, int heads, int batch, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(d) * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kPanel), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int h, int kh, int causal, int window,
           cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  constexpr int kKeys = Tile<DQK, DV>::kKeys;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(encode, &tq, q, DQK, sq, h, b, kBQ) ||
      !make_map(encode, &to, o, DV, sq, h, b, kBQ / 2) ||
      !make_map(encode, &tk, k, DQK, sk, kh, b, kKeys) ||
      !make_map(encode, &tv, v, DV, sk, kh, b, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = Smem<DQK, DV>::kBytes + 1024;  // + alignment slack
  auto kernel = flash_attention_kernel_bf16<DQK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks =
      static_cast<int64_t>((sq + kBQ - 1) / kBQ) * h * b;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(DQK));
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      tq, tk, tv, to, b, sq, sk, h, kh, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

using Launch = int (*)(const void*, const void*, const void*, void*, int, int,
                       int, int, int, int, int, cudaStream_t);

// The instance for (dh, dv): (64, 64), (128, 128), (256, 256) or (192, 128);
// any other pair is refused.
template <Launch L64, Launch L128, Launch L256, Launch L192_128>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int h, int kh, int dh, int dv, int causal,
             int window, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  Launch fn = nullptr;
  if (dh == dv && dh == 64) fn = L64;
  if (dh == dv && dh == 128) fn = L128;
  if (dh == dv && dh == 256) fn = L256;
  if (dh == 192 && dv == 128) fn = L192_128;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, b, sq, sk, h, kh, causal, window, s);
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int b, int sq, int sk, int h, int kh, int dh, int dv,
                        int causal, int window, void* stream) {
  return dispatch<tf32::launch<64, 64>, tf32::launch<128, 128>,
                  tf32::launch<256, 256>, tf32::launch<192, 128>>(
      q, k, v, o, b, sq, sk, h, kh, dh, dv, causal, window, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int b, int sq, int sk, int h, int kh, int dh, int dv,
                         int causal, int window, void* stream) {
  return dispatch<tc::launch<64, 64>, tc::launch<128, 128>,
                  tc::launch<256, 256>, tc::launch<192, 128>>(
      q, k, v, o, b, sq, sk, h, kh, dh, dv, causal, window, stream);
}

}  // extern "C"
