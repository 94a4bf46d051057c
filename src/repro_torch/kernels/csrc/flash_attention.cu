// Hopper (sm_90a) kernel K3: blocked online-softmax GQA attention with
// causal and sliding-window masks, for every prefill of the dense decoders.
//
//   o[b, i, h, :] = sum_j softmax_j(q[b,i,h,:] . k[b,j,h/G,:] / sqrt(Dh)) v[b,j,h/G,:]
//   over the keys j that i may see: j <= i (causal), j > i - window (window);
//   positions start at 0 for q and for k.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _attn_kernel) and keeps its semantics: q is scaled by 1/sqrt(Dh)
// in f32 before the product, masked scores are -1e30, the running (m, l,
// acc) state is f32, and the output is acc / max(l, 1e-30) cast to q's
// dtype.  Layouts are the reference's: q, o [B, Sq, H, Dh]; k, v
// [B, Sk, KH, Dh], H = KH * G.
//
// Bound: at the main-path shape (B 8, S 1024, H = KH = 16, Dh 64, bf16,
// causal) bytes and tensor-core operations about equally: 17.2 GFLOP (the
// causal half of 4 B H S^2 Dh), 0.0174 ms at the 989 TFLOP/s bf16 peak,
// against 67.1 MB of q, k, v and o read or written once, 0.0200 ms at
// 3.35 TB/s.  At qwen3's Dh 128 the operations bound (0.0348 ms).
//
// What this simple design does about it: it uses no tensor cores yet, so
// it runs far from that bound, on the f32 FMA units (the f32 path must
// meet the reference's f32 tolerance, which TF32 or bf16 products would
// not).  It does read q, k and v once per block and write o once, keep
// the work to what the masks need, and keep every intermediate on chip:
//   - one block per (q tile of 64 rows, head, batch); 256 threads, each
//     owning 4 query rows x 4 keys of a score tile and 4 query rows x Dh/16
//     output columns;
//   - the q tile (scaled, f32) and each 64-key K/V tile are staged in
//     shared memory (row stride Dh + 1 against bank conflicts); the running
//     (m, l, acc) state stays in registers; p goes through shared memory
//     for the P.V product;
//   - GQA reads KV head h / G directly (no repeated copies of k and v);
//   - the ragged Sq and Sk edges are masked in the kernel, no padding:
//     a key past Sk scores -inf and so counts nowhere, and non-causal calls
//     take any Sk;
//   - key tiles wholly above the causal diagonal or wholly outside the
//     window of the block's queries are not visited.
// Tensor cores (mma.sync, then wgmma with TMA) are later work.
//
// Plain C interface for ctypes: every pointer and the stream are void*,
// and each entry returns a cudaError_t as an int (0 = launched).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kLanes = 16;        // threads sharing one group of query rows
constexpr int kThreads = 256;     // (kBQ / kRows) row groups x kLanes
constexpr int kRows = 4;          // query rows per thread
constexpr int kCols = kBK / kLanes;  // keys per thread in a score tile
constexpr int kLdP = kBK + 1;     // row stride of the p tile
constexpr float kNegInf = -1e30f;  // the reference's masked score

static_assert(kBQ == kRows * (kThreads / kLanes), "row groups cover kBQ");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// Max and sum over the kLanes threads of a row group (aligned halves of a
// warp, so the xor offsets stay inside the group).
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  // q_s [kBQ][D+1], k_s [kBK][D+1], v_s [kBK][D], p_s [kBQ][kBK+1]
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kLdP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int sk, int h, int kh, int causal, int window,
                       float scale) {
  constexpr int kLd = D + 1;       // row stride of q_s and k_s
  constexpr int kDc = D / kLanes;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * kLd;
  float* v_s = k_s + kBK * kLd;
  float* p_s = v_s + kBK * D;

  const int tid = threadIdx.x;
  const int ty = tid / kLanes;     // row group: query rows ty*kRows + i
  const int tx = tid % kLanes;     // keys tx + kLanes*j, columns tx + kLanes*c
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (h / kh);

  const int64_t q_stride = static_cast<int64_t>(h) * D;   // one q/o row
  const int64_t k_stride = static_cast<int64_t>(kh) * D;  // one k/v row
  const T* qb = q + (static_cast<int64_t>(b) * sq * h + head) * D;
  T* ob = o + (static_cast<int64_t>(b) * sq * h + head) * D;
  const T* kb = k + (static_cast<int64_t>(b) * sk * kh + kv_head) * D;
  const T* vb = v + (static_cast<int64_t>(b) * sk * kh + kv_head) * D;

  // the q tile, scaled in f32 before the product; rows past Sq are zero
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    float val = 0.f;
    if (q0 + r < sq) val = to_f32(qb[(q0 + r) * q_stride + c]) * scale;
    q_s[r * kLd + c] = val;
  }

  float m[kRows], l[kRows], acc[kRows][kDc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[i][c] = 0.f;
  }

  // the keys that some query row of this tile may see
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // q_s is staged; the last tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < sk) {
        kv = to_f32(kb[(k0 + r) * k_stride + c]);
        vv = to_f32(vb[(k0 + r) * k_stride + c]);
      }
      k_s[r * kLd + c] = kv;
      v_s[r * D + c] = vv;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty * kRows + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = k_s[(tx + kLanes * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + kLanes * j;
        if (kp >= sk)
          s[i][j] = __int_as_float(0xff800000);  // past Sk: -inf, no weight
        else if ((causal && kp > qp) || (window > 0 && kp <= qp - window))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty * kRows + i) * kLdP + tx + kLanes * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDc; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[kDc];
#pragma unroll
      for (int c = 0; c < kDc; ++c) vv[c] = v_s[kk * D + tx + kLanes * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = p_s[(ty * kRows + i) * kLdP + kk];
#pragma unroll
        for (int c = 0; c < kDc; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDc; ++c)
      store(&ob[qp * q_stride + tx + kLanes * c], acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int h, int kh, int causal, int window,
           void* stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, kh, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int h, int kh, int dh, int causal, int window,
             void* stream) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, k, v, o, b, sq, sk, h, kh, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, sq, sk, h, kh, causal, window,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int b, int sq, int sk, int h, int kh, int dh,
                        int causal, int window, void* stream) {
  return dispatch<float>(q, k, v, o, b, sq, sk, h, kh, dh, causal, window,
                         stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int b, int sq, int sk, int h, int kh, int dh,
                         int causal, int window, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, kh, dh, causal,
                                 window, stream);
}

}  // extern "C"
