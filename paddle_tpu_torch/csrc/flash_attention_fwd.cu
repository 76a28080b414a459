// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_attention.py::_fwd_kernel
// (lines 43-94), launched by _flash_fwd through the pallas_call at line 140.
// Same function: O = softmax(Q K^T * scale + key_bias [+ causal mask]) V and
// lse = logsumexp of the same scores, over [B, H, T, D] heads, fp32 or bf16
// inputs, fp32 accumulation. Not carried over block by block:
//   * one CUDA block per (b*h, query tile of BM rows); a loop inside the
//     block walks the KV tiles, since blocks run in parallel and no order
//     carries across them (the TPU grid ran its KV axis in order and kept
//     m/l/acc in VMEM scratch between steps);
//   * no head-dim padding to 128 and no multiple-of-128 rule: D is padded
//     to the next of the tiers 32, 64, 128 in shared memory only, any Tq
//     and Tk, ragged tails masked;
//   * causal masking is bottom-right aligned (row r sees keys c <= r + Tk - Tq),
//     the alignment of _plain_attention (pallas_attention.py:37); the Pallas
//     body is top-left aligned (:60, :71-75). The two agree when Tq == Tk,
//     as on every causal use of the model path.
//
// The design: 4 warps per block, each owning 16 query rows; KV tiles of
// BN = 64 keys, double-buffered in shared memory with cp.async so that
// tile j+1 loads while tile j computes (one __syncthreads per tile). Both
// products run on the tensor cores as mma.sync m16n8k8 TF32 with fp32
// accumulation. fp32 inputs are split x = big + small, both TF32 (rounded
// with cvt.rna), and each product is big*big + big*small + small*big
// ("3xTF32", about 2^-22 relative error per product). bf16 inputs are
// exact in TF32 and take one product; their P (fp32 in the kernel) is
// rounded to TF32 once. The softmax stays in registers: a thread holds 2
// rows x 16 keys of S, reduces across the 4 lanes of its quad, and keeps
// m, l and the O accumulator in registers, in base 2 (exp2f, with
// scale*log2(e) folded into the score). P goes from the C fragment to the
// A fragment of P.V without moving: the key order inside each k-step is
// permuted (logical k = t -> key 2t, k = t+4 -> key 2t+1), and V's B
// fragment is read in the same order. Q and K are read in pairs along D
// under the same kind of permutation. Row paddings of 8 (Q, K) and 4 (fp32
// V) or 8 (bf16 V) elements keep every fragment read free of bank
// conflicts. Under causal masking, KV tiles wholly above a query tile's
// diagonal are skipped (by the block, and by each warp for its 16 rows),
// and the query tiles that see the most keys are launched first.
//
// Bound on an H100 SXM (data-sheet rates: 3.35 TB/s; 495 TFLOP/s TF32 and
// 989 TFLOP/s bf16 dense on the tensor cores; 67 TFLOP/s fp32 outside
// them) at the model path's shape [8, 8, 256, 64] with a key bias: it
// moves Q, K, V, O once (16.8 MB fp32, 8.4 MB bf16, plus 8 KB of key bias
// and 64 KB of lse) and does 4*B*H*Tq*Tk*D = 1.07 GFLOP (half that
// causal). fp32-accurate products take three TF32 products, so fp32 is
// bound by 3 * 1.07 GFLOP / 495 TFLOP/s = 6.5 us of operations against
// 5.0 us of bytes (on the CUDA cores it was 16 us); bf16 is bound by its
// bytes, 2.5 us. Left for later work: wgmma with TMA loads and warp
// specialisation (the only way to the full tensor-core rate), a bf16
// m16n8k16 product for bf16 serving, and split-KV for grids that do not
// fill the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

using namespace tc;

constexpr int BM = 64;         // query rows per block, 16 per warp
constexpr int BN = 64;         // keys per KV tile
constexpr int NT = BN / 8;     // 8-key column tiles of S
constexpr int THREADS = 128;   // 4 warps
constexpr int MAX_D = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// the causal fill of the JAX kernels, -1e30, in the base-2 score domain
constexpr float MASKED = -1e30f * LOG2E;

// shared-memory layout of one block: row strides in elements
template <typename T, int DT>
struct Smem {
  static constexpr int QK = DT + 8;  // Q and K rows: 8-byte pair reads
  static constexpr int V = std::is_same<T, float>::value ? DT + 4 : DT + 8;
  static constexpr size_t q_elems = (size_t)BM * QK;
  static constexpr size_t k_elems = (size_t)BN * QK;  // per stage
  static constexpr size_t v_elems = (size_t)BN * V;   // per stage
  static constexpr size_t bytes =
      sizeof(T) * (q_elems + 2 * k_elems + 2 * v_elems) + sizeof(float) * 2 * BN;
};

// two neighbouring elements of a shared-memory row as fp32
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ key_bias,
                 T* __restrict__ o, float* __restrict__ lse, int H, int tq,
                 int tk, int D, float scale_log2, int causal, int vec) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  using L = Smem<T, DT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);         // [BM][QK]
  T* k_s = q_s + L::q_elems;                       // 2 x [BN][QK]
  T* v_s = k_s + 2 * L::k_elems;                   // 2 x [BN][V]
  float* kb_s = reinterpret_cast<float*>(v_s + 2 * L::v_elems);  // 2 x [BN]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  // causal: the query tiles that see the most keys start first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BM;
  const int b = bh / H;
  const T* qg = q + ((size_t)bh * tq + q0) * D;
  const T* kg = k + (size_t)bh * tk * D;
  const T* vg = v + (size_t)bh * tk * D;
  const float* kbg = key_bias != nullptr ? key_bias + (size_t)b * tk : nullptr;

  // Causal: key c is visible to query row r when c <= r + shift. KV tiles
  // wholly above the diagonal of this query tile are skipped. A tile that
  // holds a row seeing no key at all (only when Tq > Tk) walks every KV
  // tile, so that row comes out uniform over all keys, as the plain
  // version's softmax over -1e30 does.
  const int shift = tk - tq;
  const bool skip_ok = causal && q0 + shift >= 0;
  const int kv_end = skip_ok ? min(tk, q0 + BM + shift) : tk;
  const int n_tiles = (kv_end + BN - 1) / BN;

  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * BN;
    const int n = min(BN, tk - k0);
    load_tile<T, DT, L::QK, BN, THREADS>(k_s + st * L::k_elems,
                                         kg + (size_t)k0 * D, n, D, vec, tid);
    load_tile<T, DT, L::V, BN, THREADS>(v_s + st * L::v_elems,
                                        vg + (size_t)k0 * D, n, D, vec, tid);
    if (tid < BN) {
      float* dst = kb_s + st * BN + tid;
      if (kbg != nullptr)
        cp_async4(dst, tid < n ? kbg + k0 + tid : kbg, tid < n);
      else
        *dst = 0.f;
    }
    cp_async_commit();
  };
  load_tile<T, DT, L::QK, BM, THREADS>(q_s, qg, min(BM, tq - q0), D, vec,
                                       tid);
  load_kv(0, 0);

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * 16;           // the warp's first query row
  const int r0 = wrow + g, r1 = wrow + g + 8;  // this thread's two rows
  const T* q_w = q_s + (warp * 16 + g) * L::QK + 2 * t;

  float acc[DT / 8][4];
#pragma unroll
  for (int n = 0; n < DT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {MASKED, MASKED};  // running max, base 2
  float l[2] = {0.f, 0.f};        // this thread's part of the running sum

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, k0 = it * BN;
    cp_async_wait_all();  // tile it (and Q) landed
    __syncthreads();      // ... for every thread; tile it-1 is consumed
    if (it + 1 < n_tiles) load_kv(it + 1, st ^ 1);
    // every row of this warp sees none of the tile: it adds exactly 0
    if (skip_ok && k0 > wrow + 15 + shift) continue;

    const T* k_t = k_s + st * L::k_elems + g * L::QK + 2 * t;
    const T* v_t = v_s + st * L::v_elems + 2 * t * L::V + g;
    const float* kb_t = kb_s + st * BN + 2 * t;

    // S = Q K^T, 16 rows x 64 keys per warp. Logical k = t holds d = 2t,
    // k = t + 4 holds d = 2t + 1, in both operands.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT / 8; ++kk) {
      const float2 x0 = ld_pair(q_w + 8 * kk);
      const float2 x1 = ld_pair(q_w + 8 * L::QK + 8 * kk);
      uint32_t ab[4], as[4];
      terms<SPLIT>(x0.x, ab[0], as[0]);  // (g, t)
      terms<SPLIT>(x1.x, ab[1], as[1]);  // (g + 8, t)
      terms<SPLIT>(x0.y, ab[2], as[2]);  // (g, t + 4)
      terms<SPLIT>(x1.y, ab[3], as[3]);  // (g + 8, t + 4)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 y = ld_pair(k_t + 8 * n * L::QK + 8 * kk);
        uint32_t bb0, bs0, bb1, bs1;
        terms<SPLIT>(y.x, bb0, bs0);
        terms<SPLIT>(y.y, bb1, bs1);
        mma_terms<SPLIT>(s[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }

    // scale, key bias and masks, in base 2; this thread holds rows r0
    // (s[n][0..1]) and r1 (s[n][2..3]), keys k0 + 8n + 2t + {0, 1}
    const bool masking = k0 + BN > tk || (causal && k0 + BN - 1 > wrow + shift);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 kb = *reinterpret_cast<const float2*>(kb_t + 8 * n);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + 8 * n + 2 * t + (e & 1);
        const int r = e < 2 ? r0 : r1;
        float val = fmaf(s[n][e], scale_log2, ((e & 1) ? kb.y : kb.x) * LOG2E);
        if (masking) {
          if (c >= tk)
            val = -INFINITY;  // past the last key: not part of the softmax
          else if (causal && c > r + shift)
            val = MASKED;
        }
        s[n][e] = val;
      }
    }

    // online softmax in registers; a row's 64 keys lie on one quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[i] - mx);  // m starts finite: no NaN
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * i] = exp2f(s[n][2 * i] - mx);
        s[n][2 * i + 1] = exp2f(s[n][2 * i + 1] - mx);
        sum += s[n][2 * i] + s[n][2 * i + 1];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int n = 0; n < DT / 8; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }

    // O += P V. The C fragment of S's column tile j is the A fragment of
    // k-step j with logical k = t -> key 2t, k = t + 4 -> key 2t + 1;
    // V's B fragment is read in the same key order.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t pb[4], ps[4];
      const float p[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (SPLIT)
          terms<true>(p[e], pb[e], ps[e]);
        else
          pb[e] = tf32(p[e]);  // bf16 inputs: P rounded to TF32 once
      }
#pragma unroll
      for (int n = 0; n < DT / 8; ++n) {
        const T* vp = v_t + 8 * j * L::V + 8 * n;
        uint32_t bb0, bs0, bb1, bs1;
        terms<SPLIT>(ld_one(vp), bb0, bs0);
        terms<SPLIT>(ld_one(vp + L::V), bb1, bs1);
        mma_terms<SPLIT>(acc[n], pb, ps, bb0, bb1, bs0, bs1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = i ? r1 : r0;
    if (r >= tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * tq + r) * D;
#pragma unroll
    for (int n = 0; n < DT / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D) store(acc[n][2 * i] * inv, orow + d);
      if (d + 1 < D) store(acc[n][2 * i + 1] * inv, orow + d + 1);
    }
    if (t == 0)
      lse[(size_t)bh * tq + r] = (m[i] + log2f(fmaxf(l[i], 1e-30f))) * LN2;
  }
}

template <typename T, int DT>
int launch(const void* q, const void* k, const void* v, const float* kb,
           void* o, float* lse, int B, int H, int tq, int tk, int D,
           float scale, int causal, cudaStream_t stream) {
  const size_t smem = Smem<T, DT>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = (D * sizeof(T)) % 16 == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  const dim3 grid(B * H, (tq + BM - 1) / BM);
  flash_fwd_kernel<T, DT><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kb, (T*)o, lse, H, tq, tk, D,
      scale * LOG2E, causal, (int)vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tier(const void* q, const void* k, const void* v, const float* kb,
                void* o, float* lse, int B, int H, int tq, int tk, int D,
                float scale, int causal, cudaStream_t s) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, kb, o, lse, B, H, tq, tk, D, scale, causal, s);
  if (D <= 64)
    return launch<T, 64>(q, k, v, kb, o, lse, B, H, tq, tk, D, scale, causal, s);
  return launch<T, 128>(q, k, v, kb, o, lse, B, H, tq, tk, D, scale, causal, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). Q/O: [B, H, tq, D], K/V:
// [B, H, tk, D], contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// key_bias: fp32 [B, tk] or null; lse: fp32 [B, H, tq]. Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const float* key_bias,
                                   void* o, float* lse, int B, int H,
                                   int tq, int tk, int D, float scale,
                                   int causal, int is_bf16, void* stream) {
  if (D < 1 || D > MAX_D || tq < 1 || tk < 1 || B < 1 || H < 1 ||
      (long long)B * H > 0x7fffffff || (tq + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_tier<__nv_bfloat16>(q, k, v, key_bias, o, lse, B, H, tq, tk,
                                      D, scale, causal, s);
  return launch_tier<float>(q, k, v, key_bias, o, lse, B, H, tq, tk, D, scale,
                            causal, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
