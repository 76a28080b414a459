// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// Replaces paddle_tpu/ops/pallas_attention.py::_fa_bwd (lines 213-286), the
// JAX package's backward of its TPU flash kernel. That one is not a Pallas
// kernel: it is an XLA lax.scan over KV blocks that recomputes P from the
// saved logsumexp. Same function here, over [B, H, T, D] heads, fp32 or
// bf16 inputs, fp32 arithmetic:
//   delta = rowsum(dO * O)
//   S = scale * Q K^T + key_bias (-1e30 where causal masks it)
//   P = exp(S - lse),  dV = P^T dO,  dP = dO V^T,  dSoft = P * (dP - delta)
//   dQ = scale * dSoft K,  dK = scale * dSoft^T Q,
//   dKeyBias[b, k] = sum over h and q of dSoft
// Causal masking is bottom-right aligned (key c is visible to query row r
// when c <= r + Tk - Tq), as in the forward kernel and _plain_attention.
//
// Three kernels, launched in order on the caller's stream by one C call:
//   1. delta: one warp per query row.
//   2. dK/dV: one block per (b*h, tile of BN keys); a loop inside the block
//      walks the query tiles (the TPU scan's sequential axis), keeping the
//      tile's dK and dV in registers. It also writes dKeyBias per head,
//      [B, H, Tk], which the wrapper sums over H.
//   3. dQ: one block per (b*h, tile of BM query rows), walking the key tiles.
// Each block owns its outputs, so there are no atomics and the result is
// deterministic. Both passes recompute S and dP (7 products in all against
// the 5 the function needs): the price of no atomics on dQ.
//
// Not carried over from the TPU: no head-dim padding to 128 and no
// multiple-of-128 rule. D is padded to the next of the tiers 32, 64, 128 in
// shared memory only (zero-filled), and ragged query and key tails are
// masked.
//
// The design is the simple one: tiles of 64 x 64, staged in shared memory
// as fp32 (bf16 is widened on load), 256 threads each computing a 4 x 4
// part of S and dP and a 4 x (DT/16) part of the outputs with fp32 FMAs on
// the CUDA cores. Rows of shared memory are padded by one float, so the
// column reads of S's operands are free of bank conflicts. Left for later
// work: the tensor cores (mma.sync or wgmma), cp.async or TMA pipelining,
// and bf16 tiles in shared memory.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s; 67 TFLOP/s fp32 on the CUDA
// cores, 495 TFLOP/s TF32 and 989 TFLOP/s bf16 on the tensor cores) at the
// model path's shape [8, 8, 256, 64] with a key bias, non-causal: the
// function needs 5 products of 2*B*H*Tq*Tk*D = 2.68 GFLOP. On the CUDA
// cores that is 0.040 ms; it moves about 17 MB in bf16 (Q, K, V, O, dO
// read, dQ, dK, dV written, lse, key bias), 0.005 ms, and 34 MB in fp32.
// So this kernel is bound by operations, and its two recomputed products
// and shared-memory reads (2 loads per 2 FMAs in the S/dP loop) keep it
// well above that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads over a 64 x 64 tile
constexpr int MAX_D = 128;
constexpr int LP = BN + 1;    // row stride of the P and dSoft tiles
constexpr float MASKED = -1e30f;  // the causal fill of the JAX kernels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// rows [0, 64) x cols [0, DT) of a row-major [rows][D] global tile into a
// [64][DT + 1] fp32 shared tile; rows >= n_rows and cols >= D are zero.
template <typename T, int DT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int n_rows,
                                          int D) {
  for (int i = threadIdx.x; i < 64 * DT; i += THREADS) {
    const int r = i / DT, c = i % DT;
    dst[r * (DT + 1) + c] =
        r < n_rows && c < D ? to_f(src[(size_t)r * D + c]) : 0.f;
  }
}

// n floats of a row vector into shared memory, zero past n_valid
__device__ __forceinline__ void load_row(float* dst, const float* src, int n,
                                         int n_valid) {
  if (threadIdx.x < n)
    dst[threadIdx.x] =
        src != nullptr && (int)threadIdx.x < n_valid ? src[threadIdx.x] : 0.f;
}

// This thread's 4 x 4 part of a tile (query rows ty + 16i, keys tx + 16j):
// p = exp(S - lse) and dsoft = p * (dP - delta), both 0 for rows past tq
// and keys past tk.
template <int DT>
__device__ __forceinline__ void tile_probs(
    const float* q_s, const float* k_s, const float* do_s, const float* v_s,
    const float* lse_s, const float* delta_s, const float* kb_s, int q0,
    int k0, int tq, int tk, float scale, int causal, float (&p)[4][4],
    float (&dsoft)[4][4]) {
  constexpr int LD = DT + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DT; ++d) {
    float a[4], c[4], b[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = q_s[(ty + 16 * i) * LD + d];
      c[i] = do_s[(ty + 16 * i) * LD + d];
      b[i] = k_s[(tx + 16 * i) * LD + d];
      e[i] = v_s[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
      }
  }
  const int shift = tk - tq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty + 16 * i, r = q0 + lr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lc = tx + 16 * j, c = k0 + lc;
      float pv = 0.f;
      if (r < tq && c < tk) {
        float sv = s[i][j] * scale + kb_s[lc];
        if (causal && c > r + shift) sv = MASKED;
        pv = expf(sv - lse_s[lr]);
      }
      p[i][j] = pv;
      dsoft[i][j] = pv * (dp[i][j] - delta_s[lr]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int D) {
  const long long row = ((long long)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const T* o = out + (size_t)row * D;
  const T* g = dout + (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f(o[d]), to_f(g[d]), s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <int DT>
struct DkdvSmem {
  static constexpr int LD = DT + 1;
  static constexpr size_t floats =
      (size_t)2 * BN * LD + 2 * BM * LD + 2 * BM * LP + 2 * BM + BN;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ key_bias,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, float* __restrict__ dkb_part, int H,
                      int tq, int tk, int D, float scale, int causal) {
  constexpr int LD = DT + 1, NJ = DT / 16;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;               // [BN][LD]
  float* v_s = k_s + BN * LD;      // [BN][LD]
  float* q_s = v_s + BN * LD;      // [BM][LD]
  float* do_s = q_s + BM * LD;     // [BM][LD]
  float* p_s = do_s + BM * LD;     // [BM][LP]
  float* ds_s = p_s + BM * LP;     // [BM][LP]
  float* lse_s = ds_s + BM * LP;   // [BM]
  float* delta_s = lse_s + BM;     // [BM]
  float* kb_s = delta_s + BM;      // [BN]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * BN, nk = min(BN, tk - k0);
  load_tile<T, DT>(k_s, k + ((size_t)bh * tk + k0) * D, nk, D);
  load_tile<T, DT>(v_s, v + ((size_t)bh * tk + k0) * D, nk, D);
  load_row(kb_s, key_bias != nullptr ? key_bias + (size_t)b * tk + k0 : nullptr,
           BN, nk);

  // this thread accumulates keys ty + 16i, head dims tx + 16j
  float acc_k[4][NJ], acc_v[4][NJ], acc_b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc_b[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  }

  const int shift = tk - tq;
  for (int q0 = 0; q0 < tq; q0 += BM) {
    // causal: a tile whose rows all see some key, but none of this block's
    // keys, adds exactly 0 (the same for every thread of the block)
    if (causal && q0 + shift >= 0 && q0 + BM - 1 + shift < k0) continue;
    const int nq = min(BM, tq - q0);
    __syncthreads();  // the previous query tile is consumed
    load_tile<T, DT>(q_s, q + ((size_t)bh * tq + q0) * D, nq, D);
    load_tile<T, DT>(do_s, dout + ((size_t)bh * tq + q0) * D, nq, D);
    load_row(lse_s, lse + (size_t)bh * tq + q0, BM, nq);
    load_row(delta_s, delta + (size_t)bh * tq + q0, BM, nq);
    __syncthreads();

    float p[4][4], dsoft[4][4];
    tile_probs<DT>(q_s, k_s, do_s, v_s, lse_s, delta_s, kb_s, q0, k0, tq, tk,
                   scale, causal, p, dsoft);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_s[(ty + 16 * i) * LP + tx + 16 * j] = p[i][j];
        ds_s[(ty + 16 * i) * LP + tx + 16 * j] = dsoft[i][j];
      }
    __syncthreads();

    // dV += P^T dO, dK += dSoft^T Q (scaled at the end), dKeyBias += dSoft
    for (int r = 0; r < nq; ++r) {
      float pr[4], dr[4], o[NJ], x[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = p_s[r * LP + ty + 16 * i];
        dr[i] = ds_s[r * LP + ty + 16 * i];
        acc_b[i] += dr[i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        o[j] = do_s[r * LD + tx + 16 * j];
        x[j] = q_s[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc_v[i][j] = fmaf(pr[i], o[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(dr[i], x[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= tk) continue;
    const size_t row = ((size_t)bh * tk + c) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        store(acc_k[i][j] * scale, dk + row + d);
        store(acc_v[i][j], dv + row + d);
      }
    }
    if (dkb_part != nullptr && tx == 0)
      dkb_part[(size_t)bh * tk + c] = acc_b[i];
  }
}

template <int DT>
struct DqSmem {
  static constexpr int LD = DT + 1;
  static constexpr size_t floats =
      (size_t)2 * BM * LD + 2 * BN * LD + BM * LP + 2 * BM + BN;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ key_bias,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H,
                    int tq, int tk, int D, float scale, int causal) {
  constexpr int LD = DT + 1, NJ = DT / 16;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // [BM][LD]
  float* do_s = q_s + BM * LD;     // [BM][LD]
  float* k_s = do_s + BM * LD;     // [BN][LD]
  float* v_s = k_s + BN * LD;      // [BN][LD]
  float* ds_s = v_s + BN * LD;     // [BM][LP]
  float* lse_s = ds_s + BM * LP;   // [BM]
  float* delta_s = lse_s + BM;     // [BM]
  float* kb_s = delta_s + BM;      // [BN]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x, b = bh / H;
  const int q0 = blockIdx.y * BM, nq = min(BM, tq - q0);
  load_tile<T, DT>(q_s, q + ((size_t)bh * tq + q0) * D, nq, D);
  load_tile<T, DT>(do_s, dout + ((size_t)bh * tq + q0) * D, nq, D);
  load_row(lse_s, lse + (size_t)bh * tq + q0, BM, nq);
  load_row(delta_s, delta + (size_t)bh * tq + q0, BM, nq);

  // causal: key tiles past the last key any row of this tile sees add 0,
  // when every row of the tile sees some key (rows that see none come out
  // uniform over all keys, as in the plain version)
  const int shift = tk - tq;
  const int kv_end =
      causal && q0 + shift >= 0 ? min(tk, q0 + BM + shift) : tk;

  // this thread accumulates query rows ty + 16i, head dims tx + 16j
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    const int nk = min(BN, tk - k0);
    __syncthreads();  // the previous key tile is consumed
    load_tile<T, DT>(k_s, k + ((size_t)bh * tk + k0) * D, nk, D);
    load_tile<T, DT>(v_s, v + ((size_t)bh * tk + k0) * D, nk, D);
    load_row(kb_s,
             key_bias != nullptr ? key_bias + (size_t)b * tk + k0 : nullptr,
             BN, nk);
    __syncthreads();

    float p[4][4], dsoft[4][4];
    tile_probs<DT>(q_s, k_s, do_s, v_s, lse_s, delta_s, kb_s, q0, k0, tq, tk,
                   scale, causal, p, dsoft);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[(ty + 16 * i) * LP + tx + 16 * j] = dsoft[i][j];
    __syncthreads();

    // dQ += dSoft K (scaled at the end)
    for (int c = 0; c < nk; ++c) {
      float dr[4], x[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = ds_s[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) x[j] = k_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dr[i], x[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= tq) continue;
    const size_t row = ((size_t)bh * tq + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(acc[i][j] * scale, dq + row + d);
    }
  }
}

template <typename T, int DT>
int launch(const void* q, const void* k, const void* v, const float* kb,
           const void* out, const float* lse, const void* dout, float* delta,
           void* dq, void* dk, void* dv, float* dkb_part, int B, int H,
           int tq, int tk, int D, float scale, int causal,
           cudaStream_t stream) {
  const int bh = B * H;
  const int rows = bh * tq;
  flash_bwd_delta_kernel<T><<<(rows + THREADS / 32 - 1) / (THREADS / 32),
                              THREADS, 0, stream>>>(
      (const T*)out, (const T*)dout, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_kv = DkdvSmem<DT>::bytes;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<T, DT>
      <<<dim3(bh, (tk + BN - 1) / BN), THREADS, smem_kv, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, kb, (const T*)dout, lse,
          delta, (T*)dk, (T*)dv, dkb_part, H, tq, tk, D, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = DqSmem<DT>::bytes;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, DT>
      <<<dim3(bh, (tq + BM - 1) / BM), THREADS, smem_q, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, kb, (const T*)dout, lse,
          delta, (T*)dq, H, tq, tk, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tier(const void* q, const void* k, const void* v, const float* kb,
                const void* out, const float* lse, const void* dout,
                float* delta, void* dq, void* dk, void* dv, float* dkb_part,
                int B, int H, int tq, int tk, int D, float scale, int causal,
                cudaStream_t s) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, kb, out, lse, dout, delta, dq, dk, dv,
                         dkb_part, B, H, tq, tk, D, scale, causal, s);
  if (D <= 64)
    return launch<T, 64>(q, k, v, kb, out, lse, dout, delta, dq, dk, dv,
                         dkb_part, B, H, tq, tk, D, scale, causal, s);
  return launch<T, 128>(q, k, v, kb, out, lse, dout, delta, dq, dk, dv,
                        dkb_part, B, H, tq, tk, D, scale, causal, s);
}

}  // namespace

// Plain C entry point (bound with ctypes): launches the delta, dK/dV and dQ
// kernels in that order on `stream` and returns the first launch error (0
// when all three launched). Q/O/dO/dQ: [B, H, tq, D]; K/V/dK/dV:
// [B, H, tk, D]; all contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// key_bias: fp32 [B, tk] or null; lse: fp32 [B, H, tq] from the forward;
// delta: fp32 [B, H, tq] scratch; dkb_part: fp32 [B, H, tk], the key-bias
// gradient per head (null when there is no key bias).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const float* key_bias, const void* out,
                                   const float* lse, const void* dout,
                                   float* delta, void* dq, void* dk, void* dv,
                                   float* dkb_part, int B, int H, int tq,
                                   int tk, int D, float scale, int causal,
                                   int is_bf16, void* stream) {
  if (D < 1 || D > MAX_D || tq < 1 || tk < 1 || B < 1 || H < 1 ||
      (long long)B * H > 0x7fffffff || (long long)B * H * tq > 0x7fffffff ||
      (tq + BM - 1) / BM > 65535 || (tk + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_tier<__nv_bfloat16>(q, k, v, key_bias, out, lse, dout, delta,
                                      dq, dk, dv, dkb_part, B, H, tq, tk, D,
                                      scale, causal, s);
  return launch_tier<float>(q, k, v, key_bias, out, lse, dout, delta, dq, dk,
                            dv, dkb_part, B, H, tq, tk, D, scale, causal, s);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
