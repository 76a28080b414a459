// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// Replaces paddle_tpu/ops/pallas_attention.py::_fa_bwd (lines 213-286), the
// JAX package's backward of its TPU flash kernel. That one is not a Pallas
// kernel: it is an XLA lax.scan over KV blocks that recomputes P from the
// saved logsumexp. Same function here, over [B, H, T, D] heads, fp32 or
// bf16 inputs, fp32 accumulation:
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
//   2. dK/dV: one block per (b*h, tile of BN = 64 keys); a loop inside the
//      block walks the query tiles (the TPU scan's sequential axis),
//      keeping the tile's dK and dV in registers. It also writes dKeyBias
//      per head, [B, H, Tk], which the wrapper sums over H.
//   3. dQ: one block per (b*h, tile of BM = 64 query rows), walking the
//      key tiles.
// Each block owns its outputs, so there are no atomics and the result is
// deterministic. Both passes recompute S and dP (7 products in all against
// the 5 the function needs): the price of no atomics on dQ.
//
// Not carried over from the TPU: no head-dim padding to 128 and no
// multiple-of-128 rule. D is padded to the next of the tiers 32, 64, 128 in
// shared memory only (zero-filled), and ragged query and key tails are
// masked.
//
// The design: every product runs on the tensor cores as mma.sync with fp32
// accumulation, 4 warps per block, each owning 16 rows of the block's tile.
//   * fp32 inputs: m16n8k8 TF32 as 3xTF32 (x = big + small; big*big +
//     big*small + small*big, about 2^-21 relative error per product), as
//     in the forward kernel, but with the split in 3 integer and float
//     instructions (split() below) instead of two cvt.rna.
//   * bf16 inputs: m16n8k16 bf16. Q, K, V, dO are exact in bf16, so S and
//     dP are exact products with fp32 sums; P and dSoft (fp32 in
//     registers) are rounded to bf16 once to feed dV, dK and dQ, as
//     FlashAttention-2 does. bf16 tiles stay bf16 in shared memory and are
//     read with ldmatrix (.trans for the operands read along their rows).
//   * The dK/dV pass computes S^T = K Q^T and dP^T = V dO^T, so that keys
//     are the M dimension: P^T and dSoft^T come out as C fragments that are
//     the A fragments of dV += P^T dO and dK += dSoft^T Q (by permuting the
//     k order for TF32, as the forward does for P.V; as they are for bf16),
//     with no trip through shared memory. lse and delta index the N
//     (query) dimension; dKeyBias is a row sum of dSoft^T, reduced across
//     the 4 lanes of a quad at the end.
//   * The dQ pass keeps the forward's orientation: S and dP are C
//     fragments, and dSoft is the A fragment of dQ += dSoft K.
//   * The streamed operand (Q, dO, lse and delta in the dK/dV pass; K, V
//     and the key bias in the dQ pass) is double-buffered with cp.async:
//     tile j+1 loads while tile j computes, one __syncthreads per tile.
//     Rows that are not 16-byte aligned (D = 33, say) load element by
//     element. Row paddings of 4 (fp32) and 8 (bf16) elements keep every
//     fragment read free of bank conflicts.
//   * dQ, dK and dV leave through shared memory and go to device memory
//     as whole rows (16-byte stores), not as the 2- or 4-byte pieces of a
//     C fragment scattered over 8 rows: those cost as much as the loop at
//     the model path's shape.
//   * Causal: query tiles (dK/dV) or key tiles (dQ) that add exactly 0 are
//     skipped by the block, and by each warp for its 16 rows, wherever
//     every row of the tile sees some key; a row that sees no key comes
//     out uniform over all keys, as in the plain version.
//   * At D = 128 the streamed tile is 32 rows, so the accumulators fit in
//     registers.
//   * The dQ kernel is a programmatic dependent launch of the dK/dV kernel:
//     its blocks take the SMs the dK/dV grid leaves free (neither fills
//     the card at the model path's shapes), and it waits for the dK/dV
//     grid before it ends, so the stream's order holds after it.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s; 495 TFLOP/s TF32 and 989
// TFLOP/s bf16 dense on the tensor cores, 67 TFLOP/s fp32 outside them) at
// the model path's shape [8, 8, 256, 64] with a key bias, non-causal: the
// function needs 5 products of 2*B*H*Tq*Tk*D = 0.54 GFLOP; it moves about
// 17 MB in bf16 (Q, K, V, O, dO read, dQ, dK, dV written, lse, key bias),
// 0.005 ms, and 34 MB in fp32. bf16 is bound by its bytes (5 products at
// 989 TFLOP/s take 0.0027 ms); fp32, as 3xTF32, by operations (0.0163 ms).
// What keeps the kernels above that: they run 7 products, 3 TF32 products
// each for fp32, plus the splits of every operand into TF32 terms on the
// CUDA cores (the fp32 dK/dV kernel has 9 SASS instructions for each
// HMMA); each pass has 256 blocks of 4 warps for 132 SMs, too few warps to
// hide the latency of mma.sync, ldmatrix and the tile loads. Left for
// later work: wgmma with TMA and warp specialisation, and 5 products
// instead of 7 (dQ by fp32 atomics, or dSoft written once and reused).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

using namespace tc;

constexpr int BM = 64;        // dQ pass: query rows per block, 16 per warp
constexpr int BN = 64;        // dK/dV pass: keys per block, 16 per warp
constexpr int THREADS = 128;  // 4 warps
constexpr int DELTA_THREADS = 256;  // the delta kernel: a warp per row
constexpr int MAX_D = 128;
constexpr float LOG2E = 1.4426950408889634f;
// the causal fill of the JAX kernels, -1e30, in the base-2 score domain
constexpr float MASKED = -1e30f * LOG2E;

// shared-memory geometry at head-dim tier DT: the row stride (elements)
// and the rows of the streamed tiles
template <typename T, int DT>
struct Geom {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int LD = DT + (F32 ? 4 : 8);
  static constexpr int BQ = DT == 128 ? 32 : 64;  // dK/dV: query tile rows
  static constexpr int BK = DT == 128 ? 32 : 64;  // dQ: key tile rows
  static constexpr size_t dkdv_bytes =
      sizeof(T) * LD * (2 * BN + 4 * BQ) + sizeof(float) * 4 * BQ;
  static constexpr size_t dq_bytes =
      sizeof(T) * LD * (2 * BM + 4 * BK) + sizeof(float) * 2 * BK;
};

// x = big + small for the 3xTF32 products: big is x rounded to TF32 (to
// nearest, ties away from zero, as cvt.rna rounds), small = x - big
// exactly, passed as its fp32 bits: the tensor core reads the top 10
// mantissa bits of an operand, so small is truncated to TF32 there. Three
// instructions, where two cvt.rna take eight.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c[n] += A B over one warp, n in [0, NT): A is 16 rows of a row-major
// shared tile `a` (KD columns), B(k, n) = b[n][k] for the 8 NT rows of
// another (S = Q K^T and its kin). Both row strides are LD.
template <typename T, int KD, int NT, int LD>
__device__ __forceinline__ void mma_nt(float (&c)[NT][4], const T* a,
                                       const T* b, int lane) {
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
    const float* ar = a + g * LD + t;
    const float* br = b + g * LD + t;
#pragma unroll
    for (int kk = 0; kk < KD / 8; ++kk) {
      uint32_t ab[4], as[4];
      split(ar[8 * kk], ab[0], as[0]);               // (g, t)
      split(ar[8 * LD + 8 * kk], ab[1], as[1]);      // (g + 8, t)
      split(ar[8 * kk + 4], ab[2], as[2]);           // (g, t + 4)
      split(ar[8 * LD + 8 * kk + 4], ab[3], as[3]);  // (g + 8, t + 4)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        split(br[8 * n * LD + 8 * kk], bb0, bs0);
        split(br[8 * n * LD + 8 * kk + 4], bb1, bs1);
        mma_terms<true>(c[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  } else {
    // A: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15); B: two n-tiles, each
    // (k 0-7, k 8-15)
    // (shared-memory byte addresses; a row is 2 LD bytes)
    const unsigned ar = smem_u32(a + (lane & 15) * LD + (lane >> 4) * 8);
    const unsigned br = smem_u32(
        b + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, ar + 32 * kk);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bf[4];
        ldsm_x4(bf, br + 2 * (16 * n2 * LD + 16 * kk));
        mma_bf16(c[2 * n2], af, bf[0], bf[1]);
        mma_bf16(c[2 * n2 + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// c[n] += A B over one warp, n in [0, NT): A (16 x KD) is held in
// registers as the KD / 8 C fragments p of an earlier product; B(k, n) =
// b[k][n], rows of a row-major shared tile with stride LD (dV = P^T dO and
// its kin). bf16: A is rounded to bf16 here.
template <typename T, int KD, int NT, int LD>
__device__ __forceinline__ void mma_cn(float (&c)[NT][4],
                                       const float (&p)[KD / 8][4],
                                       const T* b, int lane) {
  if constexpr (std::is_same<T, float>::value) {
    // logical k = t is column 2t of the C fragment, k = t + 4 column 2t + 1;
    // B's rows are read in the same order
    const int g = lane >> 2, t = lane & 3;
    const float* br = b + 2 * t * LD + g;
#pragma unroll
    for (int j = 0; j < KD / 8; ++j) {
      uint32_t ab[4], as[4];
      split(p[j][0], ab[0], as[0]);
      split(p[j][2], ab[1], as[1]);
      split(p[j][1], ab[2], as[2]);
      split(p[j][3], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* bp = br + 8 * j * LD + 8 * n;
        uint32_t bb0, bs0, bb1, bs1;
        split(bp[0], bb0, bs0);
        split(bp[LD], bb1, bs1);
        mma_terms<true>(c[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  } else {
    // B: two n-tiles, each (k 0-7, k 8-15), transposed on load
    const unsigned br = smem_u32(
        b + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < KD / 16; ++j) {
      const uint32_t af[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                              pack_bf16(p[2 * j][2], p[2 * j][3]),
                              pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                              pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, br + 2 * (16 * j * LD + 16 * n2));
        mma_bf16(c[2 * n2], af, bf[0], bf[1]);
        mma_bf16(c[2 * n2 + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// this warp's 16 x DT accumulator (C fragments) times mul, as T, into rows
// [0, 16) of a shared tile with row stride LD
template <typename T, int DT, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const float (&acc)[DT / 8][4],
                                           float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < DT / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      T* p = dst + (g + 8 * i) * LD + 8 * n + 2 * t;
      store(acc[n][2 * i] * mul, p);
      store(acc[n][2 * i + 1] * mul, p + 1);
    }
}

template <int N>
__device__ __forceinline__ void clear(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int D) {
  const long long row =
      ((long long)blockIdx.x * DELTA_THREADS + threadIdx.x) / 32;
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

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ key_bias,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, float* __restrict__ dkb_part, int H,
                      int tq, int tk, int D, float scale, float scale_log2,
                      int causal, int vec) {
  using G = Geom<T, DT>;
  constexpr int LD = G::LD, BQ = G::BQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [BN][LD]
  T* v_s = k_s + BN * LD;                   // [BN][LD]
  T* q_s = v_s + BN * LD;                   // 2 x [BQ][LD]
  T* do_s = q_s + 2 * BQ * LD;              // 2 x [BQ][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * LD);  // 2 x [BQ]
  float* delta_s = lse_s + 2 * BQ;                              // 2 x [BQ]

  // the dQ kernel, launched next, may start beside this one (see launch())
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * BN;
  const T* qg = q + (size_t)bh * tq * D;
  const T* dog = dout + (size_t)bh * tq * D;
  const float* lseg = lse + (size_t)bh * tq;
  const float* deltag = delta + (size_t)bh * tq;

  // Causal: a query tile whose rows all see some key, but none of this
  // block's keys, adds exactly 0. With q0 = i * BQ, tiles [0, nb) hold a
  // row that sees no key (only when Tq > Tk) and are walked; tiles
  // [nb, ns) are skipped; tiles [ns, n_qt) are walked.
  const int shift = tk - tq;
  const int n_qt = (tq + BQ - 1) / BQ;
  int nb = 0, ns = 0;
  if (causal) {
    if (shift < 0) nb = min(n_qt, (-shift + BQ - 1) / BQ);
    const int need = k0 - shift - BQ + 1;  // tile i is walked if i*BQ >= need
    ns = max(nb, min(n_qt, need <= 0 ? 0 : (need + BQ - 1) / BQ));
  }
  const int n_iter = nb + n_qt - ns;
  auto tile_q0 = [&](int i) { return (i < nb ? i : i - nb + ns) * BQ; };

  load_tile<T, DT, LD, BN, THREADS>(k_s, k + ((size_t)bh * tk + k0) * D,
                                    min(BN, tk - k0), D, vec, tid);
  load_tile<T, DT, LD, BN, THREADS>(v_s, v + ((size_t)bh * tk + k0) * D,
                                    min(BN, tk - k0), D, vec, tid);
  auto load_q = [&](int q0, int st) {
    const int n = min(BQ, tq - q0);
    load_tile<T, DT, LD, BQ, THREADS>(q_s + st * BQ * LD, qg + (size_t)q0 * D,
                                      n, D, vec, tid);
    load_tile<T, DT, LD, BQ, THREADS>(do_s + st * BQ * LD,
                                      dog + (size_t)q0 * D, n, D, vec, tid);
    if (tid < BQ) {
      const bool ok = tid < n;
      cp_async4(lse_s + st * BQ + tid, ok ? lseg + q0 + tid : lseg, ok);
      cp_async4(delta_s + st * BQ + tid, ok ? deltag + q0 + tid : deltag, ok);
    }
    cp_async_commit();
  };
  if (n_iter > 0) load_q(tile_q0(0), 0);

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kw = k0 + warp * 16;  // the warp's first key
  // this thread's keys kw + g and kw + g + 8: key bias in base 2
  float kb2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = kw + g + 8 * i;
    kb2[i] = key_bias != nullptr && c < tk
                 ? key_bias[(size_t)b * tk + c] * LOG2E : 0.f;
  }
  const T* k_w = k_s + warp * 16 * LD;
  const T* v_w = v_s + warp * 16 * LD;

  float acc_k[DT / 8][4], acc_v[DT / 8][4], acc_b[2] = {0.f, 0.f};
  clear(acc_k);
  clear(acc_v);

  for (int i = 0; i < n_iter; ++i) {
    const int st = i & 1, q0 = tile_q0(i);
    cp_async_wait_all();  // tile i (and K, V) landed
    __syncthreads();      // ... for every thread; tile i-1 is consumed
    if (i + 1 < n_iter) load_q(tile_q0(i + 1), st ^ 1);
    // every row sees some key but none of this warp's keys: adds 0
    if (causal && q0 + shift >= 0 && q0 + BQ - 1 + shift < kw) continue;
    const T* q_t = q_s + st * BQ * LD;
    const T* do_t = do_s + st * BQ * LD;
    const float* lse_t = lse_s + st * BQ + 2 * t;
    const float* delta_t = delta_s + st * BQ + 2 * t;

    // P^T: keys kw + g (+8) in s[j][0..1] ([2..3]), queries
    // q0 + 8j + 2t + {0, 1}
    float s[BQ / 8][4];
    clear(s);
    mma_nt<T, DT, BQ / 8, LD>(s, k_w, q_t, lane);
    // the masks in a code path of their own, for the tiles that need them
    auto probs = [&](auto masking) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * j);
        const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ki = e >> 1, qi = e & 1;
          float x = fmaf(s[j][e], scale_log2, kb2[ki] - l2[qi]);
          if (decltype(masking)::value) {
            const int r = q0 + 8 * j + 2 * t + qi, c = kw + g + 8 * ki;
            if (r >= tq)
              x = -INFINITY;  // past the last query: adds nothing
            else if (causal && c > r + shift)
              x = MASKED - l2[qi];
          }
          s[j][e] = exp2f(x);
        }
      }
    };
    if (q0 + BQ > tq || (causal && kw + 15 > q0 + shift))
      probs(std::true_type());
    else
      probs(std::false_type());
    mma_cn<T, BQ, DT / 8, LD>(acc_v, s, do_t, lane);  // dV += P^T dO

    // dSoft^T = P^T (dP^T - delta), dP^T = V dO^T
    float dp[BQ / 8][4];
    clear(dp);
    mma_nt<T, DT, BQ / 8, LD>(dp, v_w, do_t, lane);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(delta_t + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[j][e] = s[j][e] * (dp[j][e] - ((e & 1) ? dl.y : dl.x));
        acc_b[e >> 1] += dp[j][e];
      }
    }
    mma_cn<T, BQ, DT / 8, LD>(acc_k, dp, q_t, lane);  // dK += dSoft^T Q
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    acc_b[i] += __shfl_xor_sync(0xffffffffu, acc_b[i], 1);
    acc_b[i] += __shfl_xor_sync(0xffffffffu, acc_b[i], 2);
    const int c = kw + g + 8 * i;
    if (dkb_part != nullptr && t == 0 && c < tk)
      dkb_part[(size_t)bh * tk + c] = acc_b[i];
  }
  // dK and dV leave through shared memory (the Q and dO buffers, free
  // now), so that the stores to device memory are whole rows
  __syncthreads();
  stage_rows<T, DT, LD>(q_s + warp * 16 * LD, acc_k, scale, lane);
  stage_rows<T, DT, LD>(do_s + warp * 16 * LD, acc_v, 1.f, lane);
  __syncthreads();
  const size_t first = ((size_t)bh * tk + k0) * D;
  store_tile<T, DT, LD, BN, THREADS>(dk + first, q_s, min(BN, tk - k0), D,
                                     vec, tid);
  store_tile<T, DT, LD, BN, THREADS>(dv + first, do_s, min(BN, tk - k0), D,
                                     vec, tid);
}

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ key_bias,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H,
                    int tq, int tk, int D, float scale, float scale_log2,
                    int causal, int vec) {
  using G = Geom<T, DT>;
  constexpr int LD = G::LD, BK = G::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [BM][LD]
  T* do_s = q_s + BM * LD;                  // [BM][LD]
  T* k_s = do_s + BM * LD;                  // 2 x [BK][LD]
  T* v_s = k_s + 2 * BK * LD;               // 2 x [BK][LD]
  float* kb_s = reinterpret_cast<float*>(v_s + 2 * BK * LD);  // 2 x [BK]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H;
  // causal: the query tiles that see the most keys start first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BM;
  const T* kg = k + (size_t)bh * tk * D;
  const T* vg = v + (size_t)bh * tk * D;
  const float* kbg = key_bias != nullptr ? key_bias + (size_t)b * tk : nullptr;

  // causal: key tiles past the last key any row of this tile sees add 0,
  // when every row of the tile sees some key (rows that see none come out
  // uniform over all keys, as in the plain version)
  const int shift = tk - tq;
  const bool skip_ok = causal && q0 + shift >= 0;
  const int kv_end = skip_ok ? min(tk, q0 + BM + shift) : tk;
  const int n_tiles = (kv_end + BK - 1) / BK;

  auto load_kv = [&](int tile, int st) {
    const int k0 = tile * BK, n = min(BK, tk - k0);
    load_tile<T, DT, LD, BK, THREADS>(k_s + st * BK * LD, kg + (size_t)k0 * D,
                                      n, D, vec, tid);
    load_tile<T, DT, LD, BK, THREADS>(v_s + st * BK * LD, vg + (size_t)k0 * D,
                                      n, D, vec, tid);
    if (tid < BK) {
      float* dst = kb_s + st * BK + tid;
      if (kbg != nullptr)
        cp_async4(dst, tid < n ? kbg + k0 + tid : kbg, tid < n);
      else
        *dst = 0.f;
    }
    cp_async_commit();
  };
  const int nq = min(BM, tq - q0);
  load_tile<T, DT, LD, BM, THREADS>(q_s, q + ((size_t)bh * tq + q0) * D, nq,
                                    D, vec, tid);
  load_tile<T, DT, LD, BM, THREADS>(do_s, dout + ((size_t)bh * tq + q0) * D,
                                    nq, D, vec, tid);
  load_kv(0, 0);

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * 16;  // the warp's first query row
  const int rows[2] = {wrow + g, wrow + g + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = rows[i] < tq;
    lse2[i] = ok ? lse[(size_t)bh * tq + rows[i]] * LOG2E : 0.f;
    dl[i] = ok ? delta[(size_t)bh * tq + rows[i]] : 0.f;
  }
  const T* q_w = q_s + warp * 16 * LD;
  const T* do_w = do_s + warp * 16 * LD;

  float acc[DT / 8][4];
  clear(acc);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, k0 = it * BK;
    cp_async_wait_all();  // tile it (and Q, dO) landed
    __syncthreads();      // ... for every thread; tile it-1 is consumed
    if (it + 1 < n_tiles) load_kv(it + 1, st ^ 1);
    // every row of this warp sees none of the tile: it adds exactly 0
    if (skip_ok && k0 > wrow + 15 + shift) continue;
    const T* k_t = k_s + st * BK * LD;
    const T* v_t = v_s + st * BK * LD;
    const float* kb_t = kb_s + st * BK + 2 * t;

    // P: rows wrow + g (+8) in s[n][0..1] ([2..3]), keys k0 + 8n + 2t + {0, 1}
    float s[BK / 8][4];
    clear(s);
    mma_nt<T, DT, BK / 8, LD>(s, q_w, k_t, lane);
    // the masks in a code path of their own, for the tiles that need them
    auto probs = [&](auto masking) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float2 kb = *reinterpret_cast<const float2*>(kb_t + 8 * n);
        const float kb2[2] = {kb.x * LOG2E, kb.y * LOG2E};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e >> 1, ci = e & 1;
          float x = fmaf(s[n][e], scale_log2, kb2[ci] - lse2[ri]);
          if (decltype(masking)::value) {
            const int c = k0 + 8 * n + 2 * t + ci;
            if (c >= tk)
              x = -INFINITY;  // past the last key: adds nothing
            else if (causal && c > rows[ri] + shift)
              x = MASKED - lse2[ri];
          }
          s[n][e] = exp2f(x);
        }
      }
    };
    if (k0 + BK > tk || (causal && k0 + BK - 1 > wrow + shift))
      probs(std::true_type());
    else
      probs(std::false_type());

    // dSoft = P (dP - delta), dP = dO V^T
    float dp[BK / 8][4];
    clear(dp);
    mma_nt<T, DT, BK / 8, LD>(dp, do_w, v_t, lane);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - dl[e >> 1]);
    mma_cn<T, BK, DT / 8, LD>(acc, dp, k_t, lane);  // dQ += dSoft K
  }

  // dQ leaves through shared memory (the Q buffer, free now), so that the
  // stores to device memory are whole rows
  __syncthreads();
  stage_rows<T, DT, LD>(q_s + warp * 16 * LD, acc, scale, lane);
  __syncthreads();
  store_tile<T, DT, LD, BM, THREADS>(dq + ((size_t)bh * tq + q0) * D, q_s, nq,
                                     D, vec, tid);
  // the dK/dV grid is done and its writes visible before this grid ends,
  // so whatever follows on the stream sees both
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename T, int DT>
int launch(const void* q, const void* k, const void* v, const float* kb,
           const void* out, const float* lse, const void* dout, float* delta,
           void* dq, void* dk, void* dv, float* dkb_part, int B, int H,
           int tq, int tk, int D, float scale, int causal,
           cudaStream_t stream) {
  using G = Geom<T, DT>;
  const int bh = B * H;
  const int rows = bh * tq;
  constexpr int rows_per_block = DELTA_THREADS / 32;
  flash_bwd_delta_kernel<T>
      <<<(rows + rows_per_block - 1) / rows_per_block, DELTA_THREADS, 0,
         stream>>>((const T*)out, (const T*)dout, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // rows of every input and output 16-byte aligned: 16-byte copies
  bool vec = (D * sizeof(T)) % 16 == 0;
  for (const void* p : {q, k, v, dout, (const void*)dq, (const void*)dk,
                        (const void*)dv})
    vec = vec && (uintptr_t)p % 16 == 0;
  const float scale_log2 = scale * LOG2E;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)G::dkdv_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<T, DT>
      <<<dim3(bh, (tk + BN - 1) / BN), THREADS, G::dkdv_bytes, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, kb, (const T*)dout, lse,
          delta, (T*)dk, (T*)dv, dkb_part, H, tq, tk, D, scale, scale_log2,
          causal, (int)vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)G::dq_bytes);
  if (err != cudaSuccess) return (int)err;
  // dQ needs nothing of dK/dV: a programmatic dependent launch lets its
  // blocks start on the SMs the dK/dV grid leaves free
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bh, (tq + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = G::dq_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dq_kernel<T, DT>, (const T*)q,
                           (const T*)k, (const T*)v, kb, (const T*)dout, lse,
                           (const float*)delta, (T*)dq, H, tq, tk, D, scale,
                           scale_log2, causal, (int)vec);
  if (err != cudaSuccess) return (int)err;
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
