// Device helpers shared by the flash-attention kernels (sm_90a): TF32 and
// bf16 mma.sync, ldmatrix, cp.async, and the tile loader.
//
// Fragment layouts of mma.sync (g = lane / 4, t = lane % 4):
//   m16n8k8 TF32   A: (g, t) (g+8, t) (g, t+4) (g+8, t+4)
//                  B: (k=t, n=g) (k=t+4, n=g)
//   m16n8k16 bf16  A: (g, 2t..2t+1) (g+8, 2t..2t+1) (g, 2t+8..2t+9)
//                     (g+8, 2t+8..2t+9), two per register
//                  B: (k=2t..2t+1, n=g) (k=2t+8..2t+9, n=g)
//   C, both:       (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1)
// A C fragment feeds the A operand of a second product without moving:
// for TF32 with the k order permuted (logical k = t -> column 2t, k = t+4
// -> column 2t+1; the B operand read in the same order), for bf16 as is
// (the C fragments of two neighbouring 8-column tiles are one A fragment).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x as TF32 terms: big = tf32(x), small = tf32(x - big) when SPLIT; an
// exact TF32 value (bf16 data) passes as its own bits.
template <bool SPLIT>
__device__ __forceinline__ void terms(float x, uint32_t& big, uint32_t& small) {
  if (SPLIT) {
    big = tf32(x);
    small = tf32(x - __uint_as_float(big));
  } else {
    big = __float_as_uint(x);
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b with a, b as TF32 terms: small products first, then big*big
template <bool SPLIT>
__device__ __forceinline__ void mma_terms(float (&c)[4], const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4], uint32_t bb0,
                                          uint32_t bb1, uint32_t bs0,
                                          uint32_t bs1) {
  if (SPLIT) {
    mma(c, as, bb0, bb1);
    mma(c, ab, bs0, bs1);
  }
  mma(c, ab, bb0, bb1);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// four 8 x 8 b16 matrices from the shared-memory address a; lane l gives
// the address of row l % 8 of matrix l / 8 (16-byte aligned). Plain:
// register i holds row g, columns 2t..2t+1 of matrix i. trans: rows
// 2t..2t+1, column g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// two fp32 values as one register of two bf16 (lo in the low half),
// rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ld_one(const float* p) { return *p; }
__device__ __forceinline__ float ld_one(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
template <typename T>
__device__ __forceinline__ T zero() { return T(0.f); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// cp.async of 16 (or 4) bytes; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [0, ROWS) x cols [0, DT) of a [rows][D] global tile into a
// [ROWS][STRIDE] shared tile by a block of THREADS; rows >= n_rows and
// cols >= D are zero. vec: 16-byte cp.async (rows 16-byte aligned);
// otherwise element loads and stores.
template <typename T, int DT, int STRIDE, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int n_rows,
                                          int D, bool vec, int tid) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);    // elements per copy
    constexpr int CPR = DT / EPC;          // copies per row
    constexpr int RPP = THREADS / CPR;     // rows per pass of the block
    static_assert(ROWS % RPP == 0, "tile rows must fill whole passes");
    const int r0 = tid / CPR, c = (tid % CPR) * EPC;
#pragma unroll
    for (int j = 0; j < ROWS / RPP; ++j) {
      const int r = r0 + j * RPP;
      const bool ok = r < n_rows && c < D;
      cp_async16(dst + r * STRIDE + c, ok ? src + r * D + c : src, ok);
    }
  } else {
    for (int i = tid; i < ROWS * DT; i += THREADS) {
      const int r = i / DT, c = i % DT;
      dst[r * STRIDE + c] =
          r < n_rows && c < D ? src[(size_t)r * D + c] : zero<T>();
    }
  }
}

// rows [0, n_rows) x cols [0, D) of a [ROWS][STRIDE] shared tile out to a
// [rows][D] global tile by a block of THREADS, neighbouring threads on
// neighbouring addresses. vec: 16-byte stores (rows 16-byte aligned).
template <typename T, int DT, int STRIDE, int ROWS, int THREADS>
__device__ __forceinline__ void store_tile(T* dst, const T* src, int n_rows,
                                           int D, bool vec, int tid) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);  // elements per copy
    constexpr int CPR = DT / EPC;        // copies per row
    for (int i = tid; i < ROWS * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * EPC;
      if (r < n_rows && c < D)
        *reinterpret_cast<uint4*>(dst + (size_t)r * D + c) =
            *reinterpret_cast<const uint4*>(src + r * STRIDE + c);
    }
  } else {
    for (int i = tid; i < n_rows * D; i += THREADS) {
      const int r = i / D, c = i % D;
      dst[(size_t)r * D + c] = src[r * STRIDE + c];
    }
  }
}

}  // namespace tc
