// Tensor-core building blocks shared by the port's Hopper kernels
// (flash_fwd.cu, flash_bwd.cu, flash_bwd_tiled.cu, matmul_i8.cu): ldmatrix
// (plain and transposed), the bf16 mma.sync.m16n8k16 with float32 sums,
// the lane offsets of the three ldmatrix layouts those kernels read, and
// the flash kernels' store of an accumulator's rows. The asynchronous
// copies, the flash problem's Shape and the copy width come from
// stage_common.cuh. Each kernel is its own nvcc translation unit;
// ops/cuda_build.py keys a kernel's build on this file and the headers it
// includes too, so an edit here rebuilds every kernel that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_common.cuh"  // cp_async*, Shape, copy_width, with_dp,
                             // stage_any, store_pair

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 added to each shared row: ldmatrix's
                         // eight row addresses land in distinct banks

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// Four 8x8 16-bit matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. `ldsm_t` transposes each matrix.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 float32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values rounded to nearest even as one bf16 pair (lo first).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lane offsets (in 16-bit elements, from a 16 x 16 block's first element,
// rows `ld` apart) of the three ldmatrix layouts:
//   a_off:  A operand stored row-major (rows = m, cols = k);
//   b_off:  B operand from a tile stored n-major (rows = n, cols = k):
//           two n-tiles of 8 rows, 16 k-columns;
//   bt_off: B operand from a tile stored k-major (rows = k, cols = n),
//           transposed: 16 k-rows, two n-tiles of 8 columns.
__device__ __forceinline__ int a_off(int lane, int ld) {
  return (lane & 15) * ld + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int bt_off(int lane, int ld) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + ((lane >> 4) << 3);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Writes a warp's 16 x DP float32 accumulator (2*NP n-tiles of 8 columns,
// mma's C layout) as bf16 rows row0.. of a contiguous (B, T, H, D) tensor,
// times `scale` when `scaled`; rows >= T and columns >= D are dropped. The
// 16-byte path (D a multiple of 8) stores whole n-tiles as 32-bit pairs;
// the narrow one (kNarrow) exactly D columns (store_pair).
template <int NP, bool kNarrow = false>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&acc)[2 * NP][4],
                                           const Shape& s, int bi, int hi,
                                           int row0, float scale,
                                           bool scaled) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) {
    if (n * 8 >= s.d) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (row >= s.t) continue;
      float x0 = acc[n][2 * half], x1 = acc[n][2 * half + 1];
      if (scaled) {
        x0 = __fmul_rn(scale, x0);
        x1 = __fmul_rn(scale, x1);
      }
      if constexpr (kNarrow) {
        store_pair(out + (((long long)bi * s.t + row) * s.h + hi) * s.d,
                   n * 8 + 2 * tq, s, x0, x1);
      } else {
        const long long at =
            (((long long)bi * s.t + row) * s.h + hi) * s.d + n * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(out + at) = pack(x0, x1);
      }
    }
  }
}

}  // namespace
