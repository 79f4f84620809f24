// Copies from device memory into shared memory, and the stores of output
// rows, shared by the port's Hopper flash kernels: flash_fwd.cu,
// flash_bwd.cu and flash_bwd_tiled.cu (through mma_common.cuh, which
// matmul_i8.cu includes for its 16-byte copies) and flash_tf32.cu. It
// holds the asynchronous copies (cp.async in 16, 8 and 4 bytes), a flash
// problem's Shape, the copy width of a call, and the narrow staging and
// storing that let the flash kernels take any head dim D <= 128.
// ops/cuda_build.py keys a kernel's build on every header it includes,
// directly or through another header.
//
// The copy width. The flash kernels stage rows of (B, T, H, D) views into
// shared tiles of DP head dims (DP a power of two >= D), zeros in [D, DP)
// and past T. At launch the C entry picks one copy width W for the call
// (copy_width): the widest of 16, 8, 4 and 2 bytes that divides D's bytes,
// every stride's bytes and every operand pointer. So a chunk of W bytes
// never straddles the end of a row's D elements. Each kernel keeps its
// 16-byte path (W = 16 and D a multiple of 8: 16-byte cp.async.cg chunks,
// pair stores of whole 8-column tiles) as one instantiation per DP,
// compiled as before, and takes every other problem in a second, narrow
// instantiation per DP that reads W from the Shape (with_dp):
// - staging (stage_any): cp.async.cg for 16 bytes, cp.async.ca for 8 and
//   4 (.cg takes 16 only), and for 2 bytes (an odd D in bf16), which
//   cp.async does not take, a plain 16-bit load and shared store; chunks
//   in [D, DP) and rows past T are zero-stored W bytes at a time, so no
//   store reaches the row padding past DP;
// - stores (store_pair): exactly D columns of each output row, as pairs
//   where W holds two elements (then D is even), else one at a time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// A flash-attention problem: (B, T, H, D) with the element strides of
// its q, k and v views (unit stride along D), and the call's copy width.
struct Shape {
  int b, h, t, d;
  long long sb, st, sh;  // element strides of q, k and v
  int w;                 // copy width in bytes (copy_width)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The copy width of a call: the widest of 16, 8, 4 and 2 bytes that
// divides d * elem, each stride times elem and each pointer of `ptrs`; 0
// when that is below one element (a pointer that is not aligned to its
// elements), which the C entries refuse.
template <int N>
inline int copy_width(int d, long long sb, long long st, long long sh,
                      int elem, const void* const (&ptrs)[N]) {
  unsigned long long bits =
      (unsigned long long)d * elem | (unsigned long long)sb * elem |
      (unsigned long long)st * elem | (unsigned long long)sh * elem;
  for (const void* p : ptrs) bits |= (uintptr_t)p;
  int w = 16;
  while (w > 1 && bits % w) w /= 2;
  return w >= elem ? w : 0;
}

// Calls f(dp, narrow) with dp the smallest head-dim capacity DP in {kMin,
// ..., 128} (powers of two, kMin 8 or 16) that holds s.d, as a
// std::integral_constant, and narrow a std::bool_constant: false on the
// 16-byte path (s.w == 16 and D a multiple of 8), true otherwise.
template <int kMin, typename F>
void with_dp(const Shape& s, F&& f) {
  const bool narrow = !(s.w == 16 && s.d % 8 == 0);
  auto go = [&](auto dp) {
    if (narrow) {
      f(dp, std::true_type{});
    } else {
      f(dp, std::false_type{});
    }
  };
  if constexpr (kMin <= 8) {
    if (s.d <= 8) return go(std::integral_constant<int, 8>{});
  }
  if (s.d <= 16) {
    go(std::integral_constant<int, 16>{});
  } else if (s.d <= 32) {
    go(std::integral_constant<int, 32>{});
  } else if (s.d <= 64) {
    go(std::integral_constant<int, 64>{});
  } else {
    go(std::integral_constant<int, 128>{});
  }
}

// Copies one chunk of w bytes (16, 8, 4 or 2) into shared memory.
__device__ __forceinline__ void copy_chunk(void* dst, const void* src,
                                           int w) {
  if (w == 16) {
    cp_async16(dst, src);
  } else if (w == 8) {
    cp_async8(dst, src);
  } else if (w == 4) {
    cp_async4(dst, src);
  } else {
    *static_cast<unsigned short*>(dst) =
        __ldg(static_cast<const unsigned short*>(src));
  }
}

// Zeros one chunk of w bytes of shared memory.
__device__ __forceinline__ void zero_chunk(void* dst, int w) {
  if (w == 16) {
    *static_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else if (w == 8) {
    *static_cast<uint2*>(dst) = make_uint2(0u, 0u);
  } else if (w == 4) {
    *static_cast<uint32_t*>(dst) = 0u;
  } else {
    *static_cast<unsigned short*>(dst) = 0;
  }
}

// The narrow path's staging: copies rows r0 .. r0 + rows - 1 of one
// (batch, head) of a (B, T, H, D) tensor of E with element strides (sb,
// st, sh, 1) into `dst` (rows x LD elements, LD * sizeof(E) a multiple of
// 16) in chunks of s.w bytes, `threads` threads of the block taking the
// chunks in turn; head dims in [D, DP) and rows past T are zeros.
template <int DP, int LD, typename E>
__device__ __forceinline__ void stage_any(E* dst, const E* src, long long sb,
                                          long long st, long long sh,
                                          const Shape& s, int bi, int hi,
                                          int r0, int rows, int threads) {
  const int per = s.w / (int)sizeof(E);   // elements of a chunk
  const int lg = 31 - __clz(DP / per);    // log2 of a row's chunks
  for (int c = threadIdx.x; c < (rows << lg); c += threads) {
    const int r = c >> lg, x = (c & ((1 << lg) - 1)) * per;
    E* at = dst + r * LD + x;
    if (r0 + r < s.t && x < s.d) {
      copy_chunk(at,
                 src + (long long)bi * sb + (long long)(r0 + r) * st +
                     (long long)hi * sh + x,
                 s.w);
    } else {
      zero_chunk(at, s.w);
    }
  }
}

// The narrow path's stores: x0 and x1 as columns col and col + 1 (col
// even) of an output row that starts at `row`, each only where it is
// below D; one pair store where the copy width holds two elements (D is
// even then, so a pair lies wholly inside D or wholly past it), else one
// element at a time.
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int col,
                                           const Shape& s, float x0,
                                           float x1) {
  if (col >= s.d) return;
  if (s.w >= 4) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    *reinterpret_cast<uint32_t*>(row + col) =
        *reinterpret_cast<const uint32_t*>(&v);
    return;
  }
  row[col] = __float2bfloat16_rn(x0);
  if (col + 1 < s.d) row[col + 1] = __float2bfloat16_rn(x1);
}

__device__ __forceinline__ void store_pair(float* row, int col,
                                           const Shape& s, float x0,
                                           float x1) {
  if (col >= s.d) return;
  if (s.w >= 8) {
    *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
    return;
  }
  row[col] = x0;
  if (col + 1 < s.d) row[col + 1] = x1;
}

}  // namespace
