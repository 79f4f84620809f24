// Flash attention in float32 for Hopper (sm_90a) on the tensor cores: the
// forward, and the backward as a dQ kernel and then a dK/dV kernel. Every
// product runs as three TF32 mma.sync.m16n8k8 (3xTF32) with float32 sums.
// Bound to Python through plain C functions loaded with ctypes.
//
//   forward: s_ij = (q_i * scale) . k_j,  m_i = max_j s_ij
//            O_i = sum_j exp(s_ij - m_i) V_j / l_i,  lse_i = m_i + log l_i
//   dQ:      delta_i = dO_i . O_i
//            P_ij = exp(scale * (q_i . k_j) - lse_i)  (0 if masked)
//            dS_ij = P_ij (dO_i . V_j - delta_i),  dQ_i = scale sum_j dS_ij K_j
//   dK/dV:   dV_j = sum_i P_ij dO_i,  dK_j = scale sum_i dS_ij Q_i
//
// Replaces, for float32 problems at every head dim, the Pallas TPU
// kernels of pytorch_distributed_mnist_tpu/ops/pallas/flash.py:
// _flash_forward (:147, body _fwd_kernel :65) and _flash_backward (:274,
// bodies _dq_kernel :194 and _dkv_kernel :230, delta in XLA :285-290). It
// takes over from flash.cu's CUDA-core kernels, which stay only as routes
// a caller may name.
//
// Why 3xTF32. The float32 route is held to rtol 1e-4 against the plain
// float32 version. A TF32 operand keeps 10 mantissa bits: one TF32 product
// per multiply misses that tolerance many times over. So every operand x is
// split as hi = rna_tf32(x), lo = rna_tf32(x - hi) (round to nearest, ties
// away, as cvt.rna.tf32.f32 rounds), which carries about 21 bits, and each
// product a b is summed as a_lo b_hi + a_hi b_lo + a_hi b_hi, the two small
// products issued first (a_lo b_lo, about 2^-22 of the product, is dropped).
// Products of TF32 values are exact in float32; the sums are float32.
//
// Forward, FlashAttention-2 style. A block of 4 warps owns one (batch,
// head) and 64 query rows, 16 per warp. It copies its q tile and then
// 64-key tiles of k and v into shared memory with 16-byte cp.async loads
// straight from the strided views, double-buffered, so any T is taken; q is
// scaled in shared memory once (the reference scales q before the product).
// Per key tile a warp computes S = Q K^T in two steps of 32 keys (4 n-tiles
// of 8), runs the online softmax in float32 registers (a row's max over the
// 4 lanes of a quad), and adds P V into its 16 x D accumulator.
//
// Backward, as flash_bwd_tiled.cu: the dQ kernel owns 64 query rows,
// writes delta for the dK/dV kernel, and streams double-buffered 64-key
// tiles of K and V; the dK/dV kernel owns 64 key rows and streams 64-query
// tiles of Q and dO with their lse and delta, computing S^T = K Q^T and
// dP^T = V dO^T so that P^T and dS^T come out as the A operand of dV += P^T
// dO and dK += dS^T Q. No atomics: two runs give the same bits.
//
// Fragments. There is no ldmatrix for 32-bit elements (it moves 16-bit
// ones, and its .trans form has no 32-bit variant), so every fragment is
// read with 32-bit shared loads and split as it is read. Each shared row is
// padded by 4 floats (LD = DP + 4), which keeps both read patterns free of
// bank conflicts at DP = 8, 16, 32, 64 and 128: an A fragment or a B fragment
// of K^T, element (row g, column tq), lands on bank (g LD + tq) mod 32, and
// a B fragment read by key row 2 tq (+1), column g, on bank (8 tq + g) mod
// 32. The C layout of m16n8k8 is not its A layout: a thread holds columns
// 2tq, 2tq+1 of S, where the next product's A operand wants tq, tq+4. No
// shuffle fixes that up. P's C fragment is taken as the A fragment of a
// reordered key axis (A column tq is key 2tq, column tq+4 key 2tq+1), and
// V's (or K's, dO's, Q's) B fragment is read at those keys; the sum over
// keys does not depend on their order.
//
// Instructions. At D = 16 the kernels issue many more instructions than
// tensor-core products: every fragment element costs a shared load and a
// split, every score an exp and a few float32 operations, as in
// flash_bwd_tiled.cu. So:
// - the split is integer and float32 operations (each part's rounding an
//   add and a mask, lo one subtraction; the compiler drops the masks the
//   tensor cores do not read), fewer than cvt.rna.tf32.f32 compiles to;
// - the products of a step are issued pass by pass over independent
//   accumulators (and, below D = 32, into partial sums of P V), so that
//   consecutive mma.sync do not wait on each other; no branch separates
//   them: every n-tile of a step is computed, and only whole steps of 32
//   rows are skipped (past T, or above the causal diagonal);
// - the exponent is one fused multiply-add and the exp one ex2.approx.ftz;
// - an n-tile wholly inside T and under the start-aligned causal diagonal
//   (qi >= kj) checks no element; only the ragged and diagonal n-tiles
//   check each element. Key (or query) tiles wholly above the diagonal are
//   not loaded. Rows past T are zeros in shared memory and are never
//   stored; a row with nothing to attend gives O = 0 and lse = -1e30.
// On an H100 this form ran faster at the ViT's shapes than a first one
// that split with cvt.rna.tf32.f32 and branched around each n-tile. Head
// dims are padded to DP in {8, 16, 32, 64, 128} with zeros, which the
// products sum without a check.
//
// Shared memory, per block of 64 rows with tiles of 64 x (DP + 4) float32:
// the forward holds q and two buffers each of k and v (5 tiles, 25,600
// bytes at D = 16, 168,960 at D = 128). The dQ kernel would hold q, dO, O
// and two buffers each of k and v, 7 tiles or 236,544 bytes at D = 128,
// over the 232,448 a block may have: so O is not staged, and delta =
// rowsum(dO . O) is summed from O's and dO's rows in device memory while
// the first tiles are in flight (6 tiles, 203,264 bytes at D = 128). The
// dK/dV kernel holds k, v and two buffers each of q and dO (6 tiles). Both
// take their streamed tile in two steps of 32 rows, which keeps S, dP and
// the 16 x D dK and dV sums in registers at D = 128. Registers (ptxas -v,
// sm_90a, nvcc 12.8) of the forward, dQ and dK/dV kernels: 70, 80, 85 at
// DP = 8; 90, 126, 127 at 16; 120, 165, 128 at 32; 119, 124, 162 at 64;
// 185, 167, 254 at 128; none spilled. The narrow instantiations: 72, 72
// (48 bytes spilled), 96 at DP = 8; 80, 127, 128 at 16; 117, 165, 154 at
// 32; 124, 124, 165 at 64; 164, 166, 239 at 128.
//
// Operands: q, k and v are (B, T, H, D) float32 views sharing the strides
// (sb, st, sh) with a unit stride along D; O, dO, dQ, dK and dV are
// contiguous (B, T, H, D) float32; lse and delta are contiguous (B, H, T)
// float32. Any T >= 1 and 1 <= D <= 128, every pointer aligned to its
// elements. With D a multiple of 8, every tensor pointer 16-byte aligned
// and every stride a multiple of 4 elements the kernels take their
// 16-byte path; any other view their narrow instantiation, which copies
// and stores in the call's copy width (stage_common.cuh) at the same DP
// (D = 12 pads to 16, D = 4 and 7 to 8), and sums delta element by element
// in the same order.
//
// What bounds it on an H100 (3.35 TB/s; 495 TFLOP/s TF32 dense, so 165
// TFLOP/s of float32-accurate products at three TF32 products each): at
// the ViT's shape (B=256, T=49, H=4, D=16) the forward moves 13.0 MB (q, k,
// v in, O and lse out), 0.0039 ms, for 0.157 GFLOP of products, 0.0010 ms:
// bound by bytes. At --patch-size 2 (T = 196) it moves 52.2 MB, 0.0156 ms,
// for 2.52 GFLOP, 0.0153 ms; the backward pair moves 157.4 MB, 0.047 ms,
// for 8.81 GFLOP, 0.053 ms: there the products bound the pair. Each operand
// is read once per kernel from device memory (K and V again per 64-row
// query tile, Q and dO per key tile, from L2), and S, P, dP and dS never
// leave the chip.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stage_common.cuh"  // cp_async16, cp_async4, Shape, copy_width,
                             // with_dp, stage_any, store_pair

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;           // warps of one block
constexpr int kRows = 16 * kWarps;  // rows a block owns, and of a tile
constexpr int kPad = 4;             // floats added to each shared row
constexpr int kStep = 32;           // streamed rows per step of a warp
constexpr int kNT = kStep / 8;      // n-tiles of 8 rows per step

// 2^x in one instruction: the hardware's ex2 (about 2 ulp; a result below
// float32's smallest normal is flushed to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x as hi + lo, each a TF32 value rounded to nearest, ties away from zero:
// the rounding of cvt.rna.tf32.f32, written as integer operations (half a
// unit of the kept last bit added, the 13 dropped bits cleared), which take
// fewer instructions than that conversion compiles to.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// c (16x8 float32) += a (16x8 TF32, row-major) * b (8x8 TF32, col-major).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies rows r0 .. r0+63 of one (batch, head) of a float32 (B, T, H, D)
// tensor with element strides (sb, st, sh, 1) into `dst` (64 x (DP +
// kPad)), zeros past T and past D: 16-byte chunks, or with kNarrow chunks
// of the call's copy width.
template <int DP, bool kNarrow>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long sb, long long st,
                                      long long sh, const Shape& s, int bi,
                                      int hi, int r0) {
  constexpr int LD = DP + kPad, CPR = DP / 4;
  if constexpr (kNarrow) {
    stage_any<DP, LD>(dst, src, sb, st, sh, s, bi, hi, r0, kRows,
                      kWarps * 32);
  } else {
    for (int c = threadIdx.x; c < kRows * CPR; c += kWarps * 32) {
      const int r = c / CPR, x = c % CPR;
      float* at = dst + r * LD + x * 4;
      if (r0 + r < s.t && x * 4 < s.d) {
        cp_async16(at, src + (long long)bi * sb + (long long)(r0 + r) * st +
                           (long long)hi * sh + x * 4);
      } else {
        *reinterpret_cast<float4*>(at) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// Copies rows r0 .. r0+63 of one (batch, head) of a (B, H, T) float32
// statistic into `dst`, zeros past T.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           const Shape& s, int bh, int r0) {
  for (int r = threadIdx.x; r < kRows; r += kWarps * 32) {
    if (r0 + r < s.t) {
      cp_async4(dst + r, src + (long long)bh * s.t + r0 + r);
    } else {
      dst[r] = 0.f;
    }
  }
}

// c[n] = A B_n^T for the n-tiles n < NT: A is the warp's 16 rows at `a`,
// B_n the 8 rows of `b` from row 8n, both row-major with LD = DP + kPad
// floats a row, summed over all DP columns (those past D are zeros). Per
// k-step of 8 the products are issued pass by pass (every n-tile's a_lo b_hi,
// then every a_hi b_lo, then every a_hi b_hi), so that consecutive mma.sync
// write different accumulators and do not wait on each other.
template <int DP, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const float* a,
                                        const float* b) {
  constexpr int LD = DP + kPad;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  }
  // Unrolled whole up to D = 32; two k-steps at a time above, which keeps
  // the dQ kernel at D = 128 from spilling.
  constexpr int KU = DP >= 64 ? 2 : DP / 8;
#pragma unroll KU
  for (int kk = 0; kk < DP; kk += 8) {
    // A fragment: a0 (g, tq), a1 (g + 8, tq), a2 (g, tq + 4), a3 (g + 8,
    // tq + 4).
    const float* ar = a + g * LD + kk + tq;
    uint32_t ah[4], al[4];
    split(ar[0], ah[0], al[0]);
    split(ar[8 * LD], ah[1], al[1]);
    split(ar[4], ah[2], al[2]);
    split(ar[8 * LD + 4], ah[3], al[3]);
    // B fragment of B_n^T: b0 (k = tq, n = g), b1 (k = tq + 4, n = g).
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* br = b + (8 * n + g) * LD + kk + tq;
      split(br[0], bh[n][0], bl[n][0]);
      split(br[4], bh[n][1], bl[n][1]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(c[n], al, bh[n][0], bh[n][1]);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(c[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(c[n], ah, bh[n][0], bh[n][1]);
  }
}

// dst (16 x DP) += P B for one n-tile of P (16 x 8, mma's C layout:
// element e is row g + 8 (e >> 1), column 2 tq + (e & 1)) and the 8 rows of
// B it stands for, `br` pointing at B's row 2 tq, column g. P serves as the
// A operand of a k-step whose index tq stands for column 2 tq and tq + 4 for
// 2 tq + 1, and B's rows are read in that order. Pass by pass over groups of
// up to four 8-column tiles of dst.
template <int DP>
__device__ __forceinline__ void mma_pb_tile(float (&dst)[DP / 8][4],
                                            const float (&p)[4],
                                            const float* br) {
  constexpr int LD = DP + kPad, NJ = DP / 8, JG = NJ < 4 ? NJ : 4;
  uint32_t ah[4], al[4];
  split(p[0], ah[0], al[0]);  // (g, column 2tq)
  split(p[2], ah[1], al[1]);  // (g + 8, column 2tq)
  split(p[1], ah[2], al[2]);  // (g, column 2tq + 1)
  split(p[3], ah[3], al[3]);  // (g + 8, column 2tq + 1)
#pragma unroll
  for (int j0 = 0; j0 < NJ; j0 += JG) {
    uint32_t bh[JG][2], bl[JG][2];
#pragma unroll
    for (int jj = 0; jj < JG; ++jj) {
      split(br[8 * (j0 + jj)], bh[jj][0], bl[jj][0]);       // row 2tq
      split(br[LD + 8 * (j0 + jj)], bh[jj][1], bl[jj][1]);  // row 2tq + 1
    }
#pragma unroll
    for (int jj = 0; jj < JG; ++jj) {
      mma_tf32(dst[j0 + jj], al, bh[jj][0], bh[jj][1]);
    }
#pragma unroll
    for (int jj = 0; jj < JG; ++jj) {
      mma_tf32(dst[j0 + jj], ah, bl[jj][0], bl[jj][1]);
    }
#pragma unroll
    for (int jj = 0; jj < JG; ++jj) {
      mma_tf32(dst[j0 + jj], ah, bh[jj][0], bh[jj][1]);
    }
  }
}

// acc (16 x DP) += P B over P's NT n-tiles, B's 8 NT rows at `b` (row-major
// with LD floats a row). Below D = 32, dst has fewer than four 8-column
// tiles, so the n-tiles go round-robin into PS partial sums, added to acc at
// the end: at least four accumulator chains are in flight.
template <int DP, int NT>
__device__ __forceinline__ void mma_pb(float (&acc)[DP / 8][4],
                                       const float (&p)[NT][4],
                                       const float* b) {
  constexpr int LD = DP + kPad, NJ = DP / 8, PS = NJ >= 4 ? 1 : 4 / NJ;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const float* br = b + 2 * tq * LD + g;
  if constexpr (PS == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_pb_tile<DP>(acc, p[n], br + 8 * n * LD);
  } else {
    float part[PS][NJ][4];
#pragma unroll
    for (int q = 0; q < PS; ++q) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[q][j][e] = 0.f;
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mma_pb_tile<DP>(part[n % PS], p[n], br + 8 * n * LD);
    }
#pragma unroll
    for (int q = 0; q < PS; ++q) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[q][j][e];
      }
    }
  }
}

// Writes a warp's 16 x DP accumulator (mma's C layout) times `scale` as
// rows row0.. of a contiguous (B, T, H, D) float32 tensor; rows >= T and
// columns >= D are dropped. The 16-byte path (D a multiple of 8) stores
// whole 8-column tiles as float2 pairs; the narrow one (kNarrow) exactly
// D columns (store_pair).
template <int DP, bool kNarrow>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[DP / 8][4],
                                           const Shape& s, int bi, int hi,
                                           int row0, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    if (8 * j >= s.d) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (row >= s.t) continue;
      if constexpr (kNarrow) {
        store_pair(out + (((long long)bi * s.t + row) * s.h + hi) * s.d,
                   8 * j + 2 * tq, s, __fmul_rn(scale, acc[j][2 * half]),
                   __fmul_rn(scale, acc[j][2 * half + 1]));
      } else {
        const long long at =
            (((long long)bi * s.t + row) * s.h + hi) * s.d + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(out + at) =
            make_float2(__fmul_rn(scale, acc[j][2 * half]),
                        __fmul_rn(scale, acc[j][2 * half + 1]));
      }
    }
  }
}

template <int DP, bool kNarrow>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Shape s, float scale,
                      int causal) {
  constexpr int LD = DP + kPad;  // row stride of every shared tile
  constexpr int TILE = kRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + TILE;      // two buffers, TILE apart
  float* vs = ks + 2 * TILE;  // two buffers, TILE apart

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, bi = bh / s.h, hi = bh % s.h;
  const int q0 = blockIdx.y * kRows;
  const int wq0 = q0 + warp * 16;  // this warp's first query row
  // Under the causal mask no row of this tile (warp) sees a key past its
  // last row.
  const int kend = causal ? min(s.t, q0 + kRows) : s.t;
  const int wend = causal ? min(s.t, wq0 + 16) : s.t;
  const int ntiles = (kend + kRows - 1) / kRows;

  stage<DP, kNarrow>(qs, q, s.sb, s.st, s.sh, s, bi, hi, q0);
  stage<DP, kNarrow>(ks, k, s.sb, s.st, s.sh, s, bi, hi, 0);
  stage<DP, kNarrow>(vs, v, s.sb, s.st, s.sh, s, bi, hi, 0);
  cp_async_commit();

  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  // Row g and row g + 8 of the warp's 16: running max, and this lane's
  // share of the running sum (the quad's four shares are added at the end).
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {  // prefetch the next key tile
      stage<DP, kNarrow>(ks + (buf ^ 1) * TILE, k, s.sb, s.st, s.sh, s, bi,
                         hi, (it + 1) * kRows);
      stage<DP, kNarrow>(vs + (buf ^ 1) * TILE, v, s.sb, s.st, s.sh, s, bi,
                         hi, (it + 1) * kRows);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the prefetch has landed
    __syncthreads();
    if (it == 0) {  // q * scale, rounded once, as the reference has it
      for (int c = threadIdx.x; c < kRows * DP; c += kWarps * 32) {
        float* at = qs + (c / DP) * LD + c % DP;
        *at = __fmul_rn(*at, scale);
      }
      __syncthreads();
    }
    const int k0 = it * kRows;
    // Steps of 32 keys with a key before wend: 0, 1 or 2 of the tile's.
    const int steps =
        wq0 < s.t ? max(0, min(2, (wend - k0 + kStep - 1) / kStep)) : 0;
    if (steps > 0) {
      const float* kt = ks + buf * TILE;
      const float* vt = vs + buf * TILE;
      float sc[2][kNT][4];
      mma_abt<DP, kNT>(sc[0], qs + warp * 16 * LD, kt);
      if (steps > 1) {
        mma_abt<DP, kNT>(sc[1], qs + warp * 16 * LD, kt + kStep * LD);
      }
      // Mask; the tile's row max. Element e of n-tile n of step h is row
      // g + 8 (e >> 1), key k0 + 32h + 8n + 2tq + (e & 1).
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= steps) break;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int kb = k0 + h * kStep + 8 * n;
          const bool full = kb + 8 <= s.t && (!causal || kb + 7 <= wq0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!full) {
              const int kj = kb + 2 * tq + (e & 1);
              const int qi = wq0 + g + 8 * (e >> 1);
              if (kj >= s.t || (causal && qi < kj)) sc[h][n][e] = kNegInf;
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[h][n][e]);
          }
        }
      }
      float ml2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // 0 while nothing was kept: l and acc are still 0 then.
        const float corr = fast_exp2((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        ml2[r] = mx[r] * kLog2e;
        l[r] *= corr;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          acc[j][2 * r] *= corr;
          acc[j][2 * r + 1] *= corr;
        }
      }
      // P = exp(s - m), masked scores (-1e30) giving 0; every row has a
      // kept key in the first tile, so m is finite from there on.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= steps) break;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[h][n][e] = fast_exp2(fmaf(sc[h][n][e], kLog2e, -ml2[e >> 1]));
            l[e >> 1] += sc[h][n][e];
          }
        }
      }
      mma_pb<DP, kNT>(acc, sc[0], vt);
      if (steps > 1) mma_pb<DP, kNT>(acc, sc[1], vt + kStep * LD);
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = wq0 + g + 8 * half;
    if (row >= s.t) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    float* out = o + (((long long)bi * s.t + row) * s.h + hi) * s.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j >= s.d) break;
      const float x0 = acc[j][2 * half] / denom;
      const float x1 = acc[j][2 * half + 1] / denom;
      if constexpr (kNarrow) {
        store_pair(out, 8 * j + 2 * tq, s, x0, x1);
      } else {
        *reinterpret_cast<float2*>(out + 8 * j + 2 * tq) =
            make_float2(x0, x1);
      }
    }
    if (tq == 0) {
      lse[(long long)bh * s.t + row] =
          l[half] > 0.f ? m[half] + logf(denom) : kNegInf;
    }
  }
}

template <int DP, bool kNarrow>
__global__ void __launch_bounds__(kWarps * 32)
flash_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     float* __restrict__ delta, float* __restrict__ dq,
                     Shape s, float scale, int causal) {
  constexpr int LD = DP + kPad;
  constexpr int TILE = kRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + TILE;
  float* ks = dos + TILE;     // two buffers, TILE apart
  float* vs = ks + 2 * TILE;  // two buffers, TILE apart
  float* lse_s = vs + 2 * TILE;
  float* delta_s = lse_s + kRows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, bi = bh / s.h, hi = bh % s.h;
  const long long dsb = (long long)s.t * s.h * s.d, dst = (long long)s.h * s.d;
  const int q0 = blockIdx.y * kRows;
  const int wq0 = q0 + warp * 16;  // this warp's first query row
  const int kend = causal ? min(s.t, q0 + kRows) : s.t;
  const int wend = causal ? min(s.t, wq0 + 16) : s.t;
  const int ntiles = (kend + kRows - 1) / kRows;

  stage<DP, kNarrow>(qs, q, s.sb, s.st, s.sh, s, bi, hi, q0);
  stage<DP, kNarrow>(dos, dout, dsb, dst, s.d, s, bi, hi, q0);
  stage_rows(lse_s, lse, s, bh, q0);
  stage<DP, kNarrow>(ks, k, s.sb, s.st, s.sh, s, bi, hi, 0);
  stage<DP, kNarrow>(vs, v, s.sb, s.st, s.sh, s, bi, hi, 0);
  cp_async_commit();
  // delta = rowsum(dO * O) in float32 from the rows in device memory (O is
  // not staged: see the header), while the tiles above are in flight.
  if (threadIdx.x < kRows) {
    const int row = q0 + threadIdx.x;
    float sum = 0.f;
    if (row < s.t) {
      const long long at = (long long)bi * dsb + (long long)row * dst +
                           (long long)hi * s.d;
      if constexpr (kNarrow) {  // the same order, one element at a time
        for (int x = 0; x < s.d; ++x) {
          sum = __fadd_rn(sum, __fmul_rn(__ldg(dout + at + x),
                                         __ldg(o + at + x)));
        }
      } else {
        const float4* orow = reinterpret_cast<const float4*>(o + at);
        const float4* drow = reinterpret_cast<const float4*>(dout + at);
        for (int x = 0; x < s.d / 4; ++x) {
          const float4 a = __ldg(drow + x), b = __ldg(orow + x);
          sum = __fadd_rn(sum, __fmul_rn(a.x, b.x));
          sum = __fadd_rn(sum, __fmul_rn(a.y, b.y));
          sum = __fadd_rn(sum, __fmul_rn(a.z, b.z));
          sum = __fadd_rn(sum, __fmul_rn(a.w, b.w));
        }
      }
      delta[(long long)bh * s.t + row] = sum;
    }
    delta_s[threadIdx.x] = sum;
  }

  float dqa[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
  }
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {  // prefetch the next key tile
      stage<DP, kNarrow>(ks + (buf ^ 1) * TILE, k, s.sb, s.st, s.sh, s, bi,
                         hi, (it + 1) * kRows);
      stage<DP, kNarrow>(vs + (buf ^ 1) * TILE, v, s.sb, s.st, s.sh, s, bi,
                         hi, (it + 1) * kRows);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the prefetch has landed
    __syncthreads();
    if (wq0 < s.t) {
      // lse * log2 e and delta of rows g and g + 8 of this warp.
      float l2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l2[r] = lse_s[warp * 16 + g + 8 * r] * kLog2e;
        dl[r] = delta_s[warp * 16 + g + 8 * r];
      }
#pragma unroll
      for (int step = 0; step < kRows / kStep; ++step) {
        const int kb0 = it * kRows + step * kStep;  // first key of the step
        if (kb0 >= wend) break;
        const float* kt = ks + buf * TILE + step * kStep * LD;
        const float* vt = vs + buf * TILE + step * kStep * LD;
        float sc[kNT][4], dp[kNT][4];
        mma_abt<DP, kNT>(sc, qs + warp * 16 * LD, kt);
        mma_abt<DP, kNT>(dp, dos + warp * 16 * LD, vt);
        // dS into dp. Element e of n-tile n: query wq0 + g + 8 (e >> 1),
        // key kb0 + 8n + 2tq + (e & 1).
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int kb = kb0 + 8 * n;
          const bool full = kb + 8 <= s.t && (!causal || kb + 7 <= wq0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fast_exp2(fmaf(sc[n][e], sl2, -l2[e >> 1]));
            if (!full) {
              const int kj = kb + 2 * tq + (e & 1);
              const int qi = wq0 + g + 8 * (e >> 1);
              if (kj >= s.t || (causal && qi < kj)) p = 0.f;
            }
            dp[n][e] = p * (dp[n][e] - dl[e >> 1]);
          }
        }
        mma_pb<DP, kNT>(dqa, dp, kt);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  store_rows<DP, kNarrow>(dq, dqa, s, bi, hi, wq0, scale);
}

template <int DP, bool kNarrow>
__global__ void __launch_bounds__(kWarps * 32)
flash_dkv_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      Shape s, float scale, int causal) {
  constexpr int LD = DP + kPad;
  constexpr int TILE = kRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + TILE;
  float* qs = vs + TILE;          // two buffers, TILE apart
  float* dos = qs + 2 * TILE;     // two buffers, TILE apart
  float* lse_s = dos + 2 * TILE;  // two of kRows
  float* delta_s = lse_s + 2 * kRows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, bi = bh / s.h, hi = bh % s.h;
  const long long dsb = (long long)s.t * s.h * s.d, dst = (long long)s.h * s.d;
  const int k0 = blockIdx.y * kRows;
  const int wk0 = k0 + warp * 16;  // this warp's first key row
  const float sl2 = scale * kLog2e;
  // Under the causal mask no query before this tile's first key sees it.
  const int first = causal ? blockIdx.y : 0;
  const int ntiles = (s.t + kRows - 1) / kRows;

  stage<DP, kNarrow>(ks, k, s.sb, s.st, s.sh, s, bi, hi, k0);
  stage<DP, kNarrow>(vs, v, s.sb, s.st, s.sh, s, bi, hi, k0);
  stage<DP, kNarrow>(qs, q, s.sb, s.st, s.sh, s, bi, hi, first * kRows);
  stage<DP, kNarrow>(dos, dout, dsb, dst, s.d, s, bi, hi, first * kRows);
  stage_rows(lse_s, lse, s, bh, first * kRows);
  stage_rows(delta_s, delta, s, bh, first * kRows);
  cp_async_commit();

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }

  for (int it = first; it < ntiles; ++it) {
    const int buf = (it - first) & 1;
    if (it + 1 < ntiles) {  // prefetch the next query tile
      const int nb = buf ^ 1, r0 = (it + 1) * kRows;
      stage<DP, kNarrow>(qs + nb * TILE, q, s.sb, s.st, s.sh, s, bi, hi,
                         r0);
      stage<DP, kNarrow>(dos + nb * TILE, dout, dsb, dst, s.d, s, bi, hi,
                         r0);
      stage_rows(lse_s + nb * kRows, lse, s, bh, r0);
      stage_rows(delta_s + nb * kRows, delta, s, bh, r0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (wk0 < s.t) {
#pragma unroll
      for (int step = 0; step < kRows / kStep; ++step) {
        const int qb0 = it * kRows + step * kStep;  // first query of it
        if (qb0 >= s.t) break;
        // Under the causal mask, a step wholly before this warp's first
        // key is dead.
        if (causal && qb0 + kStep - 1 < wk0) continue;
        const int r0 = step * kStep;  // first row of the step in the tile
        const float* qt = qs + buf * TILE + r0 * LD;
        const float* dot = dos + buf * TILE + r0 * LD;
        const float* lse_t = lse_s + buf * kRows + r0;
        const float* delta_t = delta_s + buf * kRows + r0;
        float sc[kNT][4], dp[kNT][4];
        mma_abt<DP, kNT>(sc, ks + warp * 16 * LD, qt);
        mma_abt<DP, kNT>(dp, vs + warp * 16 * LD, dot);
        // P^T into sc and dS^T into dp. Element e of n-tile n: key wk0 + g
        // + 8 (e >> 1), query qb0 + 8n + 2tq + (e & 1).
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int qb = qb0 + 8 * n;
          const bool full = qb + 8 <= s.t && (!causal || qb >= wk0 + 15);
          const float2 lq = *reinterpret_cast<const float2*>(
              lse_t + 8 * n + 2 * tq);
          const float2 dq2 = *reinterpret_cast<const float2*>(
              delta_t + 8 * n + 2 * tq);
          const float l2[2] = {lq.x * kLog2e, lq.y * kLog2e};
          const float dl[2] = {dq2.x, dq2.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fast_exp2(fmaf(sc[n][e], sl2, -l2[e & 1]));
            if (!full) {
              const int qi = qb + 2 * tq + (e & 1);
              const int kj = wk0 + g + 8 * (e >> 1);
              if (qi >= s.t || (causal && qi < kj)) p = 0.f;
            }
            sc[n][e] = p;
            dp[n][e] = p * (dp[n][e] - dl[e & 1]);
          }
        }
        mma_pb<DP, kNT>(dva, sc, dot);
        mma_pb<DP, kNT>(dka, dp, qt);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  store_rows<DP, kNarrow>(dk, dka, s, bi, hi, wk0, scale);
  store_rows<DP, kNarrow>(dv, dva, s, bi, hi, wk0, 1.f);
}

// Shared memory of one block (see the header).
__host__ __device__ constexpr size_t fwd_smem(int dp) {
  return (size_t)5 * kRows * (dp + kPad) * sizeof(float);
}
__host__ __device__ constexpr size_t dq_smem(int dp) {
  return (size_t)6 * kRows * (dp + kPad) * sizeof(float) +
         (size_t)2 * kRows * sizeof(float);
}
__host__ __device__ constexpr size_t dkv_smem(int dp) {
  return (size_t)6 * kRows * (dp + kPad) * sizeof(float) +
         (size_t)4 * kRows * sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

dim3 grid_of(const Shape& s) {
  return dim3((unsigned)(s.b * s.h), (unsigned)((s.t + kRows - 1) / kRows));
}

template <int DP, bool kNarrow>
cudaError_t launch_fwd(const Shape& s, const void* q, const void* k,
                       const void* v, void* o, void* lse, float scale,
                       int causal, cudaStream_t stream) {
  const cudaError_t err =
      allow_smem(flash_fwd_tf32_kernel<DP, kNarrow>, fwd_smem(DP));
  if (err != cudaSuccess) return err;
  flash_fwd_tf32_kernel<DP, kNarrow>
      <<<grid_of(s), kWarps * 32, fwd_smem(DP), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, s, scale, causal);
  return cudaGetLastError();
}

template <int DP, bool kNarrow>
cudaError_t launch_bwd(const Shape& s, const void* q, const void* k,
                       const void* v, const void* o, const void* dout,
                       const void* lse, void* delta, void* dq, void* dk,
                       void* dv, float scale, int causal,
                       cudaStream_t stream) {
  cudaError_t err =
      allow_smem(flash_dq_tf32_kernel<DP, kNarrow>, dq_smem(DP));
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_dkv_tf32_kernel<DP, kNarrow>, dkv_smem(DP));
  if (err != cudaSuccess) return err;
  flash_dq_tf32_kernel<DP, kNarrow>
      <<<grid_of(s), kWarps * 32, dq_smem(DP), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, (const float*)lse, (float*)delta, (float*)dq, s,
      scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_dkv_tf32_kernel<DP, kNarrow>
      <<<grid_of(s), kWarps * 32, dkv_smem(DP), stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const float*)dout, (const float*)lse, (const float*)delta,
      (float*)dk, (float*)dv, s, scale, causal);
  return cudaGetLastError();
}

// What the kernels take (see the header); `bf16` must be 0.
bool takes(const Shape& s, int bf16_in) {
  return bf16_in == 0 && s.b >= 1 && s.h >= 1 && s.t >= 1 && s.d >= 1 &&
         s.d <= 128 && s.w > 0 && (long long)s.b * s.h <= 0x7fffffffLL &&
         (s.t + kRows - 1) / kRows <= 65535;
}

}  // namespace

// Each entry launches on `stream` (a stream of `device`) and returns
// cudaGetLastError() (0 when every launch was accepted), or
// cudaErrorInvalidValue for what the kernels do not take (see the notes
// above). None synchronises. This library carries its own copy of the CUDA
// runtime, whose current device is not PyTorch's: each entry selects the
// operands' device.

// q, k, v (b, t, h, d) float32 with strides (sb, st, sh, 1). Writes o (b,
// t, h, d) contiguous and lse (b, h, t) float32.
extern "C" int flash_fwd_tf32_launch(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int b, int h, int t, int d,
                                     long long sb, long long st,
                                     long long sh, float scale, int causal,
                                     int bf16_in, int device, void* stream) {
  const void* ptrs[] = {q, k, v, o};  // lse: float stores
  const Shape s{b, h, t, d, sb, st, sh, copy_width(d, sb, st, sh, 4, ptrs)};
  if (!takes(s, bf16_in)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  with_dp<8>(s, [&](auto dp, auto narrow) {
    err = launch_fwd<decltype(dp)::value, decltype(narrow)::value>(
        s, q, k, v, o, lse, scale, causal, (cudaStream_t)stream);
  });
  return (int)err;
}

// Launches the dQ kernel and then the dK/dV kernel. q, k, v as above; o and
// dout (b, t, h, d) contiguous; lse (b, h, t) float32. Writes delta (b, h,
// t) float32, and dq, dk and dv (b, t, h, d) contiguous.
extern "C" int flash_bwd_tf32_launch(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     void* delta, void* dq, void* dk,
                                     void* dv, int b, int h, int t, int d,
                                     long long sb, long long st,
                                     long long sh, float scale, int causal,
                                     int bf16_in, int device, void* stream) {
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};  // lse, delta: floats
  const Shape s{b, h, t, d, sb, st, sh, copy_width(d, sb, st, sh, 4, ptrs)};
  if (!takes(s, bf16_in)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  with_dp<8>(s, [&](auto dp, auto narrow) {
    err = launch_bwd<decltype(dp)::value, decltype(narrow)::value>(
        s, q, k, v, o, dout, lse, delta, dq, dk, dv, scale, causal,
        (cudaStream_t)stream);
  });
  return (int)err;
}
