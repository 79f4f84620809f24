// Flash attention backward for Hopper (sm_90a) at any T, on the tensor
// cores (mma.sync m16n8k16, bf16 operands, float32 sums): a dQ kernel and
// then a dK/dV kernel, as the reference's two grids. Bound to Python
// through one plain C function, loaded with ctypes, that launches both.
//
//   delta_i = dO_i . O_i
//   s_ij    = scale * (q_i . k_j),  P_ij = exp(s_ij - lse_i)  (0 if masked)
//   dS_ij   = P_ij (dO_i . V_j - delta_i)
//   dQ_i    = scale * sum_j dS_ij K_j
//   dV_j    = sum_i P_ij dO_i
//   dK_j    = scale * sum_i dS_ij Q_i
//
// Replaces, for bf16 problems with T > 128, the Pallas TPU kernels of
// _flash_backward (pytorch_distributed_mnist_tpu/ops/pallas/flash.py:274,
// bodies _dq_kernel :194 and _dkv_kernel :230) and the delta that the TPU
// path computes in XLA between them (:285-290). The fused kernel
// (flash_bwd.cu) holds a whole (batch, head) in one block and stops at
// T = 128; this pair tiles T, so the ViT at --patch-size 2 (T = 196) trains
// on the tensor cores. The CUDA-core pair of flash.cu stays only as a
// route a caller may name.
//
// dQ kernel. A block of 4 warps owns one (batch, head) and 64 query rows,
// 16 per warp. It copies its q, dO and O rows and their lse into shared
// memory with cp.async (16 bytes a thread, straight from the strided views
// of q), sums delta = rowsum(dO . O) in float32 and writes it out for the
// dK/dV kernel, and keeps Q's and dO's A fragments in registers. It then
// streams double-buffered 64-key tiles of K and V; per 16 keys it computes
// S = Q K^T and dP = dO V^T, then P and dS = P (dP - delta) in float32
// registers, rounds dS once to bf16 straight from the accumulators into the
// A layout (as the forward does with P), and adds dS K into dQ.
//
// dK/dV kernel. A block owns one (batch, head) and 64 key rows, 16 per
// warp, and streams double-buffered 64-query tiles of Q and dO with their
// lse and delta. Per 16 queries it computes S^T = K Q^T and dP^T = V dO^T,
// so P^T and dS^T come out of the accumulators already in the A layout of
// dV += P^T dO and dK += dS^T Q (the fused kernel's trick). K's and V's A
// fragments are read from shared memory per step, which keeps the 16 x
// 128 float32 dK and dV sums of D = 128 in registers.
//
// Masks. Under the start-aligned causal mask (qi >= kj) the dQ kernel
// loads no key tile past its last query and the dK/dV kernel no query
// tile before its first key; a warp skips each 16-wide step that its mask
// empties. Rows and columns past T give p = 0 and are never stored.
// No atomics: two runs give the same bits.
//
// Rounding. S and dP take the bf16 inputs as they are (exact products,
// float32 sums). P (for dV) and dS (for dQ and dK) are float32 values
// rounded once to bf16 for the tensor cores; the plain version keeps them
// float32, and a CPU emulation of these roundings tile by tile fits the
// bf16 tolerance (tests/test_torch_flash_bwd.py). exp(scale * s - lse) is
// taken as exp2 of one fused multiply-add, s * (scale * log2 e) - lse *
// log2 e: a few float32 roundings of the exponent away from the plain
// version's, far below P's bf16 rounding.
//
// Instructions. At D = 16 the products are small and the elementwise work
// per score dominates: the exp, the subtraction and product of dS, and the
// bf16 packs. So the exponent is one fused multiply-add, the exp one ex2
// instruction, and a 16 x 16 step that lies wholly inside T and under the
// causal diagonal spends nothing on the mask; only the ragged and the
// diagonal steps check each element.
//
// Operands: q, k and v are (B, T, H, D) bf16 views sharing the strides (sb,
// st, sh) with a unit stride along D; O, dO, dQ, dK and dV are contiguous
// (B, T, H, D) bf16; lse and delta are contiguous (B, H, T) float32 (delta
// written by the dQ kernel). Any T >= 1 and 1 <= D <= 128, every bf16
// pointer aligned to its elements. With D a multiple of 8, every bf16
// pointer 16-byte aligned and every stride a multiple of 8 elements both
// kernels take their 16-byte path; any other view their narrow
// instantiation, which copies and stores in the call's copy width
// (stage_common.cuh) at the same DP. delta is summed over the staged O and
// dO rows, which are zeros past D on both paths.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// ViT's --patch-size 2 shape (B=256, T=196, H=4, D=16) the dQ kernel moves
// q, k, v, O, dO and lse in and dQ and delta out, the dK/dV kernel q, k,
// v, dO, lse and delta in and dK, dV out: 80.3 MB for the pair, 0.024 ms,
// against 8.8 GFLOP of products (three in dQ, four in dK/dV), 0.009 ms.
// So the bytes bound it: each operand is read once per kernel from device
// memory (K and V again per query tile, and Q and dO per key tile, from
// L2), and S, P, dP and dS never leave the chip. The exps are a second
// floor: 2 B H T^2 of them (both kernels recompute P), 78.7 M at that
// shape, 0.021 ms at the special-function units' 16 a cycle per SM.
// Registers (ptxas -v, sm_90a, nvcc 12.8), dQ and dK/dV kernel: 64 and 72
// at D = 16, 80 and 96 at 32, 124 and 126 at 64, 206 and 244 at 128, none
// spilled (chip_smoke.py's device_build phase prints them). The narrow
// instantiations: 56 and 64 at 16 (the dK/dV kernel spills 8 bytes), 80
// (20 bytes spilled) and 95 at 32, 125 and 128 at 64, 202 and 242 at 128.

#include <math.h>

#include "mma_common.cuh"  // cp_async16, cp_async4, ldsm, ldsm_t, mma,
                           // pack, a_off, b_off, bt_off, kPad, Shape,
                           // copy_width, with_dp, stage_any, store_rows

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;           // warps of one block
constexpr int kRows = 16 * kWarps;  // rows a block owns, and of a tile

// Copies rows r0 .. r0+63 of one (batch, head) of a bf16 (B, T, H, D)
// tensor with element strides (sb, st, sh, 1) into `dst` (64 x (DP +
// kPad)), zeros past T and past D: 16-byte chunks, or with kNarrow chunks
// of the call's copy width.
template <int DP, bool kNarrow>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      long long sb, long long st,
                                      long long sh, const Shape& s, int bi,
                                      int hi, int r0) {
  constexpr int LD = DP + kPad, CPR = DP / 8;
  if constexpr (kNarrow) {
    stage_any<DP, LD>(dst, src, sb, st, sh, s, bi, hi, r0, kRows,
                      kWarps * 32);
  } else {
    for (int c = threadIdx.x; c < kRows * CPR; c += kWarps * 32) {
      const int r = c / CPR, x = c % CPR;
      bf16* at = dst + r * LD + x * 8;
      if (r0 + r < s.t && x * 8 < s.d) {
        cp_async16(at, src + (long long)bi * sb + (long long)(r0 + r) * st +
                           (long long)hi * sh + x * 8);
      } else {
        *reinterpret_cast<uint4*>(at) = make_uint4(0u, 0u, 0u, 0u);
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

// 2^x in one instruction: the hardware's ex2 (about 2 ulp; a result below
// float32's smallest normal is flushed to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P and dS of one 16 x 16 step, from its S and dP accumulators (mma's C
// layout: element e of n-tile n is row g + 8 * (e >> 1), column n * 8 +
// 2 * tq + (e & 1)), rounded to bf16 into A fragments. p = exp2(s * sl2 -
// l2) with sl2 = scale * log2 e and l2[n][e] = lse * log2 e of element
// e's query, dS = p (dP - dl[n][e]) with dl its delta. With kMasked,
// keep(n, e) says whether the mask keeps the element (else p = 0); a step
// that lies wholly inside T and under the causal diagonal takes kMasked =
// false and spends no instruction on the mask.
template <bool kMasked, typename Keep>
__device__ __forceinline__ void p_ds(const float (&sc)[2][4],
                                     const float (&dp)[2][4], float sl2,
                                     const float (&l2)[2][4],
                                     const float (&dl)[2][4], Keep keep,
                                     uint32_t (&pa)[4], uint32_t (&da)[4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = fast_exp2(fmaf(sc[n][e], sl2, -l2[n][e]));
      if (kMasked && !keep(n, e)) p[e] = 0.f;
      ds[e] = p[e] * (dp[n][e] - dl[n][e]);
    }
    pa[2 * n] = pack(p[0], p[1]);
    pa[2 * n + 1] = pack(p[2], p[3]);
    da[2 * n] = pack(ds[0], ds[1]);
    da[2 * n + 1] = pack(ds[2], ds[3]);
  }
}

template <int DP, bool kNarrow>
__global__ void __launch_bounds__(kWarps * 32)
flash_dq_tiled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ delta, bf16* __restrict__ dq,
                      Shape s, float scale, int causal) {
  constexpr int LD = DP + kPad;  // row stride of every shared tile
  constexpr int NP = DP / 16;    // 16-wide steps over the head dims
  constexpr int TILE = kRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + TILE;
  bf16* os = dos + TILE;
  bf16* ks = os + TILE;      // two buffers, TILE apart
  bf16* vs = ks + 2 * TILE;  // two buffers, TILE apart
  float* lse_s = reinterpret_cast<float*>(vs + 2 * TILE);
  float* delta_s = lse_s + kRows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, bi = bh / s.h, hi = bh % s.h;
  const long long dsb = (long long)s.t * s.h * s.d, dst = (long long)s.h * s.d;
  const int q0 = blockIdx.y * kRows;
  const int wq0 = q0 + warp * 16;  // this warp's first query row
  // Under the causal mask no row of this tile sees a key past its last row.
  const int kend = causal ? min(s.t, q0 + kRows) : s.t;
  const int ntiles = (kend + kRows - 1) / kRows;

  stage<DP, kNarrow>(qs, q, s.sb, s.st, s.sh, s, bi, hi, q0);
  stage<DP, kNarrow>(dos, dout, dsb, dst, s.d, s, bi, hi, q0);
  stage<DP, kNarrow>(os, o, dsb, dst, s.d, s, bi, hi, q0);
  stage_rows(lse_s, lse, s, bh, q0);
  stage<DP, kNarrow>(ks, k, s.sb, s.st, s.sh, s, bi, hi, 0);
  stage<DP, kNarrow>(vs, v, s.sb, s.st, s.sh, s, bi, hi, 0);
  cp_async_commit();

  uint32_t qa[NP][4], doa[NP][4];
  float dqa[2 * NP][4];
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  }
  // lse * log2 e and delta of rows g and g + 8 of this warp.
  float lse2_r[2] = {}, delta_r[2] = {};
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
    if (it == 0) {
      // delta = rowsum(dO * O) in float32; padded rows and dims are zeros.
      if (threadIdx.x < kRows) {
        const int r = threadIdx.x;
        float acc = 0.f;
#pragma unroll
        for (int x = 0; x < DP; x += 2) {
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dos + r * LD + x));
          const float2 b = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(os + r * LD + x));
          acc = __fadd_rn(acc, __fmul_rn(a.x, b.x));
          acc = __fadd_rn(acc, __fmul_rn(a.y, b.y));
        }
        delta_s[r] = acc;
        if (q0 + r < s.t) delta[(long long)bh * s.t + q0 + r] = acc;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        ldsm(qa[kk], qs + warp * 16 * LD + kk * 16 + a_off(lane, LD));
        ldsm(doa[kk], dos + warp * 16 * LD + kk * 16 + a_off(lane, LD));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2_r[r] = lse_s[warp * 16 + g + 8 * r] * kLog2e;
        delta_r[r] = delta_s[warp * 16 + g + 8 * r];
      }
    }
    const bf16* kt = ks + buf * TILE;
    const bf16* vt = vs + buf * TILE;
    const int k0 = it * kRows;
#pragma unroll
    for (int j = 0; j < kRows / 16; ++j) {
      const int ks0 = k0 + 16 * j;  // first key of this step
      // Warp-uniform: past the keys, or every key after this warp's rows.
      if (wq0 >= s.t || ks0 >= kend || (causal && ks0 > wq0 + 15)) break;
      float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        uint32_t b[4];
        ldsm(b, kt + j * 16 * LD + kk * 16 + b_off(lane, LD));
        mma(sc[0], qa[kk], b[0], b[1]);
        mma(sc[1], qa[kk], b[2], b[3]);
        ldsm(b, vt + j * 16 * LD + kk * 16 + b_off(lane, LD));
        mma(dp[0], doa[kk], b[0], b[1]);
        mma(dp[1], doa[kk], b[2], b[3]);
      }
      // Element e of n-tile n: query wq0 + g + 8 * (e >> 1), key ks0 + n *
      // 8 + 2 * tq + (e & 1); C layout of keys 0-15 is the A layout.
      float l2[2][4], dl[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          l2[n][e] = lse2_r[e >> 1];
          dl[n][e] = delta_r[e >> 1];
        }
      }
      auto keep = [&](int n, int e) {
        const int qi = wq0 + g + 8 * (e >> 1);
        const int kj = ks0 + n * 8 + 2 * tq + (e & 1);
        return qi < s.t && kj < s.t && (!causal || qi >= kj);
      };
      uint32_t pa[4], da[4];  // pa: unused here
      if (ks0 + 16 <= s.t && wq0 + 16 <= s.t && (!causal || ks0 + 15 <= wq0)) {
        p_ds<false>(sc, dp, sl2, l2, dl, keep, pa, da);
      } else {
        p_ds<true>(sc, dp, sl2, l2, dl, keep, pa, da);
      }
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        uint32_t b[4];
        ldsm_t(b, kt + j * 16 * LD + np * 16 + bt_off(lane, LD));
        mma(dqa[2 * np], da, b[0], b[1]);
        mma(dqa[2 * np + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  store_rows<NP, kNarrow>(dq, dqa, s, bi, hi, wq0, scale, true);
}

template <int DP, bool kNarrow>
__global__ void __launch_bounds__(kWarps * 32)
flash_dkv_tiled_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, Shape s,
                       float scale, int causal) {
  constexpr int LD = DP + kPad;
  constexpr int NP = DP / 16;
  constexpr int TILE = kRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + TILE;
  bf16* qs = vs + TILE;       // two buffers, TILE apart
  bf16* dos = qs + 2 * TILE;  // two buffers, TILE apart
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TILE);  // two of kRows
  float* delta_s = lse_s + 2 * kRows;                        // two of kRows

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

  float dka[2 * NP][4], dva[2 * NP][4];
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
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
    const bf16* qt = qs + buf * TILE;
    const bf16* dot = dos + buf * TILE;
    const float* lse_t = lse_s + buf * kRows;
    const float* delta_t = delta_s + buf * kRows;
    const int q0 = it * kRows;
#pragma unroll
    for (int j = 0; j < kRows / 16; ++j) {
      const int qs0 = q0 + 16 * j;  // first query of this step
      // Warp-uniform: past the queries or keys; under the causal mask,
      // every query of the step before this warp's first key.
      if (wk0 >= s.t || qs0 >= s.t) break;
      if (causal && qs0 + 15 < wk0) continue;
      float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        uint32_t a[4], b[4];
        ldsm(a, ks + warp * 16 * LD + kk * 16 + a_off(lane, LD));
        ldsm(b, qt + j * 16 * LD + kk * 16 + b_off(lane, LD));
        mma(sc[0], a, b[0], b[1]);
        mma(sc[1], a, b[2], b[3]);
        ldsm(a, vs + warp * 16 * LD + kk * 16 + a_off(lane, LD));
        ldsm(b, dot + j * 16 * LD + kk * 16 + b_off(lane, LD));
        mma(dp[0], a, b[0], b[1]);
        mma(dp[1], a, b[2], b[3]);
      }
      // P^T and dS^T: element e of n-tile n is key wk0 + g + 8 * (e >> 1),
      // query qs0 + n * 8 + 2 * tq + (e & 1); the C layout is the A layout
      // of the products below.
      float l2[2][4], dl[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = j * 16 + n * 8 + 2 * tq;  // in the tile
        const float2 l = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 d = *reinterpret_cast<const float2*>(delta_t + c);
        l2[n][0] = l2[n][2] = l.x * kLog2e;
        l2[n][1] = l2[n][3] = l.y * kLog2e;
        dl[n][0] = dl[n][2] = d.x;
        dl[n][1] = dl[n][3] = d.y;
      }
      auto keep = [&](int n, int e) {
        const int qi = qs0 + n * 8 + 2 * tq + (e & 1);
        const int kj = wk0 + g + 8 * (e >> 1);
        return qi < s.t && kj < s.t && (!causal || qi >= kj);
      };
      uint32_t pa[4], da[4];
      if (qs0 + 16 <= s.t && wk0 + 16 <= s.t && (!causal || qs0 >= wk0 + 15)) {
        p_ds<false>(sc, dp, sl2, l2, dl, keep, pa, da);
      } else {
        p_ds<true>(sc, dp, sl2, l2, dl, keep, pa, da);
      }
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        uint32_t b[4];
        ldsm_t(b, dot + j * 16 * LD + np * 16 + bt_off(lane, LD));
        mma(dva[2 * np], pa, b[0], b[1]);
        mma(dva[2 * np + 1], pa, b[2], b[3]);
        ldsm_t(b, qt + j * 16 * LD + np * 16 + bt_off(lane, LD));
        mma(dka[2 * np], da, b[0], b[1]);
        mma(dka[2 * np + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  store_rows<NP, kNarrow>(dk, dka, s, bi, hi, wk0, scale, true);
  store_rows<NP, kNarrow>(dv, dva, s, bi, hi, wk0, scale, false);
}

// Shared memory of one block: the dQ kernel's q, dO, O and two buffers
// each of k and v, with lse and delta; the dK/dV kernel's k, v and two
// buffers each of q, dO, lse and delta. Every bf16 tile is kRows x (DP +
// kPad). At D = 128: 122,368 and 105,472 bytes.
__host__ __device__ constexpr size_t dq_smem(int dp) {
  return (size_t)7 * kRows * (dp + kPad) * sizeof(bf16) +
         (size_t)2 * kRows * sizeof(float);
}
__host__ __device__ constexpr size_t dkv_smem(int dp) {
  return (size_t)6 * kRows * (dp + kPad) * sizeof(bf16) +
         (size_t)4 * kRows * sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DP, bool kNarrow>
cudaError_t launch(const Shape& s, const void* q, const void* k,
                   const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, void* dk,
                   void* dv, float scale, int causal, cudaStream_t stream) {
  const dim3 grid((unsigned)(s.b * s.h),
                  (unsigned)((s.t + kRows - 1) / kRows));
  cudaError_t err =
      allow_smem(flash_dq_tiled_kernel<DP, kNarrow>, dq_smem(DP));
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_dkv_tiled_kernel<DP, kNarrow>, dkv_smem(DP));
  if (err != cudaSuccess) return err;
  flash_dq_tiled_kernel<DP, kNarrow>
      <<<grid, kWarps * 32, dq_smem(DP), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)dout, (const float*)lse, (float*)delta, (bf16*)dq, s,
      scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_dkv_tiled_kernel<DP, kNarrow>
      <<<grid, kWarps * 32, dkv_smem(DP), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, s,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Launches the dQ kernel and then the dK/dV kernel on `stream` (a stream
// of `device`) and returns cudaGetLastError() (0 when both launches were
// accepted), or cudaErrorInvalidValue for what the kernels do not take
// (see the notes above; `bf16` must be 1). Does not synchronise. This
// library carries its own copy of the CUDA runtime, whose current device
// is not PyTorch's: it selects the operands' device.
//
// q, k, v (b, t, h, d) with strides (sb, st, sh, 1); o and dout (b, t, h,
// d) contiguous; lse (b, h, t) float32. Writes delta (b, h, t) float32,
// and dq, dk and dv (b, t, h, d) contiguous.
extern "C" int flash_bwd_tiled_launch(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk,
                                      void* dv, int b, int h, int t, int d,
                                      long long sb, long long st,
                                      long long sh, float scale, int causal,
                                      int bf16_in, int device, void* stream) {
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};  // lse, delta: floats
  const Shape s{b, h, t, d, sb, st, sh, copy_width(d, sb, st, sh, 2, ptrs)};
  const bool ok = bf16_in == 1 && b >= 1 && h >= 1 && t >= 1 && d >= 1 &&
                  d <= 128 && s.w > 0 && (long long)b * h <= 0x7fffffffLL &&
                  (t + kRows - 1) / kRows <= 65535;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  with_dp<16>(s, [&](auto dp, auto narrow) {
    err = launch<decltype(dp)::value, decltype(narrow)::value>(
        s, q, k, v, o, dout, lse, delta, dq, dk, dv, scale, causal,
        (cudaStream_t)stream);
  });
  return (int)err;
}
