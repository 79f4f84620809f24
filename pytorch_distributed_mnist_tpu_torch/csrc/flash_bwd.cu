// Flash attention backward for Hopper (sm_90a), fused: dQ, dK and dV of
// one (batch, head) in one thread block, with every product on the tensor
// cores (mma.sync m16n8k16, bf16 operands, float32 sums). Bound to Python
// through a plain C function loaded with ctypes.
//
//   delta_i = dO_i . O_i
//   s_ij    = scale * (q_i . k_j),  P_ij = exp(s_ij - lse_i)  (0 if masked)
//   dS_ij   = P_ij (dO_i . V_j - delta_i)
//   dV_j    = sum_i P_ij dO_i
//   dK_j    = scale * sum_i dS_ij Q_i
//   dQ_i    = scale * sum_j dS_ij K_j
//
// Replaces the Pallas TPU kernels of _flash_backward
// (pytorch_distributed_mnist_tpu/ops/pallas/flash.py:274, bodies
// _dq_kernel :194 and _dkv_kernel :230) together with the delta that the
// TPU path computes in XLA between them (:285-290). Those run two grids
// over (batch*head, 128-row block) and recompute S and dP in each.
//
// Design. A block owns one (batch, head) whole, T <= 128 rows. It copies
// q, k, v, O and dO (bf16) into shared memory with 16-byte cp.async loads
// straight from the strided views, pads T up to a multiple of 16 and the
// head dims up to DP with zeros, and reads lse; delta is summed on chip
// and never leaves it. Warp w owns key tile w (16 keys) and walks the
// query tiles: it computes S^T = K Q^T and dP^T = V dO^T (so P^T and
// dS^T come out of the accumulators already in the A-operand layout of
// the next product, as in FlashAttention-2), forms P and dS in float32
// registers, and accumulates dV += P^T dO and dK += dS^T Q in its own
// registers. dS^T goes to shared memory as bf16; after one barrier warp w
// computes dQ for query tile w as dS K, summing the key tiles in order.
// No atomics: every run gives the same bits. Under the causal mask
// (start-aligned, qi >= kj) tiles above the diagonal are skipped, and
// padded rows give p = 0 and are never stored.
//
// Rounding. The products S and dP take the bf16 inputs as they are (exact
// products, float32 sums). P (for dV) and dS (for dK and dQ) are float32
// values rounded once to bf16 to feed the tensor cores; the plain version
// keeps them float32. As the reference does, the product is scaled
// (scale * (q . k)), and dQ and dK take the scale once more at the end.
//
// Operands: q, k and v are (B, T, H, D) views sharing the strides (sb,
// st, sh) with a unit stride along D; O, dO, dQ, dK and dV are contiguous
// (B, T, H, D); lse is contiguous (B, H, T) float32. bfloat16 only, T <=
// 128, any 1 <= D <= 128, every pointer aligned to its elements (lse, read
// a float at a time, only needs to be contiguous). With D a multiple of 8,
// every pointer 16-byte aligned and every stride a multiple of 8 elements
// the kernel takes its 16-byte path; any other view its narrow
// instantiation, which copies and stores in the call's copy width
// (stage_common.cuh) at the same DP. delta is summed over the staged O and
// dO rows, which are zeros past D on both paths. Anything else is refused.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// ViT's training shape (B=256, T=49, H=4, D=16) it moves 13.05 MB (q, k,
// v, O, dO and lse in; dQ, dK, dV out), 3.89 us, for 0.39 GFLOP (five
// products of 2*B*H*T*T*D), 0.40 us: bound by bytes, so the design reads
// each operand once and keeps S, P, dP, dS and delta on chip. mma.sync
// rather than wgmma/TMA: at D = 16 wgmma's 64-row tiles and descriptors
// buy nothing, and the time goes to bytes and latency.
//
// Registers (ptxas -v, sm_90a, nvcc 12.8; chip_smoke.py's device_build
// phase prints them per instantiation), the 16-byte path: 62 at DP = 16,
// 95 at 32, 126 at 64, 225 at 128; the narrow one: 64, 80, 128, 225; none
// spilled.

#include "mma_common.cuh"  // cp_async16, ldsm, ldsm_t, mma, pack, a_off,
                           // b_off, bt_off, kPad, round16, Shape,
                           // copy_width, with_dp, stage_any, store_rows

namespace {

constexpr int kTile = 16;   // rows of a key or query tile: one warp's share
constexpr int kMaxT = 128;  // longest T taken: 8 tiles, 8 warps

// Dynamic shared memory for Tp padded rows and DP head dims: lse and
// delta (float32), q, k, v, O, dO (bf16, Tp x (DP + kPad)) and dS^T (bf16,
// Tp x (Tp + kPad)). At T = 128, D = 128 it is 209,920 bytes.
__host__ __device__ inline size_t smem_bytes(int tp, int dp) {
  return (size_t)2 * tp * sizeof(float) +
         (size_t)5 * tp * (dp + kPad) * sizeof(bf16) +
         (size_t)tp * (tp + kPad) * sizeof(bf16);
}

template <int DP, bool kNarrow>
__global__ void __launch_bounds__(kMaxT / kTile * 32)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                 const bf16* __restrict__ dout,
                 const float* __restrict__ lse, bf16* __restrict__ dq,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, Shape s,
                 float scale, int causal) {
  constexpr int LD = DP + kPad;  // row stride of the (Tp, DP) tiles
  constexpr int CPR = DP / 8;    // 16-byte chunks per row
  constexpr int NP = DP / 16;    // 16-wide steps over the head dims
  const int tp = round16(s.t), nt = tp / kTile, lds = tp + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lse_s = reinterpret_cast<float*>(smem);
  float* delta_s = lse_s + tp;
  bf16* qs = reinterpret_cast<bf16*>(delta_s + tp);
  bf16* ks = qs + tp * LD;
  bf16* vs = ks + tp * LD;
  bf16* os = vs + tp * LD;
  bf16* dos = os + tp * LD;
  bf16* dst = dos + tp * LD;  // dS^T: rows are keys, columns queries

  const int bh = blockIdx.x, bi = bh / s.h, hi = bh % s.h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  // Stage every operand of this (batch, head), zeros in the padding.
  if constexpr (kNarrow) {
    const long long osb = (long long)s.t * s.h * s.d,  // O's and dO's
        ost = (long long)s.h * s.d;                     // strides
    stage_any<DP, LD>(qs, q, s.sb, s.st, s.sh, s, bi, hi, 0, tp, blockDim.x);
    stage_any<DP, LD>(ks, k, s.sb, s.st, s.sh, s, bi, hi, 0, tp, blockDim.x);
    stage_any<DP, LD>(vs, v, s.sb, s.st, s.sh, s, bi, hi, 0, tp, blockDim.x);
    stage_any<DP, LD>(os, o, osb, ost, s.d, s, bi, hi, 0, tp, blockDim.x);
    stage_any<DP, LD>(dos, dout, osb, ost, s.d, s, bi, hi, 0, tp,
                      blockDim.x);
  } else {
    for (int c = tid; c < tp * CPR; c += blockDim.x) {
      const int r = c / CPR, x = c % CPR, at = r * LD + x * 8;
      if (r < s.t && x * 8 < s.d) {
        const long long view =
            bi * s.sb + r * s.st + hi * s.sh + (long long)x * 8;
        const long long dense =
            (((long long)bi * s.t + r) * s.h + hi) * s.d + x * 8;
        cp_async16(qs + at, q + view);
        cp_async16(ks + at, k + view);
        cp_async16(vs + at, v + view);
        cp_async16(os + at, o + dense);
        cp_async16(dos + at, dout + dense);
      } else {
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(qs + at) = zero;
        *reinterpret_cast<uint4*>(ks + at) = zero;
        *reinterpret_cast<uint4*>(vs + at) = zero;
        *reinterpret_cast<uint4*>(os + at) = zero;
        *reinterpret_cast<uint4*>(dos + at) = zero;
      }
    }
  }
  for (int r = tid; r < tp; r += blockDim.x) {
    lse_s[r] = r < s.t ? lse[(long long)bh * s.t + r] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  // delta = rowsum(dO * O) in float32; padded dims hold zeros.
  for (int r = tid; r < tp; r += blockDim.x) {
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
  }
  __syncthreads();

  // Pass 1: warp w owns keys k0..k0+15 and walks the query tiles.
  {
    const int k0 = warp * kTile;
    float dka[2 * NP][4] = {}, dva[2 * NP][4] = {};
    for (int qt = causal ? warp : 0; qt < nt; ++qt) {
      const int q0 = qt * kTile;
      float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        uint32_t a[4], b[4];
        ldsm(a, ks + k0 * LD + kk * 16 + a_off(lane, LD));
        ldsm(b, qs + q0 * LD + kk * 16 + b_off(lane, LD));
        mma(sc[0], a, b[0], b[1]);
        mma(sc[1], a, b[2], b[3]);
        ldsm(a, vs + k0 * LD + kk * 16 + a_off(lane, LD));
        ldsm(b, dos + q0 * LD + kk * 16 + b_off(lane, LD));
        mma(dp[0], a, b[0], b[1]);
        mma(dp[1], a, b[2], b[3]);
      }
      // P^T and dS^T: C layout (key g or g+8, queries 2tq and 2tq+1 of
      // n-tile n) is the A layout of the products below.
      uint32_t pa[4], da[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + g + ((e >> 1) << 3);
          const int qi = q0 + n * 8 + 2 * tq + (e & 1);
          const bool keep =
              qi < s.t && kj < s.t && (!causal || qi >= kj);
          p[e] = keep ? expf(__fmul_rn(scale, sc[n][e]) - lse_s[qi]) : 0.f;
          ds[e] = __fmul_rn(p[e], dp[n][e] - delta_s[qi]);
        }
        pa[2 * n] = pack(p[0], p[1]);
        pa[2 * n + 1] = pack(p[2], p[3]);
        da[2 * n] = pack(ds[0], ds[1]);
        da[2 * n + 1] = pack(ds[2], ds[3]);
        bf16* row = dst + (k0 + g) * lds + q0 + n * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(row) = da[2 * n];
        *reinterpret_cast<uint32_t*>(row + 8 * lds) = da[2 * n + 1];
      }
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        uint32_t b[4];
        ldsm_t(b, dos + q0 * LD + np * 16 + bt_off(lane, LD));
        mma(dva[2 * np], pa, b[0], b[1]);
        mma(dva[2 * np + 1], pa, b[2], b[3]);
        ldsm_t(b, qs + q0 * LD + np * 16 + bt_off(lane, LD));
        mma(dka[2 * np], da, b[0], b[1]);
        mma(dka[2 * np + 1], da, b[2], b[3]);
      }
    }
    store_rows<NP, kNarrow>(dk, dka, s, bi, hi, k0, scale, true);
    store_rows<NP, kNarrow>(dv, dva, s, bi, hi, k0, scale, false);
  }
  __syncthreads();  // every tile of dS^T is written

  // Pass 2: warp w owns queries q0..q0+15; dQ = dS K over the key tiles
  // in order (A = dS read transposed from dS^T).
  {
    const int q0 = warp * kTile;
    float dqa[2 * NP][4] = {};
    const int kend = causal ? warp + 1 : nt;
    for (int kt = 0; kt < kend; ++kt) {
      const int k0 = kt * kTile;
      uint32_t a[4];
      ldsm_t(a, dst + k0 * lds + q0 + b_off(lane, lds));
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        uint32_t b[4];
        ldsm_t(b, ks + k0 * LD + np * 16 + bt_off(lane, LD));
        mma(dqa[2 * np], a, b[0], b[1]);
        mma(dqa[2 * np + 1], a, b[2], b[3]);
      }
    }
    store_rows<NP, kNarrow>(dq, dqa, s, bi, hi, q0, scale, true);
  }
}

}  // namespace

// Launches the fused backward on `stream` (a stream of `device`) and
// returns cudaGetLastError() (0 when the launch was accepted), or
// cudaErrorInvalidValue for what the kernel does not take (see the notes
// above; `bf16` must be 1). Does not synchronise. This library carries its
// own copy of the CUDA runtime, whose current device is not PyTorch's: it
// selects the operands' device.
//
// q, k, v (b, t, h, d) with strides (sb, st, sh, 1); o and dout (b, t, h,
// d) contiguous; lse (b, h, t) float32. Writes dq, dk and dv (b, t, h, d)
// contiguous.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* dq, void* dk,
                                void* dv, int b, int h, int t, int d,
                                long long sb, long long st, long long sh,
                                float scale, int causal, int bf16_in,
                                int device, void* stream) {
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};  // lse: float loads
  const Shape s{b, h, t, d, sb, st, sh, copy_width(d, sb, st, sh, 2, ptrs)};
  const bool ok = bf16_in == 1 && b >= 1 && h >= 1 && t >= 1 &&
                  t <= kMaxT && d >= 1 && d <= 128 && s.w > 0 &&
                  (long long)b * h <= 0x7fffffffLL;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  with_dp<16>(s, [&](auto dp, auto narrow) {
    constexpr int DP = decltype(dp)::value;
    constexpr bool kNarrow = decltype(narrow)::value;
    const int tp = round16(t);
    const size_t bytes = smem_bytes(tp, DP);
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(flash_bwd_kernel<DP, kNarrow>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return;
    }
    flash_bwd_kernel<DP, kNarrow><<<dim3((unsigned)(b * h)),
                                    dim3(tp / kTile * 32), bytes,
                                    (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
        (const bf16*)dout, (const float*)lse, (bf16*)dq, (bf16*)dk,
        (bf16*)dv, s, scale, causal);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
