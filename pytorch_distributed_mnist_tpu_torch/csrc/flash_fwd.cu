// Flash attention forward for Hopper (sm_90a) on the tensor cores
// (mma.sync m16n8k16, bf16 operands, float32 sums), bound to Python
// through a plain C function loaded with ctypes.
//
//   s_ij  = scale * (q_i . k_j)                    (masked: -inf)
//   m_i   = max_j s_ij,  l_i = sum_j exp(s_ij - m_i)
//   O_i   = sum_j exp(s_ij - m_i) V_j / l_i,  lse_i = m_i + log l_i
//
// Replaces the Pallas TPU kernel of _flash_forward
// (pytorch_distributed_mnist_tpu/ops/pallas/flash.py:147, body _fwd_kernel
// :65), which walks the key blocks of one (batch*head, query block) with an
// online softmax. It also replaces, for bf16 at every head dim, the
// CUDA-core forward (flash.cu flash_fwd_kernel), which stays only as a
// route a caller may name.
//
// Design, FlashAttention-2 style. A block of 4 warps owns one (batch, head)
// and 64 query rows, 16 per warp. It copies its q tile and then 64-key
// tiles of k and v into shared memory with 16-byte cp.async loads straight from the strided views,
// double-buffered: the next key tile is in flight while this one is
// computed, so any T is taken. Each warp reads its Q fragments once with
// ldmatrix and keeps them in registers; per key tile it computes S = Q K^T
// (K read with ldmatrix as the column B operand), masks, scales and runs the
// online softmax in registers (a row's max reduced over the 4 lanes of a
// quad with __shfl_xor_sync), casts P to bf16 straight from S's
// accumulators into the A-operand layout of O += P V, and reads V with
// ldmatrix.trans. O / l and lse = m + log l are written at the end; a row
// with nothing to attend gives O = 0 and lse = -1e30. Rows >= T and head
// dims >= D are zeros in shared memory and are never stored. Under the
// causal mask (start-aligned, qi >= kj) key tiles wholly above the
// diagonal are not loaded.
//
// Rounding. Products of the bf16 inputs are exact and summed in float32.
// The float32 product is then scaled: for a power-of-two scale (D = 16 or
// 64, the ViT's D = 16 among them) that is bit for bit the reference's
// (q * scale) . k; for other D it rounds once more than the reference
// does. exp(x) is taken as exp2(x * log2 e), one multiply and the
// hardware's ex2 instead of expf's longer sequence. P is rounded once to
// bf16 for P V; l sums the float32 p.
//
// Operands: q, k and v are (B, T, H, D) bf16 views sharing the strides
// (sb, st, sh) with a unit stride along D; O is contiguous (B, T, H, D)
// bf16 and lse contiguous (B, H, T) float32. Any 1 <= D <= 128, every
// pointer aligned to its elements. With D a multiple of 8, every pointer
// 16-byte aligned and every stride a multiple of 8 elements the kernel
// takes its 16-byte path; any other view (an odd D, the ViT's D = 12
// slices, a view that starts off a 16-byte boundary) its narrow
// instantiation, which copies and stores in the call's copy width
// (stage_common.cuh) and computes the same products at the same DP.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// ViT's shape (B=256, T=49, H=4, D=16) it moves 6.62 MB (q, k, v in; O and
// lse out), 1.98 us, for 0.157 GFLOP, 0.16 us: bound by bytes. Each
// operand is read once (K and V once per 64-row query tile: at T = 49 once
// in all) and S and P never leave registers.
//
// Registers (ptxas -v, sm_90a, nvcc 12.8; chip_smoke.py's device_build
// phase prints them per instantiation), the 16-byte path: 80 at DP = 16,
// 93 at 32, 128 at 64 (36 bytes spilled), 175 at 128; the narrow one: 80,
// 96 (4 bytes spilled), 128 (4), 176.

#include <math.h>

#include "mma_common.cuh"  // cp_async16, ldsm, ldsm_t, mma, pack, a_off,
                           // b_off, bt_off, kPad, Shape, copy_width,
                           // with_dp, stage_any, store_pair

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;           // warps of one block
constexpr int kRows = 16 * kWarps;  // query rows of one block
constexpr int kKeys = 64;           // keys per shared K/V tile

// Shared memory of one block: q, then two buffers each of k and v, every
// tile kRows x (DP + kPad) bf16.
__host__ __device__ constexpr size_t smem_bytes(int dp) {
  return (size_t)5 * kRows * (dp + kPad) * sizeof(bf16);
}

// Copies rows r0 .. r0+63 of one (batch, head) of q, k or v into `dst`
// (64 x (DP + kPad)), zeros past T and past D: 16-byte chunks, or with
// kNarrow chunks of the call's copy width.
template <int DP, bool kNarrow>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      const Shape& s, int bi, int hi,
                                      int r0) {
  constexpr int LD = DP + kPad, CPR = DP / 8;
  if constexpr (kNarrow) {
    stage_any<DP, LD>(dst, src, s.sb, s.st, s.sh, s, bi, hi, r0, kRows,
                      kWarps * 32);
  } else {
    for (int c = threadIdx.x; c < kRows * CPR; c += kWarps * 32) {
      const int r = c / CPR, x = c % CPR;
      bf16* at = dst + r * LD + x * 8;
      if (r0 + r < s.t && x * 8 < s.d) {
        cp_async16(at, src + (long long)bi * s.sb +
                           (long long)(r0 + r) * s.st +
                           (long long)hi * s.sh + x * 8);
      } else {
        *reinterpret_cast<uint4*>(at) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

template <int DP, bool kNarrow>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, Shape s, float scale,
                     int causal) {
  constexpr int LD = DP + kPad;  // row stride of every shared tile
  constexpr int NP = DP / 16;    // 16-wide steps over the head dims
  constexpr int TILE = kRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, bi = bh / s.h, hi = bh % s.h;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + TILE;      // two buffers, TILE apart
  bf16* vs = qs + 3 * TILE;  // two buffers, TILE apart

  const int q0 = blockIdx.y * kRows;
  const int wq0 = q0 + warp * 16;  // this warp's first query row
  // Under the causal mask no row of this tile sees a key past its last row.
  const int kend = causal ? min(s.t, q0 + kRows) : s.t;
  const int ntiles = (kend + kKeys - 1) / kKeys;

  stage<DP, kNarrow>(qs, q, s, bi, hi, q0);
  stage<DP, kNarrow>(ks, k, s, bi, hi, 0);
  stage<DP, kNarrow>(vs, v, s, bi, hi, 0);
  cp_async_commit();

  uint32_t qa[NP][4];
  float acc[2 * NP][4];
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  // Row g and row g + 8 of the warp's 16: running max, and this lane's
  // share of the running sum (the quad's four shares are added at the end).
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {  // prefetch the next key tile
      stage<DP, kNarrow>(ks + (buf ^ 1) * TILE, k, s, bi, hi,
                         (it + 1) * kKeys);
      stage<DP, kNarrow>(vs + (buf ^ 1) * TILE, v, s, bi, hi,
                         (it + 1) * kKeys);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the prefetch has landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        ldsm(qa[kk], qs + warp * 16 * LD + kk * 16 + a_off(lane, LD));
      }
    }
    const bf16* kt = ks + buf * TILE;
    const bf16* vt = vs + buf * TILE;
    const int k0 = it * kKeys;

    // S = Q K^T: 16 rows x 64 keys, 8 n-tiles of 8 keys.
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t b[4];
        ldsm(b, kt + nn * 16 * LD + kk * 16 + b_off(lane, LD));
        mma(sc[2 * nn], qa[kk], b[0], b[1]);
        mma(sc[2 * nn + 1], qa[kk], b[2], b[3]);
      }
    }
    // Scale and mask; the tile's row max. Element e of n-tile n is row
    // g + 8 * (e >> 1), key n * 8 + 2 * tq + (e & 1).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + 2 * tq + (e & 1);
        const int qi = wq0 + g + 8 * (e >> 1);
        const bool keep = kj < s.t && (!causal || qi >= kj);
        sc[n][e] = keep ? __fmul_rn(scale, sc[n][e]) : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // 0 while nothing was kept: l and acc are still 0 then.
      corr[r] = m[r] <= kNegInf / 2 ? 0.f : exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    }
    // P in float32 (for l) and as bf16 A fragments of P V: keys 16j ..
    // 16j + 15 are n-tiles 2j and 2j + 1, whose C layout is the A layout.
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = sc[n][e] <= kNegInf / 2
                   ? 0.f
                   : exp2f((sc[n][e] - m[e >> 1]) * kLog2e);
        l[e >> 1] += p[e];
      }
      pa[n >> 1][(n & 1) * 2] = pack(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack(p[2], p[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        uint32_t b[4];
        ldsm_t(b, vt + j * 16 * LD + np * 16 + bt_off(lane, LD));
        mma(acc[2 * np], pa[j], b[0], b[1]);
        mma(acc[2 * np + 1], pa[j], b[2], b[3]);
      }
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
    bf16* out = o + (((long long)bi * s.t + row) * s.h + hi) * s.d;
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
      if (n * 8 >= s.d) break;
      const float x0 = acc[n][2 * half] / denom;
      const float x1 = acc[n][2 * half + 1] / denom;
      if constexpr (kNarrow) {
        store_pair(out, n * 8 + 2 * tq, s, x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * tq) = pack(x0, x1);
      }
    }
    if (tq == 0) {
      lse[(long long)bh * s.t + row] =
          l[half] > 0.f ? m[half] + logf(denom) : kNegInf;
    }
  }
}

template <int DP, bool kNarrow>
cudaError_t launch(const Shape& s, const void* q, const void* k,
                   const void* v, void* o, void* lse, float scale,
                   int causal, cudaStream_t stream) {
  const size_t bytes = smem_bytes(DP);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<DP, kNarrow>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)(s.b * s.h),
                  (unsigned)((s.t + kRows - 1) / kRows));
  flash_fwd_mma_kernel<DP, kNarrow><<<grid, kWarps * 32, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
      (float*)lse, s, scale, causal);
  return cudaSuccess;
}

}  // namespace

// Launches the forward on `stream` (a stream of `device`) and returns
// cudaGetLastError() (0 when the launch was accepted), or
// cudaErrorInvalidValue for what the kernel does not take (see the notes
// above; `bf16` must be 1). Does not synchronise. This library
// carries its own copy of the CUDA runtime, whose current device is not
// PyTorch's: it selects the operands' device.
//
// q, k, v (b, t, h, d) with strides (sb, st, sh, 1). Writes o (b, t, h, d)
// contiguous and lse (b, h, t) float32.
extern "C" int flash_fwd_mma_launch(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int b,
                                    int h, int t, int d, long long sb,
                                    long long st, long long sh, float scale,
                                    int causal, int bf16_in, int device,
                                    void* stream) {
  const void* ptrs[] = {q, k, v, o};  // lse: float stores
  const Shape s{b, h, t, d, sb, st, sh, copy_width(d, sb, st, sh, 2, ptrs)};
  const bool ok = bf16_in == 1 && b >= 1 && h >= 1 && t >= 1 && d >= 1 &&
                  d <= 128 && s.w > 0 && (long long)b * h <= 0x7fffffffLL;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  with_dp<16>(s, [&](auto dp, auto narrow) {
    err = launch<decltype(dp)::value, decltype(narrow)::value>(
        s, q, k, v, o, lse, scale, causal, (cudaStream_t)stream);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
