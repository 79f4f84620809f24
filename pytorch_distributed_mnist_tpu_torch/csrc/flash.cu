// Flash attention for Hopper (sm_90a): the forward, the dQ pass and the
// dK/dV pass, bound to Python through plain C functions loaded with ctypes.
//
//   forward: O_i = sum_j P_ij V_j,  P_ij = exp(s_ij - lse_i),
//            s_ij = (q_i * scale) . k_j,  lse_i = m_i + log l_i
//   dQ:      delta_i = dO_i . O_i
//            dQ_i = scale * sum_j P_ij (dO_i . V_j - delta_i) K_j
//   dK/dV:   dV_j = sum_i P_ij dO_i
//            dK_j = scale * sum_i P_ij (dO_i . V_j - delta_i) Q_i
//   (in the backward s_ij = scale * (q_i . k_j), P recomputed from lse)
//
// Replaces the Pallas TPU kernels in
// pytorch_distributed_mnist_tpu/ops/pallas/flash.py: _flash_forward (:147,
// body _fwd_kernel :65) and _flash_backward (:274, bodies _dq_kernel :194
// and _dkv_kernel :230). Those pad T to a block of 8-128 rows and run a
// sequential grid over (batch*head, block) with whole K/V rows in VMEM.
// Here nothing is padded: a thread block owns 64 query rows (forward, dQ)
// or 64 key rows (dK/dV) of one (batch, head); the other operand streams
// through shared memory tile by tile, converted to float32 once; each row
// belongs to TPR = DMAX/16 neighbouring threads that hold 16 of its head
// dims each (interleaved, so a tile's row is read without bank conflicts),
// and a row's dot products are summed across them with shuffles. The
// kernel masks the ragged edge (key or query index >= T) and the causal
// triangle (start-aligned, qi >= kj) itself; a masked score contributes
// p = 0, and a row with nothing to attend gives O = 0 and lse = -1e30. All
// accumulation is in float32 registers. The two-kernel backward needs no
// atomics across blocks, so every run gives the same bits. delta, which
// the TPU path computes in XLA between its kernels, is computed by the dQ
// kernel from the O and dO rows it already holds, and written out for the
// dK/dV kernel, which runs after it on the same stream.
//
// Rounding follows the reference where its passes differ: the forward
// scales q before the product, the backward scales the product, and dQ
// and dK take the scale once more at the end.
//
// Operands: q, k and v are (B, T, H, D) views sharing the strides (sb, st,
// sh) with a unit stride along D (the ViT hands in slices of its qkv
// product, so no copy is made); O, dO, dQ, dK and dV are contiguous
// (B, T, H, D); lse and delta are contiguous (B, H, T) float32. Types:
// float32 or bfloat16 (one for all of q, k, v, O, dO, dQ, dK, dV); D <= 128.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// ViT's training shape (B=256, T=49, H=4, D=16, bf16) the forward moves
// 6.62 MB (q, k, v in, O and lse out) and does 0.157 GFLOP (two products
// of 2*B*H*T*T*D): 1.98 us of bytes against 0.16 us of bf16 tensor-core
// operations, so it is bound by bytes. The dQ pass moves 10.04 MB (q, k,
// v, O, dO, lse in; dQ, delta out) for 0.236 GFLOP, 3.00 us; the dK/dV
// pass 10.04 MB (q, k, v, dO, lse, delta in; dK, dV out) for 0.315 GFLOP,
// 3.00 us: both bound by bytes. This design reads every operand once per
// block from device memory (K and V once per 64-row query tile: at T=49
// once in all) and keeps scores, probabilities and accumulators on chip,
// so it moves what the bound counts. It runs its products as float32 FMAs
// on the CUDA cores (67 TFLOP/s), which alone takes 2.3 us for the
// forward: a later version that wants the byte bound moves the products
// to the tensor cores (mma.sync or wgmma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;  // rows of the block's own operand
constexpr int kDimsPerThread = 16;

struct Shape {
  int b, h, t, d;
  long long sb, st, sh;  // element strides of q, k and v
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// Sum across the TPR neighbouring lanes that share one row. `mask` names
// exactly those lanes: they share their row's control flow, while other
// rows of the same warp may stop earlier (ragged or causal edge).
template <int TPR>
__device__ __forceinline__ float row_sum(float x, unsigned mask) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off /= 2) {
    x += __shfl_xor_sync(mask, x, off);
  }
  return x;
}

template <int TPR>
__device__ __forceinline__ unsigned row_lanes() {
  const unsigned lane = threadIdx.x % 32;
  return TPR == 1 ? (1u << lane)
                  : (((1u << TPR) - 1u) << (lane & ~(unsigned)(TPR - 1)));
}

// Keys (or queries) per shared tile: two float32 tiles of KT x DMAX stay
// within 32 KB of static shared memory.
template <int DMAX>
__host__ __device__ constexpr int tile_rows() {
  return DMAX <= 64 ? 64 : 32;
}

// Element offset of (bi, ti, hi, 0) in a contiguous (B, T, H, D) tensor.
__device__ __forceinline__ long long dense_row(const Shape& s, int bi, int ti,
                                               int hi) {
  return (((long long)bi * s.t + ti) * s.h + hi) * s.d;
}

// Element offset of (bi, ti, hi, 0) in q, k or v.
__device__ __forceinline__ long long view_row(const Shape& s, int bi, int ti,
                                              int hi) {
  return (long long)bi * s.sb + (long long)ti * s.st + (long long)hi * s.sh;
}

template <int DMAX, typename T>
__global__ void __launch_bounds__(kRows * (DMAX / kDimsPerThread))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Shape s, float scale, int causal) {
  constexpr int TPR = DMAX / kDimsPerThread;
  constexpr int KT = tile_rows<DMAX>();
  __shared__ float ks[KT * DMAX];
  __shared__ float vs[KT * DMAX];
  const int bh = blockIdx.x;
  const int bi = bh / s.h, hi = bh % s.h;
  const int row0 = blockIdx.y * kRows;
  const int part = threadIdx.x % TPR;
  const int qi = row0 + threadIdx.x / TPR;
  const bool live = qi < s.t;
  const unsigned lanes = row_lanes<TPR>();

  float qr[kDimsPerThread], acc[kDimsPerThread];
#pragma unroll
  for (int x = 0; x < kDimsPerThread; ++x) {
    const int dim = x * TPR + part;
    qr[x] = (live && dim < s.d)
                ? __fmul_rn(to_f(q[view_row(s, bi, qi, hi) + dim]), scale)
                : 0.f;
    acc[x] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  // Under the causal mask no row of this tile sees a key past its last row.
  const int kend = causal ? min(s.t, row0 + kRows) : s.t;
  for (int k0 = 0; k0 < kend; k0 += KT) {
    const int nk = min(KT, kend - k0);
    __syncthreads();  // every row is done with the previous tile
    for (int e = threadIdx.x; e < KT * DMAX; e += blockDim.x) {
      const int r = e / DMAX, dim = e % DMAX;
      float kx = 0.f, vx = 0.f;
      if (r < nk && dim < s.d) {
        const long long off = view_row(s, bi, k0 + r, hi) + dim;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[e] = kx;
      vs[e] = vx;
    }
    __syncthreads();
    if (!live) continue;
    const int jend = causal ? min(nk, qi - k0 + 1) : nk;
    for (int j = 0; j < jend; ++j) {
      const float* kr = ks + j * DMAX;
      float sc = 0.f;
#pragma unroll
      for (int x = 0; x < kDimsPerThread; ++x) {
        sc = fmaf(qr[x], kr[x * TPR + part], sc);
      }
      sc = row_sum<TPR>(sc, lanes);
      if (sc > m) {  // rescale what was summed against the old max
        const float corr = expf(m - sc);  // 0 while m is still -1e30
        l *= corr;
#pragma unroll
        for (int x = 0; x < kDimsPerThread; ++x) acc[x] *= corr;
        m = sc;
      }
      const float p = expf(sc - m);
      l += p;
      const float* vr = vs + j * DMAX;
#pragma unroll
      for (int x = 0; x < kDimsPerThread; ++x) {
        acc[x] = fmaf(p, vr[x * TPR + part], acc[x]);
      }
    }
  }
  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
  T* orow = o + dense_row(s, bi, qi, hi);
#pragma unroll
  for (int x = 0; x < kDimsPerThread; ++x) {
    const int dim = x * TPR + part;
    if (dim < s.d) orow[dim] = from_f<T>(acc[x] / denom);
  }
  if (part == 0) {
    lse[(long long)bh * s.t + qi] = l > 0.f ? m + logf(denom) : kNegInf;
  }
}

template <int DMAX, typename T>
__global__ void __launch_bounds__(kRows * (DMAX / kDimsPerThread))
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ o,
                const T* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ delta_out, T* __restrict__ dq, Shape s,
                float scale, int causal) {
  constexpr int TPR = DMAX / kDimsPerThread;
  constexpr int KT = tile_rows<DMAX>();
  __shared__ float ks[KT * DMAX];
  __shared__ float vs[KT * DMAX];
  const int bh = blockIdx.x;
  const int bi = bh / s.h, hi = bh % s.h;
  const int row0 = blockIdx.y * kRows;
  const int part = threadIdx.x % TPR;
  const int qi = row0 + threadIdx.x / TPR;
  const bool live = qi < s.t;
  const unsigned lanes = row_lanes<TPR>();

  float qr[kDimsPerThread], dor[kDimsPerThread], acc[kDimsPerThread];
  float delta = 0.f, lse_i = 0.f;
#pragma unroll
  for (int x = 0; x < kDimsPerThread; ++x) {
    const int dim = x * TPR + part;
    qr[x] = dor[x] = acc[x] = 0.f;
    if (live && dim < s.d) {
      const long long off = dense_row(s, bi, qi, hi) + dim;
      qr[x] = to_f(q[view_row(s, bi, qi, hi) + dim]);
      dor[x] = to_f(dout[off]);
      delta = fmaf(dor[x], to_f(o[off]), delta);
    }
  }
  if (live) {
    delta = row_sum<TPR>(delta, lanes);
    lse_i = lse[(long long)bh * s.t + qi];
    if (part == 0) delta_out[(long long)bh * s.t + qi] = delta;
  }
  const int kend = causal ? min(s.t, row0 + kRows) : s.t;
  for (int k0 = 0; k0 < kend; k0 += KT) {
    const int nk = min(KT, kend - k0);
    __syncthreads();
    for (int e = threadIdx.x; e < KT * DMAX; e += blockDim.x) {
      const int r = e / DMAX, dim = e % DMAX;
      float kx = 0.f, vx = 0.f;
      if (r < nk && dim < s.d) {
        const long long off = view_row(s, bi, k0 + r, hi) + dim;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[e] = kx;
      vs[e] = vx;
    }
    __syncthreads();
    if (!live) continue;
    const int jend = causal ? min(nk, qi - k0 + 1) : nk;
    for (int j = 0; j < jend; ++j) {
      const float* kr = ks + j * DMAX;
      const float* vr = vs + j * DMAX;
      float qk = 0.f, dp = 0.f;
#pragma unroll
      for (int x = 0; x < kDimsPerThread; ++x) {
        qk = fmaf(qr[x], kr[x * TPR + part], qk);
        dp = fmaf(dor[x], vr[x * TPR + part], dp);
      }
      qk = row_sum<TPR>(qk, lanes);
      dp = row_sum<TPR>(dp, lanes);
      const float p = expf(__fmul_rn(scale, qk) - lse_i);
      const float ds = p * (dp - delta);
#pragma unroll
      for (int x = 0; x < kDimsPerThread; ++x) {
        acc[x] = fmaf(ds, kr[x * TPR + part], acc[x]);
      }
    }
  }
  if (!live) return;
  T* row = dq + dense_row(s, bi, qi, hi);
#pragma unroll
  for (int x = 0; x < kDimsPerThread; ++x) {
    const int dim = x * TPR + part;
    if (dim < s.d) row[dim] = from_f<T>(__fmul_rn(scale, acc[x]));
  }
}

template <int DMAX, typename T>
__global__ void __launch_bounds__(kRows * (DMAX / kDimsPerThread))
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, Shape s, float scale, int causal) {
  constexpr int TPR = DMAX / kDimsPerThread;
  constexpr int QT = tile_rows<DMAX>();
  __shared__ float qs[QT * DMAX];
  __shared__ float dos[QT * DMAX];
  __shared__ float lses[QT];
  __shared__ float deltas[QT];
  const int bh = blockIdx.x;
  const int bi = bh / s.h, hi = bh % s.h;
  const int row0 = blockIdx.y * kRows;
  const int part = threadIdx.x % TPR;
  const int kj = row0 + threadIdx.x / TPR;
  const bool live = kj < s.t;
  const unsigned lanes = row_lanes<TPR>();

  float kr[kDimsPerThread], vr[kDimsPerThread];
  float dka[kDimsPerThread], dva[kDimsPerThread];
#pragma unroll
  for (int x = 0; x < kDimsPerThread; ++x) {
    const int dim = x * TPR + part;
    kr[x] = vr[x] = dka[x] = dva[x] = 0.f;
    if (live && dim < s.d) {
      const long long off = view_row(s, bi, kj, hi) + dim;
      kr[x] = to_f(k[off]);
      vr[x] = to_f(v[off]);
    }
  }
  // Under the causal mask no query before this tile's first key sees it.
  for (int i0 = causal ? row0 : 0; i0 < s.t; i0 += QT) {
    const int nq = min(QT, s.t - i0);
    __syncthreads();
    for (int e = threadIdx.x; e < QT * DMAX; e += blockDim.x) {
      const int r = e / DMAX, dim = e % DMAX;
      float qx = 0.f, dx = 0.f;
      if (r < nq && dim < s.d) {
        qx = to_f(q[view_row(s, bi, i0 + r, hi) + dim]);
        dx = to_f(dout[dense_row(s, bi, i0 + r, hi) + dim]);
      }
      qs[e] = qx;
      dos[e] = dx;
    }
    for (int r = threadIdx.x; r < QT; r += blockDim.x) {
      const bool in = r < nq;
      lses[r] = in ? lse[(long long)bh * s.t + i0 + r] : 0.f;
      deltas[r] = in ? delta[(long long)bh * s.t + i0 + r] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int jstart = causal ? max(0, kj - i0) : 0;
    for (int j = jstart; j < nq; ++j) {
      const float* qrow = qs + j * DMAX;
      const float* drow = dos + j * DMAX;
      float qk = 0.f, dp = 0.f;
#pragma unroll
      for (int x = 0; x < kDimsPerThread; ++x) {
        qk = fmaf(qrow[x * TPR + part], kr[x], qk);
        dp = fmaf(drow[x * TPR + part], vr[x], dp);
      }
      qk = row_sum<TPR>(qk, lanes);
      dp = row_sum<TPR>(dp, lanes);
      const float p = expf(__fmul_rn(scale, qk) - lses[j]);
      const float ds = p * (dp - deltas[j]);
#pragma unroll
      for (int x = 0; x < kDimsPerThread; ++x) {
        dva[x] = fmaf(p, drow[x * TPR + part], dva[x]);
        dka[x] = fmaf(ds, qrow[x * TPR + part], dka[x]);
      }
    }
  }
  if (!live) return;
  const long long out = dense_row(s, bi, kj, hi);
#pragma unroll
  for (int x = 0; x < kDimsPerThread; ++x) {
    const int dim = x * TPR + part;
    if (dim < s.d) {
      dk[out + dim] = from_f<T>(__fmul_rn(scale, dka[x]));
      dv[out + dim] = from_f<T>(dva[x]);
    }
  }
}

struct Launch {
  dim3 grid, block;
};

template <int DMAX>
Launch launch_shape(const Shape& s) {
  return {dim3((unsigned)(s.b * s.h), (unsigned)((s.t + kRows - 1) / kRows)),
          dim3(kRows * (DMAX / kDimsPerThread))};
}

// Calls f with the smallest head-dim capacity DMAX in {16, 32, 64, 128}
// that holds d.
template <typename F>
void with_dmax(int d, F&& f) {
  if (d <= 16) {
    f(std::integral_constant<int, 16>{});
  } else if (d <= 32) {
    f(std::integral_constant<int, 32>{});
  } else if (d <= 64) {
    f(std::integral_constant<int, 64>{});
  } else {
    f(std::integral_constant<int, 128>{});
  }
}

// 0 when the shape is one the kernels take, else a CUDA error code.
int check(const Shape& s, int device) {
  if (s.b < 1 || s.h < 1 || s.t < 1 || s.d < 1 || s.d > 128 ||
      (long long)s.b * s.h > 0x7fffffffLL ||
      (s.t + kRows - 1) / kRows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSetDevice(device);
}

template <typename T>
void fwd(const void* q, const void* k, const void* v, void* o, void* lse,
         const Shape& s, float scale, int causal, cudaStream_t stream) {
  with_dmax(s.d, [&](auto dmax) {
    constexpr int DMAX = decltype(dmax)::value;
    const Launch l = launch_shape<DMAX>(s);
    flash_fwd_kernel<DMAX, T><<<l.grid, l.block, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, s, scale,
        causal);
  });
}

template <typename T>
void dq(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* delta, void* dq_out,
        const Shape& s, float scale, int causal, cudaStream_t stream) {
  with_dmax(s.d, [&](auto dmax) {
    constexpr int DMAX = decltype(dmax)::value;
    const Launch l = launch_shape<DMAX>(s);
    flash_dq_kernel<DMAX, T><<<l.grid, l.block, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
        (const float*)lse, (float*)delta, (T*)dq_out, s, scale, causal);
  });
}

template <typename T>
void dkv(const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, void* dk, void* dv,
         const Shape& s, float scale, int causal, cudaStream_t stream) {
  with_dmax(s.d, [&](auto dmax) {
    constexpr int DMAX = decltype(dmax)::value;
    const Launch l = launch_shape<DMAX>(s);
    flash_dkv_kernel<DMAX, T><<<l.grid, l.block, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, s, scale,
        causal);
  });
}

}  // namespace

// Each entry launches on `stream` (a stream of `device`) and returns
// cudaGetLastError() (0 when the launch was accepted), or
// cudaErrorInvalidValue for a shape the kernels do not take. None
// synchronises. This library carries its own copy of the CUDA runtime, whose
// current device is not PyTorch's: each entry selects the operands' device.
// `bf16` is 1 for bfloat16 operands, 0 for float32.

// q, k, v (b, t, h, d) with strides (sb, st, sh, 1); writes o (b, t, h, d)
// contiguous in their type and lse (b, h, t) float32.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int b, int h, int t,
                                int d, long long sb, long long st,
                                long long sh, float scale, int causal,
                                int bf16, int device, void* stream) {
  const Shape s{b, h, t, d, sb, st, sh};
  const int bad = check(s, device);
  if (bad != 0) return bad;
  if (bf16) {
    fwd<__nv_bfloat16>(q, k, v, o, lse, s, scale, causal,
                       (cudaStream_t)stream);
  } else {
    fwd<float>(q, k, v, o, lse, s, scale, causal, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// q, k, v as above; o and dout (b, t, h, d) contiguous; lse (b, h, t)
// float32. Writes delta (b, h, t) float32 and dq (b, t, h, d) contiguous.
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* delta, void* dq_out,
                               int b, int h, int t, int d, long long sb,
                               long long st, long long sh, float scale,
                               int causal, int bf16, int device,
                               void* stream) {
  const Shape s{b, h, t, d, sb, st, sh};
  const int bad = check(s, device);
  if (bad != 0) return bad;
  if (bf16) {
    dq<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq_out, s, scale, causal,
                      (cudaStream_t)stream);
  } else {
    dq<float>(q, k, v, o, dout, lse, delta, dq_out, s, scale, causal,
              (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// q, k, v and dout as above; lse and delta (b, h, t) float32. Writes dk and
// dv (b, t, h, d) contiguous.
extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int b,
                                int h, int t, int d, long long sb,
                                long long st, long long sh, float scale,
                                int causal, int bf16, int device,
                                void* stream) {
  const Shape s{b, h, t, d, sb, st, sh};
  const int bad = check(s, device);
  if (bad != 0) return bad;
  if (bf16) {
    dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, s, scale, causal,
                       (cudaStream_t)stream);
  } else {
    dkv<float>(q, k, v, dout, lse, delta, dk, dv, s, scale, causal,
               (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
