// Fused softmax cross-entropy for Hopper (sm_90a), forward and backward,
// bound to Python through plain C functions loaded with ctypes.
//
//   forward:  loss[r] = max(lse[r] - logits[r, label[r]], 0),
//             lse[r]  = max_c logits[r, c] + log sum_c exp(logits[r, c] - max)
//   backward: dlogits[r, c] = (exp(logits[r, c] - lse[r]) - [c == label[r]])
//                             * g[r] * live[r]
//
// Replaces the Pallas TPU kernels in
// pytorch_distributed_mnist_tpu/ops/pallas/xent.py: _fwd_impl (:124, its
// pallas_call :129, body _xent_fwd_kernel :45) and _bwd_rule (:154, its
// pallas_call :162, body _xent_bwd_kernel :68). Those pad the classes to
// one 128-lane tile, mask the padding to -inf and walk blocks of up to 128
// rows. Nothing is padded here.
//
// Layout, chosen from C alone: a row belongs to a group of LANES
// consecutive lanes of a warp, each lane holding PER classes in chunks of
// SPAN neighbours, chunk j of lane k at classes (j * LANES + k) * SPAN ..
// + SPAN - 1.
//   - C <= 32: P = the next power of two >= C slots; the group's max and
//     sum take log2(LANES) xor shuffles each instead of a warp's five.
//     The forward gives each of P lanes one class; the backward gives
//     each of P / 2 lanes two (SPAN 2 where C is even: neighbours, stored
//     as one float2), each the faster choice on the H100 (PERF.md).
//   - 32 < C <= 128: one warp owns a row (LANES 32, PER 4: classes lane,
//     lane+32, lane+64, lane+96), its max and sum five-step xor shuffles.
// A chunk is one SPAN-wide load where the row stride and the pointers'
// alignment allow it, else SPAN loads of one float: the loads' width
// never changes the arithmetic. Classes past C read as -inf in the
// forward, as the TPU kernel masks them. Each lane reads its row's label
// once; the label's logit comes from the one lane that holds it (a
// register select, then one shuffle from that lane).
//
// `live` is the TPU kernel's gate (xent.py:84-86): 1, 0.5 or 0 as
// lse - picked is > 0, == 0 or < 0. It is how XLA differentiates the
// forward's clamp max(x, 0) (half the gradient at the tie), so saturated
// rows get the reference's gradient. The backward reads `picked` from the
// raw logits, not the masked ones, as the TPU kernel does: a label in
// [C, 128) picks -inf in the forward and 0 in the backward.
//
// What bounds it on an H100: at the training path's shape (256 x 10) the
// forward moves about 14 KB and the backward about 24 KB: 0.004 and 0.007
// us at 3.35 TB/s, far below the time of one launch. The kernels are bound
// by their launch and their latency; the design keeps them to one pass and
// one launch each, with no shared memory and no atomics (the same inputs
// give the same bits), and takes dependent shuffles off a small row's
// critical path.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxClasses = 128;  // the TPU kernel's one 128-lane tile
constexpr int kSmallClasses = 32;  // up to here a row is P <= 32 slots

// The lanes of this thread's group (LANES consecutive lanes of the warp).
template <int LANES>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (LANES == 32) {
    return 0xffffffffu;
  } else {
    const int first = (threadIdx.x % 32) / LANES * LANES;
    return ((1u << LANES) - 1u) << first;
  }
}

template <int LANES>
__device__ __forceinline__ float group_max(float x, unsigned mask) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2) {
    x = fmaxf(x, __shfl_xor_sync(mask, x, off, LANES));
  }
  return x;
}

template <int LANES>
__device__ __forceinline__ float group_sum(float x, unsigned mask) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2) {
    x = __fadd_rn(x, __shfl_xor_sync(mask, x, off, LANES));
  }
  return x;
}

// Class of element i (chunk i / SPAN, element i % SPAN) of lane k.
template <int LANES, int SPAN>
__device__ __forceinline__ int class_of(int i, int k) {
  return ((i / SPAN) * LANES + k) * SPAN + i % SPAN;
}

// Loads lane k's PER classes of row x, a chunk of two as one float2 if
// WIDE; classes at or past c get `pad` (C is a multiple of SPAN).
template <int LANES, int PER, int SPAN, bool WIDE>
__device__ __forceinline__ void load_row(const float* __restrict__ x, int c,
                                         int k, float pad, float (&v)[PER]) {
#pragma unroll
  for (int j = 0; j < PER / SPAN; ++j) {
    const int col = (j * LANES + k) * SPAN;
    if (col < c) {
      if constexpr (WIDE) {
        const float2 q = *reinterpret_cast<const float2*>(x + col);
        v[j * 2] = q.x;
        v[j * 2 + 1] = q.y;
      } else {
#pragma unroll
        for (int e = 0; e < SPAN; ++e) v[j * SPAN + e] = x[col + e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < SPAN; ++e) v[j * SPAN + e] = pad;
    }
  }
}

// The label's logit (0 for a label outside [0, c)): the lane that holds
// it selects it from its registers and hands it to its group.
template <int LANES, int PER, int SPAN>
__device__ __forceinline__ float pick(const float (&v)[PER], int64_t label,
                                      int c, int k, unsigned mask) {
  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int col = class_of<LANES, SPAN>(i, k);
    if (col < c && col == label) mine = v[i];
  }
  if constexpr (LANES == 1) {
    return mine;
  } else {
    const int owner = (int)(((unsigned long long)label / SPAN) % LANES);
    return __shfl_sync(mask, mine, owner, LANES);
  }
}

template <int LANES, int PER, int SPAN, bool WIDE>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const float* __restrict__ logits,
                const int64_t* __restrict__ labels, float* __restrict__ loss,
                float* __restrict__ lse_out, int b, int c, int ld) {
  const int row = blockIdx.x * (kThreads / LANES) + threadIdx.x / LANES;
  const int k = threadIdx.x % LANES;
  if (row >= b) return;  // the whole group leaves together
  const unsigned mask = group_mask<LANES>();
  const int64_t label = labels[row];
  float v[PER];
  load_row<LANES, PER, SPAN, WIDE>(logits + (size_t)row * ld, c, k, -INFINITY,
                                   v);
  const float picked_raw = pick<LANES, PER, SPAN>(v, label, c, k, mask);
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER; ++i) m = fmaxf(m, v[i]);
  m = group_max<LANES>(m, mask);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (class_of<LANES, SPAN>(i, k) < c) {
      s = __fadd_rn(s, expf(__fsub_rn(v[i], m)));
    }
  }
  s = group_sum<LANES>(s, mask);
  if (k == 0) {
    // A label in [C, 128) picks a class the TPU kernel masked to -inf.
    const float picked =
        (label >= c && label < kMaxClasses) ? -INFINITY : picked_raw;
    const float lse = __fadd_rn(m, logf(s));
    const float d = __fsub_rn(lse, picked);
    loss[row] = isnan(d) ? d : fmaxf(d, 0.f);
    lse_out[row] = lse;
  }
}

template <int LANES, int PER, int SPAN, bool WIDE>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const float* __restrict__ logits,
                const int64_t* __restrict__ labels,
                const float* __restrict__ lse_in, const float* __restrict__ g,
                float* __restrict__ dlogits, int b, int c, int ld, int ldd) {
  const int row = blockIdx.x * (kThreads / LANES) + threadIdx.x / LANES;
  const int k = threadIdx.x % LANES;
  if (row >= b) return;
  const unsigned mask = group_mask<LANES>();
  const int64_t label = labels[row];
  float v[PER];
  load_row<LANES, PER, SPAN, WIDE>(logits + (size_t)row * ld, c, k, 0.f, v);
  const float picked = pick<LANES, PER, SPAN>(v, label, c, k, mask);
  const float lse = lse_in[row];
  const float diff = __fsub_rn(lse, picked);
  const float live = diff > 0.f ? 1.f : (diff == 0.f ? 0.5f : 0.f);
  const float scale = g[row];
  float d[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int col = class_of<LANES, SPAN>(i, k);
    d[i] = 0.f;
    if (col < c) {
      const float p = expf(__fsub_rn(v[i], lse));
      const float onehot = col == label ? 1.f : 0.f;
      d[i] = __fmul_rn(__fmul_rn(__fsub_rn(p, onehot), scale), live);
    }
  }
  float* out = dlogits + (size_t)row * ldd;
#pragma unroll
  for (int j = 0; j < PER / SPAN; ++j) {
    const int col = (j * LANES + k) * SPAN;
    if (col < c) {
      if constexpr (WIDE) {
        *reinterpret_cast<float2*>(out + col) =
            make_float2(d[j * 2], d[j * 2 + 1]);
      } else {
#pragma unroll
        for (int e = 0; e < SPAN; ++e) out[col + e] = d[j * SPAN + e];
      }
    }
  }
}

// Whether a row of stride ld from p loads two floats at a time.
bool wide2(const void* p, int ld) {
  return ld % 2 == 0 && (uintptr_t)p % (2 * sizeof(float)) == 0;
}

unsigned blocks(int b, int lanes) {
  const int rows = kThreads / lanes;
  return (unsigned)((b + rows - 1) / rows);
}

// Launches f.run<LANES, PER, SPAN, WIDE>() for a row of c classes: a
// warp above 32, else f.small<P>() for P the next power of two >= c.
template <class F>
void dispatch(int c, const F& f) {
  if (c > kSmallClasses) {
    f.template run<32, 4, 1, false>();
  } else if (c > 16) {
    f.template small<32>();
  } else if (c > 8) {
    f.template small<16>();
  } else if (c > 4) {
    f.template small<8>();
  } else if (c > 2) {
    f.template small<4>();
  } else if (c > 1) {
    f.template small<2>();
  } else {
    f.template small<1>();
  }
}

struct Fwd {
  const float* logits;
  const int64_t* labels;
  float* loss;
  float* lse;
  int b, c, ld;
  cudaStream_t stream;
  // P lanes, one class each.
  template <int P>
  void small() const {
    run<P, 1, 1, false>();
  }
  template <int LANES, int PER, int SPAN, bool WIDE>
  void run() const {
    xent_fwd_kernel<LANES, PER, SPAN, WIDE>
        <<<blocks(b, LANES), kThreads, 0, stream>>>(logits, labels, loss, lse,
                                                    b, c, ld);
  }
};

struct Bwd {
  const float* logits;
  const int64_t* labels;
  const float* lse;
  const float* g;
  float* dlogits;
  int b, c, ld, ldd;
  cudaStream_t stream;
  // P / 2 lanes, two classes each: neighbours where c is even (one float2
  // where the rows allow it), else classes k and P / 2 + k.
  template <int P>
  void small() const {
    if constexpr (P == 1) {
      run<1, 1, 1, false>();
    } else if (c % 2 != 0) {
      run<P / 2, 2, 1, false>();
    } else if (wide2(logits, ld) && wide2(dlogits, ldd)) {
      run<P / 2, 2, 2, true>();
    } else {
      run<P / 2, 2, 2, false>();
    }
  }
  template <int LANES, int PER, int SPAN, bool WIDE>
  void run() const {
    xent_bwd_kernel<LANES, PER, SPAN, WIDE>
        <<<blocks(b, LANES), kThreads, 0, stream>>>(logits, labels, lse, g,
                                                    dlogits, b, c, ld, ldd);
  }
};

}  // namespace

// Each launch entry launches on `stream` (a stream of `device`) and
// returns cudaGetLastError() (0 when the launch was accepted). Neither
// synchronises. This library carries its own copy of the CUDA runtime, whose
// current device is not PyTorch's: each entry selects the operands' device.

// logits (b, c) f32 with row stride ld and unit column stride; labels (b,)
// int64; writes loss (b,) and lse (b,) f32.
extern "C" int xent_fwd_launch(const void* logits, const void* labels,
                               void* loss, void* lse, int b, int c, int ld,
                               int device, void* stream) {
  if (b <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Fwd f{(const float*)logits, (const int64_t*)labels, (float*)loss,
              (float*)lse, b, c, ld, (cudaStream_t)stream};
  dispatch(c, f);
  return (int)cudaGetLastError();
}

// logits and labels as above, lse (b,) and g (b,) f32; writes dlogits
// (b, c) f32 with row stride ldd.
extern "C" int xent_bwd_launch(const void* logits, const void* labels,
                               const void* lse, const void* g, void* dlogits,
                               int b, int c, int ld, int ldd, int device,
                               void* stream) {
  if (b <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Bwd f{(const float*)logits, (const int64_t*)labels,
              (const float*)lse, (const float*)g, (float*)dlogits, b, c, ld,
              ldd, (cudaStream_t)stream};
  dispatch(c, f);
  return (int)cudaGetLastError();
}
