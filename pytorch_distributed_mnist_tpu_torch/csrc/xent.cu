// Fused softmax cross-entropy for Hopper (sm_90a), forward and backward,
// bound to Python through plain C functions loaded with ctypes.
//
//   forward:  loss[r] = max(lse[r] - logits[r, label[r]], 0),
//             lse[r]  = max_c logits[r, c] + log sum_c exp(logits[r, c] - max)
//   backward: dlogits[r, c] = (exp(logits[r, c] - lse[r]) - [c == label[r]])
//                             * g[r] * live[r]
//
// Replaces the Pallas TPU kernels in
// pytorch_distributed_mnist_tpu/ops/pallas/xent.py: _fwd_impl (:124, body
// _xent_fwd_kernel :45) and _bwd_rule (:154, body _xent_bwd_kernel :68).
// Those pad the classes to one 128-lane tile, mask the padding to -inf and
// walk blocks of up to 128 rows. Here nothing is padded: one warp owns one
// row, each of its 32 lanes holds classes lane, lane+32, lane+64, lane+96
// (C <= 128, so at most 4 per lane), and the row's max and sums are warp
// shuffles. Classes past C read as -inf, as the TPU kernel masks them.
//
// `live` is the TPU kernel's gate (xent.py:84-86): 1, 0.5 or 0 as
// lse - picked is > 0, == 0 or < 0. It is how XLA differentiates the
// forward's clamp max(x, 0) (half the gradient at the tie), so saturated
// rows get the reference's gradient. The backward reads `picked` from the
// raw logits, not the masked ones, as the TPU kernel does.
//
// What bounds it on an H100: at the training path's shape (256 x 10) the
// forward moves about 14 KB and the backward about 24 KB: 0.004 and 0.007
// us at 3.35 TB/s, far below the time of one launch. The kernels are bound
// by their launch; the design keeps them to one pass and one launch each,
// with no shared memory and no atomics (a step is deterministic).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPerLane = 4;              // 4 x 32 = 128 classes at most
constexpr int kRowsPerBlock = 8;         // 8 warps, 256 threads
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
xent_fwd_kernel(const float* __restrict__ logits,
                const int64_t* __restrict__ labels, float* __restrict__ loss,
                float* __restrict__ lse_out, int b, int c, int ld) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= b) return;  // the whole warp leaves together
  const float* x = logits + (size_t)row * ld;
  const int64_t label = labels[row];
  float v[kPerLane];
  float m = -INFINITY;
  float picked = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int col = lane + kWarp * j;
    v[j] = col < c ? x[col] : -INFINITY;
    m = fmaxf(m, v[j]);
    if (col == label) picked = v[j];
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (lane + kWarp * j < c) s = __fadd_rn(s, expf(__fsub_rn(v[j], m)));
  }
  s = warp_sum(s);
  picked = warp_sum(picked);  // one lane holds it, the others add zeros
  if (lane == 0) {
    const float lse = __fadd_rn(m, logf(s));
    const float d = __fsub_rn(lse, picked);
    loss[row] = isnan(d) ? d : fmaxf(d, 0.f);
    lse_out[row] = lse;
  }
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
xent_bwd_kernel(const float* __restrict__ logits,
                const int64_t* __restrict__ labels,
                const float* __restrict__ lse_in, const float* __restrict__ g,
                float* __restrict__ dlogits, int b, int c, int ld, int ldd) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= b) return;
  const float* x = logits + (size_t)row * ld;
  const int64_t label = labels[row];
  float v[kPerLane];
  float picked = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int col = lane + kWarp * j;
    v[j] = col < c ? x[col] : 0.f;
    if (col == label) picked = v[j];
  }
  picked = warp_sum(picked);
  const float lse = lse_in[row];
  const float diff = __fsub_rn(lse, picked);
  const float live = diff > 0.f ? 1.f : (diff == 0.f ? 0.5f : 0.f);
  const float scale = g[row];
  float* out = dlogits + (size_t)row * ldd;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int col = lane + kWarp * j;
    if (col < c) {
      const float p = expf(__fsub_rn(v[j], lse));
      const float onehot = col == label ? 1.f : 0.f;
      out[col] = __fmul_rn(__fmul_rn(__fsub_rn(p, onehot), scale), live);
    }
  }
}

unsigned blocks_for(int b) {
  return (unsigned)((b + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

// Each entry launches on `stream` (a stream of `device`) and returns
// cudaGetLastError() (0 when the launch was accepted). Neither
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
  xent_fwd_kernel<<<blocks_for(b), kWarp * kRowsPerBlock, 0,
                    (cudaStream_t)stream>>>(
      (const float*)logits, (const int64_t*)labels, (float*)loss,
      (float*)lse, b, c, ld);
  return (int)cudaGetLastError();
}

// logits and labels as above, lse (b,) and g (b,) f32; writes dlogits (b, c)
// f32 with row stride ldd.
extern "C" int xent_bwd_launch(const void* logits, const void* labels,
                               const void* lse, const void* g, void* dlogits,
                               int b, int c, int ld, int ldd, int device,
                               void* stream) {
  if (b <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  xent_bwd_kernel<<<blocks_for(b), kWarp * kRowsPerBlock, 0,
                    (cudaStream_t)stream>>>(
      (const float*)logits, (const int64_t*)labels, (const float*)lse,
      (const float*)g, (float*)dlogits, b, c, ld, ldd);
  return (int)cudaGetLastError();
}
