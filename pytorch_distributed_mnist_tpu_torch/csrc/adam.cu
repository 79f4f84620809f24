// Fused Adam update of one float32 parameter leaf for Hopper (sm_90a),
// bound to Python through a plain C function loaded with ctypes.
//
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g
//   p = p + (-lr * (m / bc1)) / (sqrt(v / bc2 + eps_root) + eps)
//
// with the reciprocal bias corrections 1/bc1, 1/bc2 and the complements
// 1 - b1, 1 - b2 precomputed in the hypers vector, float32[9] on the device:
// [lr, b1, b2, eps, 1/bc1, 1/bc2, 1-b1, 1-b2, eps_root].
//
// Replaces the Pallas TPU kernel in
// pytorch_distributed_mnist_tpu/ops/pallas/adam.py (fused_adam_leaf, :64,
// body _adam_kernel :35), followed by the optax.apply_updates that adds its
// delta to the parameter. That kernel reads g, m, v and writes delta, m, v
// (m and v aliased in place), and apply_updates then reads p and delta and
// writes p: 36 bytes per element in all. Here one pass updates p, m and v in
// place: it reads 16 bytes per element (p, g, m, v) and writes 12 (p, m, v).
//
// Rounding: every operation is written with an explicit round-to-nearest
// intrinsic in the TPU kernel's order. Left to itself nvcc would contract
// b1 * m + c1 * g into a fused multiply-add, which rounds once instead of
// twice, and the kernel would no longer equal its plain PyTorch version
// (ops/adam.py::adam_leaf_plain) bit for bit.
//
// What bounds it on an H100: the bytes. Over all 1,625,866 parameters of
// cnn that is 45.5 MB, 0.0136 ms at 3.35 TB/s; the arithmetic (about 15
// float32 operations per element) is far below the card's float32 rate.
// The design is a grid-stride loop with neighbouring threads on neighbouring
// elements, so every load and store is coalesced; no shared memory and no
// atomics. One launch per leaf, as the TPU path makes one pallas_call per
// leaf; a launch across all leaves is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks on each of the H100's SMs

__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v,
            const float* __restrict__ h, int64_t n) {
  const float lr = h[0], b1 = h[1], b2 = h[2], eps = h[3];
  const float inv_bc1 = h[4], inv_bc2 = h[5];
  const float c1 = h[6], c2 = h[7], eps_root = h[8];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gi = g[i];
    const float mi = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(c1, gi));
    const float vi =
        __fadd_rn(__fmul_rn(b2, v[i]), __fmul_rn(__fmul_rn(c2, gi), gi));
    const float m_hat = __fmul_rn(mi, inv_bc1);
    const float v_hat = __fmul_rn(vi, inv_bc2);
    const float denom = __fadd_rn(__fsqrt_rn(__fadd_rn(v_hat, eps_root)), eps);
    const float delta = __fdiv_rn(__fmul_rn(-lr, m_hat), denom);
    p[i] = __fadd_rn(p[i], delta);
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

// Updates p, m and v (n float32 each) in place from g and the device hypers
// vector, on `stream` (a stream of `device`). Returns cudaGetLastError() (0
// when the launch was accepted). Does not synchronise. This library carries
// its own copy of the CUDA runtime, whose current device is not PyTorch's:
// the entry selects the operands' device for the launch.
extern "C" int adam_launch(void* p, const void* g, void* m, void* v,
                           const void* hypers, long long n, int device,
                           void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  adam_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)p, (const float*)g, (float*)m, (float*)v, (const float*)hypers,
      (int64_t)n);
  return (int)cudaGetLastError();
}
