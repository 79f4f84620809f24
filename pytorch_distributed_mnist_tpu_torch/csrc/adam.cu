// Fused Adam update of many float32 parameter leaves in one launch, for
// Hopper (sm_90a), bound to Python through a plain C function loaded with
// ctypes.
//
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g
//   p = p + (-lr * (m / bc1)) / (sqrt(v / bc2 + eps_root) + eps)
//
// with the reciprocal bias corrections 1/bc1, 1/bc2 and the complements
// 1 - b1, 1 - b2 as in the hypers vector [lr, b1, b2, eps, 1/bc1, 1/bc2,
// 1-b1, 1-b2, eps_root].
//
// Replaces the Pallas TPU kernel in
// pytorch_distributed_mnist_tpu/ops/pallas/adam.py (fused_adam_leaf, :64,
// body _adam_kernel :35), which the reference calls once per leaf, followed
// by the optax.apply_updates that adds its delta to the parameter. That
// kernel reads g, m, v and writes delta, m, v (m and v aliased in place),
// and apply_updates then reads p and delta and writes p: 36 bytes per
// element in all. Here one pass updates p, m and v in place: it reads 16
// bytes per element (p, g, m, v) and writes 12 (p, m, v).
//
// Design: one launch for up to kMaxLeaves leaves. The leaves' pointers and
// lengths travel by value in one __grid_constant__ struct (2,824 bytes, far
// below the kernel-parameter limit), with the prefix of their chunk counts:
// block b updates chunk b - first[i] of leaf i, the last leaf with first[i]
// <= b, found by a binary search over the struct. A chunk is kChunk
// elements, kVec per thread; a leaf whose four pointers are 16-byte aligned
// takes float4 loads and stores, any other leaf (and the ragged end of
// every leaf) scalar ones. No shared memory, no atomics, and no copy of the
// table to the device. ops/adam.py::launch_plan builds the prefix; the
// entry refuses a prefix that does not match kChunk. A model with more
// leaves takes one launch per kMaxLeaves.
//
// The hypers. adam_leaf (one leaf, ops/adam.py) passes the float32[9]
// vector it was given. FusedAdam.step passes the five injected float32
// scalars (learning_rate, b1, b2, eps, eps_root) and the int32 step count
// on the device, and every block forms the vector itself with
// ops/adam.py::adam_hypers' float32 operations: t = float(count),
// 1 / (1 - powf(b, t)) and 1 - b. So a step runs no torch op for the
// hypers. The two count increments before the launch stay torch add_ ops
// on the same stream: an increment inside this launch would race with the
// blocks that read the count.
//
// pow. Three implementations of b^t meet here: torch's (the plain version;
// on the card torch.pow of two float32 tensors is CUDA's powf), XLA's (the
// reference's optax bias correction and pallas_adam's b ** t), and this
// kernel's CUDA powf. On the CPU, torch and XLA round b1^t one ulp apart at
// 180 of t = 1..3000 (first at t = 31) and b2^t at 56 (first at t = 168),
// so a resume across the two packages agrees within allclose after step
// 31, not bit for bit (tests/test_torch_adam.py pins this). On the card
// the kernel and torch.pow both call CUDA's powf; chip_smoke.py checks the
// kernel's vector against adam_hypers on the card at every t = 1..3000 and
// the update against adam_leaves_plain over 200 steps, bit for bit.
//
// Rounding: every operation is written with an explicit round-to-nearest
// intrinsic in the TPU kernel's order. Left to itself nvcc would contract
// b1 * m + c1 * g into a fused multiply-add, which rounds once instead of
// twice, and the kernel would no longer equal its plain PyTorch version
// (ops/adam.py::adam_leaf_plain) bit for bit. Built without fast math.
//
// What bounds it on an H100: the bytes. Over the cnn's 1,625,866
// parameters that is 45.5 MB, 0.0136 ms at 3.35 TB/s; over the ViT's
// 104,970, 0.000877 ms. The arithmetic (about 15 float32 operations per
// element) is far below the card's float32 rate. Over the ViT's 31 small
// leaves the old design paid one launch per leaf; here one launch of 122
// blocks covers them (the cnn's 8 leaves: 1,593 blocks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                    // elements per thread
constexpr int kChunk = kThreads * kVec;    // elements per block
constexpr int kMaxLeaves = 64;             // leaves per launch

struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int first[kMaxLeaves + 1];  // first chunk of each leaf; first[count] is
                              // the grid's size
  int count;
};

// Where the hypers come from: `vec` (float32[9]) when it is set, else the
// injected scalars and the step count. `out`, when set, receives the nine
// values block 0 used.
struct Hypers {
  const float* vec;
  const float* lr;
  const float* b1;
  const float* b2;
  const float* eps;
  const float* eps_root;
  const int* count;
  float* out;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const float (&h)[9]) {
  const float lr = h[0], b1 = h[1], b2 = h[2], eps = h[3];
  const float inv_bc1 = h[4], inv_bc2 = h[5];
  const float c1 = h[6], c2 = h[7], eps_root = h[8];
  m = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(c1, g));
  v = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(__fmul_rn(c2, g), g));
  const float m_hat = __fmul_rn(m, inv_bc1);
  const float v_hat = __fmul_rn(v, inv_bc2);
  const float denom = __fadd_rn(__fsqrt_rn(__fadd_rn(v_hat, eps_root)), eps);
  p = __fadd_rn(p, __fdiv_rn(__fmul_rn(-lr, m_hat), denom));
}

__global__ void __launch_bounds__(kThreads)
adam_leaves_kernel(const __grid_constant__ Table t, const Hypers hy) {
  float h[9];
  if (hy.vec != nullptr) {
#pragma unroll
    for (int i = 0; i < 9; ++i) h[i] = hy.vec[i];
  } else {
    const float b1 = *hy.b1, b2 = *hy.b2;
    const float step = __int2float_rn(*hy.count);
    h[0] = *hy.lr;
    h[1] = b1;
    h[2] = b2;
    h[3] = *hy.eps;
    h[4] = __fdiv_rn(1.f, __fsub_rn(1.f, powf(b1, step)));
    h[5] = __fdiv_rn(1.f, __fsub_rn(1.f, powf(b2, step)));
    h[6] = __fsub_rn(1.f, b1);
    h[7] = __fsub_rn(1.f, b2);
    h[8] = *hy.eps_root;
  }
  if (hy.out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) hy.out[i] = h[i];
  }

  // This block's leaf: the last i with first[i] <= blockIdx.x.
  const int b = (int)blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Leaf& leaf = t.leaf[lo];
  const long long i0 =
      (long long)(b - t.first[lo]) * kChunk + (long long)threadIdx.x * kVec;
  if (i0 >= leaf.n) return;
  const bool aligned = (((uintptr_t)leaf.p | (uintptr_t)leaf.g |
                         (uintptr_t)leaf.m | (uintptr_t)leaf.v) & 15u) == 0;
  if (aligned && i0 + kVec <= leaf.n) {
    float4 p = *reinterpret_cast<const float4*>(leaf.p + i0);
    const float4 g = *reinterpret_cast<const float4*>(leaf.g + i0);
    float4 m = *reinterpret_cast<const float4*>(leaf.m + i0);
    float4 v = *reinterpret_cast<const float4*>(leaf.v + i0);
    update(p.x, g.x, m.x, v.x, h);
    update(p.y, g.y, m.y, v.y, h);
    update(p.z, g.z, m.z, v.z, h);
    update(p.w, g.w, m.w, v.w, h);
    *reinterpret_cast<float4*>(leaf.p + i0) = p;
    *reinterpret_cast<float4*>(leaf.m + i0) = m;
    *reinterpret_cast<float4*>(leaf.v + i0) = v;
    return;
  }
  for (long long i = i0; i < i0 + kVec && i < leaf.n; ++i) {
    float p = leaf.p[i], m = leaf.m[i], v = leaf.v[i];
    update(p, leaf.g[i], m, v, h);
    leaf.p[i] = p;
    leaf.m[i] = m;
    leaf.v[i] = v;
  }
}

}  // namespace

// Updates every leaf of one launch in place, on `stream` (a stream of
// `device`). Returns cudaGetLastError() (0 when the launch was accepted),
// or cudaErrorInvalidValue for a table it does not take. Does not
// synchronise. This library carries its own copy of the CUDA runtime,
// whose current device is not PyTorch's: the entry selects the operands'
// device for the launch.
//
// `rows`: n_leaves rows of five int64 in host memory, the device pointers
// of p, g, m and v and the leaf's length (at least 1). `first`: n_leaves +
// 1 int32 in host memory, 0 then the running sum of each leaf's
// ceil(n / kChunk). The hypers: `hypers` (float32[9] on the device), or,
// when it is null, the five float32 scalars and the int32 `count` on the
// device; `hypers_out` (float32[9] on the device, or null) receives the
// values used.
extern "C" int adam_leaves_launch(const long long* rows, int n_leaves,
                                  const int* first, const void* hypers,
                                  const void* lr, const void* b1,
                                  const void* b2, const void* eps,
                                  const void* eps_root, const void* count,
                                  void* hypers_out, int device,
                                  void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || first[0] != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (hypers == nullptr && (lr == nullptr || b1 == nullptr ||
                            b2 == nullptr || eps == nullptr ||
                            eps_root == nullptr || count == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Table t = {};
  t.count = n_leaves;
  t.first[0] = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const long long* r = rows + 5 * i;
    const long long n = r[4];
    const long long chunks = (n + kChunk - 1) / kChunk;
    if (n < 1 || (long long)first[i + 1] - first[i] != chunks) {
      return (int)cudaErrorInvalidValue;
    }
    t.leaf[i] = Leaf{(float*)r[0], (const float*)r[1], (float*)r[2],
                     (float*)r[3], n};
    t.first[i + 1] = first[i + 1];
  }
  const Hypers hy{(const float*)hypers,  (const float*)lr,
                  (const float*)b1,      (const float*)b2,
                  (const float*)eps,     (const float*)eps_root,
                  (const int*)count,     (float*)hypers_out};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  adam_leaves_kernel<<<(unsigned)first[n_leaves], kThreads, 0,
                       (cudaStream_t)stream>>>(t, hy);
  return (int)cudaGetLastError();
}
