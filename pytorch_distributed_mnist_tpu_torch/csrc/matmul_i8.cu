// int8 x int8 -> int32 matrix product for Hopper (sm_90a), bound to Python
// through a plain C function loaded with ctypes.
//
//   C[M, N] (int32) = A[M, K] (int8, row-major) x B[K, N] (int8, row-major)
//
// Replaces the Pallas TPU kernel in
// pytorch_distributed_mnist_tpu/ops/pallas/matmul_i8.py (matmul_i8, whose
// pallas_call is at :91 and whose body is _matmul_i8_kernel at :54). That
// kernel pads M to 32 and K, N to 128 and contracts one whole-K block per
// grid step on the MXU into an int32 accumulator. Here no operand is padded:
// the kernel masks the ragged M, N and K edges itself.
//
// What bounds it on an H100: at the serving path's shapes (fc1: M <= 128,
// K = 12544, N = 128; fc2: K = 128, N = 10; linear: K = 784, N = 10) the
// work is at most 0.41 G int8 operations against 1.6-3.3 MB of operands.
// That is far below the ~590 int8 operations per byte at which the tensor
// cores, and not device memory, would be the limit, so the least time is
// the bytes over 3.35 TB/s: 0.5-1.0 us for fc1. fc2 is bound by the launch.
//
// Design, simple first:
// - One 256-thread block computes a 32 x 64 tile of C. Each thread keeps a
//   2 x 4 tile of int32 sums in registers.
// - K is walked 64 values at a time through shared memory. Both operands are
//   stored there packed four K-values to a 32-bit word, so one __dp4a does
//   four signed int8 multiply-adds into an int32 sum.
// - Split-K: at fc1 a grid of one block per output tile is only 2-8 blocks on
//   132 SMs, each walking K = 12544. blockIdx.z takes one slice of K instead
//   and adds its partial tile into C with atomicAdd; the caller zeroes C
//   first. Integer addition is associative, so the result is exact and the
//   same on every run, whatever order the blocks finish in.
// - The worst-case sum, 127 * 127 * 12544 ~ 2.0e8, fits in int32.
// - Tensor cores (mma.sync / wgmma) and TMA are left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 32;
constexpr int kBlockN = 64;
constexpr int kBlockK = 64;              // int8 values of K per step
constexpr int kWords = kBlockK / 4;      // packed 32-bit words per step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
matmul_i8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int32_t* __restrict__ c, int m, int n, int k, int lda,
                 int ldb, int ldc, int k_per_split, int accumulate,
                 int a_vec4) {
  // +1 word of padding per row: the two rows one warp reads land in
  // different banks.
  __shared__ int a_s[kBlockM][kWords + 1];
  __shared__ int b_s[kWords][kBlockN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx, tx+16, tx+32, tx+48
  const int ty = tid / 16;  // output rows 2*ty, 2*ty+1
  const int m0 = blockIdx.y * kBlockM;
  const int n0 = blockIdx.x * kBlockN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);

  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    // A tile: 32 rows x 16 words. Neighbouring threads take neighbouring
    // words of one row. Bytes past k_end or M read as zero.
    for (int i = tid; i < kBlockM * kWords; i += kThreads) {
      const int r = i / kWords;
      const int w = i % kWords;
      const int gm = m0 + r;
      const int gk = k0 + 4 * w;
      uint32_t word = 0;
      if (gm < m) {
        const int8_t* row = a + (size_t)gm * lda;
        if (a_vec4 && gk + 3 < k_end) {
          word = *reinterpret_cast<const uint32_t*>(row + gk);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (gk + j < k_end) {
              word |= (uint32_t)(uint8_t)row[gk + j] << (8 * j);
            }
          }
        }
      }
      a_s[r][w] = (int)word;
    }
    // B tile: 16 words x 64 columns. Neighbouring threads take neighbouring
    // columns, so each byte load of a row of B is coalesced.
    for (int i = tid; i < kWords * kBlockN; i += kThreads) {
      const int w = i / kBlockN;
      const int col = i % kBlockN;
      const int gn = n0 + col;
      const int gk = k0 + 4 * w;
      uint32_t word = 0;
      if (gn < n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gk + j < k_end) {
            word |= (uint32_t)(uint8_t)b[(size_t)(gk + j) * ldb + gn]
                    << (8 * j);
          }
        }
      }
      b_s[w][col] = (int)word;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int a0 = a_s[2 * ty][w];
      const int a1 = a_s[2 * ty + 1][w];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bv = b_s[w][tx + 16 * j];
        acc[0][j] = __dp4a(a0, bv, acc[0][j]);
        acc[1][j] = __dp4a(a1, bv, acc[1][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = m0 + 2 * ty + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= n) continue;
      int32_t* dst = c + (size_t)gm * ldc + gn;
      if (accumulate) {
        atomicAdd(dst, acc[i][j]);
      } else {
        *dst = acc[i][j];
      }
    }
  }
}

}  // namespace

// Launches the product on `stream` (a stream of `device`) and returns
// cudaGetLastError() (0 when the launch was accepted). `splits` > 1 selects
// split-K, which accumulates into C with atomicAdd: C must then hold zeros.
// Does not synchronise.
extern "C" int matmul_i8_launch(const void* a, const void* b, void* c, int m,
                                int n, int k, int lda, int ldb, int ldc,
                                int splits, int device, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  // This library carries its own copy of the CUDA runtime, whose current
  // device is not PyTorch's: select the operands' device for the launch.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int k_steps = k > 0 ? (k + kBlockK - 1) / kBlockK : 1;
  if (splits < 1) splits = 1;
  if (splits > k_steps) splits = k_steps;
  const int steps_per_split = (k_steps + splits - 1) / splits;
  const int k_per_split = steps_per_split * kBlockK;
  const int z = (k_steps + steps_per_split - 1) / steps_per_split;
  const int a_vec4 =
      (lda % 4 == 0) && (reinterpret_cast<uintptr_t>(a) % 4 == 0);
  dim3 grid((n + kBlockN - 1) / kBlockN, (m + kBlockM - 1) / kBlockM, z);
  matmul_i8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (int32_t*)c, m, n, k, lda, ldb, ldc,
      k_per_split, splits > 1 ? 1 : 0, a_vec4);
  return (int)cudaGetLastError();
}
