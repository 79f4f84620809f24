// int8 x int8 -> int32 matrix product for Hopper (sm_90a) on the tensor
// cores, bound to Python through a plain C function loaded with ctypes.
//
//   C[M, N] (int32) = A[M, K] (int8, row-major) x B[K, N] (int8, row-major)
//
// Replaces the Pallas TPU kernel in
// pytorch_distributed_mnist_tpu/ops/pallas/matmul_i8.py (matmul_i8, whose
// pallas_call is at :91 and whose body is _matmul_i8_kernel at :54). That
// kernel pads M to 32 and K, N to 128 and contracts one whole-K block per
// grid step on the MXU into an int32 accumulator. Here no operand is
// padded: the kernel masks the ragged M, N and K edges itself.
//
// What bounds it on an H100: at the serving path's shapes (fc1: M <= 128,
// K = 12544, N = 128; fc2: K = 128, N = 10; linear: K = 784, N = 10) the
// work is at most 0.41 G int8 operations against 1.6-3.3 MB of operands.
// That is far below the ~590 int8 operations per byte at which the tensor
// cores, and not device memory, would be the limit, so the least time is
// the bytes over 3.35 TB/s: 0.5-1.0 us for fc1. fc2 is bound by the launch.
//
// Design:
// - A block of 4 warps owns a 32 x 32 tile of C and one slice of K, walked
//   128 bytes of K at a time through a 4-stage ring in shared memory filled
//   by 16-byte cp.async loads of A rows and B rows. Warp w takes the
//   32-byte k-step w of each stage: mma.sync m16n8k32 s8 x s8 -> s32
//   (exact int32 sums) for its 32 x 32 partial tile, A's fragments read by
//   ldmatrix (an 8 x 16-byte tile is exactly the A layout).
// - B arrives row-major (K, N), and the col operand wants K-contiguous
//   columns. Lane (g, tq) reads, for k rows 4tq .. 4tq+3 of the step, the
//   32-bit word of columns 4g .. 4g+3, and transposes the 4 x 4 bytes with
//   __byte_perm: word j then holds column 4g + j at k = 4tq .. 4tq+3, which
//   is the B fragment of n-tile j with mma column g standing for column
//   4g + j. The epilogue maps mma columns back. B's shared rows are
//   permuted within each group of four (row r at r ^ ((r >> 2) & 3) in its
//   low two bits) so that the four quads' reads fall in distinct banks.
// - Split-K: at M <= 128 the whole output is 1-16 tiles, so the card fills
//   only by splitting K. The blocks of one thread-block cluster (up to 8,
//   along the split) sum their partial tiles through distributed shared
//   memory; each block of the cluster then writes its share of the tile.
//   Where one cluster covers all of K (fc1 at M = 128) that is a plain
//   store, and C needs no zeroing; where several do, each cluster adds its
//   sum with one atomicAdd per element into a zeroed C. Integer sums are
//   exact and order-free: every run gives the same bits.
// - Ragged shapes: a 16-byte chunk that is not wholly inside the operand,
//   or an operand whose rows are not 16-byte aligned (N = 10), is staged
//   byte by byte with zeros past the edge.
// - The worst-case sum, 128 * 128 * 12544 ~ 2.1e8, fits in int32.

#include <cooperative_groups.h>

#include "mma_common.cuh"  // cp_async16, ldsm, aligned16

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockM = 32;
constexpr int kBlockN = 32;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockK = 32 * kWarps;  // int8 values of K per stage: one
                                      // 32-byte mma k-step per warp
constexpr int kStages = 4;
constexpr int kLdA = kBlockK + 16;  // padded A row: ldmatrix without bank
                                    // conflicts, 16-byte aligned
constexpr int kStageA = kBlockM * kLdA;
constexpr int kStageB = kBlockK * kBlockN;
constexpr int kSmem = kStages * (kStageA + kStageB);
constexpr int kTile = kBlockM * kBlockN;
static_assert(kSmem >= kWarps * kTile * 4, "the reduction reuses the ring");

// c (16x8 int32) += a (16x32 int8, row-major) * b (32x8 int8, col-major).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared row of B's k row r in a stage: rows permuted within each group of
// four, so that rows 4tq + i for tq = 0..3 sit in four distinct 32-byte
// bank groups.
__device__ __forceinline__ int b_slot(int r) {
  return (r & ~3) | ((r & 3) ^ ((r >> 2) & 3));
}

// The 4 x 4 byte transpose: w[i] holds bytes (i, 0..3); afterwards w[j]
// holds bytes (0..3, j).
__device__ __forceinline__ void transpose4x4(uint32_t (&w)[4]) {
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t x1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t y0 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t y1 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(x0, y0, 0x5410);
  w[1] = __byte_perm(x0, y0, 0x7632);
  w[2] = __byte_perm(x1, y1, 0x5410);
  w[3] = __byte_perm(x1, y1, 0x7632);
}

// 16 bytes of `src` from byte `at` on, those at or past `limit` read as 0.
__device__ __forceinline__ uint4 masked16(const int8_t* src, int at,
                                          int limit) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (at + i < limit) {
      w[i >> 2] |= (uint32_t)(uint8_t)src[at + i] << (8 * (i & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct Problem {
  const int8_t* a;
  const int8_t* b;
  int32_t* c;
  int m, n, k, lda, ldb, ldc;
  int k_per_split;  // a multiple of kBlockK
  int accumulate;   // 1: atomicAdd into a zeroed C; 0: plain stores
  int a_vec, b_vec; // rows 16-byte aligned: cp.async is allowed
};

// Stages K bytes k0 .. k0 + kBlockK - 1 of the block's A rows and B
// columns: 2 * kThreads chunks of 16 bytes of each operand.
__device__ __forceinline__ void load_stage(const Problem& p, uint8_t* as,
                                           uint8_t* bs, int m0, int n0,
                                           int k0, int k_end, int tid) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // A: 32 rows x kBlockK / 16 chunks
    const int c = tid + kThreads * j;
    const int r = c / (kBlockK / 16), x = c % (kBlockK / 16);
    const int gm = m0 + r, gk = k0 + 16 * x;
    uint8_t* dst = as + r * kLdA + 16 * x;
    if (gm < p.m && p.a_vec && gk + 16 <= k_end) {
      cp_async16(dst, p.a + (size_t)gm * p.lda + gk);
    } else {
      *reinterpret_cast<uint4*>(dst) =
          gm < p.m ? masked16(p.a + (size_t)gm * p.lda, gk, k_end)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // B: kBlockK k rows x 2 chunks
    const int c = tid + kThreads * j;
    const int r = c >> 1, x = c & 1;
    const int gk = k0 + r, gn = n0 + 16 * x;
    uint8_t* dst = bs + b_slot(r) * kBlockN + 16 * x;
    if (gk < k_end && p.b_vec && gn + 16 <= p.n) {
      cp_async16(dst, p.b + (size_t)gk * p.ldb + gn);
    } else {
      *reinterpret_cast<uint4*>(dst) =
          gk < k_end ? masked16(p.b + (size_t)gk * p.ldb, gn, p.n)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__global__ void __launch_bounds__(kThreads) matmul_i8_kernel(Problem p) {
  extern __shared__ __align__(16) uint8_t smem[];  // kSmem bytes
  uint8_t* a_ring = smem;
  uint8_t* b_ring = smem + kStages * kStageA;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * kBlockM, n0 = blockIdx.x * kBlockN;
  const int k_begin = blockIdx.z * p.k_per_split;
  const int k_end = min(p.k, k_begin + p.k_per_split);
  const int steps =
      k_end > k_begin ? (k_end - k_begin + kBlockK - 1) / kBlockK : 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      load_stage(p, a_ring + s * kStageA, b_ring + s * kStageB, m0, n0,
                 k_begin + s * kBlockK, k_end, tid);
    }
    cp_async_commit();
  }

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    }
  }

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` has landed; stage it-1 is free again
    const int next = it + kStages - 1;
    if (next < steps) {
      const int buf = next % kStages;
      load_stage(p, a_ring + buf * kStageA, b_ring + buf * kStageB, m0, n0,
                 k_begin + next * kBlockK, k_end, tid);
    }
    cp_async_commit();

    const uint8_t* as = a_ring + (it % kStages) * kStageA + warp * 32;
    const uint8_t* bs = b_ring + (it % kStages) * kStageB;
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      ldsm(af[mt], as + (16 * mt + (lane & 15)) * kLdA + (lane >> 4) * 16);
    }
    uint32_t bf[2][4];  // [k half][n-tile]
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp * 32 + kh * 16 + 4 * tq + i;
        bf[kh][i] = *reinterpret_cast<const uint32_t*>(
            bs + b_slot(r) * kBlockN + 4 * g);
      }
      transpose4x4(bf[kh]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_s8(acc[mt][nt], af[mt], bf[0][nt], bf[1][nt]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the partial tiles now

  // The warps' partial tiles, then their sum in red[0 .. kTile).
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // C layout: row g (+8), mma columns 2tq and 2tq+1 of n-tile nt,
        // which stand for columns 4 * (2tq + (e & 1)) + nt.
        const int row = 16 * mt + g + 8 * (e >> 1);
        const int col = 4 * (2 * tq + (e & 1)) + nt;
        red[warp * kTile + row * kBlockN + col] = acc[mt][nt][e];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kTile; e += kThreads) {
    int sum = red[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[w * kTile + e];
    red[e] = sum;
  }

  // Sum over the cluster's blocks (its slices of K) through distributed
  // shared memory; block rank r writes elements [r, r+1) * kTile / size.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int size = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int share = kTile / size;
  for (int e = rank * share + tid; e < (rank + 1) * share; e += kThreads) {
    int sum = 0;
    for (int q = 0; q < size; ++q) sum += cluster.map_shared_rank(red, q)[e];
    const int gm = m0 + e / kBlockN, gn = n0 + e % kBlockN;
    if (gm < p.m && gn < p.n) {
      int32_t* dst = p.c + (size_t)gm * p.ldc + gn;
      if (p.accumulate) {
        atomicAdd(dst, sum);
      } else {
        *dst = sum;
      }
    }
  }
  cluster.sync();  // no block leaves while a peer still reads its tile
}

}  // namespace

// Launches the product on `stream` (a stream of `device`) and returns
// cudaGetLastError() (0 when the launch was accepted), or
// cudaErrorInvalidValue for a plan the kernel does not take. K is cut into
// `splits` slices of whole kBlockK-byte steps, `cluster` (1, 2, 4 or 8, a
// divisor of `splits`) slices to a thread-block cluster. With more slices
// than one cluster holds, the clusters add into C with atomicAdd, and C
// must then hold zeros; otherwise every element is stored once. Does not
// synchronise.
extern "C" int matmul_i8_launch(const void* a, const void* b, void* c, int m,
                                int n, int k, int lda, int ldb, int ldc,
                                int splits, int cluster, int device,
                                void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || splits < 1 || splits > 65535 ||
      !(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) ||
      splits % cluster != 0) {
    return (int)cudaErrorInvalidValue;
  }
  // This library carries its own copy of the CUDA runtime, whose current
  // device is not PyTorch's: select the operands' device for the launch.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int k_steps = (k + kBlockK - 1) / kBlockK;
  const int steps_per_split = k_steps > 0 ? (k_steps + splits - 1) / splits
                                          : 1;
  Problem p;
  p.a = (const int8_t*)a;
  p.b = (const int8_t*)b;
  p.c = (int32_t*)c;
  p.m = m;
  p.n = n;
  p.k = k;
  p.lda = lda;
  p.ldb = ldb;
  p.ldc = ldc;
  p.k_per_split = steps_per_split * kBlockK;
  p.accumulate = splits > cluster ? 1 : 0;
  p.a_vec = aligned16(a) && lda % 16 == 0;
  p.b_vec = aligned16(b) && ldb % 16 == 0;

  if (kSmem > 48 * 1024) {
    err = cudaFuncSetAttribute(matmul_i8_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((n + kBlockN - 1) / kBlockN,
                        (m + kBlockM - 1) / kBlockM, splits);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kSmem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, matmul_i8_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
