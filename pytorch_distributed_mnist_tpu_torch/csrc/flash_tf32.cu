// Flash attention in float32 for Hopper (sm_90a) on the tensor cores: the
// forward, and the backward as a dQ kernel and then a dK/dV kernel. Every
// product runs as three TF32 wgmma (3xTF32) with float32 sums. Bound to
// Python through plain C functions loaded with ctypes.
//
//   forward: s_ij = (q_i * scale) . k_j,  m_i = max_j s_ij
//            O_i = sum_j exp(s_ij - m_i) V_j / l_i,  lse_i = m_i + log l_i
//   dQ:      delta_i = dO_i . O_i
//            P_ij = exp(scale * (q_i . k_j) - lse_i)  (0 if masked)
//            dS_ij = P_ij (dO_i . V_j - delta_i),  dQ_i = scale sum_j dS_ij K_j
//   dK/dV:   dV_j = sum_i P_ij dO_i,  dK_j = scale sum_i dS_ij Q_i
//
// Replaces, for float32 problems at every head dim, the Pallas TPU
// kernels of pytorch_distributed_mnist_tpu/ops/pallas/flash.py:
// _flash_forward (:147, body _fwd_kernel :65) and _flash_backward (:274,
// bodies _dq_kernel :194 and _dkv_kernel :230, delta in XLA :285-290). It
// takes over from flash.cu's CUDA-core kernels, which stay only as routes
// a caller may name.
//
// Why 3xTF32. The float32 route is held to rtol 1e-4 against the plain
// float32 version. A TF32 operand keeps 10 mantissa bits: one TF32 product
// per multiply misses that tolerance many times over. So every operand x is
// split as hi = rna_tf32(x), lo = rna_tf32(x - hi) (round to nearest, ties
// away, as cvt.rna.tf32.f32 rounds), which carries about 21 bits, and each
// product a b is summed as a_lo b_hi + a_hi b_lo + a_hi b_hi, the two small
// products issued first (a_lo b_lo, about 2^-22 of the product, is dropped).
// Products of TF32 values are exact in float32; the sums are float32.
//
// Blocks. A block is one warpgroup (4 warps, 128 threads) working through
// items: an item is a (batch, head) and 64 of its rows (query rows in the
// forward and the dQ kernel, key rows in the dK/dV kernel), 16 per warp.
// The grid is persistent: as many blocks as fit on the card at once, each
// taking every gridDim.x-th item, items (batch, head) by (batch, head). A
// block issues the copies of its next step (this item's next tile, or the
// next item's own rows and first tile) as soon as it has split the current
// one, so that they land while it computes. Every product is one
// wgmma.mma_async m64nNk8 TF32 per k-step of 8 and part (hi or lo), with
// the sums in float32 registers in mma's C layout (a thread holds columns
// 2tq, 2tq + 1 of rows g and g + 8 of its warp's 16).
//
// Copies. Wherever the call's copy width is 16 bytes (the 16-byte path,
// and narrow views such as D = 12 whose pointers and strides are 16-byte
// aligned) the tensor memory accelerator copies each tile: thread 0
// issues one cp.async.bulk.tensor per box of a tensor map that the C
// entry builds for each operand (4D, (D, H, T, B), zeros past D and T),
// and the step's copies complete on an mbarrier. Its boxes are min(DP *
// 4, 128) bytes wide and swizzled (32, 64 or 128 bytes), so that the
// split pass reads them without bank conflicts. Other views copy with
// cp.async in the call's copy width (stage_common.cuh). lse and delta
// rows go by cp.async on both.
//
// Split once, at staging. One cooperative pass splits each element of a
// landed tile once and writes its hi and lo TF32 bit patterns as planes,
// scaling q first in the forward (rounded once, as the reference scales q
// before the product). The products read planes only. A plane is wgmma's
// K-major layout without swizzle: cores of 8 rows by 4 columns, each 128
// contiguous bytes (so a core is read without bank conflicts), the next 4
// columns 128 bytes on (LBO), the next 8 rows 32 K bytes on (SBO, K the
// plane's columns). Chunk c of the split pass, 4 columns of one row, lands
// at word 4c.
//
// Transposed planes. TF32 wgmma takes only K-major operands, so where a
// product sums over the rows of a tile the pass also writes the tile
// transposed: V^T for O += P V, K^T for dQ += dS K, dO^T and Q^T for dV +=
// P^T dO and dK += dS^T Q. P and dS are split in registers as they are
// formed and go to wgmma as its A register operand. The C layout is not
// the A layout: a thread holds columns 2tq, 2tq + 1 of a chunk of 8, where
// A wants tq, tq + 4. So P's C fragment serves as the A fragment of a
// reordered axis (A column tq is key 2tq, column tq + 4 key 2tq + 1), and
// the transposed planes store each group of 8 rows in that order: row r of
// a group at column (r >> 1) + 4 (r & 1). The sum over keys does not depend
// on their order. No shuffle. The transposed stores rotate each thread's
// four elements so that a warp's stores fall on 32 banks.
//
// Per tile, the forward computes S = Q K^T (3 DP/8 wgmma, N = the tile's
// keys), masks it, runs the online softmax in float32 registers (a row's
// max over the 4 lanes of a quad), and adds P V into its 64 x DP sums. The
// dQ kernel computes S and dP = dO V^T, then P and dS = P (dP - delta), and
// adds dS K into dQ; it sums delta = rowsum(dO . O) in float32 from the
// item's staged dO and O rows (from device memory above DP = 16) and
// writes it for the dK/dV kernel. The dK/dV kernel streams query tiles
// with their lse and delta, computing S^T = K Q^T and dP^T = V dO^T so that
// P^T and dS^T come out as the A operand of dV += P^T dO and dK += dS^T Q.
// The register products go by halves (or pairs) of the tile's chunks, each
// split as A fragments just before it, which keeps the fragments live at
// once few. At DP <= 32 (small wgmma) the forward's and the dQ kernel's
// sums are stacked: a chunk's a_hi b_hi and a_hi b_lo are one wgmma of
// twice the width, [b_hi; b_lo] read through one descriptor from the hi
// and lo planes laid out one after the other, and the sum's two halves
// and the a_lo b_hi sum are added at the end (Sums). No atomics: two runs
// give the same bits.
//
// Masks. An 8-column chunk wholly inside T and under the start-aligned
// causal diagonal (qi >= kj) checks no element; only the ragged and the
// diagonal chunks check each element. Key (or query) tiles wholly past the
// diagonal are not loaded. Rows past T are zeros in shared memory and are
// never stored; a row with nothing to attend gives O = 0 and lse = -1e30.
// The exponent is one fused multiply-add and the exp one ex2.approx.ftz.
// Head dims are padded to DP in {8, 16, 32, 64, 128} with zeros, which the
// products sum without a check.
//
// Shared memory. A 64 x DP plane pair (hi and lo) takes 512 DP bytes.
// Streamed tiles: the forward takes KT = 64 keys a tile (32 at DP = 128),
// the dQ kernel 64 (16 at DP = 128), the dK/dV kernel 64 queries at DP <=
// 16, 32 at DP = 32 and 64, 16 at DP = 128. The forward holds Q's planes,
// K's and V^T's, and raw room for q and one key tile; the dQ kernel Q's,
// dO's, K's, K^T's and V's planes; the dK/dV kernel K's, V's, Q's, Q^T's,
// dO's and dO^T's. At DP <= 16 the dQ and dK/dV kernels copy an item's own
// rows (and the dQ kernel its O rows) with its first streamed tile; above,
// one after another through one raw buffer. Bytes per block on the 16-byte
// path (narrow path) at DP = 8, 16, 32, 64, 128: forward 19,464 (22,536),
// 37,896 (40,968), 74,760 (77,832), 148,488 (151,560), 197,640 (199,688);
// dQ 32,776 (37,896), 63,496 (68,616), 100,360 (102,408), 198,664
// (200,712), 215,048 (216,072); dK/dV 34,824 (38,920), 67,592 (71,688),
// 75,272 (76,296), 149,000 (150,024), 230,664 (231,688).
//
// Registers (ptxas -v, sm_90a, nvcc 12.8), forward / dQ / dK/dV, the
// 16-byte path (narrow path), none spilled: DP = 8: 90 (90), 115 (128), 134
// (139); 16: 121 (117), 128 (146), 144 (157); 32: 153 (132), 148 (160), 106
// (117); 64: 109 (117), 126 (127), 159 (168); 128: 122 (128), 121 (124),
// 237 (250).
//
// Operands: q, k and v are (B, T, H, D) float32 views sharing the strides
// (sb, st, sh) with a unit stride along D; O, dO, dQ, dK and dV are
// contiguous (B, T, H, D) float32; lse and delta are contiguous (B, H, T)
// float32. Any T >= 1 and 1 <= D <= 128, every pointer aligned to its
// elements. With D a multiple of 8, every tensor pointer 16-byte aligned
// and every stride a multiple of 4 elements the kernels take their
// 16-byte path; any other view their narrow instantiation, which stores
// exactly D columns in the call's copy width (stage_common.cuh) at the
// same DP (D = 12 pads to 16, D = 4 and 7 to 8), copies as the header's
// Copies say, and sums delta element by element in the same order.
//
// What bounds it on an H100 (3.35 TB/s; 495 TFLOP/s TF32 dense, so 165
// TFLOP/s of float32-accurate products at three TF32 products each): at
// the ViT's shape (B=256, T=49, H=4, D=16) the forward moves 13.0 MB (q, k,
// v in, O and lse out), 0.0039 ms, for 0.157 GFLOP of products, 0.0010 ms:
// bound by bytes. At --patch-size 2 (T = 196) it moves 52.2 MB, 0.0156 ms,
// for 2.52 GFLOP, 0.0153 ms; the backward pair moves 157.4 MB, 0.047 ms,
// for 8.81 GFLOP, 0.053 ms: there the products bound the pair. Each operand
// is read once per kernel from device memory (K and V again per 64-row
// query item, Q and dO per key item, from L2), and S, P, dP and dS never
// leave the chip. The kernels run at about 2.5x to 6x these bounds
// (PERF.md): 64-row tiles pad T = 196 to 256 rows and keys (1.7x the
// work), and a tile's copies, split pass, products and softmax run one
// after another in a block, overlapped only with the other blocks of its
// SM.

#include <cuda.h>  // CUtensorMap (its encoder is looked up at run time)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stage_common.cuh"  // cp_async4, Shape, copy_width, with_dp,
                             // stage_any, store_pair, smem_addr

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // rows a block owns: wgmma's M
constexpr int kPad = 4;        // floats added to each raw row
constexpr int kMaxSmem = 232448;

// Rows of a streamed tile (see the header), and whether the dQ and dK/dV
// kernels copy their own rows and the first streamed tile at once.
__host__ __device__ constexpr int fwd_tile(int dp) {
  return dp == 128 ? 32 : 64;
}
__host__ __device__ constexpr int dq_tile(int dp) {
  return dp == 128 ? 16 : 64;
}
__host__ __device__ constexpr int dkv_tile(int dp) {
  return dp <= 16 ? 64 : dp == 128 ? 16 : 32;
}
__host__ __device__ constexpr bool joint(int dp) { return dp <= 16; }

// Raw rows of the dK/dV kernel: its own k and v rows beside or instead of
// a streamed pair (q and dO) of `tile` rows; of the dQ kernel: its own q,
// dO and O rows beside, or q's or dO's instead of, a pair (k and v).
__host__ __device__ constexpr int raw_rows(int dp, int tile) {
  return joint(dp) ? 2 * kRows + 2 * tile
                   : (2 * tile > kRows ? 2 * tile : kRows);
}
__host__ __device__ constexpr int dq_raw_rows(int dp) {
  return joint(dp) ? raw_rows(dp, dq_tile(dp)) + kRows
                   : raw_rows(dp, dq_tile(dp));
}

// Shared memory of one block (see the header): planes of 32-bit words,
// then raw float rows (raw_ld), then lse and delta rows and the mbarrier,
// and up to 1024 bytes that align the planes.
__host__ __device__ constexpr int raw_ld(int dp, bool narrow) {
  return narrow ? dp + kPad : dp;
}
__host__ __device__ constexpr size_t fwd_smem(int dp, bool narrow) {
  return (size_t)4 * (2 * kRows * dp + 4 * fwd_tile(dp) * dp) +
         (size_t)4 * (kRows + 2 * fwd_tile(dp)) * raw_ld(dp, narrow) + 8 +
         1024;
}
__host__ __device__ constexpr size_t dq_smem(int dp, bool narrow) {
  return (size_t)4 * (4 * kRows * dp + 6 * dq_tile(dp) * dp) +
         (size_t)4 * dq_raw_rows(dp) * raw_ld(dp, narrow) +
         (size_t)4 * 4 * kRows + 8 + 1024;
}
__host__ __device__ constexpr size_t dkv_smem(int dp, bool narrow) {
  return (size_t)4 * (4 * kRows * dp + 8 * dkv_tile(dp) * dp) +
         (size_t)4 * raw_rows(dp, dkv_tile(dp)) * raw_ld(dp, narrow) +
         (size_t)4 * 4 * dkv_tile(dp) + 8 + 1024;
}
static_assert(fwd_smem(128, true) <= kMaxSmem &&
                  dq_smem(128, true) <= kMaxSmem &&
                  dkv_smem(128, true) <= kMaxSmem &&
                  dq_smem(64, true) <= kMaxSmem &&
                  dkv_smem(64, true) <= kMaxSmem,
              "a block's shared memory");

// 2^x in one instruction: the hardware's ex2 (about 2 ulp; a result below
// float32's smallest normal is flushed to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x as hi + lo, each a TF32 value rounded to nearest, ties away from zero:
// the rounding of cvt.rna.tf32.f32, written as integer operations (half a
// unit of the kept last bit added, the 13 dropped bits cleared), which take
// fewer instructions than that conversion compiles to.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// The descriptor of a K-major plane without swizzle (see the header): its
// start, LBO 128 bytes (the next 4 columns), SBO `sbo` bytes (the next 8
// rows), each in units of 16 bytes.
__device__ __forceinline__ uint64_t descriptor(const uint32_t* plane,
                                               int sbo) {
  return (uint64_t)((smem_addr(plane) & 0x3ffffu) >> 4) |
         ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are in flight.
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's shared stores (the planes) before wgmma's reads.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins registers that wgmma reads or writes at this point of the
// program: a read of the sums stays below wgmma_wait, and the A fragments
// and scaled sums are final before wgmma_fence (ptxas serializes the
// wgmma of a batch whose operand registers are written inside it).
template <int NJ>
__device__ __forceinline__ void hold(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}
__device__ __forceinline__ void hold(uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[e])::"memory");
}

// wgmma.mma_async m64nNk8 TF32 with float32 sums: ss takes A and B from
// shared memory (descriptors; `acc` 0 overwrites d), rs A from registers
// (a0 (g, tq), a1 (g + 8, tq), a2 (g, tq + 4), a3 (g + 8, tq + 4) of the
// warp's 16 rows) and adds into d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static __forceinline__ void ss(float (&d)[1][4],
                                            uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3 "
        "}, %4, %5, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
        : "l"(a), "l"(b), "r"(acc));
  }
  __device__ static __forceinline__ void rs(float (&d)[1][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3 "
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void ss(float (&d)[2][4],
                                            uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7 "
        "}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "l"(a), "l"(b), "r"(acc));
  }
  __device__ static __forceinline__ void rs(float (&d)[2][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7 "
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void ss(float (&d)[4][4],
                                            uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15 "
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(a), "l"(b), "r"(acc));
  }
  __device__ static __forceinline__ void rs(float (&d)[4][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15 "
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void ss(float (&d)[8][4],
                                            uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(acc));
  }
  __device__ static __forceinline__ void rs(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void ss(float (&d)[16][4],
                                            uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(acc));
  }
  __device__ static __forceinline__ void rs(float (&d)[16][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// c = A B^T in 3xTF32, A's and B's planes (rows of K columns each) read
// through descriptors: per k-step of 8, a_lo b_hi, a_hi b_lo, a_hi b_hi.
template <int N, int K>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4],
                                        const uint32_t* ahi,
                                        const uint32_t* alo,
                                        const uint32_t* bhi,
                                        const uint32_t* blo) {
  const uint64_t dah = descriptor(ahi, 32 * K), dal = descriptor(alo, 32 * K);
  const uint64_t dbh = descriptor(bhi, 32 * K), dbl = descriptor(blo, 32 * K);
#pragma unroll
  for (int s = 0; s < K / 8; ++s) {
    const uint64_t o = 16 * s;  // 256 bytes: two cores along K
    Wgmma<N>::ss(c, dal + o, dbh + o, s > 0);
    Wgmma<N>::ss(c, dah + o, dbl + o, 1);
    Wgmma<N>::ss(c, dah + o, dbh + o, 1);
  }
}

// The float32 sums of C += A B in 3xTF32, C with N columns. With kStack
// (N <= 32, where a wgmma is small) a chunk's three products are two
// wgmma: hi2 (2N wide) takes a_hi [b_hi; b_lo], one product of twice the
// width, and lo takes a_lo b_hi; C = hi2's two halves + lo (merged). Else
// lo takes all three (hi2 unused).
template <int N, bool kStack>
struct Sums {
  float hi2[kStack ? N / 4 : 1][4];
  float lo[N / 8][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) lo[j][e] = 0.f;
    }
    if constexpr (kStack) {
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) hi2[j][e] = 0.f;
      }
    }
  }
  // Rows g (e = 0, 1) times r0 and g + 8 (e = 2, 3) times r1.
  __device__ __forceinline__ void scale(float r0, float r1) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      lo[j][0] *= r0, lo[j][1] *= r0, lo[j][2] *= r1, lo[j][3] *= r1;
    }
    if constexpr (kStack) {
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        hi2[j][0] *= r0, hi2[j][1] *= r0, hi2[j][2] *= r1, hi2[j][3] *= r1;
      }
    }
  }
  __device__ __forceinline__ void hold() {
    ::hold(lo);
    if constexpr (kStack) ::hold(hi2);
  }
  // Element e of C's chunk j, in mma's C layout (read in place, so that
  // no second copy of the sums is live).
  __device__ __forceinline__ float at(int j, int e) const {
    if constexpr (kStack) return (hi2[j][e] + hi2[j + N / 8][e]) + lo[j][e];
    return lo[j][e];
  }
};

// C += A B in 3xTF32 for chunk j of 8 of the summed axis: A's hi and lo
// fragments in registers (reordered as the header says), B's transposed
// planes (N rows of 8 KC columns each, the lo plane right after the hi
// one, so that one descriptor of 2N rows reads [b_hi; b_lo]).
template <int N, int KC, bool kStack>
__device__ __forceinline__ void mma_ab(Sums<N, kStack>& c,
                                       const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4],
                                       const uint32_t* bhi,
                                       const uint32_t* blo, int j) {
  const uint64_t dbh = descriptor(bhi + 64 * j, 256 * KC);
  if constexpr (kStack) {
    Wgmma<2 * N>::rs(c.hi2, ahi, dbh);
    Wgmma<N>::rs(c.lo, alo, dbh);
  } else {
    const uint64_t dbl = descriptor(blo + 64 * j, 256 * KC);
    Wgmma<N>::rs(c.lo, alo, dbh);
    Wgmma<N>::rs(c.lo, ahi, dbl);
    Wgmma<N>::rs(c.lo, ahi, dbh);
  }
}

// The hi and lo A fragments of one 8-column chunk of a C fragment, its
// columns reordered: a0 (g, 2tq), a1 (g + 8, 2tq), a2 (g, 2tq + 1), a3 (g +
// 8, 2tq + 1).
__device__ __forceinline__ void a_frag(const float (&c)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// out[j] = v[(j + rot) & 3], rot in 0..3, by selects (no local memory).
__device__ __forceinline__ void rotate4(const uint32_t (&v)[4], int rot,
                                        uint32_t (&out)[4]) {
  uint32_t a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = (rot & 1) ? v[(j + 1) & 3] : v[j];
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = (rot & 2) ? a[(j + 2) & 3] : a[j];
}

// The column of row r (of a group of 8) in a transposed plane.
__device__ __forceinline__ int reordered(int r) {
  return (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1);
}

// A raw tile of ROWS x DP floats. cp.async copies it row-major, rows of
// DP + kPad floats. The tensor copies (dense, see the header) write it in
// boxes of SW / 4 columns (SW = min(DP * 4, 128) bytes a box row), box
// after box, each swizzled as CU_TENSOR_MAP_SWIZZLE_<SW>B lays it out:
// 16-byte chunk j of row r at chunk j ^ ((r SW >> 7) & (SW / 16 - 1)) of
// the row, which keeps the split pass's reads (8 rows at a time, one chunk
// each) free of bank conflicts.
__host__ __device__ constexpr int box_bytes(int dp) {
  return dp * 4 < 128 ? dp * 4 : 128;
}

// The offset in floats of chunk x (columns 4x .. 4x + 3) of row r, in
// the tensor copies' layout (dense) or in cp.async's.
template <int DP, int ROWS>
__device__ __forceinline__ int raw_at(int r, int x, bool dense) {
  if (!dense) return r * (DP + kPad) + 4 * x;
  constexpr int SW = box_bytes(DP), CB = SW / 16;  // 16-byte chunks a row
  const int b = x / CB, j = x % CB;
  return b * ROWS * (SW / 4) + r * (SW / 4) +
         4 * (j ^ ((r * SW >> 7) & (CB - 1)));
}

// One split pass over a raw tile (ROWS x DP floats, as raw_at lays it
// out): with kNat its hi and lo planes (ROWS x DP), chunk c (row (c & 7)
// + 8 ((c >> 3) / (DP / 4)), columns 4 ((c >> 3) % (DP / 4))) at word 4c;
// with kT its transposed planes (DP x ROWS, rows reordered). With kScale
// each element is first multiplied by `scale`, rounded once.
template <int DP, int ROWS, bool kNat, bool kT, bool kScale = false>
__device__ __forceinline__ void split_tile(const float* raw, bool dense,
                                           uint32_t* hi, uint32_t* lo,
                                           uint32_t* thi, uint32_t* tlo,
                                           float scale = 1.f) {
  constexpr int CPR = DP / 4, CHUNKS = ROWS * CPR;
  // A thread's chunks, read in batches of up to 4 before any is split.
  constexpr int PER = (CHUNKS + kThreads - 1) / kThreads;
  constexpr int BATCH = PER < 4 ? PER : 4;
#pragma unroll 1
  for (int i0 = 0; i0 < PER; i0 += BATCH) {
    float4 v[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int c = threadIdx.x + (i0 + i) * kThreads;
      const int r = (c & 7) + 8 * ((c >> 3) / CPR), x = (c >> 3) % CPR;
      if (CHUNKS % kThreads == 0 || c < CHUNKS) {
        v[i] = *reinterpret_cast<const float4*>(
            raw + raw_at<DP, ROWS>(r, x, dense));
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int c = threadIdx.x + (i0 + i) * kThreads;
      if (CHUNKS % kThreads != 0 && c >= CHUNKS) continue;
      const int r = (c & 7) + 8 * ((c >> 3) / CPR), x = (c >> 3) % CPR;
      float f[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kScale) f[e] = __fmul_rn(f[e], scale);
        split(f[e], h[e], l[e]);
      }
      if constexpr (kNat) {
        *reinterpret_cast<uint4*>(hi + 4 * c) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + 4 * c) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
      if constexpr (kT) {
        // Element e (head dim d = 4x + e) at word `at + 4e`, on bank 16 (x &
        // 1) + 4e + (p & 3): 8 banks for a warp's 32 chunks. So the warp's
        // j-th store takes element (j + rot) & 3, rot from bits 0 and 4 of
        // c, which puts its 32 stores on 32 banks.
        const int p = reordered(r);
        const int at = ((x >> 1) * (ROWS / 4) + (p >> 2)) * 32 +
                       (x & 1) * 16 + (p & 3);
        const int rot = (c & 1) | ((c >> 3) & 2);
        uint32_t hr[4], lr[4];
        rotate4(h, rot, hr);
        rotate4(l, rot, lr);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = (j + rot) & 3;
          thi[at + 4 * e] = hr[j];
          tlo[at + 4 * e] = lr[j];
        }
      }
    }
  }
}

// The mbarrier on which a step's tensor copies complete.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Thread 0 announces the bytes of the step's tensor copies (one arrival).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Copies rows r0 .. r0 + ROWS - 1 of one (batch, head) of a float32 (B, T,
// H, D) tensor with element strides (sb, st, sh, 1) into `dst` (raw_at's
// layout), zeros past T and past D. With dense, thread 0 asks the tensor
// memory accelerator for DP / (SW / 4) boxes of the tensor's map
// (tensor_map), completing on `bar` (ROWS DP 4 bytes; the step's
// mbar_expect counts them); else every thread copies chunks of the call's
// copy width with cp.async.
template <int DP, int ROWS>
__device__ __forceinline__ void stage(float* dst, const CUtensorMap* map,
                                      const float* src, long long sb,
                                      long long st, long long sh,
                                      const Shape& s, int bi, int hi, int r0,
                                      uint64_t* bar, bool dense) {
  if (!dense) {
    stage_any<DP, DP + kPad>(dst, src, sb, st, sh, s, bi, hi, r0, ROWS,
                             kThreads);
  } else if (threadIdx.x == 0) {
    constexpr int BC = box_bytes(DP) / 4;  // columns of a box
#pragma unroll
    for (int b = 0; b < DP / BC; ++b) {
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
              smem_addr(dst + b * ROWS * BC)),
          "l"(reinterpret_cast<uint64_t>(map)), "r"(b * BC), "r"(hi),
          "r"(r0), "r"(bi),
          "r"(smem_addr(bar))
          : "memory");
    }
  }
}

// Where a step's copies complete: its cp.async groups (the narrow path's
// tiles, and the lse and delta rows on both paths) and, on the 16-byte
// path, its tensor copies on an mbarrier whose phase flips each step.
// Built by every thread of the block at once.
struct Arrivals {
  uint64_t* bar;
  bool tensor;  // the tiles come by tensor copies
  int phase = 0;

  __device__ Arrivals(uint64_t* b, bool t) : bar(b), tensor(t) {
    if (tensor && threadIdx.x == 0) mbar_init(bar);
    __syncthreads();
  }
  // Thread 0 announces a step's tensor copies, before it issues them.
  __device__ __forceinline__ void expect(int bytes) {
    if (tensor && threadIdx.x == 0) mbar_expect(bar, (uint32_t)bytes);
  }
  __device__ __forceinline__ void wait() {
    cp_async_wait<0>();
    if (tensor) {
      mbar_wait(bar, phase);
      phase ^= 1;
    }
  }
};

// The first 1024-byte boundary of dynamic shared memory (a swizzled
// tensor copy's destination repeats its pattern every 1024 bytes).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// Copies `rows` rows from r0 of one (batch, head) of a (B, H, T) float32
// statistic into `dst`, zeros past T.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           const Shape& s, int bh, int r0,
                                           int rows) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    if (r0 + r < s.t) {
      cp_async4(dst + r, src + (long long)bh * s.t + r0 + r);
    } else {
      dst[r] = 0.f;
    }
  }
}

// Writes a 64 x DP sum (mma's C layout, the warp's 16 rows from row0)
// times `scale` as rows of a contiguous (B, T, H, D) float32 tensor; rows
// >= T and columns >= D are dropped. The 16-byte path (D a multiple of 8)
// stores whole 8-column chunks as float2 pairs; the narrow one (kNarrow)
// exactly D columns (store_pair).
template <int DP, bool kNarrow, bool kStack>
__device__ __forceinline__ void store_rows(float* out,
                                           const Sums<DP, kStack>& acc,
                                           const Shape& s, int bi, int hi,
                                           int row0, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    if (8 * j >= s.d) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (row >= s.t) continue;
      if constexpr (kNarrow) {
        store_pair(out + (((long long)bi * s.t + row) * s.h + hi) * s.d,
                   8 * j + 2 * tq, s, __fmul_rn(scale, acc.at(j, 2 * half)),
                   __fmul_rn(scale, acc.at(j, 2 * half + 1)));
      } else {
        const long long at =
            (((long long)bi * s.t + row) * s.h + hi) * s.d + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(out + at) =
            make_float2(__fmul_rn(scale, acc.at(j, 2 * half)),
                        __fmul_rn(scale, acc.at(j, 2 * half + 1)));
      }
    }
  }
}

// An item (see the header): a (batch, head) and its 64 rows from r0.
struct Item {
  int bi, hi, bh, r0;
};

__device__ __forceinline__ Item item_of(const Shape& s, int item) {
  const int blocks = (s.t + kRows - 1) / kRows;
  const int bh = item / blocks;
  return {bh / s.h, bh % s.h, bh, (item % blocks) * kRows};
}

__device__ __forceinline__ int items_of(const Shape& s) {
  return s.b * s.h * ((s.t + kRows - 1) / kRows);
}

template <int DP, bool kNarrow>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Shape s, float scale,
                      int causal) {
  constexpr int KT = fwd_tile(DP);
  // Tensor copies on the 16-byte path and wherever the call's copy width
  // is 16 bytes (a D that is not a multiple of 8); cp.async elsewhere.
  const bool dense = !kNarrow || s.w == 16;
  const int LD = dense ? DP : DP + kPad;  // raw floats a row
  extern __shared__ __align__(128) unsigned char smem_in[];
  unsigned char* smem = align1024(smem_in);
  uint32_t* qh = reinterpret_cast<uint32_t*>(smem);
  uint32_t* ql = qh + kRows * DP;
  uint32_t* kh = ql + kRows * DP;
  uint32_t* kl = kh + KT * DP;
  uint32_t* vth = kl + KT * DP;  // V^T: DP rows of KT keys
  uint32_t* vtl = vth + KT * DP;
  float* qraw = reinterpret_cast<float*>(vtl + KT * DP);
  float* kraw = qraw + kRows * LD;
  float* vraw = kraw + KT * LD;
  uint64_t* bar = reinterpret_cast<uint64_t*>(vraw + KT * LD);
  Arrivals arrivals(bar, dense);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int items = items_of(s);
  auto stage_q = [&](const Item& w) {
    stage<DP, kRows>(qraw, &map_q, q, s.sb, s.st, s.sh, s, w.bi, w.hi, w.r0,
                     bar, dense);
  };
  auto stage_keys = [&](const Item& w, int tile) {
    stage<DP, KT>(kraw, &map_k, k, s.sb, s.st, s.sh, s, w.bi, w.hi, tile * KT,
                  bar, dense);
    stage<DP, KT>(vraw, &map_v, v, s.sb, s.st, s.sh, s, w.bi, w.hi, tile * KT,
                  bar, dense);
  };
  // The first item's q and first key tile.
  arrivals.expect((kRows + 2 * KT) * DP * 4);
  stage_q(item_of(s, blockIdx.x));
  stage_keys(item_of(s, blockIdx.x), 0);
  cp_async_commit();

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item cur = item_of(s, item);
    const int wq0 = cur.r0 + warp * 16;  // this warp's first query row
    // Under the causal mask no row of an item sees a key past its last.
    const int kend = causal ? min(s.t, cur.r0 + kRows) : s.t;
    const int ntiles = (kend + KT - 1) / KT;
    constexpr bool kStack = DP <= 32;
    Sums<DP, kStack> acc;  // O's sums
    acc.zero();
    // Row g and row g + 8 of the warp's 16: running max, and this lane's
    // share of the running sum (the quad's four shares are added at the
    // end).
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    for (int tile = 0; tile < ntiles; ++tile) {
      arrivals.wait();
      __syncthreads();  // this step's tiles have landed; the planes are free
      if (tile == 0) {  // q * scale, rounded once, as the reference has it
        split_tile<DP, kRows, true, false, true>(qraw, dense, qh, ql,
                                                          nullptr, nullptr,
                                                          scale);
      }
      split_tile<DP, KT, true, false>(kraw, dense, kh, kl, nullptr,
                                               nullptr);
      split_tile<DP, KT, false, true>(vraw, dense, nullptr, nullptr, vth,
                                               vtl);
      proxy_fence();
      __syncthreads();
      // The raw buffers are free: the next step's copies, this item's next
      // key tile or the next item's q and first key tile.
      if (tile + 1 < ntiles) {
        arrivals.expect(2 * KT * DP * 4);
        stage_keys(cur, tile + 1);
      } else if (item + gridDim.x < items) {
        const Item next = item_of(s, item + gridDim.x);
        arrivals.expect((kRows + 2 * KT) * DP * 4);
        stage_q(next);
        stage_keys(next, 0);
      }
      cp_async_commit();

      const int k0 = tile * KT;
      float sc[KT / 8][4];
      wgmma_fence();
      mma_abt<KT, DP>(sc, qh, ql, kh, kl);
      wgmma_commit();
      wgmma_wait();
      hold(sc);
      // Mask; the tile's row max. Element e of chunk n is row g + 8 (e >>
      // 1) of the warp, key k0 + 8n + 2tq + (e & 1).
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        const int kb = k0 + 8 * n;
        const bool full = kb + 8 <= s.t && (!causal || kb + 7 <= wq0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!full) {
            const int kj = kb + 2 * tq + (e & 1);
            const int qi = wq0 + g + 8 * (e >> 1);
            if (kj >= s.t || (causal && qi < kj)) sc[n][e] = kNegInf;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
        }
      }
      float ml2[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // 0 while nothing was kept: l and acc are still 0 then.
        corr[r] = fast_exp2((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        ml2[r] = mx[r] * kLog2e;
        l[r] *= corr[r];
      }
      acc.scale(corr[0], corr[1]);
      // P = exp(s - m), masked scores (-1e30) giving 0; every row has a
      // kept key in the first tile, so m is finite from there on.
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = fast_exp2(fmaf(sc[n][e], kLog2e, -ml2[e >> 1]));
          l[e >> 1] += sc[n][e];
        }
      }
      // O += P V in two halves of the key chunks, P split as A fragments
      // half by half, so that one half's fragments are live at a time.
      constexpr int KC = KT / 8;
#pragma unroll
      for (int j0 = 0; j0 < KC; j0 += KC / 2) {
        uint32_t ph[KC / 2][4], pl[KC / 2][4];
#pragma unroll
        for (int n = 0; n < KC / 2; ++n) {
          a_frag(sc[j0 + n], ph[n], pl[n]);
          hold(ph[n]);
          hold(pl[n]);
        }
        acc.hold();
        wgmma_fence();
#pragma unroll
        for (int n = 0; n < KC / 2; ++n) {
          mma_ab<DP, KC, kStack>(acc, ph[n], pl[n], vth, vtl, j0 + n);
        }
        wgmma_commit();
        wgmma_wait();
        acc.hold();
      }
    }

    // O and lse of the item's rows.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wq0 + g + 8 * half;
      if (row >= s.t) continue;
      const float denom = fmaxf(l[half], 1e-30f), inv = 1.f / denom;
      float* out = o + (((long long)cur.bi * s.t + row) * s.h + cur.hi) * s.d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if (8 * j >= s.d) break;
        const float x0 = acc.at(j, 2 * half) * inv;
        const float x1 = acc.at(j, 2 * half + 1) * inv;
        if constexpr (kNarrow) {
          store_pair(out, 8 * j + 2 * tq, s, x0, x1);
        } else {
          *reinterpret_cast<float2*>(out + 8 * j + 2 * tq) =
              make_float2(x0, x1);
        }
      }
      if (tq == 0) {
        lse[(long long)cur.bh * s.t + row] =
            l[half] > 0.f ? m[half] + logf(denom) : kNegInf;
      }
    }
  }
}

// delta = rowsum(dO * O) of one row in float32, in the order of D, from
// device memory (unrolled to DP, so that every load is in flight at once).
template <int DP, bool kNarrow>
__device__ __forceinline__ float row_delta(const float* dorow,
                                           const float* orow, int d) {
  float sum = 0.f;
  if constexpr (kNarrow) {  // one element at a time
#pragma unroll
    for (int x = 0; x < DP; ++x) {
      if (x < d) {
        sum = __fadd_rn(sum, __fmul_rn(__ldg(dorow + x), __ldg(orow + x)));
      }
    }
  } else {
#pragma unroll
    for (int x = 0; x < DP / 4; ++x) {
      if (4 * x < d) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(dorow) + x);
        const float4 b = __ldg(reinterpret_cast<const float4*>(orow) + x);
        sum = __fadd_rn(sum, __fmul_rn(a.x, b.x));
        sum = __fadd_rn(sum, __fmul_rn(a.y, b.y));
        sum = __fadd_rn(sum, __fmul_rn(a.z, b.z));
        sum = __fadd_rn(sum, __fmul_rn(a.w, b.w));
      }
    }
  }
  return sum;
}

// The same sum, in the same order, from row r of the staged raw tiles of
// dO and O (64 rows, raw_at's layout).
template <int DP>
__device__ __forceinline__ float staged_delta(const float* doraw,
                                              const float* oraw, int r,
                                              int d, bool dense) {
  float sum = 0.f;
#pragma unroll
  for (int x = 0; x < DP / 4; ++x) {
    const int at = raw_at<DP, kRows>(r, x, dense);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * x + e < d) {
        sum = __fadd_rn(sum, __fmul_rn(doraw[at + e], oraw[at + e]));
      }
    }
  }
  return sum;
}

template <int DP, bool kNarrow>
__global__ void __launch_bounds__(kThreads)
flash_dq_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o,
                     const __grid_constant__ CUtensorMap map_do,
                     const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     float* __restrict__ delta, float* __restrict__ dq,
                     Shape s, float scale, int causal) {
  constexpr int KT = dq_tile(DP);
  // Tensor copies on the 16-byte path and wherever the call's copy width
  // is 16 bytes (a D that is not a multiple of 8); cp.async elsewhere.
  const bool dense = !kNarrow || s.w == 16;
  const int LD = dense ? DP : DP + kPad;  // raw floats a row
  constexpr bool kJoint = joint(DP);
  extern __shared__ __align__(128) unsigned char smem_in[];
  unsigned char* smem = align1024(smem_in);
  uint32_t* qh = reinterpret_cast<uint32_t*>(smem);
  uint32_t* ql = qh + kRows * DP;
  uint32_t* doh = ql + kRows * DP;
  uint32_t* dol = doh + kRows * DP;
  uint32_t* kh = dol + kRows * DP;
  uint32_t* kl = kh + KT * DP;
  uint32_t* kth = kl + KT * DP;  // K^T: DP rows of KT keys
  uint32_t* ktl = kth + KT * DP;
  uint32_t* vh = ktl + KT * DP;
  uint32_t* vl = vh + KT * DP;
  float* raw = reinterpret_cast<float*>(vl + KT * DP);
  float* lse_s = raw + dq_raw_rows(DP) * LD;  // two of kRows
  float* delta_s = lse_s + 2 * kRows;         // two of kRows
  uint64_t* bar = reinterpret_cast<uint64_t*>(delta_s + 2 * kRows);
  Arrivals arrivals(bar, dense);
  // q's, dO's and O's raw rows, then K's and V's (after them, or in their
  // place).
  float* qraw = raw;
  float* doraw = raw + (kJoint ? kRows * LD : 0);
  float* oraw = raw + 2 * kRows * LD;  // kJoint only
  float* kraw = raw + (kJoint ? 3 * kRows * LD : 0);
  float* vraw = kraw + KT * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long long dsb = (long long)s.t * s.h * s.d, dst = (long long)s.h * s.d;
  const float sl2 = scale * kLog2e;
  const int items = items_of(s);
  auto stage_keys = [&](const Item& w, int tile) {
    stage<DP, KT>(kraw, &map_k, k, s.sb, s.st, s.sh, s, w.bi, w.hi, tile * KT,
                  bar, dense);
    stage<DP, KT>(vraw, &map_v, v, s.sb, s.st, s.sh, s, w.bi, w.hi, tile * KT,
                  bar, dense);
  };
  auto stage_q = [&](const Item& w) {
    stage<DP, kRows>(qraw, &map_q, q, s.sb, s.st, s.sh, s, w.bi, w.hi, w.r0,
                     bar, dense);
  };
  auto stage_do = [&](const Item& w) {
    stage<DP, kRows>(doraw, &map_do, dout, dsb, dst, s.d, s, w.bi, w.hi, w.r0,
                     bar, dense);
  };
  // An item's own rows (kJoint): q, dO, O and lse, and its first key tile.
  auto stage_rows_of = [&](const Item& w, int buf) {
    arrivals.expect((3 * kRows + 2 * KT) * DP * 4);
    stage_q(w);
    stage_do(w);
    stage<DP, kRows>(oraw, &map_o, o, dsb, dst, s.d, s, w.bi, w.hi, w.r0, bar,
                     dense);
    stage_rows(lse_s + buf * kRows, lse, s, w.bh, w.r0, kRows);
    stage_keys(w, 0);
  };
  if constexpr (kJoint) {
    stage_rows_of(item_of(s, blockIdx.x), 0);
    cp_async_commit();
  }

  // step: this block's items so far (the parity of its lse and delta rows)
  for (int item = blockIdx.x, step = 0; item < items;
       item += gridDim.x, ++step) {
    const Item cur = item_of(s, item);
    const int buf = step & 1;
    const int wq0 = cur.r0 + warp * 16;  // this warp's first query row
    const int kend = causal ? min(s.t, cur.r0 + kRows) : s.t;
    const int ntiles = (kend + KT - 1) / KT;
    // The item's rows: q and dO split, delta written for the dK/dV
    // kernel, and its first key tile landed.
    if constexpr (kJoint) {
      arrivals.wait();
      __syncthreads();
      split_tile<DP, kRows, true, false>(qraw, dense, qh, ql, nullptr,
                                                  nullptr);
      split_tile<DP, kRows, true, false>(doraw, dense, doh, dol, nullptr,
                                                  nullptr);
      // delta from the staged rows.
      if (threadIdx.x < kRows) {
        const int row = cur.r0 + threadIdx.x;
        float sum = 0.f;
        if (row < s.t) {
          sum = staged_delta<DP>(doraw, oraw, threadIdx.x, s.d,
                                      dense);
          delta[(long long)cur.bh * s.t + row] = sum;
        }
        delta_s[buf * kRows + threadIdx.x] = sum;
      }
    } else {  // q, then dO, then the first key tile, through one buffer
      __syncthreads();  // the previous item is done with the planes
      arrivals.expect(kRows * DP * 4);
      stage_q(cur);
      stage_rows(lse_s + buf * kRows, lse, s, cur.bh, cur.r0, kRows);
      cp_async_commit();
      // delta from device memory while the copies are in flight.
      if (threadIdx.x < kRows) {
        const int row = cur.r0 + threadIdx.x;
        float sum = 0.f;
        if (row < s.t) {
          const long long at = (long long)cur.bi * dsb + (long long)row * dst +
                               (long long)cur.hi * s.d;
          sum = row_delta<DP, kNarrow>(dout + at, o + at, s.d);
          delta[(long long)cur.bh * s.t + row] = sum;
        }
        delta_s[buf * kRows + threadIdx.x] = sum;
      }
      arrivals.wait();
      __syncthreads();
      split_tile<DP, kRows, true, false>(qraw, dense, qh, ql, nullptr,
                                                  nullptr);
      __syncthreads();
      arrivals.expect(kRows * DP * 4);
      stage_do(cur);
      cp_async_commit();
      arrivals.wait();
      __syncthreads();
      split_tile<DP, kRows, true, false>(doraw, dense, doh, dol, nullptr,
                                                  nullptr);
      __syncthreads();
      arrivals.expect(2 * KT * DP * 4);
      stage_keys(cur, 0);
      cp_async_commit();
      arrivals.wait();
      __syncthreads();
    }

    constexpr bool kStack = DP <= 32;
    Sums<DP, kStack> dqs;  // dQ's sums
    dqs.zero();
    float l2[2], dl[2];  // lse * log2 e and delta of rows g and g + 8
    for (int tile = 0; tile < ntiles; ++tile) {
      if (tile > 0) {
        arrivals.wait();
        __syncthreads();  // the tile has landed; the planes are free
      }
      split_tile<DP, KT, true, true>(kraw, dense, kh, kl, kth, ktl);
      split_tile<DP, KT, true, false>(vraw, dense, vh, vl, nullptr,
                                               nullptr);
      proxy_fence();
      __syncthreads();
      if (tile == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l2[r] = lse_s[buf * kRows + warp * 16 + g + 8 * r] * kLog2e;
          dl[r] = delta_s[buf * kRows + warp * 16 + g + 8 * r];
        }
      }
      // The raw buffers are free: the next step's copies (the next item's
      // rows only where they have buffers of their own).
      if (tile + 1 < ntiles) {
        arrivals.expect(2 * KT * DP * 4);
        stage_keys(cur, tile + 1);
      } else if (kJoint && item + gridDim.x < items) {
        stage_rows_of(item_of(s, item + gridDim.x), buf ^ 1);
      }
      cp_async_commit();

      const int k0 = tile * KT;
      float sc[KT / 8][4], dp[KT / 8][4];
      wgmma_fence();
      mma_abt<KT, DP>(sc, qh, ql, kh, kl);
      mma_abt<KT, DP>(dp, doh, dol, vh, vl);
      wgmma_commit();
      wgmma_wait();
      hold(sc);
      hold(dp);
      // dS = P (dP - delta). Element e of chunk n: query wq0 + g + 8 (e >>
      // 1), key k0 + 8n + 2tq + (e & 1).
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        const int kb = k0 + 8 * n;
        const bool full = kb + 8 <= s.t && (!causal || kb + 7 <= wq0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(sc[n][e], sl2, -l2[e >> 1]));
          if (!full) {
            const int kj = kb + 2 * tq + (e & 1);
            const int qi = wq0 + g + 8 * (e >> 1);
            if (kj >= s.t || (causal && qi < kj)) p = 0.f;
          }
          dp[n][e] = p * (dp[n][e] - dl[e >> 1]);
        }
      }
      // dQ += dS K in two halves of the key chunks, as the forward's P V.
      constexpr int KC = KT / 8;
#pragma unroll
      for (int j0 = 0; j0 < KC; j0 += KC / 2) {
        uint32_t dsh[KC / 2][4], dsl[KC / 2][4];
#pragma unroll
        for (int n = 0; n < KC / 2; ++n) {
          a_frag(dp[j0 + n], dsh[n], dsl[n]);
          hold(dsh[n]);
          hold(dsl[n]);
        }
        wgmma_fence();
#pragma unroll
        for (int n = 0; n < KC / 2; ++n) {
          mma_ab<DP, KC, kStack>(dqs, dsh[n], dsl[n], kth, ktl, j0 + n);
        }
        wgmma_commit();
        wgmma_wait();
        dqs.hold();
      }
    }
    store_rows<DP, kNarrow>(dq, dqs, s, cur.bi, cur.hi, wq0, scale);
  }
}

template <int DP, bool kNarrow>
__global__ void __launch_bounds__(kThreads)
flash_dkv_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      Shape s, float scale, int causal) {
  constexpr int QT = dkv_tile(DP);
  // Tensor copies on the 16-byte path and wherever the call's copy width
  // is 16 bytes (a D that is not a multiple of 8); cp.async elsewhere.
  const bool dense = !kNarrow || s.w == 16;
  const int LD = dense ? DP : DP + kPad;  // raw floats a row
  constexpr bool kJoint = joint(DP);
  extern __shared__ __align__(128) unsigned char smem_in[];
  unsigned char* smem = align1024(smem_in);
  uint32_t* kh = reinterpret_cast<uint32_t*>(smem);
  uint32_t* kl = kh + kRows * DP;
  uint32_t* vh = kl + kRows * DP;
  uint32_t* vl = vh + kRows * DP;
  uint32_t* qh = vl + kRows * DP;
  uint32_t* ql = qh + QT * DP;
  uint32_t* qth = ql + QT * DP;  // Q^T: DP rows of QT queries
  uint32_t* qtl = qth + QT * DP;
  uint32_t* doh = qtl + QT * DP;
  uint32_t* dol = doh + QT * DP;
  uint32_t* doth = dol + QT * DP;  // dO^T
  uint32_t* dotl = doth + QT * DP;
  float* raw = reinterpret_cast<float*>(dotl + QT * DP);
  float* lse_s = raw + raw_rows(DP, QT) * LD;  // two of QT
  float* delta_s = lse_s + 2 * QT;             // two of QT
  uint64_t* bar = reinterpret_cast<uint64_t*>(delta_s + 2 * QT);
  Arrivals arrivals(bar, dense);
  // k's and v's raw rows, then Q's and dO's (after them, or in their place).
  float* kraw = raw;
  float* vraw = raw + (kJoint ? kRows * LD : 0);
  float* qraw = raw + (kJoint ? 2 * kRows * LD : 0);
  float* doraw = qraw + QT * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long long dsb = (long long)s.t * s.h * s.d, dst = (long long)s.h * s.d;
  const float sl2 = scale * kLog2e;
  const int items = items_of(s);
  const int ntiles = (s.t + QT - 1) / QT;
  // Under the causal mask no query before an item's first key sees it.
  auto first_of = [&](const Item& w) { return causal ? w.r0 / QT : 0; };
  auto stage_queries = [&](const Item& w, int tile, int buf) {
    const int r0 = tile * QT;
    stage<DP, QT>(qraw, &map_q, q, s.sb, s.st, s.sh, s, w.bi, w.hi, r0, bar,
                  dense);
    stage<DP, QT>(doraw, &map_do, dout, dsb, dst, s.d, s, w.bi, w.hi, r0, bar,
                  dense);
    stage_rows(lse_s + buf * QT, lse, s, w.bh, r0, QT);
    stage_rows(delta_s + buf * QT, delta, s, w.bh, r0, QT);
  };
  auto stage_k = [&](const Item& w) {
    stage<DP, kRows>(kraw, &map_k, k, s.sb, s.st, s.sh, s, w.bi, w.hi, w.r0,
                     bar, dense);
  };
  auto stage_v = [&](const Item& w) {
    stage<DP, kRows>(vraw, &map_v, v, s.sb, s.st, s.sh, s, w.bi, w.hi, w.r0,
                     bar, dense);
  };
  // An item's own rows (kJoint): k and v, and its first query tile.
  auto stage_rows_of = [&](const Item& w, int buf) {
    arrivals.expect((2 * kRows + 2 * QT) * DP * 4);
    stage_k(w);
    stage_v(w);
    stage_queries(w, first_of(w), buf);
  };
  if constexpr (kJoint) {
    stage_rows_of(item_of(s, blockIdx.x), 0);
    cp_async_commit();
  }

  // step: this block's query tiles so far (the parity of its lse and
  // delta rows)
  int step = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item cur = item_of(s, item);
    const int wk0 = cur.r0 + warp * 16;  // this warp's first key row
    const int first = first_of(cur);
    // The item's rows: k and v split, and its first query tile landed.
    if constexpr (kJoint) {
      arrivals.wait();
      __syncthreads();
      split_tile<DP, kRows, true, false>(kraw, dense, kh, kl, nullptr,
                                                  nullptr);
      split_tile<DP, kRows, true, false>(vraw, dense, vh, vl, nullptr,
                                                  nullptr);
    } else {  // k, then v, then the first query tile, through one buffer
      __syncthreads();  // the previous item is done with the planes
      arrivals.expect(kRows * DP * 4);
      stage_k(cur);
      cp_async_commit();
      arrivals.wait();
      __syncthreads();
      split_tile<DP, kRows, true, false>(kraw, dense, kh, kl, nullptr,
                                                  nullptr);
      __syncthreads();
      arrivals.expect(kRows * DP * 4);
      stage_v(cur);
      cp_async_commit();
      arrivals.wait();
      __syncthreads();
      split_tile<DP, kRows, true, false>(vraw, dense, vh, vl, nullptr,
                                                  nullptr);
      __syncthreads();
      arrivals.expect(2 * QT * DP * 4);
      stage_queries(cur, first, step & 1);
      cp_async_commit();
      arrivals.wait();
      __syncthreads();
    }

    constexpr bool kStack = false;  // four stacked sums: too many registers
    Sums<DP, kStack> dks, dvs;      // dK's and dV's sums
    dks.zero();
    dvs.zero();
    for (int tile = first; tile < ntiles; ++tile, ++step) {
      const int buf = step & 1;
      if (tile > first) {
        arrivals.wait();
        __syncthreads();  // the tile has landed; the planes are free
      }
      split_tile<DP, QT, true, true>(qraw, dense, qh, ql, qth, qtl);
      split_tile<DP, QT, true, true>(doraw, dense, doh, dol, doth, dotl);
      proxy_fence();
      __syncthreads();
      // The raw buffers are free: the next step's copies (the next item's
      // rows only where they have buffers of their own).
      if (tile + 1 < ntiles) {
        arrivals.expect(2 * QT * DP * 4);
        stage_queries(cur, tile + 1, buf ^ 1);
      } else if (kJoint && item + gridDim.x < items) {
        stage_rows_of(item_of(s, item + gridDim.x), buf ^ 1);
      }
      cp_async_commit();

      const int qb0 = tile * QT;  // the tile's first query
      const float* lse_t = lse_s + buf * QT;
      const float* delta_t = delta_s + buf * QT;
      float st[QT / 8][4], dpt[QT / 8][4];
      wgmma_fence();
      mma_abt<QT, DP>(st, kh, kl, qh, ql);
      mma_abt<QT, DP>(dpt, vh, vl, doh, dol);
      wgmma_commit();
      wgmma_wait();
      hold(st);
      hold(dpt);
      // P^T into st and dS^T into dpt. Element e of chunk n: key wk0 + g +
      // 8 (e >> 1), query qb0 + 8n + 2tq + (e & 1).
#pragma unroll
      for (int n = 0; n < QT / 8; ++n) {
        const int qb = qb0 + 8 * n;
        const bool full = qb + 8 <= s.t && (!causal || qb >= wk0 + 15);
        const float2 lq =
            *reinterpret_cast<const float2*>(lse_t + 8 * n + 2 * tq);
        const float2 dq2 =
            *reinterpret_cast<const float2*>(delta_t + 8 * n + 2 * tq);
        const float l2[2] = {lq.x * kLog2e, lq.y * kLog2e};
        const float dl[2] = {dq2.x, dq2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(st[n][e], sl2, -l2[e & 1]));
          if (!full) {
            const int qi = qb + 2 * tq + (e & 1);
            const int kj = wk0 + g + 8 * (e >> 1);
            if (qi >= s.t || (causal && qi < kj)) p = 0.f;
          }
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dl[e & 1]);
        }
      }
      // dV += P^T dO and dK += dS^T Q by pairs of query chunks, P^T and
      // dS^T split as A fragments pair by pair, the two products in turn.
      constexpr int KC = QT / 8, G = KC >= 4 ? 2 : 1;
#pragma unroll
      for (int j0 = 0; j0 < KC; j0 += G) {
        uint32_t pth[G][4], ptl[G][4], dsh[G][4], dsl[G][4];
#pragma unroll
        for (int n = 0; n < G; ++n) {
          a_frag(st[j0 + n], pth[n], ptl[n]);
          a_frag(dpt[j0 + n], dsh[n], dsl[n]);
          hold(pth[n]);
          hold(ptl[n]);
          hold(dsh[n]);
          hold(dsl[n]);
        }
        wgmma_fence();
#pragma unroll
        for (int n = 0; n < G; ++n) {
          mma_ab<DP, KC, kStack>(dvs, pth[n], ptl[n], doth, dotl, j0 + n);
          mma_ab<DP, KC, kStack>(dks, dsh[n], dsl[n], qth, qtl, j0 + n);
        }
        wgmma_commit();
        wgmma_wait();
        dvs.hold();
        dks.hold();
      }
    }
    store_rows<DP, kNarrow>(dk, dks, s, cur.bi, cur.hi, wk0, scale);
    store_rows<DP, kNarrow>(dv, dvs, s, cur.bi, cur.hi, wk0, 1.f);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The persistent grid: as many blocks of `kernel` as fit on the card at
// once, and no more than the problem's items.
template <typename K>
cudaError_t grid_of(K kernel, size_t smem, const Shape& s, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  const long long items =
      (long long)s.b * s.h * ((s.t + kRows - 1) / kRows);
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(items < fit ? items : fit);
  return err;
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry points
// (no link to libcuda); null where it is missing.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a (B, T, H, D) float32 view with element strides (sb,
// st, sh, 1) for stage's tensor copies: boxes of box_bytes(DP) / 4 columns
// by `rows` rows of one (batch, head), swizzled as raw_at reads them,
// zeros past T and D. A stride of an axis of one element is never
// stepped; it is given the extent of the axes inside it.
template <int DP>
cudaError_t tensor_map(CUtensorMap* map, const void* p, const Shape& s,
                       long long sb, long long st, long long sh, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (s.h == 1) sh = s.d;
  if (s.t == 1) st = s.h * sh;
  if (s.b == 1) sb = s.t * st;
  constexpr int SW = box_bytes(DP);
  const cuuint64_t dims[4] = {(cuuint64_t)s.d, (cuuint64_t)s.h,
                              (cuuint64_t)s.t, (cuuint64_t)s.b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 4, (cuuint64_t)st * 4,
                                 (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {SW / 4, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      SW == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
      : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                 : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP, bool kNarrow>
cudaError_t launch_fwd(const Shape& s, const void* q, const void* k,
                       const void* v, void* o, void* lse, float scale,
                       int causal, cudaStream_t stream) {
  constexpr size_t kSmem = fwd_smem(DP, kNarrow);
  CUtensorMap tq{}, tk{}, tv{};
  cudaError_t err = cudaSuccess;
  if (s.w == 16) {  // the kernel's tensor copies (see dense)
    constexpr int KT = fwd_tile(DP);
    const cudaError_t e[] = {
        tensor_map<DP>(&tq, q, s, s.sb, s.st, s.sh, kRows),
        tensor_map<DP>(&tk, k, s, s.sb, s.st, s.sh, KT),
        tensor_map<DP>(&tv, v, s, s.sb, s.st, s.sh, KT)};
    for (cudaError_t x : e) {
      if (x != cudaSuccess) err = x;
    }
  }
  if (err == cudaSuccess) {
    err = allow_smem(flash_fwd_tf32_kernel<DP, kNarrow>, kSmem);
  }
  int grid = 0;
  if (err == cudaSuccess) {
    err = grid_of(flash_fwd_tf32_kernel<DP, kNarrow>, kSmem, s, &grid);
  }
  if (err != cudaSuccess) return err;
  flash_fwd_tf32_kernel<DP, kNarrow><<<grid, kThreads, kSmem, stream>>>(
      tq, tk, tv, (const float*)q, (const float*)k, (const float*)v,
      (float*)o, (float*)lse, s, scale, causal);
  return cudaGetLastError();
}

template <int DP, bool kNarrow>
cudaError_t launch_bwd(const Shape& s, const void* q, const void* k,
                       const void* v, const void* o, const void* dout,
                       const void* lse, void* delta, void* dq, void* dk,
                       void* dv, float scale, int causal,
                       cudaStream_t stream) {
  constexpr size_t kDqSmem = dq_smem(DP, kNarrow);
  constexpr size_t kDkvSmem = dkv_smem(DP, kNarrow);
  // O and dO are contiguous (B, T, H, D).
  const long long osb = (long long)s.t * s.h * s.d, ost = (long long)s.h * s.d;
  CUtensorMap tq{}, tk{}, tv{}, to{}, tdo{};     // the dQ kernel's
  CUtensorMap kq{}, kk{}, kv{}, kdo{};          // the dK/dV kernel's
  cudaError_t err = cudaSuccess;
  if (s.w == 16) {  // the kernels' tensor copies (see dense)
    constexpr int KT = dq_tile(DP), QT = dkv_tile(DP);
    const cudaError_t e[] = {
        tensor_map<DP>(&tq, q, s, s.sb, s.st, s.sh, kRows),
        tensor_map<DP>(&tk, k, s, s.sb, s.st, s.sh, KT),
        tensor_map<DP>(&tv, v, s, s.sb, s.st, s.sh, KT),
        tensor_map<DP>(&to, o, s, osb, ost, s.d, kRows),
        tensor_map<DP>(&tdo, dout, s, osb, ost, s.d, kRows),
        tensor_map<DP>(&kq, q, s, s.sb, s.st, s.sh, QT),
        tensor_map<DP>(&kk, k, s, s.sb, s.st, s.sh, kRows),
        tensor_map<DP>(&kv, v, s, s.sb, s.st, s.sh, kRows),
        tensor_map<DP>(&kdo, dout, s, osb, ost, s.d, QT)};
    for (cudaError_t x : e) {
      if (x != cudaSuccess) err = x;
    }
  }
  if (err == cudaSuccess) {
    err = allow_smem(flash_dq_tf32_kernel<DP, kNarrow>, kDqSmem);
  }
  if (err == cudaSuccess) {
    err = allow_smem(flash_dkv_tf32_kernel<DP, kNarrow>, kDkvSmem);
  }
  int dq_grid = 0, dkv_grid = 0;
  if (err == cudaSuccess) {
    err = grid_of(flash_dq_tf32_kernel<DP, kNarrow>, kDqSmem, s, &dq_grid);
  }
  if (err == cudaSuccess) {
    err = grid_of(flash_dkv_tf32_kernel<DP, kNarrow>, kDkvSmem, s,
                  &dkv_grid);
  }
  if (err != cudaSuccess) return err;
  flash_dq_tf32_kernel<DP, kNarrow><<<dq_grid, kThreads, kDqSmem, stream>>>(
      tq, tk, tv, to, tdo, (const float*)q, (const float*)k,
      (const float*)v, (const float*)o, (const float*)dout,
      (const float*)lse, (float*)delta, (float*)dq, s, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_dkv_tf32_kernel<DP, kNarrow>
      <<<dkv_grid, kThreads, kDkvSmem, stream>>>(
      kq, kk, kv, kdo, (const float*)q, (const float*)k, (const float*)v,
      (const float*)dout, (const float*)lse, (const float*)delta,
      (float*)dk, (float*)dv, s, scale, causal);
  return cudaGetLastError();
}

// What the kernels take (see the header); `bf16` must be 0.
bool takes(const Shape& s, int bf16_in) {
  return bf16_in == 0 && s.b >= 1 && s.h >= 1 && s.t >= 1 && s.d >= 1 &&
         s.d <= 128 && s.w > 0 &&
         (long long)s.b * s.h * ((s.t + kRows - 1) / kRows) <= 0x7fffffffLL;
}

}  // namespace

// Each entry launches on `stream` (a stream of `device`) and returns
// cudaGetLastError() (0 when every launch was accepted), or
// cudaErrorInvalidValue for what the kernels do not take (see the notes
// above). None synchronises. This library carries its own copy of the CUDA
// runtime, whose current device is not PyTorch's: each entry selects the
// operands' device.

// q, k, v (b, t, h, d) float32 with strides (sb, st, sh, 1). Writes o (b,
// t, h, d) contiguous and lse (b, h, t) float32.
extern "C" int flash_fwd_tf32_launch(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int b, int h, int t, int d,
                                     long long sb, long long st,
                                     long long sh, float scale, int causal,
                                     int bf16_in, int device, void* stream) {
  const void* ptrs[] = {q, k, v, o};  // lse: float stores
  const Shape s{b, h, t, d, sb, st, sh, copy_width(d, sb, st, sh, 4, ptrs)};
  if (!takes(s, bf16_in)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  with_dp<8>(s, [&](auto dp, auto narrow) {
    err = launch_fwd<decltype(dp)::value, decltype(narrow)::value>(
        s, q, k, v, o, lse, scale, causal, (cudaStream_t)stream);
  });
  return (int)err;
}

// Launches the dQ kernel and then the dK/dV kernel. q, k, v as above; o and
// dout (b, t, h, d) contiguous; lse (b, h, t) float32. Writes delta (b, h,
// t) float32, and dq, dk and dv (b, t, h, d) contiguous.
extern "C" int flash_bwd_tf32_launch(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     void* delta, void* dq, void* dk,
                                     void* dv, int b, int h, int t, int d,
                                     long long sb, long long st,
                                     long long sh, float scale, int causal,
                                     int bf16_in, int device, void* stream) {
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};  // lse, delta: floats
  const Shape s{b, h, t, d, sb, st, sh, copy_width(d, sb, st, sh, 4, ptrs)};
  if (!takes(s, bf16_in)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  with_dp<8>(s, [&](auto dp, auto narrow) {
    err = launch_bwd<decltype(dp)::value, decltype(narrow)::value>(
        s, q, k, v, o, dout, lse, delta, dq, dk, dv, scale, causal,
        (cudaStream_t)stream);
  });
  return (int)err;
}
