"""The tensor-core ``matmul_i8`` kernel's data layout, modelled in numpy on
the CPU (the kernel itself runs only on the card: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold it to ``matmul_i8_plain`` exactly).

``csrc/matmul_i8.cu`` builds the column B operand of ``mma.sync
m16n8k32`` from row-major B by transposing 4 x 4 bytes with
``__byte_perm``, lets mma column g of n-tile j stand for column 4g + j, and
permutes B's shared rows so that a warp's reads hit distinct banks. The
selectors are read from the source, and one warp's 32-byte k-step is
carried through the PTX fragment layouts to the epilogue's columns: it
must give A @ B exactly."""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from pytorch_distributed_mnist_tpu_torch.ops import cuda_build
from pytorch_distributed_mnist_tpu_torch.ops import matmul_i8 as port

pytestmark = pytest.mark.serve
torch.set_num_threads(2)

with open(cuda_build.source_path("matmul_i8")) as _f:
    SOURCE = _f.read()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def byte_perm(x, y, selector):
    """CUDA's ``__byte_perm(x, y, s)``: byte i of the result is byte
    ``(s >> 4i) & 7`` of the eight bytes ``x`` (0-3) then ``y`` (4-7)."""
    pool = [(int(x) >> (8 * i)) & 0xFF for i in range(4)] + \
           [(int(y) >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(selector >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _selectors():
    body = SOURCE.split("void transpose4x4(")[1].split("\n}\n")[0]
    return [int(s, 16) for s in
            re.findall(r"__byte_perm\(\w+\[?\d?\]?, \w+\[?\d?\]?, "
                       r"(0x[0-9a-fA-F]+)\)", body)]


def transpose4x4(words):
    """The kernel's ``transpose4x4``, with its selectors as the source has
    them: x0, x1 from words 0 and 1; y0, y1 from words 2 and 3; then
    (x0, y0) -> words 0, 1 and (x1, y1) -> words 2, 3."""
    s = _selectors()
    assert len(s) == 8
    x0, x1 = byte_perm(words[0], words[1], s[0]), byte_perm(words[0],
                                                           words[1], s[1])
    y0, y1 = byte_perm(words[2], words[3], s[2]), byte_perm(words[2],
                                                           words[3], s[3])
    return [byte_perm(x0, y0, s[4]), byte_perm(x0, y0, s[5]),
            byte_perm(x1, y1, s[6]), byte_perm(x1, y1, s[7])]


def _word(row_bytes):
    """Four bytes (uint8) as the little-endian 32-bit word a load gives."""
    return int(np.asarray(row_bytes, np.uint8).view("<u4")[0])


def _bytes(word):
    return np.array([(word >> (8 * i)) & 0xFF for i in range(4)], np.uint8)


def b_slot(r):
    """The kernel's shared row of B's k row r (``b_slot``)."""
    return (r & ~3) | ((r & 3) ^ ((r >> 2) & 3))


def test_b_slot_formula_is_the_kernels():
    assert "return (r & ~3) | ((r & 3) ^ ((r >> 2) & 3));" in SOURCE


def test_byte_perm_transpose_gives_the_k_quads_of_b_transposed():
    rng = np.random.default_rng(0)
    for _ in range(64):
        block = rng.integers(0, 256, size=(4, 4), dtype=np.uint8)
        got = transpose4x4([_word(block[i]) for i in range(4)])
        for j in range(4):
            # word j: column j at k rows 0..3, the B fragment's k-quad
            np.testing.assert_array_equal(_bytes(got[j]), block[:, j])


def _ldmatrix(smem, lane_addr):
    """``ldmatrix.x4`` of 8 x 16-byte matrices: lane l names the row
    address of row l % 8 of matrix l / 8; register j of lane L gets bytes
    4 (L % 4) .. + 3 of row L / 4 of matrix j."""
    regs = np.zeros((32, 4, 4), np.uint8)
    for lane in range(32):
        for j in range(4):
            at = lane_addr(8 * j + lane // 4) + 4 * (lane % 4)
            regs[lane, j] = smem[at:at + 4]
    return regs


def _mma_m16n8k32(a_regs, b_regs):
    """``mma.sync.m16n8k32.row.col.s32.s8.s8.s32`` by the PTX fragment
    layouts: A byte i of lane (g, tq) is row g (+8 for regs 1, 3), column
    4tq + i (+16 for regs 2, 3); B byte i of reg r is k row 4tq + i + 16r,
    column g; C element e is row g + 8 (e >> 1), column 2tq + (e & 1)."""
    a = np.zeros((16, 32), np.int64)
    b = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, tq = lane >> 2, lane & 3
        for r in range(4):
            for i in range(4):
                a[g + 8 * (r & 1), 4 * tq + i + 16 * (r >> 1)] = \
                    a_regs[lane, r, i].astype(np.int8)
        for r in range(2):
            for i in range(4):
                b[4 * tq + i + 16 * r, g] = b_regs[lane][r][i].astype(np.int8)
    c = a @ b
    return np.array([[c[(lane >> 2) + 8 * (e >> 1), 2 * (lane & 3) + (e & 1)]
                      for e in range(4)] for lane in range(32)])


@pytest.mark.parametrize("warp", range(4))
def test_one_warp_k_step_through_the_fragments_gives_a_times_b(warp):
    # A stage as the kernel stages it: A rows of kBlockK bytes padded to
    # kLdA, B's k rows of 32 bytes at their permuted slots. Warp w takes
    # the 32-byte k-step w.
    block_k, ld_a, block_n = (_constant("kWarps") * 32, block_k_pad(),
                              _constant("kBlockN"))
    rng = np.random.default_rng(warp)
    a = rng.integers(-128, 128, size=(32, block_k), dtype=np.int8)
    b = rng.integers(-128, 128, size=(block_k, block_n), dtype=np.int8)
    a_smem = np.zeros(32 * ld_a, np.uint8)
    for r in range(32):
        a_smem[r * ld_a:r * ld_a + block_k] = a[r].view(np.uint8)
    b_smem = np.zeros(block_k * block_n, np.uint8)
    for r in range(block_k):
        b_smem[b_slot(r) * block_n:(b_slot(r) + 1) * block_n] = \
            b[r].view(np.uint8)

    c = np.zeros((32, block_n), np.int64)
    # B fragments: lane (g, tq) reads the word of columns 4g..4g+3 at k
    # rows warp*32 + kh*16 + 4tq + i and transposes it.
    bf = []
    for lane in range(32):
        g, tq = lane >> 2, lane & 3
        halves = []
        for kh in range(2):
            words = []
            for i in range(4):
                r = warp * 32 + kh * 16 + 4 * tq + i
                at = b_slot(r) * block_n + 4 * g
                words.append(_word(b_smem[at:at + 4]))
            halves.append([_bytes(w) for w in transpose4x4(words)])
        bf.append(halves)
    for mt in range(2):
        af = _ldmatrix(a_smem, lambda l: (16 * mt + (l & 15)) * ld_a
                       + (l >> 4) * 16 + warp * 32)
        for nt in range(4):
            frag = _mma_m16n8k32(af, [[bf[lane][0][nt], bf[lane][1][nt]]
                                      for lane in range(32)])
            for lane in range(32):
                g, tq = lane >> 2, lane & 3
                for e in range(4):
                    # the kernel's epilogue: column 4 (2tq + (e & 1)) + nt
                    row = 16 * mt + g + 8 * (e >> 1)
                    col = 4 * (2 * tq + (e & 1)) + nt
                    c[row, col] += frag[lane, e]
    k0 = warp * 32
    want = a[:, k0:k0 + 32].astype(np.int64) @ b[k0:k0 + 32].astype(np.int64)
    np.testing.assert_array_equal(c, want)


def block_k_pad():
    """kLdA: kBlockK + 16."""
    assert "constexpr int kLdA = kBlockK + 16;" in SOURCE
    return _constant("kWarps") * 32 + 16


@pytest.mark.parametrize("warp", range(4))
def test_b_fragment_reads_hit_32_distinct_banks(warp):
    block_n = _constant("kBlockN")
    for kh in range(2):
        for i in range(4):
            banks = set()
            for lane in range(32):
                g, tq = lane >> 2, lane & 3
                r = warp * 32 + kh * 16 + 4 * tq + i
                banks.add(((b_slot(r) * block_n + 4 * g) // 4) % 32)
            assert len(banks) == 32


def test_a_ldmatrix_rows_hit_distinct_banks():
    # Each 8-address phase of ldmatrix reads 8 rows of 16 bytes: with the
    # padded row they cover 8 distinct groups of 4 banks.
    ld_a = block_k_pad()
    for mt in range(2):
        for phase in range(4):
            groups = {((16 * mt + ((8 * phase + l) & 15)) * ld_a
                       + ((8 * phase + l) >> 4) * 16) // 16 % 8
                      for l in range(8)}
            assert len(groups) == 8


@pytest.mark.parametrize("m,k,n", chip_smoke.CHECK_SHAPES,
                         ids=["x".join(map(str, s))
                              for s in chip_smoke.CHECK_SHAPES])
def test_cpu_wrapper_is_exact_and_counts_nothing_at_every_check_shape(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-128, 128, size=(m, k), dtype=np.int8)
    b = rng.integers(-128, 128, size=(k, n), dtype=np.int8)
    before = port.matmul_i8.launches
    got = port.matmul_i8(torch.from_numpy(a), torch.from_numpy(b))
    assert port.matmul_i8.launches == before
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


def test_kernel_constants_match_the_wrapper():
    assert (_constant("kBlockM"), _constant("kBlockN"),
            _constant("kWarps") * 32) == (port._BLOCK_M, port._BLOCK_N,
                                          port._BLOCK_K)
