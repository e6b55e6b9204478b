// Hopper kernels for the trainer's product over a bit-packed 0/1 matrix.
//
// The CBOW's hot op is h = X @ W_ih (ref: G2Vec.py:238-239), with X the
// 0/1 path matrix held bit-packed: P [M, NB] uint8, gene g in bit 7-(g&7)
// of byte g>>3 (np.packbits order, as the walker writes it).
//
//   pm_fwd_kernel: out[M, H] f32 = unpack(P) @ bf16(W)[G, H]
//     replaces g2vec_tpu/ops/packed_matmul.py _fwd_call -> _fwd_kernel
//     (pallas_call at :302).
//   pm_bwd_kernel + pm_bwd_sum_kernel:
//                  dW[G, H] f32 = unpack(P)^T @ bf16(g_out)[M, H]
//     replaces g2vec_tpu/ops/packed_matmul.py _bwd_call -> _bwd_kernel
//     (pallas_call at :323).
//
// What bounds them on an H100 SXM (3.35 TB/s; 989 TFLOP/s dense bf16 on
// the tensor cores, 67 TFLOP/s f32 outside them): X is a path matrix,
// ~lenPath of G bits set per row (about 1% at the example scale). The
// work the data needs is one f32 add per set bit per hidden column, against
// P and the dense operand read once and the output written once: both
// functions are bound by bytes, 0.0154 ms for the forward (M 40,399 x
// G 5,850 x H 128) and 0.0104 ms for the backward (M 32,319) at the
// example-scale shapes.
//
// Forward. Each block stages the packed bytes and a bf16 tile of W in
// shared memory, with the next tile's global loads issued into registers
// while the current tile is consumed. Lanes map to 4 consecutive hidden
// columns each (a warp covers 128 columns), so every lane of a warp works
// on the same packed byte: the bit loop is warp-uniform, zero bytes are
// skipped, and each set bit costs one 8-byte shared load and four f32 adds
// per lane on the CUDA cores. A row's result is its own bits' W rows added
// in ascending gene order, whatever else is in the launch: the forward is
// M-invariant, which the trainer's fused [train | val] launch relies on.
//
// Backward. A bit loop on the CUDA cores leaves the backward latency-bound
// (a dependent chain of one-byte branches and adds per row), so it runs on
// the tensor cores instead: mma.sync m16n8k16 bf16 -> f32 with A = X^T
// (16 genes x 16 path rows) built in registers straight from the packed
// bits and B = the g_out tile (16 rows x 8 columns) from shared memory.
// No unpacked 0/1 matrix exists anywhere, in device or shared memory.
// This design does the dense 2*M*G*H operations, 4.84e10 at the example
// shape: its own ceiling is 0.049 ms at the dense bf16 rate, about 5x the
// byte bound, which it trades for a short pipeline with no branches.
//   - A block owns 128 genes x 128 hidden columns of one slice of rows;
//     its 8 warps are 4 (genes) x 2 (columns) tiles of 32 genes x 64
//     columns (2 x 8 MMA tiles, 64 f32 accumulators a thread), two blocks
//     to an SM. 64 columns, not the 128 of a 16-gene warp tile, halve the
//     ldmatrix traffic per MMA; 64 genes x 32 columns would halve it again
//     but doubles the integer work that builds A, and measured slower.
//   - The rows stream through a 4-stage cp.async ring of 64 rows each:
//     the g_out tile in 16-byte copies into rows padded from 256 to 272
//     bytes, so ldmatrix.trans's 8 rows fall on 8 distinct bank groups,
//     and the block's 16 packed bytes per row in 4-byte copies (the
//     wrapper pads P's rows to a multiple of 4 bytes when G needs it).
//     Rows past the slice and columns past H are zero-filled by the copy.
//   - A lane's four A registers hold rows 2t, 2t+1, 2t+8, 2t+9 of the
//     k-step for genes groupID and groupID+8. Each packed word is shifted
//     once by groupID, then each register is one prmt (sign mode: a byte's
//     bit 7 copied over a half) and one mask to bf16 1.0 (0x3F80).
//     1.0 x bf16 is exact; the tensor cores add the 16 products of a
//     k-step before rounding to f32, well inside the tolerance.
//   - The grid is (gene tiles, H tiles, S slices of M). Slice s writes its
//     partial dW to a workspace [S, G, H] and pm_bwd_sum_kernel adds the
//     partials in the order s = 0..S-1; with S = 1 the first pass writes
//     dW itself. S comes from (M, G, H) and the SM count alone: as many
//     slices as fill the resident blocks in two waves (_bwd_slices in
//     ops/packed_matmul.py, which plans from this file's kBwd* tile).
//     Nothing here uses atomics, so dW is bitwise the same from run to run.
//   - What still bounds it: every warp both waits on its own copies and
//     issues MMAs, so the two overlap only as far as the other resident
//     block hides them. A producer warp feeding wgmma consumers through TMA
//     is the next step.
// The plain PyTorch versions of both functions live in
// g2vec_tpu_torch/ops/packed_matmul.py; the wrapper there checks shapes,
// dtypes, devices and contiguity before any pointer reaches this file.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 128;                    // hidden columns per block

// Forward: a block owns 128 rows x 128 columns and walks the genes in
// chunks of 64 (8 packed bytes per row).
constexpr int kFwdRows = 128;
constexpr int kFwdRowsPerWarp = kFwdRows / kWarps;              // 16
constexpr int kFwdGenes = 64;
constexpr int kFwdBytes = kFwdGenes / 8;                        // 8
constexpr int kFwdPBytesPerThread = kFwdRows * kFwdBytes / kThreads;   // 4
constexpr int kFwdWQuadsPerThread = kFwdGenes * (kTileH / 4) / kThreads;  // 8

// Backward: kBwdWarpsM x kBwdWarpsN warps (genes x columns) of
// kBwdWarpGenes x kBwdWarpCols each; a block owns one tile of genes x
// columns for one slice of rows, and streams the slice through a ring of
// kBwdStages stages of kBwdRows rows.
constexpr int kBwdWarpsM = 4;
constexpr int kBwdWarpsN = 2;
constexpr int kBwdThreads = 32 * kBwdWarpsM * kBwdWarpsN;
constexpr int kBwdBlocksPerSM = 2;       // _bwd_slices plans for this
constexpr int kBwdWarpGenes = 32;
constexpr int kBwdWarpCols = 64;
constexpr int kBwdMTiles = kBwdWarpGenes / 16;                  // MMA tiles
constexpr int kBwdNTiles = kBwdWarpCols / 8;
constexpr int kBwdGenes = kBwdWarpsM * kBwdWarpGenes;
constexpr int kBwdCols = kBwdWarpsN * kBwdWarpCols;
constexpr int kBwdBytes = kBwdGenes / 8;       // packed bytes per row
constexpr int kBwdWords = kBwdBytes / 4;       // ... in 4-byte words
constexpr int kBwdWarpWords = kBwdWarpGenes / 32;
constexpr int kBwdRows = 64;
constexpr int kBwdStages = 4;
constexpr int kBwdGStride = kBwdCols + 8;      // bf16 per staged g_out row
constexpr int kBwdGBytes = kBwdRows * kBwdGStride * 2;
constexpr int kBwdStageBytes = kBwdGBytes + kBwdRows * kBwdBytes;
constexpr int kBwdSmem = kBwdStages * kBwdStageBytes;
constexpr int kBwdGChunks = kBwdRows * kBwdCols / 8 / kBwdThreads;  // per thread
constexpr int kBwdPWords = kBwdRows * kBwdWords / kBwdThreads;       // per thread
constexpr int kSumThreads = 256;
static_assert(kBwdGChunks * 8 * kBwdThreads == kBwdRows * kBwdCols &&
              kBwdPWords * kBwdThreads == kBwdRows * kBwdWords &&
              kBwdPWords > 0, "every thread copies whole chunks and words");
static_assert(kBwdWarpGenes % 32 == 0 && kBwdNTiles % 2 == 0 &&
              kBwdRows % 16 == 0, "whole packed words, n-tile pairs, k-steps");

// Four packed bf16 (element 0 in the low half of v.x) -> four f32, exactly:
// a bf16 is the upper 16 bits of the f32 with the same value.
__device__ __forceinline__ float4 bf16x4_to_float4(const uint2 v) {
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ void add4(float (&acc)[4], const float4 v) {
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
}

__global__ void __launch_bounds__(kThreads)
pm_fwd_kernel(const uint8_t* __restrict__ packed,
              const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
              int m, int g, int nb, int h) {
    __shared__ __align__(8) uint8_t p_s[kFwdRows][kFwdBytes];
    __shared__ __align__(16) __nv_bfloat16 w_s[kFwdGenes][kTileH];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int row0 = blockIdx.x * kFwdRows;
    const int col0 = blockIdx.y * kTileH;

    // Staging map. Packed tile: thread -> row tid/2, bytes (tid%2)*4..+3.
    // W tile: quad q = i*256 + tid -> gene q/32, columns (q%32)*4..+3.
    const int p_row = tid >> 1;
    const int p_byte = (tid & 1) * kFwdPBytesPerThread;
    uint8_t p_reg[kFwdPBytesPerThread];
    uint2 w_reg[kFwdWQuadsPerThread];

    auto fetch = [&](int g0) {
        const int grow = row0 + p_row;
#pragma unroll
        for (int j = 0; j < kFwdPBytesPerThread; ++j) {
            const int byte = (g0 >> 3) + p_byte + j;
            p_reg[j] = (grow < m && byte < nb)
                ? packed[static_cast<size_t>(grow) * nb + byte] : 0;
        }
#pragma unroll
        for (int i = 0; i < kFwdWQuadsPerThread; ++i) {
            const int q = i * kThreads + tid;
            const int gene = g0 + (q >> 5);
            const int col = col0 + (q & 31) * 4;
            w_reg[i] = (gene < g && col < h)
                ? *reinterpret_cast<const uint2*>(
                      w + static_cast<size_t>(gene) * h + col)
                : make_uint2(0u, 0u);
        }
    };
    auto stash = [&]() {
#pragma unroll
        for (int j = 0; j < kFwdPBytesPerThread; ++j)
            p_s[p_row][p_byte + j] = p_reg[j];
#pragma unroll
        for (int i = 0; i < kFwdWQuadsPerThread; ++i) {
            const int q = i * kThreads + tid;
            *reinterpret_cast<uint2*>(&w_s[q >> 5][(q & 31) * 4]) = w_reg[i];
        }
    };

    float acc[kFwdRowsPerWarp][4];
#pragma unroll
    for (int r = 0; r < kFwdRowsPerWarp; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;

    fetch(0);
    for (int g0 = 0; g0 < g; g0 += kFwdGenes) {
        __syncthreads();                    // previous chunk fully consumed
        stash();
        __syncthreads();
        if (g0 + kFwdGenes < g) fetch(g0 + kFwdGenes);   // in flight below
#pragma unroll
        for (int r = 0; r < kFwdRowsPerWarp; ++r) {
            const uint2 bytes = *reinterpret_cast<const uint2*>(
                p_s[warp * kFwdRowsPerWarp + r]);
            if ((bytes.x | bytes.y) == 0u) continue;       // warp-uniform
#pragma unroll
            for (int b = 0; b < kFwdBytes; ++b) {
                unsigned bits = ((b < 4 ? bytes.x : bytes.y) >> (8 * (b & 3))) & 0xffu;
                while (bits) {
                    // MSB first = ascending gene order within the byte.
                    const int j = __clz(bits) - 24;
                    bits &= ~(0x80u >> j);
                    add4(acc[r], bf16x4_to_float4(*reinterpret_cast<const uint2*>(
                        &w_s[b * 8 + j][lane * 4])));
                }
            }
        }
    }

    const int col = col0 + lane * 4;
    if (col < h) {
#pragma unroll
        for (int r = 0; r < kFwdRowsPerWarp; ++r) {
            const int row = row0 + warp * kFwdRowsPerWarp + r;
            if (row < m)
                *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * h + col) =
                    make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
    }
}

// cp.async copies of 16 and 4 bytes; bytes past src_bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// Four 8x8 bf16 matrices, transposed: the B fragments of two n-tiles.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a @ b on one 16x8x16 tile, bf16 inputs, f32 sums.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One A register: bf16 0/1 of one gene on two path rows. lo and hi are
// the rows' packed words shifted so that the gene's bit of every byte sits
// at the byte's bit 7; prmt's sign mode copies bit 7 of byte `byte` of lo
// over the low half and that of hi over the high half (0xFFFF or 0), and
// the mask leaves bf16 1.0 (0x3F80) or 0 in each half.
__device__ __forceinline__ uint32_t bits_to_bf16x2(uint32_t lo, uint32_t hi,
                                                   int byte) {
    uint32_t r;
    asm("prmt.b32 %0, %1, %2, %3;\n"
        : "=r"(r) : "r"(lo), "r"(hi), "r"(0xCC88u + 0x1111u * byte));
    return r & 0x3F803F80u;
}

__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSM)
pm_bwd_kernel(const uint8_t* __restrict__ packed,
              const __nv_bfloat16* __restrict__ gout, float* __restrict__ part,
              int m, int g, int nb, int h, int rows_per_slice) {
    extern __shared__ __align__(16) uint8_t smem[];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp % kBwdWarpsM, wn = warp / kBwdWarpsM;   // warp tile
    const int gid = lane >> 2, tig = lane & 3;     // MMA groupID, thread in group
    const int byte0 = blockIdx.x * kBwdBytes;
    const int col0 = blockIdx.y * kBwdCols;
    const int row_begin = blockIdx.z * rows_per_slice;
    const int row_end = min(m, row_begin + rows_per_slice);
    const int n_steps = max(0, row_end - row_begin + kBwdRows - 1) / kBwdRows;
    const uint32_t smem0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

    // Staging map of one stage, q = i * kBwdThreads + tid. g_out tile:
    // 16-byte chunk q -> row q / (kBwdCols/8), columns (q % (kBwdCols/8))*8
    // ..+7. Packed tile: word q -> row q / kBwdWords, bytes
    // (q % kBwdWords)*4..+3, kept row-major at byte q*4.
    auto load_stage = [&](int step, int stage) {
        const int r0 = row_begin + step * kBwdRows;
        const uint32_t base = smem0 + stage * kBwdStageBytes;
#pragma unroll
        for (int i = 0; i < kBwdGChunks; ++i) {
            const int q = i * kBwdThreads + tid;
            const int r = q / (kBwdCols / 8), c = q % (kBwdCols / 8) * 8;
            const bool ok = r0 + r < row_end && col0 + c < h;
            cp_async_16(base + (r * kBwdGStride + c) * 2,
                        ok ? gout + static_cast<size_t>(r0 + r) * h + col0 + c
                           : gout,
                        ok ? 16 : 0);
        }
#pragma unroll
        for (int i = 0; i < kBwdPWords; ++i) {
            const int q = i * kBwdThreads + tid;
            const int row = r0 + q / kBwdWords;
            const int byte = byte0 + q % kBwdWords * 4;
            const bool ok = row < row_end && byte < nb;
            cp_async_4(base + kBwdGBytes + q * 4,
                       ok ? packed + static_cast<size_t>(row) * nb + byte
                          : packed,
                       ok ? 4 : 0);
        }
    };

    float acc[kBwdMTiles][kBwdNTiles][4];          // [m-tile][n-tile][frag]
#pragma unroll
    for (int j = 0; j < kBwdMTiles; ++j)
#pragma unroll
        for (int n = 0; n < kBwdNTiles; ++n)
            acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.0f;

#pragma unroll
    for (int s = 0; s < kBwdStages - 1; ++s) {
        if (s < n_steps) load_stage(s, s);
        cp_async_commit();                         // one group per stage, even if empty
    }

    // ldmatrix.x4.trans: lanes 0-15 address rows 0-15 of the k-step at the
    // n-tile's column, lanes 16-31 the same rows 8 columns on.
    const int ld_row = lane & 15;
    const int ld_col = wn * kBwdWarpCols + (lane >> 4) * 8;

    for (int step = 0; step < n_steps; ++step) {
        cp_async_wait<kBwdStages - 2>();           // this step's stage landed
        __syncthreads();                           // ... for every thread, and
                                                   // the step before is consumed
        const int next = step + kBwdStages - 1;
        if (next < n_steps) load_stage(next, next % kBwdStages);
        cp_async_commit();

        const int stage = step % kBwdStages;
        const uint32_t g_s = smem0 + stage * kBwdStageBytes;
        const uint32_t* p_s = reinterpret_cast<const uint32_t*>(
            smem + stage * kBwdStageBytes + kBwdGBytes) + wm * kBwdWarpWords;
#pragma unroll
        for (int k0 = 0; k0 < kBwdRows; k0 += 16) {
            // The warp's packed words on this lane's rows k0 + 2t + {0, 1,
            // 8, 9}, shifted to put gene groupID's bit of each byte at bit 7.
            uint32_t v[4][kBwdWarpWords];
#pragma unroll
            for (int w = 0; w < kBwdWarpWords; ++w) {
                v[0][w] = p_s[(k0 + 2 * tig) * kBwdWords + w] << gid;
                v[1][w] = p_s[(k0 + 2 * tig + 1) * kBwdWords + w] << gid;
                v[2][w] = p_s[(k0 + 2 * tig + 8) * kBwdWords + w] << gid;
                v[3][w] = p_s[(k0 + 2 * tig + 9) * kBwdWords + w] << gid;
            }
            uint32_t a[kBwdMTiles][4];
#pragma unroll
            for (int j = 0; j < kBwdMTiles; ++j) {
                // m-tile j: bytes 2j (genes +groupID) and 2j+1 (+8+groupID).
                const int w = j / 2, byte = j % 2 * 2;
                a[j][0] = bits_to_bf16x2(v[0][w], v[1][w], byte);
                a[j][1] = bits_to_bf16x2(v[0][w], v[1][w], byte + 1);
                a[j][2] = bits_to_bf16x2(v[2][w], v[3][w], byte);
                a[j][3] = bits_to_bf16x2(v[2][w], v[3][w], byte + 1);
            }
#pragma unroll
            for (int n = 0; n < kBwdNTiles; n += 2) {
                uint32_t b[4];
                ldmatrix_x4_trans(
                    b, g_s + ((k0 + ld_row) * kBwdGStride + ld_col + n * 8) * 2);
#pragma unroll
                for (int j = 0; j < kBwdMTiles; ++j) {
                    mma_16816(acc[j][n], a[j], b[0], b[1]);
                    mma_16816(acc[j][n + 1], a[j], b[2], b[3]);
                }
            }
        }
    }

    // C fragment: rows (genes) gid and gid + 8, columns 2t and 2t + 1.
    float* out = part + static_cast<size_t>(blockIdx.z) * g * h;
#pragma unroll
    for (int j = 0; j < kBwdMTiles; ++j) {
        const int gene = byte0 * 8 + wm * kBwdWarpGenes + j * 16 + gid;
#pragma unroll
        for (int n = 0; n < kBwdNTiles; ++n) {
            const int col = col0 + wn * kBwdWarpCols + n * 8 + 2 * tig;
            if (col >= h) continue;
            if (gene < g)
                *reinterpret_cast<float2*>(out + static_cast<size_t>(gene) * h + col) =
                    make_float2(acc[j][n][0], acc[j][n][1]);
            if (gene + 8 < g)
                *reinterpret_cast<float2*>(out + static_cast<size_t>(gene + 8) * h + col) =
                    make_float2(acc[j][n][2], acc[j][n][3]);
        }
    }
}

// dW = part[0] + part[1] + ... + part[S-1], added in that order.
__global__ void __launch_bounds__(kSumThreads)
pm_bwd_sum_kernel(const float4* __restrict__ part, float4* __restrict__ dw,
                  int64_t n4, int n_slices) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x;
    if (i >= n4) return;
    float4 acc = part[i];
    for (int s = 1; s < n_slices; ++s) {
        const float4 v = part[s * n4 + i];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
    }
    dw[i] = acc;
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
// success). Preconditions, checked by the Python wrapper: P [m, nb] uint8
// contiguous, W / g_out bf16 contiguous, out / dW f32 contiguous, g, h >= 1.
//   forward: nb == ceil(g/8), h % 4 == 0, W 8-byte aligned, m >= 1.
//   backward: nb (P's row stride) >= ceil(g/8) and nb % 4 == 0, P 4-byte
//     aligned, h % 8 == 0, g_out 16-byte aligned;
//     rows_per_slice * n_slices >= m, n_slices >= 1,
//     and with n_slices > 1 a workspace `work` of n_slices * g * h f32.

int g2v_pm_fwd(const void* packed, const void* w, void* out, int64_t m,
               int64_t g, int64_t nb, int64_t h, void* stream) {
    const dim3 grid(static_cast<unsigned>((m + kFwdRows - 1) / kFwdRows),
                    static_cast<unsigned>((h + kTileH - 1) / kTileH));
    pm_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed),
        static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out),
        static_cast<int>(m), static_cast<int>(g), static_cast<int>(nb),
        static_cast<int>(h));
    return static_cast<int>(cudaGetLastError());
}

int g2v_pm_bwd(const void* packed, const void* gout, void* dw, void* work,
               int64_t m, int64_t g, int64_t nb, int64_t h,
               int64_t rows_per_slice, int64_t n_slices, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaFuncSetAttribute(
        pm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    float* part = static_cast<float*>(n_slices > 1 ? work : dw);
    const dim3 grid(static_cast<unsigned>((g + kBwdGenes - 1) / kBwdGenes),
                    static_cast<unsigned>((h + kBwdCols - 1) / kBwdCols),
                    static_cast<unsigned>(n_slices));
    pm_bwd_kernel<<<grid, kBwdThreads, kBwdSmem, s>>>(
        static_cast<const uint8_t*>(packed),
        static_cast<const __nv_bfloat16*>(gout), part,
        static_cast<int>(m), static_cast<int>(g), static_cast<int>(nb),
        static_cast<int>(h), static_cast<int>(rows_per_slice));
    err = cudaGetLastError();
    if (err != cudaSuccess || n_slices == 1) return static_cast<int>(err);
    const int64_t n4 = g * h / 4;
    pm_bwd_sum_kernel<<<static_cast<unsigned>((n4 + kSumThreads - 1) / kSumThreads),
                        kSumThreads, 0, s>>>(
        static_cast<const float4*>(work), static_cast<float4*>(dw), n4,
        static_cast<int>(n_slices));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
