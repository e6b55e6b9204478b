// Hopper kernels for the trainer's product over a bit-packed 0/1 matrix.
//
// The CBOW's hot op is h = X @ W_ih (ref: G2Vec.py:238-239), with X the
// 0/1 path matrix held bit-packed: P [M, NB] uint8, NB = ceil(G/8), gene g
// in bit 7-(g&7) of byte g>>3 (np.packbits order, as the walker writes it).
//
//   pm_fwd_kernel: out[M, H] f32 = unpack(P) @ bf16(W)[G, H]
//     replaces g2vec_tpu/ops/packed_matmul.py _fwd_call -> _fwd_kernel
//     (pallas_call at :302).
//   pm_bwd_kernel: dW[G, H] f32 = unpack(P)^T @ bf16(g_out)[M, H]
//     replaces g2vec_tpu/ops/packed_matmul.py _bwd_call -> _bwd_kernel
//     (pallas_call at :323).
//
// What bounds them on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the
// tensor cores): X is a path matrix, ~lenPath of G bits set per row (about
// 1% at the reference's example scale). The work the data needs is one
// f32 add per set bit per hidden column, nnz*H adds (~3e8 for the forward
// at M = 45k), against P's bytes read once (M*NB, 43 MB at that shape):
// both kernels are bound by bytes, ~0.02 ms for the forward and ~0.014 ms
// for the backward at the example-scale shapes. A dense bf16 product of
// the same shapes would need 2*M*G*H = 8.7e10 operations (0.09 ms on the
// tensor cores).
//
// Design. The kernels read packbits order directly, so the TPU package's
// blockwise bit layout (an artefact of pltpu.repeat) and its host re-pack
// are gone, and they mask ragged M, G and H themselves: no row or gene
// padding is needed. Each block stages the packed bytes and a bf16 tile of
// the dense operand in shared memory, with the next tile's global loads
// issued into registers while the current tile is consumed. Lanes map to
// 4 consecutive hidden columns each (a warp covers 128 columns), so every
// lane of a warp works on the same packed byte: the bit loop is
// warp-uniform, zero bytes are skipped, and each set bit costs one 8-byte
// shared load and four f32 adds per lane. No tensor cores: with 1% of the
// bits set, a dense MMA would do ~100x the useful work. Sums are taken in
// a fixed order with no atomics and no split of the reduction, so
//   - the forward is M-invariant: a row's result is its own bits' W rows
//     added in ascending gene order, whatever else is in the launch (the
//     trainer's fused [train | val] launch relies on it);
//   - the backward is bitwise reproducible: each dW element adds its rows
//     in ascending row order. Its grid is one block per 64 genes (118 at
//     G = 7,528), which under-fills the 132 SMs; a split-M pass is later
//     work.
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

// Backward: a block owns 64 genes (one packed byte per warp) x 128 columns
// and walks all M rows in chunks of 64.
constexpr int kBwdGenes = 8 * kWarps;                           // 64
constexpr int kBwdRows = 64;
constexpr int kBwdPBytesPerThread = kBwdRows * kWarps / kThreads;      // 2
constexpr int kBwdGQuadsPerThread = kBwdRows * (kTileH / 4) / kThreads;  // 8

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

__global__ void __launch_bounds__(kThreads)
pm_bwd_kernel(const uint8_t* __restrict__ packed,
              const __nv_bfloat16* __restrict__ gout, float* __restrict__ dw,
              int m, int g, int nb, int h) {
    __shared__ uint8_t p_s[kBwdRows][kWarps];
    __shared__ __align__(16) __nv_bfloat16 g_s[kBwdRows][kTileH];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int byte0 = blockIdx.x * (kBwdGenes / 8);
    const int col0 = blockIdx.y * kTileH;

    // Staging map. Packed tile: thread -> row tid/4, bytes (tid%4)*2..+1.
    // g_out tile: quad q = i*256 + tid -> row q/32, columns (q%32)*4..+3.
    const int p_row = tid >> 2;
    const int p_byte = (tid & 3) * kBwdPBytesPerThread;
    uint8_t p_reg[kBwdPBytesPerThread];
    uint2 g_reg[kBwdGQuadsPerThread];

    auto fetch = [&](int r0) {
        const int grow = r0 + p_row;
#pragma unroll
        for (int j = 0; j < kBwdPBytesPerThread; ++j) {
            const int byte = byte0 + p_byte + j;
            p_reg[j] = (grow < m && byte < nb)
                ? packed[static_cast<size_t>(grow) * nb + byte] : 0;
        }
#pragma unroll
        for (int i = 0; i < kBwdGQuadsPerThread; ++i) {
            const int q = i * kThreads + tid;
            const int row = r0 + (q >> 5);
            const int col = col0 + (q & 31) * 4;
            g_reg[i] = (row < m && col < h)
                ? *reinterpret_cast<const uint2*>(
                      gout + static_cast<size_t>(row) * h + col)
                : make_uint2(0u, 0u);
        }
    };
    auto stash = [&]() {
#pragma unroll
        for (int j = 0; j < kBwdPBytesPerThread; ++j)
            p_s[p_row][p_byte + j] = p_reg[j];
#pragma unroll
        for (int i = 0; i < kBwdGQuadsPerThread; ++i) {
            const int q = i * kThreads + tid;
            *reinterpret_cast<uint2*>(&g_s[q >> 5][(q & 31) * 4]) = g_reg[i];
        }
    };

    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

    fetch(0);
    for (int r0 = 0; r0 < m; r0 += kBwdRows) {
        __syncthreads();
        stash();
        __syncthreads();
        if (r0 + kBwdRows < m) fetch(r0 + kBwdRows);
#pragma unroll 4
        for (int r = 0; r < kBwdRows; ++r) {
            const unsigned bits = p_s[r][warp];           // warp-uniform
            if (bits == 0u) continue;
            const float4 v = bf16x4_to_float4(
                *reinterpret_cast<const uint2*>(&g_s[r][lane * 4]));
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (bits & (0x80u >> j)) add4(acc[j], v);
        }
    }

    const int col = col0 + lane * 4;
    if (col < h) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int gene = (byte0 + warp) * 8 + j;
            if (gene < g)
                *reinterpret_cast<float4*>(dw + static_cast<size_t>(gene) * h + col) =
                    make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        }
    }
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
// success). Preconditions, checked by the Python wrapper: P [m, nb] uint8
// contiguous with nb == ceil(g/8), W / g_out bf16 contiguous, out / dW f32
// contiguous, h % 4 == 0, m >= 1 for the forward.

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

int g2v_pm_bwd(const void* packed, const void* gout, void* dw, int64_t m,
               int64_t g, int64_t nb, int64_t h, void* stream) {
    const dim3 grid(static_cast<unsigned>((g + kBwdGenes - 1) / kBwdGenes),
                    static_cast<unsigned>((h + kTileH - 1) / kTileH));
    pm_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed),
        static_cast<const __nv_bfloat16*>(gout), static_cast<float*>(dw),
        static_cast<int>(m), static_cast<int>(g), static_cast<int>(nb),
        static_cast<int>(h));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
