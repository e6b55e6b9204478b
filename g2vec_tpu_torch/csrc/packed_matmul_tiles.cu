// The packed-matmul forward under every layout the tile planner may pick.
//
// csrc/packed_matmul.cu builds its forward (pm_fwd_kernel) under one layout,
// FwdShipped. This source includes it and builds the same body, fwd_block<L>,
// once for each candidate layout below, so that --kernel-autotune
// (ops/packed_matmul.py: tile_candidates, autotune_packed_matmul) can time
// them at a run's exact shapes and launch the fastest. It is built only when
// a sweep, or a run whose plan names a layout other than the shipped one,
// asks for it; a default run never loads it.
//
// A layout is (warps along the rows, warps along the columns, genes a ring
// stage, ring stages): blocks of 64 or 128 rows x 128 columns, each warp 32
// rows x 128 or 64 columns, rings of 2-4 stages of 64 or 128 genes. Every
// one walks every gene in the same ascending k-steps, so every candidate is
// bitwise the shipped layout on every row (packed_matmul.cu, "Forward").
//
// For each layout (WM, WN, GENES, STAGES) it exports
//   int g2v_pm_fwd_layout_WM_WN_GENES_STAGES(packed, w, out, m, g, nb, h,
//                                            stream)
//     with g2v_pm_fwd's arguments and preconditions, and
//   int g2v_pm_fwd_layout_occupancy_WM_WN_GENES_STAGES()
//     the blocks the card keeps resident on one SM (-1 on an error).

#include "packed_matmul.cu"

// The candidates, the shipped layout first (ops/packed_matmul.py FWD_LAYOUTS
// holds the same list).
#define G2V_FWD_LAYOUTS(X) \
    X(4, 1, 128, 2)        \
    X(4, 2, 64, 4)         \
    X(4, 1, 64, 4)         \
    X(4, 1, 128, 3)        \
    X(4, 2, 128, 2)        \
    X(4, 2, 128, 3)        \
    X(2, 1, 128, 2)        \
    X(2, 1, 64, 3)         \
    X(2, 1, 64, 4)         \
    X(2, 2, 128, 2)        \
    X(2, 2, 64, 4)

namespace {

template <class L>
__global__ void __launch_bounds__(L::kThreads, L::kBlocksPerSM)
pm_fwd_layout_kernel(const uint8_t* __restrict__ packed,
                     const __nv_bfloat16* __restrict__ w,
                     float* __restrict__ out, int m, int g, int nb, int h) {
    fwd_block<L>(packed, w, out, m, g, nb, h);
}

}  // namespace

#define G2V_FWD_ENTRY(WM, WN, GENES, STAGES)                                  \
    extern "C" int g2v_pm_fwd_layout_##WM##_##WN##_##GENES##_##STAGES(        \
        const void* packed, const void* w, void* out, int64_t m, int64_t g,   \
        int64_t nb, int64_t h, void* stream) {                                \
        using L = FwdLayout<WM, WN, GENES, STAGES>;                           \
        return launch_fwd<L>(pm_fwd_layout_kernel<L>, packed, w, out, m, g,   \
                             nb, h, stream);                                  \
    }                                                                         \
    extern "C" int g2v_pm_fwd_layout_occupancy_##WM##_##WN##_##GENES##_##STAGES() { \
        using L = FwdLayout<WM, WN, GENES, STAGES>;                           \
        return fwd_occupancy<L>(pm_fwd_layout_kernel<L>);                     \
    }

G2V_FWD_LAYOUTS(G2V_FWD_ENTRY)
