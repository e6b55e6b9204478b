// Hopper kernels for stage 3's random walks over a CSR graph: one weighted
// no-revisit walk per walker, written straight into np.packbits rows, and
// the resumable walk states of the edge partition.
//
//   g2v_walk_kernel: out[W, nbytes] uint8, row w = the genes walker w visits
//   (gene g in bit 7-(g&7) of byte g>>3, MSB of byte 0 = gene 0).
//     replaces g2vec_tpu/ops/device_walker.py _get_walk_fn (the lax.scan over
//     path steps with its inner f64 scan over degree slots, :186-275) and
//     _get_pack_fn (the bit scatter, :278-300), and computes what
//     g2vec_tpu_torch/native/walker.cpp walk_range computes (:40-100): for
//     the same CSR bytes, starts, stream ids, len_path and seed the rows are
//     byte-identical to the C++ sampler's.
//
// The walk (generate_randomPath, ref: G2Vec.py:328-346): from the current
// gene, the next one is drawn with probability proportional to the weight
// of its out-edge, among the edges whose weight is > 0 and whose target the
// walk has not visited; a gene with no such edge ends the walk, and so does
// len_path. Duplicate edges are separate slots.
//
// Bit-exactness with the C++ sampler:
//   - the stream is native uint64 splitmix64: state seed ^ (sid * golden),
//     one discarded draw, then one draw per step that draws; the uniform is
//     (z >> 11) * 2^-53, exact;
//   - pass 1 sums (double)weights[k] left to right over the eligible slots of
//     the row and counts them; m == 0 or total <= 0 breaks before drawing, so
//     a walk's stream is frozen where the C++ one is;
//   - pass 2 recomputes the same running sums in the same order and takes
//     the first eligible slot with target < cum, or the last eligible slot
//     when rounding leaves none: the index the C++ binary search over its
//     cumbuf returns, from the same doubles, with no per-thread buffer;
//   - this file is built with -fmad=false and the sums and the draw use
//     __dadd_rn/__dmul_rn, so nothing is contracted into an FMA.
//
// The visited mask is the output row itself: the walker sets gene n's bit as
// it enters n and tests that bit, so no mask, path buffer or pack pass
// exists. One thread owns a row, so there are no races; the wrapper zeroes
// the rows (torch.zeros) before the launch.
//
// What bounds it: dependent loads along each walk, not bandwidth. A step
// reads indptr[cur] and indptr[cur+1], then each slot's index and weight,
// then the visited byte of each target: three round trips to L2 or memory in
// a chain, twice over the row. On the example (5,850 genes, out-degree at
// most 7, mean 2.2; 58,500 walkers of len_path 80 a group) a walk is 26 steps
// on average and 80 at most. The bytes the walk must move through device
// memory, each once, are the packed rows written (42.8 MB), the starts and
// stream ids (0.7 MB) and the CSR (126 KB, which stays in the 50 MB L2 while
// the steps scan its rows again and again): about 0.013 ms at 3.35 TB/s, some
// 39x under the kernel's 0.51 ms on an H100 SXM at 700 W (PERF.md section 6).
// 58,500 threads are 229 blocks of 256, all resident at once on 132 SMs, so
// the launch lasts about as long as its longest walk's chain of loads.
//
//   g2v_walk_states_kernel: advances explicit walk states in place over an
//   availability-masked CSR (the edge partition's resumable walks):
//   cur/pos [W] int32, rng [W] uint64, paths [W, len_path] int32 in and out,
//   status [W] uint8 out (0 finished, 1 suspended on a gene whose row is not
//   held: avail[cur] == 0).
//     replaces g2vec_tpu/ops/device_walker.py _get_walk_fn (:186) as
//     _run_states (:332) drives it for advance_walk_states_device (:375),
//     and computes what g2vec_tpu_torch/native/walker.cpp
//     walk_partial_range computes: for the same states, CSR bytes and avail
//     mask, the four state arrays and the status are bitwise the C++ ones,
//     the frozen stream of a walker that suspends or dead-ends included.
//
// The step is g2v_walk_kernel's (the same pass-1 sum, draw, pass-2 pick and
// last-eligible fallback), behind the C++ gates in their order: a full path
// finishes first (even on an unavailable gene), then an unavailable gene
// suspends, then the scan, then the draw. The visited test cannot be a bit
// of an output row here: a packed row at G 262,144 is 32 KB a walker, and
// the state carries no mask. So a candidate is tested against the walker's
// own path prefix, as the reference does (device_walker.py:221): a scan of
// at most len_path int32s of the row of `paths` the thread owns, which
// stays in L1 across the steps. One thread owns one walker and its row, so
// there are no races and nothing to zero.
//
// What bounds it: the same chains of dependent loads, now with a prefix scan
// of up to len_path words for each candidate. The bytes it must move, each
// once: the state read and written (paths 58,500 x 80 x 4 B each way on the
// example, plus cur, pos, rng and status), the CSR and the mask: about 38 MB,
// 0.011 ms at 3.35 TB/s. PERF.md section 6 has its time beside that bound.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint64_t kGolden = 0x9e3779b97f4a7c15ULL;
constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t splitmix64(uint64_t& s) {
    uint64_t z = (s += kGolden);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
}

__device__ __forceinline__ bool visited(const uint8_t* row, int32_t n) {
    return (row[n >> 3] >> (7 - (n & 7))) & 1u;
}

__device__ __forceinline__ void visit(uint8_t* row, int32_t n) {
    row[n >> 3] |= static_cast<uint8_t>(0x80u >> (n & 7));
}

__global__ void __launch_bounds__(kThreads)
g2v_walk_kernel(const int32_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const float* __restrict__ weights,
                const int32_t* __restrict__ starts,
                const uint64_t* __restrict__ stream_ids, int64_t n_walkers,
                int32_t len_path, uint64_t seed, uint8_t* out,
                int64_t nbytes) {
    const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (w >= n_walkers) return;
    uint8_t* row = out + w * nbytes;
    uint64_t st = seed ^ (stream_ids[w] * kGolden);
    splitmix64(st);  // decorrelate nearby stream ids, as walk_range does
    int32_t cur = starts[w];
    visit(row, cur);
    for (int32_t step = 1; step < len_path; ++step) {
        const int32_t b = __ldg(indptr + cur), e = __ldg(indptr + cur + 1);
        int32_t m = 0;
        double total = 0.0;
        for (int32_t k = b; k < e; ++k) {
            const float wk = __ldg(weights + k);
            if (wk > 0.0f && !visited(row, __ldg(indices + k))) {
                total = __dadd_rn(total, static_cast<double>(wk));
                ++m;
            }
        }
        if (m == 0 || total <= 0.0) break;  // dead end (G2Vec.py:343-344)
        const double u =
            static_cast<double>(splitmix64(st) >> 11) * 0x1.0p-53;
        const double target = __dmul_rn(u, total);
        int32_t nxt = -1;
        double cum = 0.0;
        for (int32_t k = b; k < e; ++k) {
            const float wk = __ldg(weights + k);
            const int32_t t = __ldg(indices + k);
            if (wk > 0.0f && !visited(row, t)) {
                cum = __dadd_rn(cum, static_cast<double>(wk));
                nxt = t;
                if (target < cum) break;
            }
        }
        visit(row, nxt);
        cur = nxt;
    }
}

__device__ __forceinline__ bool on_path(const int32_t* path, int32_t plen,
                                        int32_t n) {
    for (int32_t i = 0; i < plen; ++i)
        if (path[i] == n) return true;
    return false;
}

__global__ void __launch_bounds__(kThreads)
g2v_walk_states_kernel(const int32_t* __restrict__ indptr,
                       const int32_t* __restrict__ indices,
                       const float* __restrict__ weights,
                       const uint8_t* __restrict__ avail, int32_t* cur,
                       uint64_t* rng, int32_t* pos, int32_t* paths,
                       uint8_t* status, int64_t n_walkers,
                       int32_t len_path) {
    const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (w >= n_walkers) return;
    int32_t* path = paths + w * len_path;
    int32_t plen = pos[w];
    int32_t c = cur[w];
    uint64_t st = rng[w];
    uint8_t suspended = 0;
    while (plen < len_path) {
        if (!__ldg(avail + c)) {  // the row of c is not held here
            suspended = 1;
            break;
        }
        const int32_t b = __ldg(indptr + c), e = __ldg(indptr + c + 1);
        int32_t m = 0;
        double total = 0.0;
        for (int32_t k = b; k < e; ++k) {
            const float wk = __ldg(weights + k);
            if (wk > 0.0f && !on_path(path, plen, __ldg(indices + k))) {
                total = __dadd_rn(total, static_cast<double>(wk));
                ++m;
            }
        }
        if (m == 0 || total <= 0.0) break;  // dead end
        const double u =
            static_cast<double>(splitmix64(st) >> 11) * 0x1.0p-53;
        const double target = __dmul_rn(u, total);
        int32_t nxt = -1;
        double cum = 0.0;
        for (int32_t k = b; k < e; ++k) {
            const float wk = __ldg(weights + k);
            const int32_t t = __ldg(indices + k);
            if (wk > 0.0f && !on_path(path, plen, t)) {
                cum = __dadd_rn(cum, static_cast<double>(wk));
                nxt = t;
                if (target < cum) break;
            }
        }
        path[plen++] = nxt;
        c = nxt;
    }
    cur[w] = c;
    rng[w] = st;
    pos[w] = plen;
    status[w] = suspended;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Preconditions, checked by the Python wrapper and its callers: indptr
// [G+1] int32 a valid CSR row-pointer array over indices/weights [E]
// (int32 in [0, G), float32); starts [n_walkers] int32 in [0, G);
// stream_ids [n_walkers] uint64; out [n_walkers, nbytes] uint8 zeroed,
// nbytes >= ceil(G/8); every pointer on the device of `stream`.
int g2v_walk_device(const void* indptr, const void* indices,
                    const void* weights, const void* starts,
                    const void* stream_ids, int64_t n_walkers,
                    int32_t len_path, uint64_t seed, void* out,
                    int64_t nbytes, void* stream) {
    if (n_walkers <= 0 || len_path <= 0) return 0;
    const unsigned blocks =
        static_cast<unsigned>((n_walkers + kThreads - 1) / kThreads);
    g2v_walk_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(indptr),
        static_cast<const int32_t*>(indices),
        static_cast<const float*>(weights),
        static_cast<const int32_t*>(starts),
        static_cast<const uint64_t*>(stream_ids), n_walkers, len_path, seed,
        static_cast<uint8_t*>(out), nbytes);
    return static_cast<int>(cudaGetLastError());
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Preconditions, checked by the Python wrapper and its callers: indptr
// [G+1] int32 a valid CSR row-pointer array over indices/weights [E]
// (int32 in [0, G), float32); avail [G] uint8; cur [n_walkers] int32 in
// [0, G); pos [n_walkers] int32 in [1, len_path]; rng [n_walkers] uint64;
// paths [n_walkers, len_path] int32 holding each walker's prefix of pos
// genes, -1 after it; status [n_walkers] uint8; every pointer on the
// device of `stream`.
int g2v_walk_states_device(const void* indptr, const void* indices,
                           const void* weights, const void* avail,
                           void* cur, void* rng, void* pos, void* paths,
                           void* status, int64_t n_walkers,
                           int32_t len_path, void* stream) {
    if (n_walkers <= 0 || len_path <= 0) return 0;
    const unsigned blocks =
        static_cast<unsigned>((n_walkers + kThreads - 1) / kThreads);
    g2v_walk_states_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(indptr),
        static_cast<const int32_t*>(indices),
        static_cast<const float*>(weights),
        static_cast<const uint8_t*>(avail), static_cast<int32_t*>(cur),
        static_cast<uint64_t*>(rng), static_cast<int32_t*>(pos),
        static_cast<int32_t*>(paths), static_cast<uint8_t*>(status),
        n_walkers, len_path);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
