// Hopper kernels for stage 3's random walks over a CSR graph: one weighted
// no-revisit walk per walker, written straight into np.packbits rows, and
// the resumable walk states of the edge partition. A group of lanes walks
// each walker.
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
// The walk (generate_randomPath, ref: G2Vec.py:328-346): from the current
// gene, the next one is drawn with probability proportional to the weight
// of its out-edge, among the edges whose weight is > 0 and whose target the
// walk has not visited; a gene with no such edge ends the walk, and so does
// len_path. Duplicate edges are separate slots. The states kernel puts the
// C++ gates before each step in their order: a full path finishes (even on
// an unavailable gene), then an unavailable gene suspends, then the scan,
// then the draw.
//
// Bit-exactness with the C++ sampler:
//   - the stream is native uint64 splitmix64: state seed ^ (sid * golden),
//     one discarded draw, then one draw per step that draws; the uniform is
//     (z >> 11) * 2^-53, exact. Every lane of a group carries the same state
//     and draws the same word;
//   - a step sums (double)weights[k] over the eligible slots strictly left
//     to right: the lanes shuffle the chunk's weights (0 for a slot that is
//     not eligible: the running sum is never -0.0, so adding +0.0 leaves it
//     unchanged) and every lane adds them in slot order, keeping the running
//     sum at its own slot. That is the C++ total and its cumbuf, double for
//     double; no tree or parallel scan, which would round otherwise;
//   - m == 0 or total <= 0 ends the walk before the draw, so a walk's stream
//     is frozen where the C++ one is;
//   - the pick is the first eligible slot whose running sum exceeds
//     target = u * total (a ballot and a find-first-set), else the last
//     eligible slot: the index the C++ binary search over its cumbuf
//     returns, from the same doubles;
//   - this file is built with -fmad=false and the sums and the draw use
//     __dadd_rn/__dmul_rn, so nothing is contracted into an FMA.
//
// What bounds them. The bytes a one-shot launch must move through device
// memory, each once, are the packed rows written, the starts and stream
// ids and the CSR: on the example (5,850 genes, out-degree at most 7, mean
// 2.2; 58,500 walkers of len_path 80 a group; a walk is 26 steps on
// average and 80 at most) 43.7 MB, about 0.013 ms at 3.35 TB/s. An advance
// of the states moves each walker's state, its prefix and its new entries.
// The kernels take many times that (PERF.md section 6): a step is a chain
// of some 200 dependent instructions (two loads, the visited test, the
// ordered float64 sum, the splitmix64 draw, ballots and shuffles), so a
// small launch (a streaming shard's walkers, an advance whose walks are
// short) lasts about its longest walk's chain, and a full launch is bound
// by the SMs' instruction issue, most of it integer work. The levers:
//   1. A group of 8 or 16 lanes walks one walker. The lanes load a row's
//      slots at once, one slot a lane, and test their visited bits at once,
//      so a step is two dependent round trips (the row's bounds, then its
//      slots) where one thread took two for every slot. A row that fits
//      the group keeps its slots and running sums in registers from the
//      sum to the pick, and each lane loads its target's row bounds (and,
//      for the states, its avail byte) beside the slot, so the next step's
//      bounds come by a shuffle. A wider row is walked in chunks of the
//      group, the running sum carried from chunk to chunk, and read again
//      for the pick. The wrapper takes 8 lanes where every row of the CSR
//      fits them and 16 where one does not: 8 ran fastest where every row
//      fits 8 slots, 16 faster than 8 on every graph with wider rows
//      (ops/device_walker_probe.py times copies of this file under 4 to 32
//      lanes; PERF.md section 6).
//   2. The groups of a warp run in lockstep: every shuffle, ballot and sync
//      takes the full warp's mask, and a group whose walker is idle or done
//      masks its work off. (With masks of a group's own lanes the groups of
//      a warp drift apart and are issued one after another.)
//   3. The visited set of a one-shot walk is a mask of ceil(G/8) bytes in
//      dynamic shared memory (bits in the packed rows' order); the group
//      zeroes it, sets a bit a step and at the end writes the row once with
//      coalesced stores. Nothing zeroes the rows beforehand and no byte of
//      device memory is read back. Where a block's masks do not fit the
//      227 KB of shared memory, the other instance keeps the mask in the
//      output row (the group zeroes it first). The states kernel tests a
//      candidate against the walker's path prefix where it lies, in
//      `paths`: a copy of the prefix in shared memory ran no faster
//      (PERF.md section 6).
//   4. The grid is as many blocks as the card holds at once (at most the
//      blocks the walkers fill). A group walks its block's own walker
//      first, then takes the next one from a counter in device memory
//      when its walk ends (one atomicAdd a walker, on the counter only: no
//      row or state is written by an atomic), so a group whose walk ended
//      early walks again instead of idling until its block's longest walk
//      ends. Rows and states depend only on their own streams, so the
//      order of the walks changes no byte.
//   5. Each lane sums a chunk's slots up to its own in an unrolled chain
//      and takes the chunk's total from the last lane by one shuffle (a
//      loop over the eligible slots alone ran slower at 16 lanes). The
//      warp's widest row is reduced across the warp only when a vote finds
//      a row wider than its group.
//   A copy of the CSR in shared memory (126 KB at the example, one block an
//   SM beside it) was built and timed: it shortens a lone walk's step, but
//   every launch measured ran as fast or faster with the CSR read through
//   the L1 cache, since a full launch is bound by issue, not loads. It was
//   left out.
//   The wrapper (ops/device_walker.py walk_plan) chooses the group from
//   the CSR's largest out-degree and where the masks live from the number
//   of genes; g2v_walk_device refuses masks in shared memory that do not
//   fit. What a launch asks of the runtime (the SMs, the blocks an SM
//   holds) is read once a device and kernel.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr uint64_t kGolden = 0x9e3779b97f4a7c15ULL;
// Lanes that walk one walker (consecutive lanes of a warp): a narrow group
// for a CSR whose rows all fit it, a wide one for any other; threads a
// block.
constexpr int kNarrow = 8;
constexpr int kWide = 16;
constexpr int kThreads = 256;
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
// Shared memory a block may use on Hopper; a walker's mask there starts on
// a 16-byte boundary (it is zeroed in 16-byte words).
constexpr int64_t kSmemLimit = 232448;
constexpr int64_t kAlign = 16;

__host__ __device__ constexpr int64_t mask_stride(int64_t nbytes) {
    return (nbytes + kAlign - 1) / kAlign * kAlign;
}

__device__ __forceinline__ uint64_t splitmix64(uint64_t& s) {
    uint64_t z = (s += kGolden);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
}

// The T consecutive lanes of a warp that walk one walker. The warp's
// 32 / T groups run in lockstep (lever 2): every lane of the warp reaches
// every shuffle, ballot and sync, with the full warp's mask.
constexpr unsigned kFull = 0xffffffffu;

template <int T>
struct Group {
    static_assert(T >= 2 && T <= 32 && (T & (T - 1)) == 0,
                  "a group is a power-of-two slice of a warp");
    static constexpr int kWalks = kThreads / T;  // walkers a block
    static constexpr unsigned kLow = T == 32 ? kFull : (1u << T) - 1u;
    unsigned rank;  // the lane within the group
    unsigned base;  // the group's first lane in the warp

    __device__ static Group make() {
        const unsigned lane = threadIdx.x & 31u;
        return {lane & (T - 1u), lane & ~(T - 1u)};
    }
    // `v` from the group's lane `src`.
    template <class V>
    __device__ V shfl(V v, int src) const {
        return __shfl_sync(kFull, v, src, T);
    }
    // The group's lanes for which `p` holds, as bits from the group's lane 0.
    __device__ unsigned ballot(bool p) const {
        return (__ballot_sync(kFull, p) >> base) & kLow;
    }
    // The largest `v` over the warp (a bound every group's loop shares).
    __device__ static int max(int v) { return __reduce_max_sync(kFull, v); }
    __device__ static bool any(bool p) { return __any_sync(kFull, p); }
    __device__ static void sync() { __syncwarp(kFull); }
};

// A row's bounds in the CSR and whether it is held here.
struct Row {
    int32_t b, e;
    bool held;
};

template <bool kAvail>
__device__ __forceinline__ Row load_row(const int32_t* indptr,
                                        const uint8_t* avail, int32_t n) {
    return {__ldg(indptr + n), __ldg(indptr + n + 1),
            !kAvail || __ldg(avail + n) != 0};
}

// One lane's slot of a chunk of a row.
struct Slot {
    int32_t t;      // target gene
    bool elig;      // weight > 0 and target not visited
    double cum;     // the row's running sum up to this slot
    Row next;       // the target's row (loaded only when `prefetch`)
    unsigned bits;  // the chunk's eligible lanes (the same in every lane)
};

// Slots [c0, c0 + T) of the row ending at e, one a lane (none when
// c0 >= e): loads and tests them, then adds the chunk's eligible weights to
// `run` in slot order (a slot that is not eligible adds +0.0, which leaves
// a sum of positive weights unchanged, or nothing), as every lane of the
// group does with the same values.
template <int T, bool kAvail, class Seen>
__device__ __forceinline__ Slot scan_chunk(
        const Group<T>& g, const int32_t* indptr, const int32_t* indices,
        const float* weights, const uint8_t* avail, int32_t c0, int32_t e,
        bool prefetch, double& run, Seen seen) {
    const int32_t k = c0 + static_cast<int32_t>(g.rank);
    Slot s{0, false, 0.0, {0, 0, false}, 0u};
    float wk = 0.0f;
    if (k < e) {
        s.t = __ldg(indices + k);
        wk = __ldg(weights + k);
        if (prefetch) s.next = load_row<kAvail>(indptr, avail, s.t);
        s.elig = wk > 0.0f && !seen(s.t);
    }
    s.bits = g.ballot(s.elig);
    // Each lane sums the slots up to its own; the last lane's sum is the
    // chunk's.
    const float mine = s.elig ? wk : 0.0f;
    float v[T];
#pragma unroll
    for (int j = 0; j < T; ++j) v[j] = g.shfl(mine, j);
    double cum = run;
#pragma unroll
    for (int j = 0; j < T; ++j)
        if (j <= static_cast<int>(g.rank))
            cum = __dadd_rn(cum, static_cast<double>(v[j]));
    s.cum = cum;
    run = g.shfl(cum, T - 1);
    return s;
}

// One step of every walking group of the warp, each from its `row`: the
// next gene, or -1 for a group that is not `walking` or whose row has no
// eligible slot (its walk ends; its stream is not drawn). Every lane of a
// group returns the same gene and leaves the same state in `st` and `row`
// (the next gene's row).
template <int T, bool kAvail, class Seen>
__device__ __forceinline__ int32_t walk_step(
        const Group<T>& g, bool walking, const int32_t* indptr,
        const int32_t* indices, const float* weights, const uint8_t* avail,
        Row& row, uint64_t& st, Seen seen) {
    const int32_t b0 = walking ? row.b : 0, e0 = walking ? row.e : 0;
    const bool one = e0 - b0 <= T;
    // The warp's widest row: T when every row fits its group (a vote), the
    // reduction's answer only when one does not.
    const int widest = Group<T>::any(!one) ? Group<T>::max(e0 - b0) : T;
    const int chunks = (widest + T - 1) / T;
    double total = 0.0;
    int32_t m = 0, last = 0;
    Slot s{0, false, 0.0, {0, 0, false}, 0u};
    for (int c = 0; c < chunks; ++c) {
        // A group whose row ended before this chunk keeps its last one's
        // slot: a row of one chunk picks from it below.
        const Slot r = scan_chunk<T, kAvail>(
            g, indptr, indices, weights, avail, b0 + c * T, e0, one, total,
            seen);
        const int hi = r.bits ? 31 - __clz(r.bits) : 0;
        const int32_t t_hi = g.shfl(r.t, hi);
        if (b0 + c * T < e0) s = r;
        if (r.bits) {
            m += __popc(r.bits);
            last = one ? hi : t_hi;  // a lane of the row, or a gene
        }
    }
    // m == 0 or total <= 0: a dead end (G2Vec.py:343-344).
    const bool draws = walking && m > 0 && total > 0.0;
    uint64_t drawn = st;
    const double u = static_cast<double>(splitmix64(drawn) >> 11) * 0x1.0p-53;
    const double target = __dmul_rn(u, total);
    if (draws) st = drawn;
    // A row of one chunk: its slots and running sums are still in registers.
    const unsigned hits = g.ballot(s.elig && target < s.cum);
    const int src = hits ? __ffs(hits) - 1 : last;
    const Row next{g.shfl(s.next.b, src), g.shfl(s.next.e, src),
                   g.shfl(static_cast<int>(s.next.held), src) != 0};
    int32_t nxt = g.shfl(s.t, src);
    // A wider row: pass 2 recomputes the same running sums chunk by chunk.
    const bool wide = draws && !one;
    if (Group<T>::any(wide)) {
        bool found = false;
        double cum = 0.0;
        int32_t pick = last;
        for (int c = 0; c < chunks && Group<T>::any(wide && !found); ++c) {
            const Slot r = scan_chunk<T, kAvail>(
                g, indptr, indices, weights, avail, b0 + c * T,
                wide ? e0 : 0, false, cum, seen);
            const unsigned h = g.ballot(r.elig && target < r.cum);
            const int32_t t_h = g.shfl(r.t, h ? __ffs(h) - 1 : 0);
            if (wide && !found && h) {
                pick = t_h;
                found = true;
            }
        }
        if (wide) {
            nxt = pick;
            row = load_row<kAvail>(indptr, avail, pick);
        }
    }
    if (!draws) return -1;
    if (one) row = next;
    return nxt;
}

// Zero n bytes at p (aligned to the widest word that divides n) with the
// group's lanes, where `on`; every lane of the warp takes the same trips.
template <class V, int T>
__device__ __forceinline__ void zero_words(const Group<T>& g, bool on,
                                           uint8_t* p, int64_t n) {
    V* q = reinterpret_cast<V*>(p);
    for (int64_t i = g.rank; i < n / int64_t(sizeof(V)); i += T)
        if (on) q[i] = V{};
}

template <int T>
__device__ __forceinline__ void zero_bytes(const Group<T>& g, bool on,
                                           uint8_t* p, int64_t n) {
    if (n % 16 == 0) zero_words<uint4>(g, on, p, n);
    else if (n % 8 == 0) zero_words<uint2>(g, on, p, n);
    else if (n % 4 == 0) zero_words<uint32_t>(g, on, p, n);
    else zero_words<uint8_t>(g, on, p, n);
}

template <class V, int T>
__device__ __forceinline__ void copy_words(const Group<T>& g, bool on,
                                           uint8_t* dst, const uint8_t* src,
                                           int64_t n) {
    V* d = reinterpret_cast<V*>(dst);
    const V* s = reinterpret_cast<const V*>(src);
    for (int64_t i = g.rank; i < n / int64_t(sizeof(V)); i += T)
        if (on) d[i] = s[i];
}

// Copy n bytes from the 16-byte aligned mask to a row aligned to the
// widest word that divides n, where `on`.
template <int T>
__device__ __forceinline__ void copy_bytes(const Group<T>& g, bool on,
                                           uint8_t* dst, const uint8_t* src,
                                           int64_t n) {
    if (n % 16 == 0) copy_words<uint4>(g, on, dst, src, n);
    else if (n % 8 == 0) copy_words<uint2>(g, on, dst, src, n);
    else if (n % 4 == 0) copy_words<uint32_t>(g, on, dst, src, n);
    else copy_words<uint8_t>(g, on, dst, src, n);
}

__device__ __forceinline__ void set_bit(uint8_t* mask, int32_t n) {
    mask[n >> 3] |= static_cast<uint8_t>(0x80u >> (n & 7));
}

// The next walker of a group whose walker ended (`ended`): after the
// grid's own walkers (one a group), the next one the counter `next` hands
// out, until none is left (then n_walkers). Other groups keep `w`.
template <int T>
__device__ __forceinline__ int64_t next_walker(const Group<T>& g, bool ended,
                                               int64_t w,
                                               unsigned long long* next,
                                               int64_t n_walkers) {
    const int64_t handed =
        static_cast<int64_t>(gridDim.x) * Group<T>::kWalks;
    unsigned long long got = 0;
    if (ended && g.rank == 0 && handed < n_walkers)
        got = atomicAdd(next, 1ULL);
    got = g.shfl(got, 0);
    if (!ended) return w;
    return handed < n_walkers ? handed + static_cast<int64_t>(got)
                              : n_walkers;
}

// g2v_walk_kernel: every group walks its walkers one after the other, in
// lockstep with the other groups of its warp, one step each a trip. The
// visited masks live in shared memory (kShared) or in the rows.
template <int T, bool kShared>
__global__ void __launch_bounds__(kThreads)
g2v_walk_kernel(const int32_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const float* __restrict__ weights,
                const int32_t* __restrict__ starts,
                const uint64_t* __restrict__ stream_ids, int64_t n_walkers,
                int32_t len_path, uint64_t seed, uint8_t* out,
                int64_t nbytes, unsigned long long* next) {
    extern __shared__ __align__(16) uint8_t smem[];
    const Group<T> g = Group<T>::make();
    const int64_t slot = threadIdx.x / T;
    const int64_t stride = mask_stride(nbytes);
    int64_t w =
        static_cast<int64_t>(blockIdx.x) * Group<T>::kWalks + slot;
    bool live = w < n_walkers, fresh = live;
    uint8_t* mask = smem + slot * stride;
    uint64_t st = 0;
    Row row{0, 0, false};
    int32_t len = 0;  // genes on the walk so far
    while (Group<T>::any(live)) {
        if (Group<T>::any(fresh)) {  // groups that start a walker
            if (!kShared && fresh) mask = out + w * nbytes;
            zero_bytes(g, fresh, mask, kShared ? stride : nbytes);
            Group<T>::sync();
            if (fresh) {
                st = seed ^ (__ldg(stream_ids + w) * kGolden);
                splitmix64(st);  // decorrelate nearby stream ids, as
                                 // walk_range does
                const int32_t start = __ldg(starts + w);
                row = load_row<false>(indptr, nullptr, start);
                if (g.rank == 0) set_bit(mask, start);
                len = 1;
            }
            Group<T>::sync();
        }
        const bool walking = live && len < len_path;
        const auto seen = [mask](int32_t t) {
            return ((mask[t >> 3] >> (7 - (t & 7))) & 1u) != 0;
        };
        const int32_t nxt = walk_step<T, false>(
            g, walking, indptr, indices, weights, nullptr, row, st, seen);
        if (nxt >= 0) {
            if (g.rank == 0) set_bit(mask, nxt);
            ++len;
        }
        Group<T>::sync();
        const bool ended = live && (nxt < 0 || len == len_path);
        fresh = false;
        if (Group<T>::any(ended)) {
            if (kShared) copy_bytes(g, ended, out + w * nbytes, mask, nbytes);
            Group<T>::sync();  // the set is zeroed again for the next walker
            w = next_walker(g, ended, w, next, n_walkers);
            if (ended) {
                live = w < n_walkers;
                fresh = live;
            }
        }
    }
}

// g2v_walk_states_kernel: every group advances its walkers one after the
// other, in lockstep with the other groups of its warp. A walker's visited
// set is its prefix in `paths`.
template <int T>
__global__ void __launch_bounds__(kThreads)
g2v_walk_states_kernel(const int32_t* __restrict__ indptr,
                       const int32_t* __restrict__ indices,
                       const float* __restrict__ weights,
                       const uint8_t* __restrict__ avail, int32_t* cur,
                       uint64_t* rng, int32_t* pos, int32_t* paths,
                       uint8_t* status, int64_t n_walkers, int32_t len_path,
                       unsigned long long* next) {
    const Group<T> g = Group<T>::make();
    int64_t w = static_cast<int64_t>(blockIdx.x) * Group<T>::kWalks +
                threadIdx.x / T;
    bool live = w < n_walkers, fresh = live;
    const int32_t* path = paths;
    int32_t plen = 0, c = 0;
    uint64_t st = 0;
    Row row{0, 0, false};
    while (Group<T>::any(live)) {
        if (fresh) {  // a group that takes up a walker
            plen = pos[w];
            c = cur[w];
            st = rng[w];
            row = load_row<true>(indptr, avail, c);
            path = paths + w * len_path;
        }
        // The C++ gates in their order: a full path finishes, then an
        // unavailable gene suspends, then the scan and the draw.
        const bool full = plen >= len_path;
        const bool suspend = live && !full && !row.held;
        const bool walking = live && !full && row.held;
        const auto seen = [path, plen](int32_t t) {
            for (int32_t i = 0; i < plen; ++i)
                if (path[i] == t) return true;
            return false;
        };
        const int32_t nxt = walk_step<T, true>(
            g, walking, indptr, indices, weights, avail, row, st, seen);
        if (nxt >= 0) {
            if (g.rank == 0) paths[w * len_path + plen] = nxt;
            ++plen;
            c = nxt;
        }
        Group<T>::sync();
        const bool ended = live && (full || suspend || (walking && nxt < 0));
        fresh = false;
        if (Group<T>::any(ended)) {
            if (ended && g.rank == 0) {
                cur[w] = c;
                rng[w] = st;
                pos[w] = plen;
                status[w] = suspend ? 1 : 0;
            }
            w = next_walker(g, ended, w, next, n_walkers);
            if (ended) {
                live = w < n_walkers;
                fresh = live;
            }
        }
    }
}

// What a launch reads of the runtime once a device and kernel: the SMs,
// and the blocks of the kernel that one SM holds with the dynamic shared
// memory of the last launch (a run asks for one size).
constexpr int kMaxDevices = 64;
struct Fit {
    int sms = 0;
    int64_t smem = -1;
    int per_sm = 0;
};
std::mutex fit_mutex;

// The grid in `blocks`: the blocks that `walks` walkers a block fill, at
// most as many as the card holds at once (the groups then take the
// remaining walkers from the counter). The first launch of a kernel on a
// device raises its dynamic shared memory limit to kSmemLimit.
template <class K>
cudaError_t grid_for(K kernel, Fit* fits, int64_t smem, int64_t n_walkers,
                     int walks, unsigned* blocks) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(fit_mutex);
    Fit& f = fits[dev];
    if (f.sms == 0) {
        int sms = 0;
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(kSmemLimit));
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
        if (err != cudaSuccess) return err;
        f.sms = sms;
    }
    if (f.smem != smem) {
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kThreads, static_cast<size_t>(smem));
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        f.per_sm = per_sm;
        f.smem = smem;
    }
    const int64_t fill = (n_walkers + walks - 1) / walks;
    const int64_t resident = static_cast<int64_t>(f.per_sm) * f.sms;
    *blocks = static_cast<unsigned>(fill < resident ? fill : resident);
    return cudaSuccess;
}

// Zero the walker counter on `stream` where the grid leaves walkers to it.
cudaError_t arm_counter(unsigned blocks, int walks, int64_t n_walkers,
                        unsigned long long* next, cudaStream_t stream) {
    if (static_cast<int64_t>(blocks) * walks >= n_walkers) return cudaSuccess;
    return cudaMemsetAsync(next, 0, sizeof(*next), stream);
}

struct WalkArgs {
    const int32_t* indptr;
    const int32_t* indices;
    const float* weights;
    const int32_t* starts;
    const uint64_t* stream_ids;
    int64_t n_walkers;
    int32_t len_path;
    uint64_t seed;
    uint8_t* out;
    int64_t nbytes;
};

struct StatesArgs {
    const int32_t* indptr;
    const int32_t* indices;
    const float* weights;
    const uint8_t* avail;
    int32_t* cur;
    uint64_t* rng;
    int32_t* pos;
    int32_t* paths;
    uint8_t* status;
    int64_t n_walkers;
    int32_t len_path;
};

template <int T, bool kShared>
cudaError_t launch(const WalkArgs& a, unsigned long long* next,
                   cudaStream_t stream) {
    static Fit fits[kMaxDevices];
    constexpr int walks = Group<T>::kWalks;
    const auto kernel = g2v_walk_kernel<T, kShared>;
    const int64_t smem = kShared ? walks * mask_stride(a.nbytes) : 0;
    unsigned blocks = 0;
    cudaError_t err = grid_for(kernel, fits, smem, a.n_walkers, walks,
                               &blocks);
    if (err == cudaSuccess)
        err = arm_counter(blocks, walks, a.n_walkers, next, stream);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, stream>>>(
        a.indptr, a.indices, a.weights, a.starts, a.stream_ids, a.n_walkers,
        a.len_path, a.seed, a.out, a.nbytes, next);
    return cudaGetLastError();
}

template <int T>
cudaError_t launch(const StatesArgs& a, unsigned long long* next,
                   cudaStream_t stream) {
    static Fit fits[kMaxDevices];
    constexpr int walks = Group<T>::kWalks;
    const auto kernel = g2v_walk_states_kernel<T>;
    unsigned blocks = 0;
    cudaError_t err = grid_for(kernel, fits, 0, a.n_walkers, walks, &blocks);
    if (err == cudaSuccess)
        err = arm_counter(blocks, walks, a.n_walkers, next, stream);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, 0, stream>>>(
        a.indptr, a.indices, a.weights, a.avail, a.cur, a.rng, a.pos,
        a.paths, a.status, a.n_walkers, a.len_path, next);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue where `shared` asks for masks in shared memory
// that a block's walkers do not fit. Preconditions, checked by the Python
// wrapper and its callers: indptr [G+1] int32 a valid CSR row-pointer array
// over indices/weights [E] (int32 in [0, G), float32); starts [n_walkers]
// int32 in [0, G); stream_ids [n_walkers] uint64; out [n_walkers, nbytes]
// uint8 (any contents, every byte is written), 16-byte aligned, nbytes =
// ceil(G/8); every pointer on the device of `stream`. `wide`: the wide
// group walks each walker (1) or the narrow one (0); `shared`: the visited
// masks in shared memory (1) or in the rows (0). `next`: one uint64 of
// device memory for the counter of the walkers handed out after the
// grid's own (zeroed on `stream` when the grid leaves any to it).
int g2v_walk_device(const void* indptr, const void* indices,
                    const void* weights, const void* starts,
                    const void* stream_ids, int64_t n_walkers,
                    int32_t len_path, uint64_t seed, void* out,
                    int64_t nbytes, int wide, int shared, void* next,
                    void* stream) {
    const int walks = kThreads / (wide ? kWide : kNarrow);
    if (shared && walks * mask_stride(nbytes) > kSmemLimit)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_walkers <= 0 || len_path <= 0) return 0;
    const WalkArgs a{static_cast<const int32_t*>(indptr),
                     static_cast<const int32_t*>(indices),
                     static_cast<const float*>(weights),
                     static_cast<const int32_t*>(starts),
                     static_cast<const uint64_t*>(stream_ids),
                     n_walkers,
                     len_path,
                     seed,
                     static_cast<uint8_t*>(out),
                     nbytes};
    auto* counter = static_cast<unsigned long long*>(next);
    const auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        wide ? (shared ? launch<kWide, true>(a, counter, s)
                       : launch<kWide, false>(a, counter, s))
             : (shared ? launch<kNarrow, true>(a, counter, s)
                       : launch<kNarrow, false>(a, counter, s));
    return static_cast<int>(err);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Preconditions, checked by the Python wrapper and its callers: indptr
// [G+1] int32 a valid CSR row-pointer array over indices/weights [E]
// (int32 in [0, G), float32); avail [G] uint8; cur [n_walkers] int32 in
// [0, G); pos [n_walkers] int32 in [1, len_path]; rng [n_walkers] uint64;
// paths [n_walkers, len_path] int32 holding each walker's prefix of pos
// genes, -1 after it; status [n_walkers] uint8; every pointer on the
// device of `stream`. `wide` and `next` as for g2v_walk_device.
int g2v_walk_states_device(const void* indptr, const void* indices,
                           const void* weights, const void* avail, void* cur,
                           void* rng, void* pos, void* paths, void* status,
                           int64_t n_walkers, int32_t len_path, int wide,
                           void* next, void* stream) {
    if (n_walkers <= 0 || len_path <= 0) return 0;
    const StatesArgs a{static_cast<const int32_t*>(indptr),
                       static_cast<const int32_t*>(indices),
                       static_cast<const float*>(weights),
                       static_cast<const uint8_t*>(avail),
                       static_cast<int32_t*>(cur),
                       static_cast<uint64_t*>(rng),
                       static_cast<int32_t*>(pos),
                       static_cast<int32_t*>(paths),
                       static_cast<uint8_t*>(status),
                       n_walkers,
                       len_path};
    auto* counter = static_cast<unsigned long long*>(next);
    const auto s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(wide ? launch<kWide>(a, counter, s)
                                 : launch<kNarrow>(a, counter, s));
}

}  // extern "C"
