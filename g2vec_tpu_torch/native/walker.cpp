// Native CPU random-walk sampler of the port: the packed walk of
// g2vec_tpu/native/walker.cpp, step for step, so that the same CSR, walk
// parameters and seed give byte-identical packed rows in both packages.
//
// Reference semantics (generate_randomPath, ref: G2Vec.py:328-346):
// weighted no-revisit walks of at most len_path nodes, Categorical over the
// current node's positive out-edge weights restricted to unvisited targets,
// early stop at dead ends. Each step is an O(out_degree) two-pass scan
// (mass total, then inverse-CDF pick by binary search over the eligible
// neighbours' running sums) with an O(1)-membership visited byte mask that
// is wiped by path replay after each walk.
//
// Threading: walkers split into contiguous ranges over n_threads OS
// threads. Every walker draws from its own splitmix64 stream keyed by
// (seed, stream_id), so results are bit-identical for any thread count.
//
// Resumable walks (the edge partition, g2vec_tpu/native/walker.cpp
// :146-253, 279-330): a walker's state is explicit (current gene, raw
// splitmix64 state, path prefix), so a walk can stop where its current
// gene's row is not held here and go on, bit for bit, where it is.
//
// Exposed flat-C so ctypes can load it.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t& s) {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
}

// 53-bit mantissa uniform in [0, 1).
inline double uniform01(uint64_t& s) {
    return static_cast<double>(splitmix64(s) >> 11) * 0x1.0p-53;
}

// Writes [nbytes] np.packbits-layout multi-hot rows (MSB of byte 0 =
// gene 0) for walkers [lo, hi).
void walk_range(const int32_t* indptr, const int32_t* indices,
                const float* weights, int32_t n_genes, const int32_t* starts,
                const uint64_t* stream_ids, int32_t len_path, uint64_t seed,
                uint8_t* out_packed, int64_t nbytes, int64_t max_degree,
                int64_t lo, int64_t hi) {
    std::vector<uint8_t> visited(static_cast<size_t>(n_genes), 0);
    std::vector<int32_t> path(static_cast<size_t>(len_path));
    // Eligible-neighbour compaction, sized by the maximum row degree
    // (duplicate edges are legal and each occupies its own slot).
    std::vector<double> cumbuf(static_cast<size_t>(max_degree));
    std::vector<int32_t> idxbuf(static_cast<size_t>(max_degree));
    for (int64_t w = lo; w < hi; ++w) {
        std::fill(path.begin(), path.end(), -1);
        uint64_t st = seed ^ (stream_ids[w] * 0x9e3779b97f4a7c15ULL);
        splitmix64(st);  // decorrelate nearby stream ids
        int32_t cur = starts[w];
        path[0] = cur;
        visited[cur] = 1;
        int32_t plen = 1;
        for (int32_t step = 1; step < len_path; ++step) {
            const int32_t b = indptr[cur], e = indptr[cur + 1];
            int32_t m = 0;
            double total = 0.0;
            for (int32_t k = b; k < e; ++k) {
                const int32_t t = indices[k];
                if (!visited[t] && weights[k] > 0.0f) {
                    total += weights[k];
                    cumbuf[m] = total;
                    idxbuf[m] = t;
                    ++m;
                }
            }
            if (m == 0 || total <= 0.0) break;  // dead end (G2Vec.py:343-344)
            const double target = uniform01(st) * total;
            // Smallest j with target < cumbuf[j]; target == total after
            // rounding falls through to the last eligible neighbour.
            int32_t lo_j = 0, hi_j = m;
            while (lo_j < hi_j) {
                const int32_t mid = lo_j + ((hi_j - lo_j) >> 1);
                if (target < cumbuf[mid]) hi_j = mid;
                else lo_j = mid + 1;
            }
            const int32_t nxt = idxbuf[lo_j < m ? lo_j : m - 1];
            path[plen++] = nxt;
            visited[nxt] = 1;
            cur = nxt;
        }
        uint8_t* row = out_packed + w * nbytes;
        std::fill(row, row + nbytes, 0);
        for (int32_t i = 0; i < plen; ++i) {
            const int32_t n = path[i];
            row[n >> 3] |= static_cast<uint8_t>(0x80u >> (n & 7));
        }
        for (int32_t i = 0; i < plen; ++i) visited[path[i]] = 0;
    }
}

// Resumable walks over an availability-masked CSR. Each walker carries
// explicit state: its current gene, its raw splitmix64 state and the path
// prefix taken so far (the visited mask is rebuilt from the prefix). The
// step body is a literal copy of walk_range's: the same eligible scan, the
// same running sums in the same order, one uniform01 draw a step, so a
// walk draws the same sequence wherever, and in however many pieces, it
// runs. The gates come in walk_range's order: the length, then the row's
// availability (avail[c] == 0 suspends: the rank holding c's row resumes
// it), then the scan, then the draw. A walker whose path is full finishes
// even on an unavailable gene; a suspended or dead-ended walker keeps its
// stream where it stopped.
void walk_partial_range(const int32_t* indptr, const int32_t* indices,
                        const float* weights, int32_t n_genes,
                        const uint8_t* avail, int32_t* cur, uint64_t* rng,
                        int32_t* pos, int32_t* paths, int32_t len_path,
                        uint8_t* status, int64_t max_degree, int64_t lo,
                        int64_t hi) {
    std::vector<uint8_t> visited(static_cast<size_t>(n_genes), 0);
    std::vector<double> cumbuf(static_cast<size_t>(max_degree));
    std::vector<int32_t> idxbuf(static_cast<size_t>(max_degree));
    for (int64_t w = lo; w < hi; ++w) {
        int32_t* path = paths + w * len_path;
        int32_t plen = pos[w];
        for (int32_t i = 0; i < plen; ++i) visited[path[i]] = 1;
        int32_t c = cur[w];
        uint64_t st = rng[w];
        uint8_t suspended = 0;
        while (plen < len_path) {
            if (!avail[c]) {  // the row of c is not held here
                suspended = 1;
                break;
            }
            const int32_t b = indptr[c], e = indptr[c + 1];
            int32_t m = 0;
            double total = 0.0;
            for (int32_t k = b; k < e; ++k) {
                const int32_t t = indices[k];
                if (!visited[t] && weights[k] > 0.0f) {
                    total += weights[k];
                    cumbuf[m] = total;
                    idxbuf[m] = t;
                    ++m;
                }
            }
            if (m == 0 || total <= 0.0) break;  // dead end
            const double target = uniform01(st) * total;
            int32_t lo_j = 0, hi_j = m;
            while (lo_j < hi_j) {
                const int32_t mid = lo_j + ((hi_j - lo_j) >> 1);
                if (target < cumbuf[mid]) hi_j = mid;
                else lo_j = mid + 1;
            }
            const int32_t nxt = idxbuf[lo_j < m ? lo_j : m - 1];
            path[plen++] = nxt;
            visited[nxt] = 1;
            c = nxt;
        }
        cur[w] = c;
        rng[w] = st;
        pos[w] = plen;
        status[w] = suspended;
        for (int32_t i = 0; i < plen; ++i) visited[path[i]] = 0;
    }
}

int32_t resolve_threads(int32_t n_threads, int64_t n_walkers) {
    if (n_threads <= 0) {
        unsigned hw = std::thread::hardware_concurrency();
        n_threads = hw ? static_cast<int32_t>(hw) : 1;
    }
    return static_cast<int32_t>(std::min<int64_t>(n_threads, n_walkers));
}

int64_t max_row_degree(const int32_t* indptr, int32_t n_genes) {
    int64_t max_degree = 1;
    for (int32_t g = 0; g < n_genes; ++g)
        max_degree = std::max<int64_t>(max_degree, indptr[g + 1] - indptr[g]);
    return max_degree;
}

}  // namespace

extern "C" {

// out must hold n_walkers * nbytes uint8 (nbytes = ceil(n_genes/8)).
void g2v_walk_packed(const int32_t* indptr, const int32_t* indices,
                     const float* weights, int32_t n_genes,
                     const int32_t* starts, const uint64_t* stream_ids,
                     int64_t n_walkers, int32_t len_path, uint64_t seed,
                     int32_t n_threads, uint8_t* out, int64_t nbytes) {
    if (len_path <= 0 || n_walkers <= 0) return;
    const int64_t max_degree = max_row_degree(indptr, n_genes);
    n_threads = resolve_threads(n_threads, n_walkers);
    const int64_t chunk = (n_walkers + n_threads - 1) / n_threads;
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min<int64_t>(lo + chunk, n_walkers);
        if (lo >= hi) break;
        pool.emplace_back(walk_range, indptr, indices, weights, n_genes,
                          starts, stream_ids, len_path, seed, out, nbytes,
                          max_degree, lo, hi);
    }
    for (auto& th : pool) th.join();
}

// A walker's first state, as walk_range seeds it: seed ^ (stream_id *
// golden), then one discarded splitmix64 output. Resumed from this state,
// g2v_walk_partial draws the stream g2v_walk_packed would have drawn.
void g2v_init_walk_state(uint64_t seed, const uint64_t* stream_ids,
                         int64_t n, uint64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        uint64_t st = seed ^ (stream_ids[i] * 0x9e3779b97f4a7c15ULL);
        splitmix64(st);
        out[i] = st;
    }
}

// Runs or resumes walks with explicit state over an availability-masked
// CSR. cur/rng/pos/paths ([n_walkers], [n_walkers, len_path]) are in-out;
// status[w] is 1 when walker w suspended on a gene whose row is not held
// (avail 0; cur[w] names it), 0 when it finished (full length or dead
// end). Rows with avail 0 may be empty: they are never scanned.
void g2v_walk_partial(const int32_t* indptr, const int32_t* indices,
                      const float* weights, int32_t n_genes,
                      const uint8_t* avail, int32_t* cur, uint64_t* rng,
                      int32_t* pos, int32_t* paths, int64_t n_walkers,
                      int32_t len_path, int32_t n_threads, uint8_t* status) {
    if (len_path <= 0 || n_walkers <= 0) return;
    const int64_t max_degree = max_row_degree(indptr, n_genes);
    n_threads = resolve_threads(n_threads, n_walkers);
    const int64_t chunk = (n_walkers + n_threads - 1) / n_threads;
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min<int64_t>(lo + chunk, n_walkers);
        if (lo >= hi) break;
        pool.emplace_back(walk_partial_range, indptr, indices, weights,
                          n_genes, avail, cur, rng, pos, paths, len_path,
                          status, max_degree, lo, hi);
    }
    for (auto& th : pool) th.join();
}

// Packs finished [n_rows, len_path] paths (-1 after the end) into
// np.packbits rows, the encoding g2v_walk_packed writes: the shard owner
// assembles walks finished elsewhere without a [W, G] bool matrix.
void g2v_pack_paths(const int32_t* paths, int64_t n_rows, int32_t len_path,
                    uint8_t* out, int64_t nbytes) {
    for (int64_t r = 0; r < n_rows; ++r) {
        const int32_t* path = paths + r * len_path;
        uint8_t* row = out + r * nbytes;
        std::fill(row, row + nbytes, 0);
        for (int32_t i = 0; i < len_path; ++i) {
            const int32_t n = path[i];
            if (n < 0) break;
            row[n >> 3] |= static_cast<uint8_t>(0x80u >> (n & 7));
        }
    }
}

}  // extern "C"
