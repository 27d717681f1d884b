// K2 and K3: the port's point-cloud searches, hand-written for Hopper
// (sm_90a). Built at first use by kernels/pointcloud.py with nvcc into a
// shared library with a plain C interface, loaded with ctypes.
//
// No Pallas kernel stands behind either. They replace the JAX package's
// host C++ (native/pointcloud.cpp::knn_mean_dist, :67-127, and
// ::nearest_index, :136-235), whose search ran on one host thread.
//
// K2, knn_mean_dist: each point's mean distance to its k nearest
// neighbours under the native search's ring rule (kernels/pointcloud.py
// says what it is). The rule makes the candidates a property of the cell:
// every point of a cell looks at the points of the same cube of cells. So
// a block takes up to KNN_THREADS points of one cell, one a thread, and
// streams the cube's points through shared memory once for all of them,
// N-body style. A cell of many points gets many blocks, so a few dense
// cells, which made the host search quadratic on one thread, spread over
// the SMs. The cube is walked in passes of KNN_PASS cells: the block's
// threads look the cells up in the sorted key table (a binary search
// each), scan their counts in shared memory, then load the pass's points
// tile by tile. Bound: the squared distances, 8 float operations a pair
// (3 differences, 3 products, 2 sums), against the card's float32 rate; a
// pair also costs a compare against the current k-th smallest.
//
// Each thread keeps the k + 1 smallest squared distances it has seen, its
// own 0 included (a duplicate's 0 is as good: one 0 is dropped at the end),
// in registers: a right-aligned ascending list of KMAX slots, -inf below
// it, so the k-th smallest sits in the last slot at a static index and an
// insertion is 2 * KMAX min/max operations with no dynamic indexing. The
// square roots of the k smallest are summed in ascending order, as the C
// code sums them. Where k + 1 > 32 the list is the point's row of k + 1
// floats in global scratch instead, kept sorted by insertion: slower, and
// the same values.
//
// K3, nearest_index: exact nearest reference point of each query, over a
// dense grid of the reference points (kernels/pointcloud.py: nearest_prepare
// sorts them by cell; cell_first[c]..cell_first[c + 1] are cell c's). One
// thread a query walks shells of cells of growing Chebyshev radius r around
// its cell, clipped to the grid, as the native search walks its hash. A
// row of cells along z is one run of sorted points, so a shell is a few
// runs, not a hash lookup a cell. After shell r every point within the
// cube of radius r is seen, and any other lies more than r cells away:
// cells are floor(p * inv) with the product taken exactly in double, so
// (x' - x) * inv > r holds exactly. The walk stops once the best squared
// distance is below (r / inv)^2 by more than the float32 rounding of a
// squared distance (NN_MARGIN), so no point left unseen can even tie. A
// query beyond NN_FAR cells of the grid scans every point. Among equal
// squared distances the lowest original index wins. Bound: its bytes, or
// the pairs it evaluates (counted on request) at 8 float operations each.
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn), as the plain versions round them, so nothing contracts into
// an FMA and the kernels equal the plain versions bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int KNN_THREADS = 128;   // kernels/pointcloud.py: KNN_THREADS
constexpr int KNN_PASS = 1024;     // cube cells looked up a pass
constexpr int KNN_PER = KNN_PASS / KNN_THREADS;
constexpr int NN_THREADS = 128;
constexpr double NN_FAR = 268435456.0;   // 2^28 cells: int arithmetic stays exact
constexpr double NN_MARGIN = 1e-5;       // far above 5 float32 roundings (3e-7)

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float dist2(float4 a, float4 b) {
    const float dx = __fsub_rn(a.x, b.x);
    const float dy = __fsub_rn(a.y, b.y);
    const float dz = __fsub_rn(a.z, b.z);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Index of `key` in the ascending table, or -1.
__device__ __forceinline__ int find_cell(const long long* __restrict__ keys, int n,
                                         long long key) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[mid] < key) lo = mid + 1;
        else hi = mid;
    }
    return (lo < n && keys[lo] == key) ? lo : -1;
}

// KMAX > 0: the list in registers. KMAX == 0: k + 1 > 32, the list is the
// point's row of k + 1 floats in `wide` (global memory), kept by insertion.
template <int KMAX>
__global__ void __launch_bounds__(KNN_THREADS)
knn_mean_dist_kernel(const float4* __restrict__ pts, const long long* __restrict__ cell_key,
                     const int* __restrict__ cell_start, const int* __restrict__ cell_count,
                     const int* __restrict__ cell_ring, int n_cells,
                     const int* __restrict__ item_cell, const int* __restrict__ item_first,
                     long long step_x, long long step_y, int k, float* __restrict__ wide,
                     float* __restrict__ out) {
    __shared__ float4 tile[KNN_THREADS];
    __shared__ int nb_start[KNN_PASS];   // first point of each cube cell of the pass
    __shared__ int nb_end[KNN_PASS];     // inclusive scan of the cells' counts
    __shared__ int warp_sum[KNN_THREADS / 32];

    const int c = item_cell[blockIdx.x];
    const int q = item_first[blockIdx.x] + threadIdx.x;
    const bool active = q < cell_count[c];
    const int self = cell_start[c] + q;
    const float4 p = active ? pts[self] : make_float4(0.f, 0.f, 0.f, 0.f);
    const long long key = cell_key[c];
    const int R = cell_ring[c];
    const int side = 2 * R + 1;
    const int n_off = side * side * side;

    constexpr int SLOTS = KMAX > 0 ? KMAX : 1;
    float best[SLOTS];
    float* row = nullptr;
    if constexpr (KMAX > 0) {
#pragma unroll
        for (int j = 0; j < KMAX; ++j) best[j] = j < KMAX - (k + 1) ? -inf_f() : inf_f();
    } else if (active) {
        row = wide + static_cast<long long>(self) * (k + 1);
        for (int j = 0; j <= k; ++j) row[j] = inf_f();
    }
    int n_cand = 0;   // points in the cube, this thread's own included

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int base = 0; base < n_off; base += KNN_PASS) {
        // 1. this pass's cube cells, KNN_PER consecutive offsets a thread
        int st[KNN_PER], end[KNN_PER];
        int run = 0;
#pragma unroll
        for (int j = 0; j < KNN_PER; ++j) {
            const int o = base + threadIdx.x * KNN_PER + j;
            int s = 0, t = 0;
            if (o < n_off) {
                const int ix = o / (side * side), iy = (o / side) % side, iz = o % side;
                const int f = find_cell(cell_key, n_cells,
                                        key + (ix - R) * step_x + (iy - R) * step_y + (iz - R));
                if (f >= 0) {
                    s = cell_start[f];
                    t = cell_count[f];
                }
            }
            run += t;
            st[j] = s;
            end[j] = run;
        }
        // 2. the block's scan of the counts
        int incl = run;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += v;
        }
        if (lane == 31) warp_sum[warp] = incl;
        __syncthreads();
        int before = incl - run, total = 0;
#pragma unroll
        for (int w = 0; w < KNN_THREADS / 32; ++w) {
            before += w < warp ? warp_sum[w] : 0;
            total += warp_sum[w];
        }
#pragma unroll
        for (int j = 0; j < KNN_PER; ++j) {
            nb_start[threadIdx.x * KNN_PER + j] = st[j];
            nb_end[threadIdx.x * KNN_PER + j] = before + end[j];
        }
        __syncthreads();
        // 3. the pass's points through shared memory, a tile at a time
        for (int t0 = 0; t0 < total; t0 += KNN_THREADS) {
            const int e = t0 + threadIdx.x;
            if (e < total) {
                int lo = 0, hi = KNN_PASS - 1;   // the first cell whose end exceeds e
                while (lo < hi) {
                    const int mid = (lo + hi) >> 1;
                    if (nb_end[mid] > e) hi = mid;
                    else lo = mid + 1;
                }
                tile[threadIdx.x] = pts[nb_start[lo] + e - (lo ? nb_end[lo - 1] : 0)];
            }
            __syncthreads();
            const int lim = min(KNN_THREADS, total - t0);
            if (active) {
                for (int t = 0; t < lim; ++t) {
                    const float d = dist2(p, tile[t]);
                    if constexpr (KMAX > 0) {
                        if (d < best[KMAX - 1]) {
                            // drop the largest, insert d: new[j] = max(old[j-1], min(old[j], d))
#pragma unroll
                            for (int j = KMAX - 1; j > 0; --j)
                                best[j] = fmaxf(best[j - 1], fminf(best[j], d));
                            best[0] = fminf(best[0], d);
                        }
                    } else if (d < row[k]) {
                        int j = k;
                        for (; j > 0 && row[j - 1] > d; --j) row[j] = row[j - 1];
                        row[j] = d;
                    }
                }
            }
            __syncthreads();
        }
        n_cand += total;
    }
    if (!active) return;
    // the list's first slot holds one 0 (the point's own); the k after it, ascending
    const int kk = min(k, n_cand - 1);
    float s = 0.f;
    if constexpr (KMAX > 0) {
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
            if (j >= KMAX - k && j < KMAX - k + kk) s = __fadd_rn(s, __fsqrt_rn(best[j]));
    } else {
        for (int j = 1; j <= kk; ++j) s = __fadd_rn(s, __fsqrt_rn(row[j]));
    }
    out[self] = kk > 0 ? __fdiv_rn(s, static_cast<float>(kk)) : 0.f;
}

struct NnGrid {
    const float4* __restrict__ ref;       // reference points sorted by cell
    const int* __restrict__ ref_id;       // their original indices
    const int* __restrict__ cell_first;   // (cells + 1,) first sorted point of each cell
    int sx, sy, sz;                       // the grid's cells along x, y, z
};

struct NnBest {
    float d2;         // the best squared distance so far
    int arg;          // its point's original index
    long long pairs;  // pairs evaluated
};

__device__ __forceinline__ void nn_run(const NnGrid& g, float4 q, int a, int b, NnBest& best) {
    for (int j = a; j < b; ++j) {
        const float d = dist2(q, g.ref[j]);
        const int id = g.ref_id[j];
        if (d < best.d2 || (d == best.d2 && id < best.arg)) {
            best.d2 = d;
            best.arg = id;
        }
    }
    best.pairs += b - a;
}

// The cells (x, y, z0..z1) clipped to the grid: one run of sorted points.
__device__ __forceinline__ void nn_row(const NnGrid& g, float4 q, int x, int y, int z0, int z1,
                                       NnBest& best) {
    if (x < 0 || x >= g.sx || y < 0 || y >= g.sy) return;
    z0 = max(z0, 0);
    z1 = min(z1, g.sz - 1);
    if (z0 > z1) return;
    const int base = (x * g.sy + y) * g.sz;
    nn_run(g, q, g.cell_first[base + z0], g.cell_first[base + z1 + 1], best);
}

// Cells beyond the grid on this axis: how far the cell v lies outside
// 0..s-1, and how far the farthest grid cell lies from it.
__device__ __forceinline__ int nn_gap(int v, int s) { return v < 0 ? -v : max(v - (s - 1), 0); }
__device__ __forceinline__ int nn_reach(int v, int s) { return max(v, s - 1 - v); }

__global__ void __launch_bounds__(NN_THREADS)
nearest_index_kernel(NnGrid g, int n, float inv, double cx0, double cy0, double cz0,
                     const float4* __restrict__ query, int m, long long* __restrict__ out,
                     unsigned long long* __restrict__ pairs) {
    const int qi = blockIdx.x * NN_THREADS + threadIdx.x;
    if (qi >= m) return;
    const float4 q = query[qi];
    const double dinv = inv;
    const double fx = floor(__dmul_rn(q.x, dinv)) - cx0;
    const double fy = floor(__dmul_rn(q.y, dinv)) - cy0;
    const double fz = floor(__dmul_rn(q.z, dinv)) - cz0;
    NnBest best{inf_f(), 0x7fffffff, 0};
    if (fabs(fx) > NN_FAR || fabs(fy) > NN_FAR || fabs(fz) > NN_FAR) {
        nn_run(g, q, 0, n, best);
    } else {
        const int qx = static_cast<int>(fx), qy = static_cast<int>(fy), qz = static_cast<int>(fz);
        const int r0 = max(nn_gap(qx, g.sx), max(nn_gap(qy, g.sy), nn_gap(qz, g.sz)));
        const int r1 = max(nn_reach(qx, g.sx), max(nn_reach(qy, g.sy), nn_reach(qz, g.sz)));
        const double cell = 1.0 / dinv;
        for (int r = r0; r <= r1; ++r) {
            if (r == 0) {
                nn_row(g, q, qx, qy, qz, qz, best);
            } else {
                // x faces whole, y faces without their x edges, z faces inside both
                for (int y = max(qy - r, 0); y <= min(qy + r, g.sy - 1); ++y) {
                    nn_row(g, q, qx - r, y, qz - r, qz + r, best);
                    nn_row(g, q, qx + r, y, qz - r, qz + r, best);
                }
                for (int x = max(qx - r + 1, 0); x <= min(qx + r - 1, g.sx - 1); ++x) {
                    nn_row(g, q, x, qy - r, qz - r, qz + r, best);
                    nn_row(g, q, x, qy + r, qz - r, qz + r, best);
                    for (int y = max(qy - r + 1, 0); y <= min(qy + r - 1, g.sy - 1); ++y) {
                        nn_row(g, q, x, y, qz - r, qz - r, best);
                        nn_row(g, q, x, y, qz + r, qz + r, best);
                    }
                }
            }
            const double reach = r * cell;
            if (static_cast<double>(best.d2) < reach * reach * (1.0 - NN_MARGIN)) break;
        }
    }
    out[qi] = best.arg;
    if (pairs != nullptr) atomicAdd(pairs, static_cast<unsigned long long>(best.pairs));
}

}  // namespace

extern "C" {

// K2 over n points sorted by cell (float4, w unused). Block b takes up to
// KNN_THREADS points of cell item_cell[b] from its item_first[b]-th on.
// Writes out in sorted order. `wide` is n * (k + 1) floats of scratch where
// k + 1 > 32, else unused. Returns cudaGetLastError() of the launch.
int knn_mean_dist_launch(const void* pts, int n, const void* cell_key, const void* cell_start,
                         const void* cell_count, const void* cell_ring, int n_cells,
                         const void* item_cell, const void* item_first, int n_items,
                         long long step_x, long long step_y, int k, void* wide, void* out,
                         void* stream) {
    (void)n;
    cudaGetLastError();   // this library's runtime keeps an earlier refusal
    const dim3 grid(n_items), block(KNN_THREADS);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KNN_ARGS                                                                           \
    static_cast<const float4*>(pts), static_cast<const long long*>(cell_key),              \
        static_cast<const int*>(cell_start), static_cast<const int*>(cell_count),          \
        static_cast<const int*>(cell_ring), n_cells, static_cast<const int*>(item_cell),   \
        static_cast<const int*>(item_first), step_x, step_y, k, static_cast<float*>(wide),    \
        static_cast<float*>(out)
    if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (k + 1 <= 8) knn_mean_dist_kernel<8><<<grid, block, 0, s>>>(KNN_ARGS);
    else if (k + 1 <= 16) knn_mean_dist_kernel<16><<<grid, block, 0, s>>>(KNN_ARGS);
    else if (k + 1 <= 24) knn_mean_dist_kernel<24><<<grid, block, 0, s>>>(KNN_ARGS);
    else if (k + 1 <= 32) knn_mean_dist_kernel<32><<<grid, block, 0, s>>>(KNN_ARGS);
    else if (wide == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    else knn_mean_dist_kernel<0><<<grid, block, 0, s>>>(KNN_ARGS);
#undef KNN_ARGS
    return static_cast<int>(cudaGetLastError());
}

// K3: the nearest of n reference points (sorted by cell, with their
// original indices and the (sx * sy * sz + 1,) cell table) for each of m
// queries (float4, w unused); cells are floor(p * inv) - (cx0, cy0, cz0).
// Adds the pairs evaluated to *pairs unless it is null. Returns
// cudaGetLastError() of the launch.
int nearest_index_launch(const void* ref, const void* ref_id, const void* cell_first, int n,
                         int sx, int sy, int sz, float inv, double cx0, double cy0, double cz0,
                         const void* query, int m, void* out, void* pairs, void* stream) {
    cudaGetLastError();
    const NnGrid g{static_cast<const float4*>(ref), static_cast<const int*>(ref_id),
                   static_cast<const int*>(cell_first), sx, sy, sz};
    const dim3 grid((m + NN_THREADS - 1) / NN_THREADS), block(NN_THREADS);
    nearest_index_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        g, n, inv, cx0, cy0, cz0, static_cast<const float4*>(query), m,
        static_cast<long long*>(out), static_cast<unsigned long long*>(pairs));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
