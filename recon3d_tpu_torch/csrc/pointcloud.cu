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
// every point of a cell looks at the points of the same cube of cells.
// Evaluating every such pair is bound by the card's float32 issue rate (8
// rounded operations a pair; a bit-exact kernel that evaluates them all
// cannot reach half the operation bound), and nearly all of them cannot
// change the result: a point's k-th neighbour lies far inside its cell.
// So K2 evaluates only candidates that could enter a list:
// - The glue sorts each cell's points by the Morton code of their
//   sub-cell and cuts the cell's run into chunks of up to KNN_CHUNK points
//   with their boxes. A chunk is one block's queries (two a thread, so one
//   shared load serves two pairs) and, for the blocks of its cube, one
//   candidate tile.
// - A block walks its cube from near to far: its own chunk, the rest of
//   its cell, then the shells r = 1..R, whose cells its threads look up
//   KNN_PASS at a time (a binary search each in the sorted key table).
// - Before it takes a cell or a chunk it compares the squared distance
//   between the block's box and that box (box_d2) with T, the largest last
//   slot of the block's lists, reduced over the block after every tile, so
//   the branch is the same for every thread. box_d2 rounds each operation
//   as a squared distance does; rounding to nearest is monotone, so every
//   pair of the two boxes has a rounded squared distance of at least
//   box_d2. A list takes d only if d < its last slot <= T, and the slots
//   only fall, so a skipped chunk never held a value that would have
//   entered a list: the lists, and so the sums, are the same bits. A list
//   that is not yet full holds inf and skips nothing. kk still comes from
//   the cube's count of points (cell_cube), evaluated or not.
// - The surviving chunks, each one contiguous run, come through a ring of
//   two tiles in shared memory by cp.async: the next chunk's copy (chosen
//   with the T of before the current tile, so at worst a copy too many) is
//   in flight while the current one is evaluated.
// - Blocks start in the order the glue gives, heaviest cube first, so the
//   dense cells' blocks do not form the tail.
// No tensor cores: |p|^2 + |q|^2 - 2 p.q loses small distances to
// cancellation and cannot equal the difference form bit for bit, and with
// a depth of 3 wgmma would have nothing to work on.
//
// Each query keeps the k + 1 smallest squared distances it has seen, its
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
// sorts them by cell; cell_first[c]..cell_first[c + 1] are cell c's; each
// point's w holds its original index). The glue sorts the queries by the
// linear key of their cell, clamped to one cell beyond the grid, so a block
// of NN_THREADS consecutive queries (read through query_id from the
// callers' order) lies in a few neighbouring cells. The block stages the
// reference points of the cells within Chebyshev radius 1 of its queries'
// cells (a few z-runs of the sorted table, at most NN_STAGE points in
// NN_RUNS runs) into shared memory by cp.async, and every thread scans
// there its query's cube of radius 1 (nine column slices: shells 0 and 1).
// A query whose best squared distance then lies below (1 / inv)^2 by the
// margin is done. Any other (on the main path's mesh, vertices in the
// fused cloud's holes, several cells from any point), and every query of
// a block whose neighbourhood overflows the stage, is left in a list for
// a second launch, whose warps take the walks over the whole
// card, a walk a warp, the lanes splitting each shell's runs: a far
// query's shells are spread over 32 lanes, not one thread's serial chain
// that holds its warp, and a block whose queries all walk does not hold
// its SM (warp walks inside the block, tried first, were slower than a
// thread a walk; a block a far walk was slower still: PERF.md §6). A shell
// is clipped to the grid before its columns are split, so a query far
// outside the grid pays for the grid's columns, not for the shell's. The
// walks are bound by scattered loads: a cell-table lookup and a run of
// points for each column of a shell. After shell r every point within the cube of
// radius r is seen, and any other lies more than r cells away: cells are
// floor(p * inv) with the product taken exactly in double, so (x' - x) *
// inv > r holds exactly. The walk stops once the best squared distance is
// below (r / inv)^2 by more than the float32 rounding of a squared
// distance (NN_MARGIN), so no point left unseen can even tie. A query
// beyond NN_FAR cells of the grid has its warp scan every point. Among
// equal squared distances the lowest original index wins (in a thread,
// and in the warp's reduction of its lanes' bests); the index is read
// only where d <= the best. Bound: its bytes, or the pairs it evaluates
// (counted on request) at 8 float operations each.
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn), as the plain versions round them, so nothing contracts into
// an FMA and the kernels equal the plain versions bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int KNN_CHUNK = 128;     // kernels/pointcloud.py: KNN_CHUNK
constexpr int KNN_THREADS = 64;    // two queries a thread
constexpr int KNN_PASS = 512;      // shell cells looked up a pass
constexpr int KNN_PER = KNN_PASS / KNN_THREADS;
constexpr int KNN_WARPS = KNN_THREADS / 32;
constexpr int NN_THREADS = 128;    // kernels/pointcloud.py: NN_THREADS
constexpr int NN_STAGE = 2048;     // reference points a block stages
constexpr int NN_RUNS = 64;        // z-runs a block stages
constexpr int NN_WARPS = NN_THREADS / 32;
constexpr int NN_WALK_THREADS = 256;     // 8 walks at a time a block
constexpr int NN_WALK_BLOCKS_PER_SM = 8;
constexpr double NN_FAR = 268435456.0;   // 2^28 cells: int arithmetic stays exact
constexpr double NN_MARGIN = 1e-5;       // far above 5 float32 roundings (3e-7)

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float dist2(float4 a, float4 b) {
    const float dx = __fsub_rn(a.x, b.x);
    const float dy = __fsub_rn(a.y, b.y);
    const float dz = __fsub_rn(a.z, b.z);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Lower bound of the rounded squared distance between any point of box a
// and any of box b (kernels/pointcloud.py: box_lower_bound).
__device__ __forceinline__ float box_d2(float4 alo, float4 ahi, float4 blo, float4 bhi) {
    const float gx = fmaxf(fmaxf(__fsub_rn(blo.x, ahi.x), 0.f), __fsub_rn(alo.x, bhi.x));
    const float gy = fmaxf(fmaxf(__fsub_rn(blo.y, ahi.y), 0.f), __fsub_rn(alo.y, bhi.y));
    const float gz = fmaxf(fmaxf(__fsub_rn(blo.z, ahi.z), 0.f), __fsub_rn(alo.z, bhi.z));
    return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Cells at Chebyshev distance r >= 1: the two x faces whole, the two y
// faces without their x edges, the two z faces inside both.
__device__ __forceinline__ int shell_size(int r) {
    const int a = 2 * r + 1, b = 2 * r - 1;
    return a * a * a - b * b * b;
}
__device__ __forceinline__ void shell_offset(int r, int j, int& dx, int& dy, int& dz) {
    const int a = 2 * r + 1, b = 2 * r - 1;
    if (j < 2 * a * a) {
        const int rem = j % (a * a);
        dx = j < a * a ? -r : r;
        dy = rem / a - r;
        dz = rem % a - r;
        return;
    }
    j -= 2 * a * a;
    if (j < 2 * b * a) {
        const int rem = j % (b * a);
        dy = j < b * a ? -r : r;
        dx = rem / a - (r - 1);
        dz = rem % a - r;
        return;
    }
    j -= 2 * b * a;
    const int rem = j % (b * b);
    dz = j < b * b ? -r : r;
    dx = rem / b - (r - 1);
    dy = rem % b - (r - 1);
}

struct KnnGrid {
    const float4* __restrict__ pts;          // points in knn_order
    const long long* __restrict__ cell_key;  // (C,) ascending
    const int* __restrict__ cell_ring;       // (C,) R
    const int* __restrict__ cell_cube;       // (C,) points in the R-cube, own included
    const int* __restrict__ cell_chunk;      // (C + 1,) first chunk of each cell
    const float4* __restrict__ cell_box;     // (C, 2) lo, hi
    int n_cells;
    const int* __restrict__ chunk_start;     // (NC + 1,) first point of each chunk
    const float4* __restrict__ chunk_box;    // (NC, 2)
    const int* __restrict__ chunk_cell;      // (NC,)
    const int* __restrict__ block_chunk;     // (NC,) the chunk of each block
    long long step_x, step_y;
};

// KMAX > 0: the lists in registers. KMAX == 0: k + 1 > 32, each list is its
// point's row of k + 1 floats in `wide` (global memory), kept by insertion.
template <int KMAX>
__global__ void __launch_bounds__(KNN_THREADS)
knn_mean_dist_kernel(KnnGrid g, int k, float* __restrict__ wide, float* __restrict__ out,
                     unsigned long long* __restrict__ pairs) {
    __shared__ __align__(16) float4 tile[2][KNN_CHUNK];
    __shared__ int occ[KNN_PASS];            // a pass's cells that survive the skip
    __shared__ int warp_part[KNN_WARPS];
    __shared__ float warp_max[KNN_WARPS];

    const int own = g.block_chunk[blockIdx.x];
    const int c = g.chunk_cell[own];
    const int first = g.chunk_start[own];
    const int len = g.chunk_start[own + 1] - first;
    const float4 blo = g.chunk_box[2 * own], bhi = g.chunk_box[2 * own + 1];
    const long long key = g.cell_key[c];
    const int R = g.cell_ring[c];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    constexpr int SLOTS = KMAX > 0 ? KMAX : 1;
    float4 p[2];
    bool act[2];
    float best[2][SLOTS];
    float* row[2] = {nullptr, nullptr};
    float last[2];   // each list's last slot: inf until full, -inf for no query
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int e = threadIdx.x + i * KNN_THREADS;
        act[i] = e < len;
        p[i] = act[i] ? g.pts[first + e] : make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (KMAX > 0) {
#pragma unroll
            for (int j = 0; j < KMAX; ++j)
                best[i][j] = act[i] && j >= KMAX - (k + 1) ? inf_f() : -inf_f();
            last[i] = best[i][KMAX - 1];
        } else {
            last[i] = -inf_f();
            if (act[i]) {
                row[i] = wide + static_cast<long long>(first + e) * (k + 1);
                for (int j = 0; j <= k; ++j) row[i][j] = inf_f();
                last[i] = inf_f();
            }
        }
    }

    // The walk's cursor, the same in every thread: shell r (0: the own
    // cell) and its next offset; the pass's surviving cells; the current
    // cell's chunks.
    int r = 0, base = 0, occ_i = 0, n_occ = 0;
    int ch = g.cell_chunk[c], ch_end = g.cell_chunk[c + 1];
    // The next chunk whose box may hold a value below T, or -1; its bound in lb.
    auto next_chunk = [&](float T, float& lb) -> int {
        while (true) {
            while (ch < ch_end) {
                const int x = ch++;
                if (x == own) continue;
                lb = box_d2(blo, bhi, g.chunk_box[2 * x], g.chunk_box[2 * x + 1]);
                if (lb < T) return x;
            }
            if (occ_i < n_occ) {
                const int f = occ[occ_i++];
                ch = g.cell_chunk[f];
                ch_end = g.cell_chunk[f + 1];
                continue;
            }
            if (r == 0 || base >= shell_size(r)) {
                ++r;
                base = 0;
            }
            if (r > R) return -1;
            // a pass: look the shell's next cells up, keep those whose box may hold a value below T
            __syncthreads();   // every thread is done reading occ
            const int size = shell_size(r);
            unsigned keep = 0;
            int found[KNN_PER];
#pragma unroll
            for (int j = 0; j < KNN_PER; ++j) {
                const int o = base + threadIdx.x * KNN_PER + j;
                found[j] = -1;
                if (o < size) {
                    int dx, dy, dz;
                    shell_offset(r, o, dx, dy, dz);
                    const int f = find_cell(g.cell_key, g.n_cells,
                                            key + dx * g.step_x + dy * g.step_y + dz);
                    if (f >= 0 && box_d2(blo, bhi, g.cell_box[2 * f], g.cell_box[2 * f + 1]) < T) {
                        found[j] = f;
                        keep |= 1u << j;
                    }
                }
            }
            const int mine = __popc(keep);
            int incl = mine;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int v = __shfl_up_sync(0xffffffffu, incl, d);
                if (lane >= d) incl += v;
            }
            if (lane == 31) warp_part[warp] = incl;
            __syncthreads();
            int pos = incl - mine;
            n_occ = 0;
#pragma unroll
            for (int w = 0; w < KNN_WARPS; ++w) {
                pos += w < warp ? warp_part[w] : 0;
                n_occ += warp_part[w];
            }
#pragma unroll
            for (int j = 0; j < KNN_PER; ++j)
                if (keep & (1u << j)) occ[pos++] = found[j];
            __syncthreads();
            occ_i = 0;
            base += KNN_PASS;
        }
    };
    auto issue = [&](int x, int s) {
        const int a = g.chunk_start[x], n_x = g.chunk_start[x + 1] - a;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int e = threadIdx.x + i * KNN_THREADS;
            if (e < n_x) cp_async16(&tile[s][e], g.pts + a + e);
        }
        cp_async_commit();
    };

    float T = inf_f();          // the block's largest last slot
    int cur = own, s = 0;
    float lb_cur = 0.f;
    long long evaluated = 0;    // points of the tiles evaluated
    issue(cur, s);
    while (cur >= 0) {
        float lb_next = 0.f;
        const int nxt = next_chunk(T, lb_next);
        if (nxt >= 0) {
            issue(nxt, s ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();   // the current tile has landed
        if (lb_cur < T) {  // T may have fallen since the chunk was chosen
            const int n_t = g.chunk_start[cur + 1] - g.chunk_start[cur];
            evaluated += n_t;
            for (int t = 0; t < n_t; ++t) {
                const float4 v = tile[s][t];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const float d = dist2(p[i], v);
                    if constexpr (KMAX > 0) {
                        if (d < best[i][KMAX - 1]) {
#pragma unroll
                            for (int j = KMAX - 1; j > 0; --j)
                                best[i][j] = fmaxf(best[i][j - 1], fminf(best[i][j], d));
                            best[i][0] = fminf(best[i][0], d);
                        }
                    } else if (d < last[i]) {
                        float* rw = row[i];
                        int j = k;
                        for (; j > 0 && rw[j - 1] > d; --j) rw[j] = rw[j - 1];
                        rw[j] = d;
                        last[i] = rw[k];
                    }
                }
            }
        }
        // T: the largest last slot over the block
        if constexpr (KMAX > 0) {
            last[0] = best[0][KMAX - 1];
            last[1] = best[1][KMAX - 1];
        }
        float m = fmaxf(last[0], last[1]);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
        if (lane == 0) warp_max[warp] = m;
        __syncthreads();   // also: every thread is done with tile s
        T = warp_max[0];
#pragma unroll
        for (int w = 1; w < KNN_WARPS; ++w) T = fmaxf(T, warp_max[w]);
        cur = nxt;
        lb_cur = lb_next;
        s ^= 1;
    }
    if (pairs != nullptr && threadIdx.x == 0)   // each query against the others
        atomicAdd(pairs, static_cast<unsigned long long>(len) *
                             static_cast<unsigned long long>(evaluated - 1));

    // the list's first slot holds one 0 (the point's own); the k after it, ascending
    const int kk = min(k, g.cell_cube[c] - 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        if (!act[i]) continue;
        float sum = 0.f;
        if constexpr (KMAX > 0) {
#pragma unroll
            for (int j = 0; j < KMAX; ++j)
                if (j >= KMAX - k && j < KMAX - k + kk) sum = __fadd_rn(sum, __fsqrt_rn(best[i][j]));
        } else {
            for (int j = 1; j <= kk; ++j) sum = __fadd_rn(sum, __fsqrt_rn(row[i][j]));
        }
        out[first + threadIdx.x + i * KNN_THREADS] =
            kk > 0 ? __fdiv_rn(sum, static_cast<float>(kk)) : 0.f;
    }
}

struct NnGrid {
    const float4* __restrict__ ref;       // reference points sorted by cell; w: index bits
    const int* __restrict__ cell_first;   // (cells + 1,) first sorted point of each cell
    int sx, sy, sz;                       // the grid's cells along x, y, z
};

struct NnBest {
    float d2;         // the best squared distance so far
    int arg;          // its point's original index
    long long pairs;  // pairs evaluated
};

__device__ __forceinline__ float4 nn_query(const float* __restrict__ query, int i) {
    const float* p = query + 3 * static_cast<long long>(i);
    return make_float4(p[0], p[1], p[2], 0.f);
}

__device__ __forceinline__ void nn_take(float4 q, float4 v, NnBest& best) {
    const float d = dist2(q, v);
    if (d <= best.d2) {
        const int id = __float_as_int(v.w);
        if (d < best.d2 || id < best.arg) {
            best.d2 = d;
            best.arg = id;
        }
    }
}

__device__ __forceinline__ void nn_run(const NnGrid& g, float4 q, int a, int b, NnBest& best) {
    for (int j = a; j < b; ++j) nn_take(q, g.ref[j], best);
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
__device__ __forceinline__ int nn_clamp(double f, int s) {
    return static_cast<int>(fmin(fmax(f, -1.0), static_cast<double>(s)));
}
// The cells v - r and v + r that lie in 0..s-1 (n of them, first a, second b).
__device__ __forceinline__ int nn_faces(int v, int r, int s, int& a, int& b) {
    const bool lo = v - r >= 0 && v - r < s, hi = v + r >= 0 && v + r < s;
    a = lo ? v - r : v + r;
    b = v + r;
    return static_cast<int>(lo) + static_cast<int>(hi);
}
// Cells of v - d..v + d that lie in 0..s-1: the first, and how many.
__device__ __forceinline__ int nn_span(int v, int d, int s, int& first) {
    first = max(v - d, 0);
    return max(min(v + d, s - 1) - first + 1, 0);
}

// The best (d2, then the lowest index) over the warp, in every lane.
__device__ __forceinline__ void nn_warp_best(NnBest& b) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, b.d2, d);
        const int oa = __shfl_xor_sync(0xffffffffu, b.arg, d);
        if (od < b.d2 || (od == b.d2 && oa < b.arg)) {
            b.d2 = od;
            b.arg = oa;
        }
    }
}

// Shell r >= 0 around the cell (qx, qy, qz), clipped to the grid, its runs
// split over the warp's lanes: the columns of the x faces and of the y
// faces (without their x edges) whole along z, then the cells of the z
// faces inside both. Only the faces and columns that lie in the grid are
// counted, so a shell costs at most its sx * sy columns, however far out
// the query lies.
__device__ __forceinline__ void nn_shell_warp(const NnGrid& g, float4 q, int qx, int qy, int qz,
                                              int r, NnBest& b) {
    const int lane = threadIdx.x & 31;
    if (r == 0) {
        if (lane == 0) nn_row(g, q, qx, qy, qz, qz, b);
        return;
    }
    int fx0, fx1, fy0, fy1, fz0, fz1, y0, xi0, yi0;
    const int nfx = nn_faces(qx, r, g.sx, fx0, fx1);
    const int nfy = nn_faces(qy, r, g.sy, fy0, fy1);
    const int nfz = nn_faces(qz, r, g.sz, fz0, fz1);
    const int ny = nn_span(qy, r, g.sy, y0);
    const int nxi = nn_span(qx, r - 1, g.sx, xi0);
    const int nyi = nn_span(qy, r - 1, g.sy, yi0);
    const int inner = nxi * nyi;
    const int a = nfx * ny, bnd = a + nfy * nxi, items = bnd + nfz * inner;
    for (int j = lane; j < items; j += 32) {
        if (j < a) {
            nn_row(g, q, j < ny ? fx0 : fx1, y0 + j % ny, qz - r, qz + r, b);
        } else if (j < bnd) {
            const int jj = j - a;
            nn_row(g, q, xi0 + jj % nxi, jj < nxi ? fy0 : fy1, qz - r, qz + r, b);
        } else {
            const int jj = j - bnd, rem = jj % inner, z = jj < inner ? fz0 : fz1;
            nn_row(g, q, xi0 + rem / nyi, yi0 + rem % nyi, z, z, b);
        }
    }
}

// Block-wide exclusive scan of one int a thread; *total gets the sum.
__device__ __forceinline__ int nn_scan(int v, int* warp_part, int& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
    }
    if (lane == 31) warp_part[warp] = incl;
    __syncthreads();
    int before = incl - v;
    total = 0;
#pragma unroll
    for (int w = 0; w < NN_WARPS; ++w) {
        before += w < warp ? warp_part[w] : 0;
        total += warp_part[w];
    }
    return before;
}

// A walk the stage could not settle: the query's original index, its
// first shell (-1: every point), and its best so far.
struct NnWalk {
    int query, r_first;
    float d2;
    int arg;
};

struct NnOut {
    long long* __restrict__ out;               // (m,) at the queries' original indices
    const long long* __restrict__ query_id;    // (m,) the sorted queries' original indices
    NnWalk* __restrict__ walks;                // (m,) the walks the stages leave
    int* __restrict__ n_walks;                 // their count
    unsigned long long* __restrict__ pairs;    // or null
};

__global__ void __launch_bounds__(NN_THREADS)
nearest_stage_kernel(NnGrid g, float inv, double cx0, double cy0, double cz0,
                     const float* __restrict__ query, int m, NnOut o) {
    __shared__ __align__(16) float4 stage[NN_STAGE];
    __shared__ int run_src[NN_RUNS], run_dst[NN_RUNS + 1];
    __shared__ int box[6];
    __shared__ int warp_part[NN_WARPS];

    const int qi = blockIdx.x * NN_THREADS + threadIdx.x;
    const bool active = qi < m;
    const int id = active ? static_cast<int>(o.query_id[qi]) : 0;
    const float4 q = active ? nn_query(query, id) : make_float4(0.f, 0.f, 0.f, 0.f);
    const double dinv = inv;
    const double fx = floor(__dmul_rn(q.x, dinv)) - cx0;
    const double fy = floor(__dmul_rn(q.y, dinv)) - cy0;
    const double fz = floor(__dmul_rn(q.z, dinv)) - cz0;
    const bool far = fabs(fx) > NN_FAR || fabs(fy) > NN_FAR || fabs(fz) > NN_FAR;
    // the queries' cells, clamped to one cell beyond the grid
    const int cx = nn_clamp(fx, g.sx), cy = nn_clamp(fy, g.sy), cz = nn_clamp(fz, g.sz);

    // 1. the block's box of cells, widened by one and clipped to the grid
    if (threadIdx.x < 6) box[threadIdx.x] = threadIdx.x < 3 ? 0x7fffffff : -0x7fffffff;
    __syncthreads();
    if (active) {
        atomicMin(&box[0], cx);
        atomicMin(&box[1], cy);
        atomicMin(&box[2], cz);
        atomicMax(&box[3], cx);
        atomicMax(&box[4], cy);
        atomicMax(&box[5], cz);
    }
    __syncthreads();
    const int x0 = max(box[0] - 1, 0), x1 = min(box[3] + 1, g.sx - 1);
    const int y0 = max(box[1] - 1, 0), y1 = min(box[4] + 1, g.sy - 1);
    const int z0 = max(box[2] - 1, 0), z1 = min(box[5] + 1, g.sz - 1);
    const int ny = y1 - y0 + 1;
    const int runs = (x1 >= x0 && y1 >= y0 && z1 >= z0) ? (x1 - x0 + 1) * ny : 0;
    // 2. its z-runs in the sorted table, copied into the stage if they fit
    int staged = 0;           // points in the stage
    bool stage_ok = false;    // the stage holds the whole neighbourhood
    if (runs <= NN_RUNS) {
        int len = 0;
        if (threadIdx.x < runs) {
            const int x = x0 + threadIdx.x / ny, y = y0 + threadIdx.x % ny;
            const int cbase = (x * g.sy + y) * g.sz;
            run_src[threadIdx.x] = g.cell_first[cbase + z0];
            len = g.cell_first[cbase + z1 + 1] - run_src[threadIdx.x];
        }
        int total;
        const int before = nn_scan(len, warp_part, total);
        if (threadIdx.x < runs) run_dst[threadIdx.x] = before;
        if (threadIdx.x == 0) run_dst[runs] = total;
        __syncthreads();
        if (total <= NN_STAGE) {
            staged = total;
            stage_ok = true;
            const int lane = threadIdx.x & 31;
            for (int i = threadIdx.x >> 5; i < runs; i += NN_WARPS)
                for (int e = run_dst[i] + lane; e < run_dst[i + 1]; e += 32)
                    cp_async16(&stage[e], g.ref + run_src[i] + (e - run_dst[i]));
            cp_async_commit();
            cp_async_wait<0>();
        }
        __syncthreads();
    }

    // 3. every thread scans the stage for its query: where the query's
    // cell is its clamped one, the stage holds the query's cube of radius 1
    // within the grid, and the thread scans that (shells 0 and 1: the
    // cube's columns, each a slice of a run); else the whole stage. A
    // query the stage settles is done, any other is left to
    // nearest_walk_kernel.
    NnBest best{inf_f(), 0x7fffffff, 0};
    bool walk = false;
    int r_first = 0;   // the walk's first shell; -1: every point (beyond NN_FAR)
    if (active) {
        const bool covered = stage_ok && !far && static_cast<double>(cx) == fx &&
                             static_cast<double>(cy) == fy && static_cast<double>(cz) == fz;
        if (covered) {
            const int za = max(cz - 1, z0), zb = min(cz + 1, z1);
            for (int x = max(cx - 1, x0); x <= min(cx + 1, x1); ++x)
                for (int y = max(cy - 1, y0); y <= min(cy + 1, y1); ++y) {
                    const int run = (x - x0) * ny + (y - y0);
                    const int* col = g.cell_first + (x * g.sy + y) * g.sz;
                    const int shift = run_dst[run] - run_src[run];
                    const int a = col[za] + shift, b = col[zb + 1] + shift;
                    for (int j = a; j < b; ++j) nn_take(q, stage[j], best);
                    best.pairs += b - a;
                }
        } else {
            for (int j = 0; j < staged; ++j) nn_take(q, stage[j], best);
            best.pairs += staged;
        }
        if (far) {
            walk = true;
            r_first = -1;
        } else {
            const int qx = static_cast<int>(fx), qy = static_cast<int>(fy), qz = static_cast<int>(fz);
            const int r1 = max(nn_reach(qx, g.sx), max(nn_reach(qy, g.sy), nn_reach(qz, g.sz)));
            const double cell = 1.0 / dinv;
            r_first = covered ? 2
                              : max(nn_gap(qx, g.sx), max(nn_gap(qy, g.sy), nn_gap(qz, g.sz)));
            walk = r_first <= r1 &&
                   !(covered && static_cast<double>(best.d2) < cell * cell * (1.0 - NN_MARGIN));
        }
        if (walk) o.walks[atomicAdd(o.n_walks, 1)] = NnWalk{id, r_first, best.d2, best.arg};
        else o.out[id] = best.arg;
    }
    if (o.pairs != nullptr) {
        unsigned long long v = static_cast<unsigned long long>(best.pairs);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
        if ((threadIdx.x & 31) == 0) atomicAdd(o.pairs, v);
    }
}

// The walks the stages left, a warp a walk over the whole grid of blocks:
// its lanes split each shell's runs (or, beyond NN_FAR, the points), the
// best reduced over the warp after each shell.
__global__ void __launch_bounds__(NN_WALK_THREADS)
nearest_walk_kernel(NnGrid g, int n, float inv, double cx0, double cy0, double cz0,
                    const float* __restrict__ query, NnOut o) {
    const int lane = threadIdx.x & 31;
    const int warps = gridDim.x * (NN_WALK_THREADS / 32);
    const int count = *o.n_walks;
    const double dinv = inv, cell = 1.0 / dinv;
    long long walk_pairs = 0;
    for (int i = blockIdx.x * (NN_WALK_THREADS / 32) + (threadIdx.x >> 5); i < count; i += warps) {
        const NnWalk w = o.walks[i];
        const float4 v = nn_query(query, w.query);
        NnBest b{w.d2, w.arg, 0};
        if (w.r_first < 0) {
            for (int j = lane; j < n; j += 32) nn_take(v, g.ref[j], b);
            b.pairs += (n - lane + 31) / 32;
            nn_warp_best(b);
        } else {
            const int vx = static_cast<int>(floor(__dmul_rn(v.x, dinv)) - cx0);
            const int vy = static_cast<int>(floor(__dmul_rn(v.y, dinv)) - cy0);
            const int vz = static_cast<int>(floor(__dmul_rn(v.z, dinv)) - cz0);
            const int r1 = max(nn_reach(vx, g.sx), max(nn_reach(vy, g.sy), nn_reach(vz, g.sz)));
            for (int r = w.r_first; r <= r1; ++r) {
                nn_shell_warp(g, v, vx, vy, vz, r, b);
                nn_warp_best(b);
                const double reach = r * cell;
                if (static_cast<double>(b.d2) < reach * reach * (1.0 - NN_MARGIN)) break;
            }
        }
        if (lane == 0) o.out[w.query] = b.arg;
        walk_pairs += b.pairs;
    }
    if (o.pairs != nullptr) {
        unsigned long long v = static_cast<unsigned long long>(walk_pairs);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
        if (lane == 0 && v > 0) atomicAdd(o.pairs, v);
    }
}

}  // namespace

extern "C" {

// K2 over n points in knn_order (float4, w unused), one block a chunk in
// the order block_chunk gives. Writes out in that sorted order. `wide` is
// n * (k + 1) floats of scratch where k + 1 > 32, else unused. Adds the
// pairs evaluated to *pairs unless it is null. Returns cudaGetLastError()
// of the launch.
int knn_mean_dist_launch(const void* pts, const void* cell_key, const void* cell_ring,
                         const void* cell_cube, const void* cell_chunk, const void* cell_box,
                         int n_cells, const void* chunk_start, const void* chunk_box,
                         const void* chunk_cell, const void* block_chunk, int n_blocks,
                         long long step_x, long long step_y, int k, void* wide, void* out,
                         void* pairs, void* stream) {
    cudaGetLastError();   // this library's runtime keeps an earlier refusal
    const KnnGrid g{static_cast<const float4*>(pts),        static_cast<const long long*>(cell_key),
                    static_cast<const int*>(cell_ring),     static_cast<const int*>(cell_cube),
                    static_cast<const int*>(cell_chunk),    static_cast<const float4*>(cell_box),
                    n_cells,
                    static_cast<const int*>(chunk_start),   static_cast<const float4*>(chunk_box),
                    static_cast<const int*>(chunk_cell),    static_cast<const int*>(block_chunk),
                    step_x, step_y};
    const dim3 grid(n_blocks), block(KNN_THREADS);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* o = static_cast<float*>(out);
    float* w = static_cast<float*>(wide);
    auto* pr = static_cast<unsigned long long*>(pairs);
    if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (k + 1 <= 8) knn_mean_dist_kernel<8><<<grid, block, 0, s>>>(g, k, w, o, pr);
    else if (k + 1 <= 16) knn_mean_dist_kernel<16><<<grid, block, 0, s>>>(g, k, w, o, pr);
    else if (k + 1 <= 24) knn_mean_dist_kernel<24><<<grid, block, 0, s>>>(g, k, w, o, pr);
    else if (k + 1 <= 32) knn_mean_dist_kernel<32><<<grid, block, 0, s>>>(g, k, w, o, pr);
    else if (wide == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    else knn_mean_dist_kernel<0><<<grid, block, 0, s>>>(g, k, w, o, pr);
    return static_cast<int>(cudaGetLastError());
}

// K3: the nearest of n reference points (sorted by cell, w the bits of
// each one's original index, with the (sx * sy * sz + 1,) cell table) for
// each of m queries ((m, 3) float32 in the callers' order), taken in the
// order query_id gives; cells are floor(p * inv) - (cx0, cy0, cz0). Two
// launches on the stream: the stages, which leave the walks they cannot
// settle in `walks` (m * 16 bytes of scratch, then 4 for their count), then
// the walks. Writes out at the queries' original indices. Adds the pairs
// evaluated to *pairs unless it is null. Returns cudaGetLastError() after
// the launches.
int nearest_index_launch(const void* ref, const void* cell_first, int n, int sx, int sy, int sz,
                         float inv, double cx0, double cy0, double cz0, const void* query,
                         const void* query_id, int m, void* out, void* walks, void* pairs,
                         void* stream) {
    cudaGetLastError();
    const NnGrid g{static_cast<const float4*>(ref), static_cast<const int*>(cell_first), sx, sy,
                   sz};
    auto* w = static_cast<NnWalk*>(walks);
    const NnOut o{static_cast<long long*>(out), static_cast<const long long*>(query_id), w,
                  reinterpret_cast<int*>(w + m), static_cast<unsigned long long*>(pairs)};
    const auto* q = static_cast<const float*>(query);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaMemsetAsync(o.n_walks, 0, sizeof(int), s);
    nearest_stage_kernel<<<(m + NN_THREADS - 1) / NN_THREADS, NN_THREADS, 0, s>>>(
        g, inv, cx0, cy0, cz0, q, m, o);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    int sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    nearest_walk_kernel<<<sms * NN_WALK_BLOCKS_PER_SM, NN_WALK_THREADS, 0, s>>>(
        g, n, inv, cx0, cy0, cz0, q, o);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
