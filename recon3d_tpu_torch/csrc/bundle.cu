// Bundle adjustment's Schur-reduced LM step (sfm/bundle.py::_lm_step) as
// hand-written segment kernels for Hopper (sm_90a). Built at first use by
// kernels/bundle.py with nvcc into a shared library with a plain C
// interface, loaded with ctypes; every launch goes on the caller's stream.
//
// No Pallas kernel stands behind these: the JAX package's bundle
// adjustment (recon3d_tpu/sfm/bundle.py) is plain jnp, which XLA fuses on
// the TPU. On the card its port ran every J/J^T contraction as an einsum
// (cuBLAS's batched gemv over (2, 6) and (2, 3) blocks) and summed it into
// points or cameras by a cumsum over the whole padded (D, O) table and two
// boundary gathers: ~2,650 launches an LM step, each scan and gemv at 1-2%
// of the card's bandwidth, and a scan walks all O rows of the capacity
// (262,144 at DTU's size) however few are live.
//
// Here each per-observation product is formed in registers and summed
// straight into its segment by walking the segment's rows:
// - a point's rows are contiguous in the point-major table
//   ([pt_start, pt_end)), so one thread a point sums them in row order;
// - a camera's rows are contiguous after the sort by camera (cam_perm,
//   [cam_start, cam_end)), so one block a camera sums them, row q going to
//   thread q mod the block and the threads' sums meeting in a fixed tree.
// No atomics and no order that depends on scheduling: two runs give the
// same bits. Rows outside every segment (the padding of the capacity, the
// table's invalid rows) are never read or written, so the work scales
// with the live rows. A sum no longer comes from the difference of two
// float32 prefix sums over the table, so it keeps more of its precision.
//
// One LM step: linearize (the Huber weight, the residual and the Jacobian
// blocks of every row, in registers, written once point-major; each
// point's J^T J and J^T r), point_setup (the damped point blocks' closed-
// form inverses and w_p = Cinv(-g_p)), cam_setup (the rows gathered into
// camera order, each camera's gradient, diagonal, block-Jacobi block of
// the Schur complement and E w_p), cg_init (lambda, each camera's 6x6
// inverse, the right-hand side and the CG state), then cg_iters times
// point_pass (A: s_p = sum Jp^T Jc x), cam_pass (B: y_c = sum Jc^T (Jc x
// - Jp Cinv s)) and cg_update (V: one block over the 6C-long CG state),
// then point_pass and point_update (the back-substituted point step) and
// cost (the candidate's residuals, summed by point) with half_sum. With a
// mesh the host adds each partial sum over the ranks between two launches.
//
// What bounds it: bytes of the live rows, and launches. A CG iteration
// reads a live row twice: 80 B in pass A, 80 B and 40 B of its point's
// blocks in pass B. At DTU's ~50,000 observations that is ~9 MB an
// iteration, which stays in the 50 MB L2; the two passes run at a quarter
// to a third of the HBM byte bound (PERF.md section 6), and a step's
// device time (~0.46 ms at DTU's size) sits below the host's time to
// launch its 80 kernels, so the launches set the pace.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int PT_THREADS = 128;    // points a block (one thread a point)
constexpr int CAM_THREADS = 256;   // a camera's block
constexpr int VEC_THREADS = 256;   // the one block of cg_init, cg_update, half_sum
constexpr int MAX_WARPS = 32;

// Row records, in floats (kernels/bundle.py: ROW_PM, ROW_CM):
// point-major  Jc (2x6) | Jp (2x3) | camera (int bits) | weight | r (2) | point (int bits) | 0
// camera-major Jc (2x6) | Jp (2x3) | point (int bits) | 0
constexpr int ROW_PM = 24;
constexpr int ROW_CM = 20;
// Per-point sums: Jp^T Jp (00 01 02 11 12 22) | Jp^T r (3) | r.r
constexpr int PSUM = 10;
// Per-point blocks: Cinv (00 01 02 11 12 22) | g_p (3) | w_p (3)
constexpr int PBLK = 12;
// Per-camera sums: g (6) | diag (6) | S upper triangle (21) | E w_p (6) | 0
constexpr int CSUM = 40;
constexpr int CSUM_USED = 39;
constexpr int CS_G = 0, CS_DIAG = 6, CS_S = 12, CS_EW = 33;

__device__ __forceinline__ int sym6(int a, int b) {   // a <= b
    return a * 6 - (a * (a - 1)) / 2 + (b - a);
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
    return x < lo ? lo : x;   // torch's clamp_min: a NaN stays NaN
}

// The camera-frame depth clamped away from 0 with its sign kept.
__device__ __forceinline__ float clamp_depth(float z) {
    return fabsf(z) < 1e-6f ? (z < 0.f ? -1e-6f : 1e-6f) : z;
}

// v[i] summed over the block, in every thread. Each warp's lanes meet in
// a butterfly (a lane and its partner add the same two values, so every
// lane holds the same bits), then every thread adds the warps' sums in
// warp order. Every thread of the block must call it. red holds
// MAX_WARPS * N floats of shared memory.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int m = 16; m >= 1; m >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], m);
    }
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) red[warp * N + i] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) {
        float s = red[i];
        for (int w = 1; w < warps; ++w) s += red[w * N + i];
        v[i] = s;
    }
    __syncthreads();
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

struct Blocks {
    float jc[2][6];
    float jp[2][3];
};

// Jc and Jp of a row record (both layouts start alike).
__device__ __forceinline__ void load_blocks(const float* rec, Blocks& b) {
    const float4 a = ld4(rec), c = ld4(rec + 4), d = ld4(rec + 8), e = ld4(rec + 12);
    b.jc[0][0] = a.x; b.jc[0][1] = a.y; b.jc[0][2] = a.z; b.jc[0][3] = a.w;
    b.jc[0][4] = c.x; b.jc[0][5] = c.y; b.jc[1][0] = c.z; b.jc[1][1] = c.w;
    b.jc[1][2] = d.x; b.jc[1][3] = d.y; b.jc[1][4] = d.z; b.jc[1][5] = d.w;
    b.jp[0][0] = e.x; b.jp[0][1] = e.y; b.jp[0][2] = e.z; b.jp[1][0] = e.w;
}

__device__ __forceinline__ void sym3(const float* s, float (&m)[3][3]) {
    m[0][0] = s[0]; m[0][1] = s[1]; m[0][2] = s[2];
    m[1][0] = s[1]; m[1][1] = s[3]; m[1][2] = s[4];
    m[2][0] = s[2]; m[2][1] = s[4]; m[2][2] = s[5];
}

// ---- linearize: one thread a point ---------------------------------------
// The residual at the linearization point, its Huber IRLS weight
// (_robust_weights), the weighted residual and Jacobian blocks
// (_per_obs_jacobians) of each row of point p, written point-major, and
// p's sums of Jp^T Jp, Jp^T r and r.r. Row o of p's segment observes point
// p (the table is point-major).
__global__ void __launch_bounds__(PT_THREADS) linearize_kernel(
    const float* __restrict__ K, const float* __restrict__ R0, const float* __restrict__ t0,
    const float* __restrict__ X0, const long long* __restrict__ obs_cam,
    const float* __restrict__ obs_xy, const float* __restrict__ obs_w,
    const long long* __restrict__ pt_start, const long long* __restrict__ pt_end, int P,
    float delta, float* __restrict__ rows, float* __restrict__ psum) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const float k00 = K[0], k01 = K[1], k02 = K[2], k11 = K[4], k12 = K[5];
    const float X = X0[3 * p], Y = X0[3 * p + 1], Z = X0[3 * p + 2];
    float acc[PSUM];
#pragma unroll
    for (int i = 0; i < PSUM; ++i) acc[i] = 0.f;
    const long long end = pt_end[p];
    for (long long o = pt_start[p]; o < end; ++o) {
        const int c = static_cast<int>(obs_cam[o]);
        const float* R = R0 + 9 * c;
        const float* t = t0 + 3 * c;
        const float xc = R[0] * X + R[1] * Y + R[2] * Z + t[0];
        const float yc = R[3] * X + R[4] * Y + R[5] * Z + t[1];
        const float zc = R[6] * X + R[7] * Y + R[8] * Z + t[2];
        const float zs = clamp_depth(zc);
        const float dz = (fabsf(zc) >= 1e-6f ? 1.f : 0.f) / zs;
        const float x = xc / zs, y = yc / zs;
        const float ow = obs_w[o];
        const float e0 = (k00 * x + k01 * y + k02) - obs_xy[2 * o];
        const float e1 = (k11 * y + k12) - obs_xy[2 * o + 1];
        const float a0 = e0 * ow, a1 = e1 * ow;
        const float n = sqrtf(a0 * a0 + a1 * a1);
        const float w = ow * sqrtf(n <= delta ? 1.f : delta / clamp_min(n, 1e-12f));
        const float r0 = e0 * w, r1 = e1 * w;
        float d[2][3];
        d[0][0] = (k00 / zs) * w;
        d[0][1] = (k01 / zs) * w;
        d[0][2] = (-(k00 * x + k01 * y) * dz) * w;
        d[1][0] = 0.f * w;
        d[1][1] = (k11 / zs) * w;
        d[1][2] = (-k11 * y * dz) * w;
        Blocks b;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            // d (2x3) times [-hat(Xc) | I] and times R
            b.jc[i][0] = -d[i][1] * zc + d[i][2] * yc;
            b.jc[i][1] = d[i][0] * zc - d[i][2] * xc;
            b.jc[i][2] = -d[i][0] * yc + d[i][1] * xc;
            b.jc[i][3] = d[i][0];
            b.jc[i][4] = d[i][1];
            b.jc[i][5] = d[i][2];
#pragma unroll
            for (int k = 0; k < 3; ++k)
                b.jp[i][k] = d[i][0] * R[k] + d[i][1] * R[3 + k] + d[i][2] * R[6 + k];
        }
        float* rec = rows + static_cast<size_t>(o) * ROW_PM;
        st4(rec, b.jc[0][0], b.jc[0][1], b.jc[0][2], b.jc[0][3]);
        st4(rec + 4, b.jc[0][4], b.jc[0][5], b.jc[1][0], b.jc[1][1]);
        st4(rec + 8, b.jc[1][2], b.jc[1][3], b.jc[1][4], b.jc[1][5]);
        st4(rec + 12, b.jp[0][0], b.jp[0][1], b.jp[0][2], b.jp[1][0]);
        st4(rec + 16, b.jp[1][1], b.jp[1][2], __int_as_float(c), w);
        st4(rec + 20, r0, r1, __int_as_float(p), 0.f);
        int s = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
            for (int k = a; k < 3; ++k)
                acc[s++] += b.jp[0][a] * b.jp[0][k] + b.jp[1][a] * b.jp[1][k];
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) acc[6 + a] += b.jp[0][a] * r0 + b.jp[1][a] * r1;
        acc[9] += r0 * r0 + r1 * r1;
    }
#pragma unroll
    for (int i = 0; i < PSUM; ++i) psum[static_cast<size_t>(p) * PSUM + i] = acc[i];
}

// ---- point_setup: one thread a point -------------------------------------
// Cp = Jp^T Jp + damping diag(Jp^T Jp) + 1e-8 I and its closed-form
// inverse (_inv3x3: adjugate over the determinant, guarded at 1e-18), zero
// where the points are frozen; g_p and w_p = Cinv (-g_p).
__global__ void __launch_bounds__(PT_THREADS) point_setup_kernel(
    const float* __restrict__ psum, const float* __restrict__ damping, int P, int motion_only,
    float* __restrict__ pblk) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const float* s = psum + static_cast<size_t>(p) * PSUM;
    const float dmp = *damping;
    const float a = (s[0] + dmp * s[0]) + 1e-8f, b = s[1], c = s[2];
    const float d = s[1], e = (s[3] + dmp * s[3]) + 1e-8f, f = s[4];
    const float g = s[2], h = s[4], i = (s[5] + dmp * s[5]) + 1e-8f;
    float ci[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (!motion_only) {
        const float A = e * i - f * h;
        const float B = -(d * i - f * g);
        const float Cc = d * h - e * g;
        float det = a * A + b * B + c * Cc;
        if (fabsf(det) < 1e-18f) det = 1e-18f;
        ci[0] = A / det;
        ci[1] = -(b * i - c * h) / det;
        ci[2] = (b * f - c * e) / det;
        ci[3] = (a * i - c * g) / det;
        ci[4] = -(a * f - c * d) / det;
        ci[5] = (a * e - b * d) / det;
    }
    float m[3][3];
    sym3(ci, m);
    const float g0 = s[6], g1 = s[7], g2 = s[8];
    float* out = pblk + static_cast<size_t>(p) * PBLK;
    st4(out, ci[0], ci[1], ci[2], ci[3]);
    st4(out + 4, ci[4], ci[5], g0, g1);
    st4(out + 8, g2, m[0][0] * -g0 + m[0][1] * -g1 + m[0][2] * -g2,
        m[1][0] * -g0 + m[1][1] * -g1 + m[1][2] * -g2,
        m[2][0] * -g0 + m[2][1] * -g1 + m[2][2] * -g2);
}

// ---- cam_setup: one block a camera ---------------------------------------
// Gathers the camera's rows into camera order (rows_cm, read by every
// cam_pass) and sums, over them: g = Jc^T r, diag = the squares of Jc's
// columns, the block-Jacobi block sum (Jc^T Jc - (Jc^T Jp) Cinv (Jp^T Jc))
// (upper triangle) and E w_p = sum Jc^T (Jp w_p).
__global__ void __launch_bounds__(CAM_THREADS) cam_setup_kernel(
    const float* __restrict__ rows, const long long* __restrict__ cam_perm,
    const long long* __restrict__ cam_start, const long long* __restrict__ cam_end,
    const float* __restrict__ pblk, float* __restrict__ rows_cm, float* __restrict__ csum) {
    __shared__ float red[MAX_WARPS * CSUM_USED];
    const int cam = blockIdx.x;
    float acc[CSUM_USED];
#pragma unroll
    for (int i = 0; i < CSUM_USED; ++i) acc[i] = 0.f;
    const long long end = cam_end[cam];
    for (long long q = cam_start[cam] + threadIdx.x; q < end; q += blockDim.x) {
        const float* rec = rows + static_cast<size_t>(cam_perm[q]) * ROW_PM;
        Blocks b;
        load_blocks(rec, b);
        const float4 f = ld4(rec + 16), g = ld4(rec + 20);
        b.jp[1][1] = f.x; b.jp[1][2] = f.y;
        const float r0 = g.x, r1 = g.y;
        const int p = __float_as_int(g.z);
        float* out = rows_cm + static_cast<size_t>(q) * ROW_CM;
        st4(out, b.jc[0][0], b.jc[0][1], b.jc[0][2], b.jc[0][3]);
        st4(out + 4, b.jc[0][4], b.jc[0][5], b.jc[1][0], b.jc[1][1]);
        st4(out + 8, b.jc[1][2], b.jc[1][3], b.jc[1][4], b.jc[1][5]);
        st4(out + 12, b.jp[0][0], b.jp[0][1], b.jp[0][2], b.jp[1][0]);
        st4(out + 16, b.jp[1][1], b.jp[1][2], g.z, 0.f);
        const float* pb = pblk + static_cast<size_t>(p) * PBLK;
        const float4 u = ld4(pb), v = ld4(pb + 4), wv = ld4(pb + 8);
        const float cs[6] = {u.x, u.y, u.z, u.w, v.x, v.y};
        float ci[3][3];
        sym3(cs, ci);
        const float wp[3] = {wv.y, wv.z, wv.w};
        float E[6][3], F[6][3];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
            acc[CS_G + a] += b.jc[0][a] * r0 + b.jc[1][a] * r1;
            acc[CS_DIAG + a] += b.jc[0][a] * b.jc[0][a] + b.jc[1][a] * b.jc[1][a];
#pragma unroll
            for (int k = 0; k < 3; ++k) E[a][k] = b.jc[0][a] * b.jp[0][k] + b.jc[1][a] * b.jp[1][k];
#pragma unroll
            for (int k = 0; k < 3; ++k)
                F[a][k] = E[a][0] * ci[0][k] + E[a][1] * ci[1][k] + E[a][2] * ci[2][k];
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
            for (int k = a; k < 6; ++k) {
                const float bo = b.jc[0][a] * b.jc[0][k] + b.jc[1][a] * b.jc[1][k];
                const float ece = F[a][0] * E[k][0] + F[a][1] * E[k][1] + F[a][2] * E[k][2];
                acc[CS_S + sym6(a, k)] += bo - ece;
            }
        }
        const float u0 = b.jp[0][0] * wp[0] + b.jp[0][1] * wp[1] + b.jp[0][2] * wp[2];
        const float u1 = b.jp[1][0] * wp[0] + b.jp[1][1] * wp[1] + b.jp[1][2] * wp[2];
#pragma unroll
        for (int a = 0; a < 6; ++a) acc[CS_EW + a] += b.jc[0][a] * u0 + b.jc[1][a] * u1;
    }
    block_sum<CSUM_USED>(acc, red);
    if (threadIdx.x == 0) {
        float* out = csum + static_cast<size_t>(cam) * CSUM;
#pragma unroll
        for (int i = 0; i < CSUM_USED; ++i) out[i] = acc[i];
        out[CSUM_USED] = 0.f;
    }
}

// In-place inverse of an SPD 6x6 block by Gauss-Jordan elimination without
// pivoting (stable for symmetric positive definite matrices, whose pivots
// stay positive).
__device__ __forceinline__ void invert6(float (&A)[6][6]) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        const float piv = 1.f / A[k][k];
        A[k][k] = 1.f;
#pragma unroll
        for (int j = 0; j < 6; ++j) A[k][j] *= piv;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            if (i == k) continue;
            const float f = A[i][k];
            A[i][k] = 0.f;
#pragma unroll
            for (int j = 0; j < 6; ++j) A[i][j] -= f * A[k][j];
        }
    }
}

// ---- cg_init: one block ---------------------------------------------------
// Per camera (camera 0 is the gauge: its rows of every vector are zero):
// lambda = damping diag + 1e-8, the preconditioner block M = (S + diag
// lambda)^-1 (the identity's inverse for the gauge camera and cameras
// without observations), b = (-g - E w_p), and the CG state x = 0, r = b,
// z = p = M r; rz = r.z and cost0 = 0.5 sum r.r over the points' sums.
// scal: cost0, rz, cost1.
__global__ void __launch_bounds__(VEC_THREADS) cg_init_kernel(
    const float* __restrict__ csum, const float* __restrict__ psum,
    const float* __restrict__ damping, int C, int P, float* __restrict__ Minv,
    float* __restrict__ lam, float* __restrict__ x, float* __restrict__ r,
    float* __restrict__ z, float* __restrict__ p, float* __restrict__ scal) {
    __shared__ float red[MAX_WARPS * 2];
    const float dmp = *damping;
    float part[2] = {0.f, 0.f};
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        const float* s = csum + static_cast<size_t>(c) * CSUM;
        const float fc = c != 0 ? 1.f : 0.f;
        float g[6], dg[6], l[6];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
            g[a] = s[CS_G + a] * fc;
            dg[a] = s[CS_DIAG + a] * fc;
            l[a] = dmp * dg[a] + 1e-8f;
        }
        const bool live = fc > 0.f && (dg[0] + dg[1] + dg[2] + dg[3] + dg[4] + dg[5]) > 0.f;
        float A[6][6];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
            for (int k = 0; k < 6; ++k) {
                if (live)
                    A[a][k] = s[CS_S + (a <= k ? sym6(a, k) : sym6(k, a))] + (a == k ? l[a] : 0.f);
                else
                    A[a][k] = a == k ? 1.f : 0.f;
            }
        }
        invert6(A);
        float bv[6];
#pragma unroll
        for (int a = 0; a < 6; ++a) bv[a] = (-g[a] - s[CS_EW + a]) * fc;
        float* Mc = Minv + static_cast<size_t>(c) * 36;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
            float za = 0.f;
#pragma unroll
            for (int k = 0; k < 6; ++k) {
                Mc[a * 6 + k] = A[a][k];
                za += A[a][k] * bv[k];
            }
            za *= fc;
            const int e = 6 * c + a;
            lam[e] = l[a];
            x[e] = 0.f;
            r[e] = bv[a];
            z[e] = za;
            p[e] = za;
            part[0] += bv[a] * za;
        }
    }
    for (int i = threadIdx.x; i < P; i += blockDim.x)
        part[1] += psum[static_cast<size_t>(i) * PSUM + 9];
    block_sum<2>(part, red);
    if (threadIdx.x == 0) {
        scal[0] = 0.5f * part[1];
        scal[1] = part[0];
    }
}

// ---- point_pass (A): one thread a point ----------------------------------
// s_p = sum over p's rows of Jp^T (Jc v_cam), camera 0's rows left out
// (v is the CG direction p or the solution x, masked at the gauge).
__global__ void __launch_bounds__(PT_THREADS) point_pass_kernel(
    const float* __restrict__ rows, const long long* __restrict__ pt_start,
    const long long* __restrict__ pt_end, const float* __restrict__ v, int P,
    float* __restrict__ s) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    const long long end = pt_end[p];
    for (long long o = pt_start[p]; o < end; ++o) {
        const float* rec = rows + static_cast<size_t>(o) * ROW_PM;
        const float4 f = ld4(rec + 16);
        const int c = __float_as_int(f.z);
        if (c == 0) continue;
        Blocks b;
        load_blocks(rec, b);
        b.jp[1][1] = f.x; b.jp[1][2] = f.y;
        const float* vc = v + 6 * c;
        float u[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
            u[i] = b.jc[i][0] * vc[0] + b.jc[i][1] * vc[1] + b.jc[i][2] * vc[2]
                 + b.jc[i][3] * vc[3] + b.jc[i][4] * vc[4] + b.jc[i][5] * vc[5];
        a0 += b.jp[0][0] * u[0] + b.jp[1][0] * u[1];
        a1 += b.jp[0][1] * u[0] + b.jp[1][1] * u[1];
        a2 += b.jp[0][2] * u[0] + b.jp[1][2] * u[1];
    }
    st4(s + 4 * static_cast<size_t>(p), a0, a1, a2, 0.f);
}

// ---- cam_pass (B): one block a camera -------------------------------------
// y_c = sum over c's rows of Jc^T (Jc v_c - Jp Cinv_p s_p): the camera
// block and the coupling through the eliminated points of the Schur
// product, unmasked and undamped (cg_update adds lambda and the gauge).
__global__ void __launch_bounds__(CAM_THREADS) cam_pass_kernel(
    const float* __restrict__ rows_cm, const long long* __restrict__ cam_start,
    const long long* __restrict__ cam_end, const float* __restrict__ pblk,
    const float* __restrict__ s, const float* __restrict__ v, float* __restrict__ y) {
    __shared__ float red[MAX_WARPS * 6];
    const int cam = blockIdx.x;
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (cam != 0) {
        float vc[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) vc[j] = v[6 * cam + j];
        const long long end = cam_end[cam];
        for (long long q = cam_start[cam] + threadIdx.x; q < end; q += blockDim.x) {
            const float* rec = rows_cm + static_cast<size_t>(q) * ROW_CM;
            Blocks b;
            load_blocks(rec, b);
            const float4 f = ld4(rec + 16);
            b.jp[1][1] = f.x; b.jp[1][2] = f.y;
            const size_t pt = static_cast<size_t>(__float_as_int(f.z));
            const float4 c0 = ld4(pblk + pt * PBLK), c1 = ld4(pblk + pt * PBLK + 4);
            const float cs[6] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y};
            float ci[3][3];
            sym3(cs, ci);
            const float4 sp = ld4(s + 4 * pt);
            float t[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) t[k] = ci[k][0] * sp.x + ci[k][1] * sp.y + ci[k][2] * sp.z;
            float u[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                u[i] = (b.jc[i][0] * vc[0] + b.jc[i][1] * vc[1] + b.jc[i][2] * vc[2]
                        + b.jc[i][3] * vc[3] + b.jc[i][4] * vc[4] + b.jc[i][5] * vc[5])
                     - (b.jp[i][0] * t[0] + b.jp[i][1] * t[1] + b.jp[i][2] * t[2]);
#pragma unroll
            for (int a = 0; a < 6; ++a) acc[a] += b.jc[0][a] * u[0] + b.jc[1][a] * u[1];
        }
    }
    block_sum<6>(acc, red);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int a = 0; a < 6; ++a) y[6 * cam + a] = acc[a];
    }
}

// ---- cg_update (V): one block ----------------------------------------------
// One preconditioned CG iteration on the 6C-long camera state, as
// sfm/bundle.py's loop takes it: Ap = (y + lambda p) masked at the gauge,
// alpha = rz / max(p.Ap, 1e-12), x += alpha p, r -= alpha Ap, z = M r
// masked, beta = r.z / max(rz, 1e-12), p = z + beta p. Element e belongs
// to thread e mod the block; each dot product is summed in that fixed
// order and tree.
__global__ void __launch_bounds__(VEC_THREADS) cg_update_kernel(
    const float* __restrict__ y, const float* __restrict__ Minv, const float* __restrict__ lam,
    int C, float* __restrict__ x, float* __restrict__ r, float* __restrict__ z,
    float* __restrict__ p, float* __restrict__ Ap, float* __restrict__ scal) {
    __shared__ float red[MAX_WARPS];
    const int n = 6 * C;
    const float rz = scal[1];
    float part[1] = {0.f};
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const float ap = e >= 6 ? y[e] + lam[e] * p[e] : 0.f;
        Ap[e] = ap;
        part[0] += p[e] * ap;
    }
    block_sum<1>(part, red);
    const float alpha = rz / clamp_min(part[0], 1e-12f);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        x[e] += alpha * p[e];
        r[e] -= alpha * Ap[e];
    }
    __syncthreads();
    part[0] = 0.f;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int c = e / 6, a = e - 6 * c;
        const float* m = Minv + static_cast<size_t>(c) * 36 + a * 6;
        const float* rc = r + 6 * c;
        float ze = m[0] * rc[0] + m[1] * rc[1] + m[2] * rc[2]
                 + m[3] * rc[3] + m[4] * rc[4] + m[5] * rc[5];
        ze *= c != 0 ? 1.f : 0.f;
        z[e] = ze;
        part[0] += r[e] * ze;
    }
    block_sum<1>(part, red);
    const float beta = part[0] / clamp_min(rz, 1e-12f);
    for (int e = threadIdx.x; e < n; e += blockDim.x) p[e] = z[e] + beta * p[e];
    if (threadIdx.x == 0) scal[1] = part[0];
}

// ---- point_update: one thread a point -------------------------------------
// The back-substituted point step dX_p = Cinv_p (-g_p - s_p), s from a
// point_pass over the camera step.
__global__ void __launch_bounds__(PT_THREADS) point_update_kernel(
    const float* __restrict__ pblk, const float* __restrict__ s, int P, float* __restrict__ dX) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const float* pb = pblk + static_cast<size_t>(p) * PBLK;
    float ci[3][3];
    sym3(pb, ci);
    const float4 sp = ld4(s + 4 * static_cast<size_t>(p));
    const float h0 = -pb[6] - sp.x, h1 = -pb[7] - sp.y, h2 = -pb[8] - sp.z;
#pragma unroll
    for (int a = 0; a < 3; ++a)
        dX[3 * static_cast<size_t>(p) + a] = ci[a][0] * h0 + ci[a][1] * h1 + ci[a][2] * h2;
}

// ---- cost: one thread a point ----------------------------------------------
// The candidate's weighted residuals (_residuals at (R, t), X0 + dX, with
// the step's weights) summed by point: rr_p = sum r.r.
__global__ void __launch_bounds__(PT_THREADS) cost_kernel(
    const float* __restrict__ K, const float* __restrict__ R, const float* __restrict__ t,
    const float* __restrict__ X0, const float* __restrict__ dX, const float* __restrict__ rows,
    const float* __restrict__ obs_xy, const long long* __restrict__ pt_start,
    const long long* __restrict__ pt_end, int P, float* __restrict__ rr) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const float k00 = K[0], k01 = K[1], k02 = K[2], k11 = K[4], k12 = K[5];
    const float X = X0[3 * p] + dX[3 * p], Y = X0[3 * p + 1] + dX[3 * p + 1];
    const float Z = X0[3 * p + 2] + dX[3 * p + 2];
    float acc = 0.f;
    const long long end = pt_end[p];
    for (long long o = pt_start[p]; o < end; ++o) {
        const float4 f = ld4(rows + static_cast<size_t>(o) * ROW_PM + 16);
        const int c = __float_as_int(f.z);
        const float w = f.w;
        const float* Rc = R + 9 * c;
        const float* tc = t + 3 * c;
        const float xc = Rc[0] * X + Rc[1] * Y + Rc[2] * Z + tc[0];
        const float yc = Rc[3] * X + Rc[4] * Y + Rc[5] * Z + tc[1];
        const float zs = clamp_depth(Rc[6] * X + Rc[7] * Y + Rc[8] * Z + tc[2]);
        const float x = xc / zs, y = yc / zs;
        const float r0 = ((k00 * x + k01 * y + k02) - obs_xy[2 * o]) * w;
        const float r1 = ((k11 * y + k12) - obs_xy[2 * o + 1]) * w;
        acc += r0 * r0 + r1 * r1;
    }
    rr[p] = acc;
}

// ---- half_sum: one block ---------------------------------------------------
// *out = 0.5 sum of n values, in a fixed order.
__global__ void __launch_bounds__(VEC_THREADS) half_sum_kernel(
    const float* __restrict__ v, int n, float* __restrict__ out) {
    __shared__ float red[MAX_WARPS];
    float part[1] = {0.f};
    for (int i = threadIdx.x; i < n; i += blockDim.x) part[0] += v[i];
    block_sum<1>(part, red);
    if (threadIdx.x == 0) *out = 0.5f * part[0];
}

int blocks_of(int n, int threads) { return (n + threads - 1) / threads; }

// The launchers' untyped pointers, typed.
const float* fin(const void* p) { return static_cast<const float*>(p); }
float* fout(void* p) { return static_cast<float*>(p); }
const long long* iin(const void* p) { return static_cast<const long long*>(p); }
cudaStream_t on(void* p) { return static_cast<cudaStream_t>(p); }

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() of the launch (this library's runtime keeps an
// earlier refusal, so it is cleared first). Shapes: C cameras, P points;
// pointers as kernels/bundle.py documents them.

int ba_linearize_launch(const void* K, const void* R0, const void* t0, const void* X0,
                        const void* obs_cam, const void* obs_xy, const void* obs_w,
                        const void* pt_start, const void* pt_end, int P, float delta,
                        void* rows, void* psum, void* stream) {
    cudaGetLastError();
    if (P <= 0) return 0;
    linearize_kernel<<<blocks_of(P, PT_THREADS), PT_THREADS, 0, on(stream)>>>(
        fin(K), fin(R0), fin(t0), fin(X0), iin(obs_cam), fin(obs_xy), fin(obs_w),
        iin(pt_start), iin(pt_end), P, delta, fout(rows), fout(psum));
    return static_cast<int>(cudaGetLastError());
}

int ba_point_setup_launch(const void* psum, const void* damping, int P, int motion_only,
                          void* pblk, void* stream) {
    cudaGetLastError();
    if (P <= 0) return 0;
    point_setup_kernel<<<blocks_of(P, PT_THREADS), PT_THREADS, 0, on(stream)>>>(
        fin(psum), fin(damping), P, motion_only, fout(pblk));
    return static_cast<int>(cudaGetLastError());
}

int ba_cam_setup_launch(const void* rows, const void* cam_perm, const void* cam_start,
                        const void* cam_end, const void* pblk, int C, void* rows_cm,
                        void* csum, void* stream) {
    cudaGetLastError();
    if (C <= 0) return 0;
    cam_setup_kernel<<<C, CAM_THREADS, 0, on(stream)>>>(
        fin(rows), iin(cam_perm), iin(cam_start), iin(cam_end), fin(pblk), fout(rows_cm),
        fout(csum));
    return static_cast<int>(cudaGetLastError());
}

int ba_cg_init_launch(const void* csum, const void* psum, const void* damping, int C, int P,
                      void* Minv, void* lam, void* x, void* r, void* z, void* p, void* scal,
                      void* stream) {
    cudaGetLastError();
    cg_init_kernel<<<1, VEC_THREADS, 0, on(stream)>>>(
        fin(csum), fin(psum), fin(damping), C, P, fout(Minv), fout(lam), fout(x), fout(r),
        fout(z), fout(p), fout(scal));
    return static_cast<int>(cudaGetLastError());
}

int ba_point_pass_launch(const void* rows, const void* pt_start, const void* pt_end,
                         const void* v, int P, void* s, void* stream) {
    cudaGetLastError();
    if (P <= 0) return 0;
    point_pass_kernel<<<blocks_of(P, PT_THREADS), PT_THREADS, 0, on(stream)>>>(
        fin(rows), iin(pt_start), iin(pt_end), fin(v), P, fout(s));
    return static_cast<int>(cudaGetLastError());
}

int ba_cam_pass_launch(const void* rows_cm, const void* cam_start, const void* cam_end,
                       const void* pblk, const void* s, const void* v, int C, void* y,
                       void* stream) {
    cudaGetLastError();
    if (C <= 0) return 0;
    cam_pass_kernel<<<C, CAM_THREADS, 0, on(stream)>>>(
        fin(rows_cm), iin(cam_start), iin(cam_end), fin(pblk), fin(s), fin(v), fout(y));
    return static_cast<int>(cudaGetLastError());
}

int ba_cg_update_launch(const void* y, const void* Minv, const void* lam, int C, void* x,
                        void* r, void* z, void* p, void* Ap, void* scal, void* stream) {
    cudaGetLastError();
    cg_update_kernel<<<1, VEC_THREADS, 0, on(stream)>>>(
        fin(y), fin(Minv), fin(lam), C, fout(x), fout(r), fout(z), fout(p), fout(Ap), fout(scal));
    return static_cast<int>(cudaGetLastError());
}

int ba_point_update_launch(const void* pblk, const void* s, int P, void* dX, void* stream) {
    cudaGetLastError();
    if (P <= 0) return 0;
    point_update_kernel<<<blocks_of(P, PT_THREADS), PT_THREADS, 0, on(stream)>>>(
        fin(pblk), fin(s), P, fout(dX));
    return static_cast<int>(cudaGetLastError());
}

int ba_cost_launch(const void* K, const void* R, const void* t, const void* X0, const void* dX,
                   const void* rows, const void* obs_xy, const void* pt_start, const void* pt_end,
                   int P, void* rr, void* stream) {
    cudaGetLastError();
    if (P <= 0) return 0;
    cost_kernel<<<blocks_of(P, PT_THREADS), PT_THREADS, 0, on(stream)>>>(
        fin(K), fin(R), fin(t), fin(X0), fin(dX), fin(rows), fin(obs_xy), iin(pt_start),
        iin(pt_end), P, fout(rr));
    return static_cast<int>(cudaGetLastError());
}

int ba_half_sum_launch(const void* v, int n, void* out, void* stream) {
    cudaGetLastError();
    half_sum_kernel<<<1, VEC_THREADS, 0, on(stream)>>>(fin(v), n, fout(out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
