// LightGlue's masked multi-head attention (neural/lightglue.py::Attention)
// as one hand-written kernel for Hopper (sm_90a). Built at first use by
// kernels/attention.py with nvcc into a shared library with a plain C
// interface, loaded with ctypes; every launch goes on the caller's stream.
//
// No Pallas kernel stands behind it: the JAX package's attention
// (recon3d_tpu/neural/lightglue.py) is plain jnp, which XLA fuses on the
// TPU. On the card the plain version writes the (B, H, Nq, Nk) float32
// logits to device memory and reads them back in three elementwise passes
// (the division by sqrt(Dh), the -1e9 mask, the softmax) and a second
// matrix product: at LightGlue's chunk of 8 pairs, 4 heads and 2,048
// keypoint slots that is 537 MB of logits a call, moved about seven times.
//
// What bounds it here: float32 FMAs. A full-chunk call is 34.36 GFLOP
// (2 x 2 Nq Nk Dh a pair and head) against 67 MB of q, k, v and output, so
// at 67 TFLOP/s and 3.35 TB/s the products take 0.513 ms and the bytes
// 0.020 ms. The kernel computes in float32 on the CUDA cores (no TF32, no
// split, no half precision), as the configuration states.
//
// How the logits stay out of device memory: one block takes one (pair,
// head, tile of BQ query rows) and streams the keys and values of that
// pair and head through shared memory, BK keys a tile (cp.async, the next
// key tile loading during this tile's P V, the next value tile during the
// next tile's Q K^T). For each key tile it forms S = Q K^T * scale in
// registers, a thread 8 query rows by 8 keys, sets invalid keys to -1e9
// exactly as the plain version does (so a row whose keys are all invalid
// still averages every value), keeps each row's running max and sum
// (online softmax), rescales its accumulator by exp(m_old - m_new), puts
// P in shared memory and accumulates P V, a thread 8 rows by Dh / 8
// columns (4 rows at Dh 128, whose accumulators would not fit). At the end
// it divides by the row sum once and writes the message in (B, Nq, H * Dh)
// layout. Keys past Nk get -inf (they are not keys at all), query rows
// past Nq are computed and not written. The exponentials are ex2.approx of
// (s - m) log2(e): s - m is formed first, so two equal masked logits give
// exactly 1.
//
// Shared memory (floats): Qs [Dh][BQ + 4] (q transposed, loaded once), Ks
// [BK][Dh + 4], Vs [BK][Dh], Ps [BK][BQ + 4]; the paddings of 4 make the
// 16-byte reads and writes of eight neighbouring threads fall on distinct
// banks. At Dh 64 a block of 128 threads (BQ 128 query rows) takes 99 KB,
// 233 registers a thread, and two fit on an SM: LightGlue's full chunk is
// 8 x 4 x 16 = 512 blocks, 1.94 waves of 264. Of the blocks timed at that
// chunk (PERF.md, section 6) this one was the fastest: 8 rows a thread do
// 256 FMAs for 16 shared-memory reads where 4 rows do 128 for 12. A
// thread's 8 keys of a tile are tx, tx + 8, ...: a row's keys lie in 8
// neighbouring lanes, which the row max and sum reduce by shuffles.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 128;                  // a block: 4 warps
constexpr int BK = 64;                        // keys a tile
constexpr int KEYS = BK / 8;                  // keys a thread in a tile
constexpr int MAX_DEVICES = 64;               // devices whose attributes are remembered
constexpr float MASKED = -1e9f;               // an invalid key's logit
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
    const float* q;
    const float* k;
    const float* v;
    const unsigned char* valid;   // (B, Nk) bool
    float* out;                   // (B, Nq, H * Dh)
    int Nq, Nk;
    long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn;
    long long valid_sb, o_sb, o_sn;
    float scale;
};

// ROWS query rows a thread: 8 where the accumulators fit in registers (Dh
// 32 and 64), else 4.
template <int DH>
struct Tile {
    static constexpr int ROWS = DH <= 64 ? 8 : 4;
    static constexpr int BQ = ROWS * THREADS / 8;   // query rows a block
    static constexpr int QSTR = BQ + 4;
    static constexpr int KSTR = DH + 4;
    static constexpr int VSTR = DH;
    static constexpr int PSTR = BQ + 4;
    static constexpr int NC = DH / 32;               // float4 columns of the output a thread
    static constexpr int SMEM =
        static_cast<int>(sizeof(float)) * (DH * QSTR + BK * KSTR + BK * VSTR + BK * PSTR);
    // blocks an SM holds: 99 KB (Dh 64) or 67 KB (Dh 32) of shared memory and
    // up to 255 registers a thread; 116 KB at Dh 128
    static constexpr int MIN_BLOCKS = DH <= 64 ? 2 : 1;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// 16 bytes global -> shared, asynchronously; zeros where !full
__device__ __forceinline__ void cp16(float* dst, const float* src, bool full) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const int n = full ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// BK rows of a (pair, head)'s keys or values from row key0 into dst (row
// stride `stride` floats); rows past Nk are zeros.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, int stride, const float* src,
                                          long long sn, int key0, int Nk) {
    constexpr int CHUNKS = DH / 4;
#pragma unroll
    for (int c = threadIdx.x; c < BK * CHUNKS; c += THREADS) {
        const int r = c / CHUNKS, d = (c % CHUNKS) * 4;
        const int key = key0 + r;
        const bool in = key < Nk;
        cp16(dst + r * stride + d, src + (in ? key : 0) * sn + d, in);
    }
    cp_commit();
}

template <int DH>
__global__ void __launch_bounds__(THREADS, Tile<DH>::MIN_BLOCKS)
attention_kernel(const Args a) {
    using T = Tile<DH>;
    constexpr int ROWS = T::ROWS;
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;
    float* Ks = Qs + DH * T::QSTR;
    float* Vs = Ks + BK * T::KSTR;
    float* Ps = Vs + BK * T::VSTR;

    const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
    const int q0 = blockIdx.x * T::BQ, h = blockIdx.y, b = blockIdx.z;
    const float* qb = a.q + b * a.q_sb + h * a.q_sh;
    const float* kb = a.k + b * a.k_sb + h * a.k_sh;
    const float* vb = a.v + b * a.v_sb + h * a.v_sh;
    const unsigned char* valid = a.valid + b * a.valid_sb;

    load_tile<DH>(Ks, T::KSTR, kb, a.k_sn, 0, a.Nk);
    load_tile<DH>(Vs, T::VSTR, vb, a.v_sn, 0, a.Nk);
    // q, transposed: Qs[d][row]
    for (int c = threadIdx.x; c < T::BQ * (DH / 4); c += THREADS) {
        const int r = c / (DH / 4), d = (c % (DH / 4)) * 4;
        const int n = q0 + r;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < a.Nq) x = *reinterpret_cast<const float4*>(qb + n * a.q_sn + d);
        Qs[(d + 0) * T::QSTR + r] = x.x;
        Qs[(d + 1) * T::QSTR + r] = x.y;
        Qs[(d + 2) * T::QSTR + r] = x.z;
        Qs[(d + 3) * T::QSTR + r] = x.w;
    }

    float o[ROWS][4 * T::NC];
    float m[ROWS], l[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        m[i] = neg_inf();
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < 4 * T::NC; ++c) o[i][c] = 0.f;
    }

    const int tiles = (a.Nk + BK - 1) / BK;
    for (int t = 0; t < tiles; ++t) {
        const int key0 = t * BK;
        cp_wait<1>();          // this tile's keys (its values may still load)
        __syncthreads();

        float s[ROWS][KEYS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
            for (int j = 0; j < KEYS; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DH; d += 4) {
            float qr[4][ROWS];
#pragma unroll
            for (int dd = 0; dd < 4; ++dd)
#pragma unroll
                for (int r = 0; r < ROWS; r += 4) {
                    const float4 x =
                        *reinterpret_cast<const float4*>(Qs + (d + dd) * T::QSTR + ty * ROWS + r);
                    qr[dd][r + 0] = x.x;
                    qr[dd][r + 1] = x.y;
                    qr[dd][r + 2] = x.z;
                    qr[dd][r + 3] = x.w;
                }
#pragma unroll
            for (int j = 0; j < KEYS; ++j) {
                const float4 kv = *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * T::KSTR + d);
#pragma unroll
                for (int i = 0; i < ROWS; ++i) {
                    s[i][j] = fmaf(qr[0][i], kv.x, s[i][j]);
                    s[i][j] = fmaf(qr[1][i], kv.y, s[i][j]);
                    s[i][j] = fmaf(qr[2][i], kv.z, s[i][j]);
                    s[i][j] = fmaf(qr[3][i], kv.w, s[i][j]);
                }
            }
        }

        // scale and mask: the plain version's where(valid, att / sqrt(Dh), -1e9)
#pragma unroll
        for (int j = 0; j < KEYS; ++j) {
            const int key = key0 + tx + 8 * j;
            const bool in = key < a.Nk;
            const bool ok = in && valid[key] != 0;
#pragma unroll
            for (int i = 0; i < ROWS; ++i)
                s[i][j] = ok ? s[i][j] * a.scale : (in ? MASKED : neg_inf());
        }

        // online softmax; a row's keys of the tile lie in 8 neighbouring lanes
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
            float mx = s[i][0];
#pragma unroll
            for (int j = 1; j < KEYS; ++j) mx = fmaxf(mx, s[i][j]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            const float mnew = fmaxf(m[i], mx);
            const float alpha = ex2((m[i] - mnew) * LOG2E);
            m[i] = mnew;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < KEYS; ++j) {
                const float p = ex2((s[i][j] - mnew) * LOG2E);
                s[i][j] = p;
                sum += p;
            }
            l[i] = l[i] * alpha + sum;   // this thread's keys; the lanes add up at the end
#pragma unroll
            for (int c = 0; c < 4 * T::NC; ++c) o[i][c] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < KEYS; ++j)
#pragma unroll
            for (int r = 0; r < ROWS; r += 4)
                *reinterpret_cast<float4*>(Ps + (tx + 8 * j) * T::PSTR + ty * ROWS + r) =
                    make_float4(s[r][j], s[r + 1][j], s[r + 2][j], s[r + 3][j]);

        cp_wait<0>();          // this tile's values
        __syncthreads();       // Ks read by all, Ps written, Vs visible
        if (t + 1 < tiles) load_tile<DH>(Ks, T::KSTR, kb, a.k_sn, key0 + BK, a.Nk);

#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float pr[ROWS];
#pragma unroll
            for (int r = 0; r < ROWS; r += 4) {
                const float4 p = *reinterpret_cast<const float4*>(Ps + kk * T::PSTR + ty * ROWS + r);
                pr[r + 0] = p.x;
                pr[r + 1] = p.y;
                pr[r + 2] = p.z;
                pr[r + 3] = p.w;
            }
#pragma unroll
            for (int c = 0; c < T::NC; ++c) {
                const float4 vv = *reinterpret_cast<const float4*>(Vs + kk * T::VSTR + c * 32 + tx * 4);
#pragma unroll
                for (int i = 0; i < ROWS; ++i) {
                    o[i][4 * c + 0] = fmaf(pr[i], vv.x, o[i][4 * c + 0]);
                    o[i][4 * c + 1] = fmaf(pr[i], vv.y, o[i][4 * c + 1]);
                    o[i][4 * c + 2] = fmaf(pr[i], vv.z, o[i][4 * c + 2]);
                    o[i][4 * c + 3] = fmaf(pr[i], vv.w, o[i][4 * c + 3]);
                }
            }
        }
        __syncthreads();       // Ps and Vs read by all
        if (t + 1 < tiles) load_tile<DH>(Vs, T::VSTR, vb, a.v_sn, key0 + BK, a.Nk);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        float sum = l[i];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        const int n = q0 + ty * ROWS + i;
        if (n >= a.Nq) continue;
        float* row = a.out + b * a.o_sb + n * a.o_sn + h * DH + tx * 4;
#pragma unroll
        for (int c = 0; c < T::NC; ++c)
            *reinterpret_cast<float4*>(row + c * 32) =
                make_float4(o[i][4 * c + 0] / sum, o[i][4 * c + 1] / sum,
                            o[i][4 * c + 2] / sum, o[i][4 * c + 3] / sum);
    }
}

template <int DH>
int launch(const Args& a, int B, int H, cudaStream_t stream) {
    using T = Tile<DH>;
    // the attributes belong to the function on one device: set them once
    // on each device the kernel runs on (the caller's current device)
    static bool configured[MAX_DEVICES] = {};
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device >= MAX_DEVICES || !configured[device]) {
        e = cudaFuncSetAttribute(attention_kernel<DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(attention_kernel<DH>,
                                     cudaFuncAttributePreferredSharedMemoryCarveout,
                                     cudaSharedmemCarveoutMaxShared);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (device < MAX_DEVICES) configured[device] = true;
    }
    const dim3 grid((a.Nq + T::BQ - 1) / T::BQ, H, B);
    attention_kernel<DH><<<grid, THREADS, T::SMEM, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Enqueue one attention on `stream`: q (B, H, Nq, Dh), k and v (B, H, Nk,
// Dh), each by its batch, head and row strides in floats (the last axis
// contiguous, every row 16-byte aligned), valid (B, Nk) bool by its batch
// stride, out (B, Nq, H * Dh) by its batch and row strides. Returns
// cudaGetLastError() of the launch (this library's runtime keeps an
// earlier refusal, so it is cleared first); a head width other than 32, 64
// or 128 is refused.
int lg_attention_launch(const void* q, const void* k, const void* v, const void* valid,
                        void* out, int B, int H, int Nq, int Nk, int Dh, long long q_sb,
                        long long q_sh, long long q_sn, long long k_sb, long long k_sh,
                        long long k_sn, long long v_sb, long long v_sh, long long v_sn,
                        long long valid_sb, long long o_sb, long long o_sn, float scale,
                        void* stream) {
    cudaGetLastError();
    if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || B > 65535 || H > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const unsigned char*>(valid),
                 static_cast<float*>(out), Nq, Nk, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb,
                 v_sh, v_sn, valid_sb, o_sb, o_sn, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (Dh) {
        case 32: return launch<32>(a, B, H, s);
        case 64: return launch<64>(a, B, H, s);
        case 128: return launch<128>(a, B, H, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
