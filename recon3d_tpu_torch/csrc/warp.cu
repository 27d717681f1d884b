// K1: bilinear warp of float32 planes, a 4-tap gather for Hopper.
//
// Replaces recon3d_tpu/ops/warp_pallas.py::_tent_warp_kernel (launched by
// _tent_warp_flat, wrapped by bilinear_sample_pallas). The TPU kernel
// expresses bilinear sampling as tent-weight matrix products so the MXU
// does the work instead of XLA's slow gathers; on this card a gather is
// cheap, so the kernel computes the gather formula of
// recon3d_tpu/ops/image.py::bilinear_sample directly, at the exact level
// (no bf16 rounding).
//
// Layout: planes (N, H, W); coords (Nc, M, 2) interleaved (x, y) with
// Nc == N (own points: plane n reads coordinate row n) or Nc == 1 (shared
// points: every plane reads row 0); out (N, M) float32; valid (Nc, M) bool
// (one byte), since validity depends on the point alone.
//
// Bound: memory traffic. A point costs 8 B of coordinates and 1 B of
// validity per coordinate row, and 4 B of sample per plane; the planes
// themselves are small (a few KB to 150 KB each) and their taps are
// served on chip. Three variants, chosen by kernels/warp.py::plan_launch:
//   `plane`:       own points on a 2-D grid, taps through __ldg from L1/L2;
//   `shared`:      shared points, taps through __ldg (planes too large for
//                  shared memory: SuperPoint's 256 descriptor planes,
//                  undistortion's colour planes), on a 2-D grid whose y
//                  dimension splits the planes into groups;
//   `shared_smem`: shared points on a persistent grid, one or two blocks
//                  an SM, each of which copies all N planes into shared
//                  memory once and takes its taps from there.
// What each does about the bound:
//   (a) shared points are loaded once per point and plane group, not once
//       per plane: one thread reads (x, y), computes validity, floor,
//       weights and tap offsets once and then takes its group of planes,
//       writing one sample a plane; one validity byte a point. Coordinate
//       traffic is 8 B a point and group (the TSDF lookup reads 57 MB, not
//       113). `shared` splits the N planes into groups of P on blockIdx.y
//       where the points alone give too few blocks to fill the card
//       (SuperPoint's 2,048 points make 8 blocks of 256 threads), and
//       takes a group's planes U at a time, issuing all 4 * U * VEC tap
//       loads of a batch before any arithmetic or store: a thread that
//       walked its planes one by one waited a memory round trip a plane.
//   (b) no 64-bit division: own points run on a 2-D grid (blockIdx.y is
//       the plane, looping when N exceeds 65,535) with a 32-bit index
//       inside the plane; shared points take their plane group from
//       blockIdx.y in the same way.
//   (c) 16-byte I/O: a thread takes VEC = 4 (or 2) consecutive points,
//       loads their coordinates as float4, stores each plane's samples as
//       a float4 (float2) and the validity as one 32-bit (16-bit) word,
//       all with evict-first hints (__ldcs/__stcs) so the streams do not
//       push the planes out of L1/L2. VEC = 1 is the scalar path for an
//       odd M or coordinates only 8-byte aligned, and for small launches,
//       where more threads hide latency better than wider ones.
//   (d) taps from shared memory: `shared_smem` stages the planes with a
//       TMA bulk copy into an mbarrier when the source address and size
//       are 16-byte multiples (plain coalesced loads otherwise), and loads
//       its first points' coordinates while the copy is in flight. Own
//       points take their taps through L1/L2: a block that copies its plane
//       first serves too few points to pay for the copy (slower at 12 of
//       the 13 main-path shapes, PERF.md).
//
// The arithmetic repeats the plain PyTorch version operation by operation,
// each product and sum rounded on its own (__fmul_rn / __fadd_rn forbid
// FMA contraction), so on the card the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const float* planes;
  const float* coords;
  float* out;
  uint8_t* valid;
  long long n_planes;
  long long planes_per_block;  // `shared`: planes a group of blockIdx.y
  int M;  // points per coordinate row, below 2^30 (32-bit indices)
  int H;
  int W;
  float fill;
};

// Validity and tap offsets of one point, shared by every plane it samples.
struct Taps {
  int o00, o01, o10, o11;
  float fx, fy;
  bool ok;
};

__device__ __forceinline__ Taps taps_of(float x, float y, int H, int W) {
  Taps t;
  t.ok = (x >= 0.0f) && (x <= (float)(W - 1)) && (y >= 0.0f) &&
         (y <= (float)(H - 1)) && isfinite(x) && isfinite(y);
  // Invalid points are zeroed as in the plain version (they read nothing).
  const float xv = t.ok ? x : 0.0f;
  const float yv = t.ok ? y : 0.0f;
  const float x0 = floorf(xv);
  const float y0 = floorf(yv);
  t.fx = __fsub_rn(xv, x0);
  t.fy = __fsub_rn(yv, y0);
  const int x0i = (int)x0;
  const int y0i = (int)y0;
  const int x1i = min(x0i + 1, W - 1);
  const int y1i = min(y0i + 1, H - 1);
  t.o00 = y0i * W + x0i;
  t.o01 = y0i * W + x1i;
  t.o10 = y1i * W + x0i;
  t.o11 = y1i * W + x1i;
  return t;
}

template <bool SMEM>
__device__ __forceinline__ float tap(const float* img, int o) {
  if constexpr (SMEM) {
    return img[o];
  } else {
    return __ldg(img + o);
  }
}

__device__ __forceinline__ float blend(float v00, float v01, float v10, float v11,
                                      const Taps& t) {
  const float gx = __fsub_rn(1.0f, t.fx);
  const float gy = __fsub_rn(1.0f, t.fy);
  // ((v00*gx)*gy + (v01*fx)*gy) + (v10*gx)*fy) + (v11*fx)*fy, left to right
  // as the plain version evaluates it.
  float acc = __fmul_rn(__fmul_rn(v00, gx), gy);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, t.fx), gy));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, gx), t.fy));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, t.fx), t.fy));
  return acc;
}

template <bool SMEM>
__device__ __forceinline__ float sample(const float* img, const Taps& t, float fill) {
  if (!t.ok) return fill;
  return blend(tap<SMEM>(img, t.o00), tap<SMEM>(img, t.o01), tap<SMEM>(img, t.o10),
               tap<SMEM>(img, t.o11), t);
}

// VEC consecutive points from coordinate pointer c (VEC = 4 or 2: 16-byte
// aligned; VEC = 1: 8-byte aligned).
template <int VEC>
__device__ __forceinline__ void load_taps(const float* c, int H, int W, Taps (&t)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(c));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(c) + 1);
    t[0] = taps_of(a.x, a.y, H, W);
    t[1] = taps_of(a.z, a.w, H, W);
    t[2] = taps_of(b.x, b.y, H, W);
    t[3] = taps_of(b.z, b.w, H, W);
  } else if constexpr (VEC == 2) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(c));
    t[0] = taps_of(a.x, a.y, H, W);
    t[1] = taps_of(a.z, a.w, H, W);
  } else {
    const float2 a = __ldcs(reinterpret_cast<const float2*>(c));
    t[0] = taps_of(a.x, a.y, H, W);
  }
}

template <int VEC>
__device__ __forceinline__ void store_valid(uint8_t* p, const Taps (&t)[VEC]) {
  if constexpr (VEC == 4) {
    const unsigned int bits = (unsigned int)t[0].ok | ((unsigned int)t[1].ok << 8) |
                              ((unsigned int)t[2].ok << 16) |
                              ((unsigned int)t[3].ok << 24);
    __stcs(reinterpret_cast<unsigned int*>(p), bits);
  } else if constexpr (VEC == 2) {
    const unsigned short bits = (unsigned short)(t[0].ok | (t[1].ok << 8));
    __stcs(reinterpret_cast<unsigned short*>(p), bits);
  } else {
    *p = t[0].ok ? 1 : 0;
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* o, const float (&s)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(o), make_float4(s[0], s[1], s[2], s[3]));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(o), make_float2(s[0], s[1]));
  } else {
    __stcs(o, s[0]);
  }
}

template <int VEC, bool SMEM>
__device__ __forceinline__ void store_samples(float* o, const float* img, const Taps (&t)[VEC],
                                              float fill) {
  float s[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = sample<SMEM>(img, t[i], fill);
  store_row<VEC>(o, s);
}

// ---- staging planes into shared memory -------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Waits for the planes' copy (the mbarrier's first phase); a copy that has
// not landed after about a second traps (a launch error) rather than hang
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 2000000000LL) {
      __trap();
    }
  }
}

// Starts copying n floats from src into dst. Returns true if the copy is a
// TMA bulk copy in flight (mbar_wait before reading dst); else the block
// has copied them with plain loads and synchronised. Called by the whole
// block.
constexpr unsigned int kBulkChunk = 32768;

__device__ __forceinline__ bool stage_begin(float* dst, const float* src, int n, uint64_t* bar) {
  const unsigned int bytes = (unsigned int)n * 4u;
  if (((reinterpret_cast<uintptr_t>(src) | bytes) & 15u) == 0) {
    if (threadIdx.x == 0) {
      const uint32_t b = smem_addr(bar);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"(bytes)
                   : "memory");
      for (unsigned int off = 0; off < bytes; off += kBulkChunk) {
        const unsigned int len = min(kBulkChunk, bytes - off);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst) + off),
            "l"(reinterpret_cast<const char*>(src) + off), "r"(len), "r"(b)
            : "memory");
      }
    }
    return true;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
  __syncthreads();
  return false;
}

// Planes go at the start of dynamic shared memory, the mbarrier after
// them at a 16-byte boundary (kernels/warp.py::plan_launch counts both).
__device__ __forceinline__ uint64_t* bar_after(unsigned char* smem, long long n_floats) {
  return reinterpret_cast<uint64_t*>(smem + ((n_floats * 4 + 15) / 16) * 16);
}

// ---- the kernels -----------------------------------------------------

// Shared points, taps through L1/L2: blockIdx.x and the thread walk the
// points VEC at a time; blockIdx.y takes the group of planes_per_block
// consecutive planes of its index (looping past 65,535 groups). A thread
// takes its group's planes U at a time: all tap loads of a batch first (a
// batch past the group's end predicated off), then the arithmetic and the
// stores. Only the blocks of the first group write validity.
// A batch holds the taps of 8 samples at VEC 1 (U = 8) and of 4 at VEC 2
// and 4 (U = 2, 1), and VEC 1 and 2 are held to 64 registers: four blocks
// an SM. The planner takes VEC 2 and 4 only where the points alone fill the
// card, and there warps in flight hide latency better than taps in flight
// (U = 8 at VEC 2 took 126 registers, U = 4 at VEC 4 192, and ran 1.8x and
// 1.6x slower at the TSDF lookup's 7,077,888 points; PERF.md, PR 12).
template <int VEC>
__global__ void __launch_bounds__(256, VEC == 4 ? 1 : 4) tent_warp_shared(Args a) {
  constexpr int U = VEC == 1 ? 8 : VEC == 2 ? 2 : 1;
  const int HW = a.H * a.W;
  const int groups = a.M / VEC;
  const int N = (int)a.n_planes;
  const int P = (int)a.planes_per_block;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += gridDim.x * blockDim.x) {
    const int m = g * VEC;
    Taps t[VEC];
    load_taps<VEC>(a.coords + 2 * (long long)m, a.H, a.W, t);
    if (blockIdx.y == 0) store_valid<VEC>(a.valid + m, t);
    for (int first = blockIdx.y * P; first < N; first += gridDim.y * P) {
      const int last = min(first + P, N);
      for (int n = first; n < last; n += U) {
        float v[U][VEC][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u < last - n) {
            const float* img = a.planes + (long long)(n + u) * HW;
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              v[u][i][0] = __ldg(img + t[i].o00);
              v[u][i][1] = __ldg(img + t[i].o01);
              v[u][i][2] = __ldg(img + t[i].o10);
              v[u][i][3] = __ldg(img + t[i].o11);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u < last - n) {
            float s[VEC];
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              // an invalid point's offsets are those of (0, 0): read, not used
              s[i] = t[i].ok ? blend(v[u][i][0], v[u][i][1], v[u][i][2], v[u][i][3], t[i])
                             : a.fill;
            }
            store_row<VEC>(a.out + (long long)(n + u) * a.M + m, s);
          }
        }
      }
    }
  }
}

// Shared points on a persistent grid: every block copies all N planes into
// shared memory, then each thread takes VEC points at a time and walks the
// N planes with them.
template <int VEC>
__global__ void __launch_bounds__(1024) tent_warp_shared_smem(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HW = a.H * a.W;
  const int groups = a.M / VEC;
  const float* img = reinterpret_cast<float*>(smem_raw);
  uint64_t* bar = bar_after(smem_raw, a.n_planes * HW);
  mbar_init(bar);
  bool pending = stage_begin(reinterpret_cast<float*>(smem_raw), a.planes,
                             (int)(a.n_planes * HW), bar);
  const int stride = gridDim.x * blockDim.x;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const long long m = (long long)g * VEC;
    Taps t[VEC];
    load_taps<VEC>(a.coords + 2 * m, a.H, a.W, t);
    store_valid<VEC>(a.valid + m, t);
    if (pending) {
      mbar_wait(bar);
      pending = false;
    }
    const float* p = img;
    float* o = a.out + m;
    for (long long n = 0; n < a.n_planes; ++n) {
      store_samples<VEC, true>(o, p, t, a.fill);
      p += HW;
      o += a.M;
    }
  }
  if (pending) mbar_wait(bar);  // no copy may outlive the block
}

// Own points, taps through L1/L2: blockIdx.y is the plane (looping past
// 65,535 planes), blockIdx.x and the thread walk its points VEC at a time
// with a 32-bit index.
template <int VEC>
__global__ void __launch_bounds__(256) tent_warp_plane(Args a) {
  const int HW = a.H * a.W;
  const int groups = a.M / VEC;
  for (long long n = blockIdx.y; n < a.n_planes; n += gridDim.y) {
    const float* img = a.planes + n * HW;
    const long long row = n * a.M;
    for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < groups;
         g += gridDim.x * blockDim.x) {
      const long long m = row + (long long)g * VEC;
      Taps t[VEC];
      load_taps<VEC>(a.coords + 2 * m, a.H, a.W, t);
      store_valid<VEC>(a.valid + m, t);
      store_samples<VEC, false>(a.out + m, img, t, a.fill);
    }
  }
}

template <int VEC, int VARIANT>
int launch(const Args& a, unsigned int gx, unsigned int gy, int threads, int smem,
           cudaStream_t stream) {
  void (*kernel)(Args);
  if constexpr (VARIANT == 0) {
    kernel = tent_warp_plane<VEC>;
  } else if constexpr (VARIANT == 1) {
    kernel = tent_warp_shared<VEC>;
  } else {
    kernel = tent_warp_shared_smem<VEC>;
  }
  // this library's runtime keeps a refused call's error until it is read:
  // clear it, so that the check after the launch reports this launch alone
  (void)cudaGetLastError();
  if (smem > 0) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(gx, gy), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Variants as numbered in kernels/warp.py::VARIANTS.
// planes_per_block: the planes of a blockIdx.y group (`shared`, whose
// 32-bit plane indices take N below 2^29; ignored by the other variants).
extern "C" int tent_warp_launch(int variant, int vec, const void* planes, const void* coords,
                                void* out, void* valid, long long n_planes, long long M,
                                int H, int W, float fill, unsigned int grid_x,
                                unsigned int grid_y, int threads, int smem_bytes,
                                long long planes_per_block, void* stream) {
  if ((vec != 1 && vec != 2 && vec != 4) || M <= 0 || M >= (1LL << 30) || M % vec != 0 ||
      (long long)H * W >= (1LL << 30) ||
      (variant == 1 && (planes_per_block < 1 || planes_per_block > n_planes ||
                        n_planes >= (1LL << 29))))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)planes, (const float*)coords, (float*)out, (uint8_t*)valid,
               n_planes, planes_per_block, (int)M, H, W, fill};
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant * 8 + vec) {
#define K1_CASE(V, VEC) \
  case V * 8 + VEC: return launch<VEC, V>(a, grid_x, grid_y, threads, smem_bytes, s);
    K1_CASE(0, 1) K1_CASE(0, 2) K1_CASE(0, 4)
    K1_CASE(1, 1) K1_CASE(1, 2) K1_CASE(1, 4)
    K1_CASE(2, 1) K1_CASE(2, 2) K1_CASE(2, 4)
#undef K1_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The limits the launch planner needs: SMs, and the shared memory one block
// may opt into and one SM holds.
extern "C" int tent_warp_device_info(int device, int* sm_count, int* smem_block_optin,
                                     int* smem_per_sm) {
  cudaError_t e = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_block_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               device);
  return (int)e;
}
