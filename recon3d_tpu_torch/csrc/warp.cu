// K1: bilinear warp of float32 planes, a direct 4-tap gather for Hopper.
//
// Replaces recon3d_tpu/ops/warp_pallas.py::_tent_warp_kernel (launched by
// _tent_warp_flat, wrapped by bilinear_sample_pallas). The TPU kernel
// expresses bilinear sampling as tent-weight matrix products so the MXU
// does the work instead of XLA's slow gathers; on this card a gather is
// cheap (texels come from L1/L2), so the kernel computes the gather
// formula of recon3d_tpu/ops/image.py::bilinear_sample directly, one thread
// per sample, at the exact level (no bf16 rounding).
//
// Bound: memory traffic. Each sample reads 8 B of (x, y) coordinates and
// writes 4 B of value plus 1 B of validity; its four texels come from a
// plane (PatchMatch: 120x160 = 77 KB and 30x40 floats; a launch's N planes
// total a few MB at most) that stays resident in the 50 MB L2, so device
// memory sees ~13 B per sample. Coordinates and outputs are read and
// written coalesced (neighbouring threads, neighbouring samples).
// Next design step: fuse the reprojection of recon3d_tpu_torch/dense/
// patchmatch.py::_warp_sources into the kernel, so it reads the depth
// field (4 B per sample, shared by the J sources) instead of 8 B of
// coordinates per source.
//
// Layout: planes (N, H, W); coords (Nc, M, 2) interleaved (x, y) with
// Nc == N, or Nc == 1 for coordinates shared by every plane (coord_stride
// 0); out (N, M) float32; valid (N, M) bool (one byte). Sample m of plane
// n reads plane n at coords[n * coord_stride + m].
//
// The arithmetic repeats the plain PyTorch version operation by operation,
// each product and sum rounded on its own (__fmul_rn / __fadd_rn forbid
// FMA contraction), so on the card the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void tent_warp_kernel(const float* __restrict__ planes,
                                 const float2* __restrict__ coords,
                                 float* __restrict__ out,
                                 uint8_t* __restrict__ valid,
                                 long long total, long long M,
                                 long long coord_stride, int H, int W,
                                 float fill) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long n = i / M;
    const long long m = i - n * M;
    const float2 p = coords[n * coord_stride + m];
    const float x = p.x;
    const float y = p.y;
    const bool ok = (x >= 0.0f) && (x <= (float)(W - 1)) && (y >= 0.0f) &&
                    (y <= (float)(H - 1)) && isfinite(x) && isfinite(y);
    float v = fill;
    if (ok) {
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float fx = __fsub_rn(x, x0);
      const float fy = __fsub_rn(y, y0);
      const int x0i = (int)x0;
      const int y0i = (int)y0;
      const int x1i = min(x0i + 1, W - 1);
      const int y1i = min(y0i + 1, H - 1);
      const float* img = planes + n * (long long)H * W;
      const float v00 = __ldg(img + (long long)y0i * W + x0i);
      const float v01 = __ldg(img + (long long)y0i * W + x1i);
      const float v10 = __ldg(img + (long long)y1i * W + x0i);
      const float v11 = __ldg(img + (long long)y1i * W + x1i);
      const float gx = __fsub_rn(1.0f, fx);
      const float gy = __fsub_rn(1.0f, fy);
      // ((v00*gx)*gy + (v01*fx)*gy) + (v10*gx)*fy) + (v11*fx)*fy, left to
      // right as the plain version evaluates it.
      float acc = __fmul_rn(__fmul_rn(v00, gx), gy);
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, fx), gy));
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, gx), fy));
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, fx), fy));
      v = acc;
    }
    out[i] = v;
    valid[i] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int tent_warp_f32(const void* planes, const void* coords, void* out,
                             void* valid, long long n_planes, long long M,
                             long long coord_stride, int H, int W, float fill,
                             void* stream) {
  const long long total = n_planes * M;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  // Grid-stride loop beyond this: 132 SMs x 16 resident blocks x many waves.
  if (blocks > 1048576LL) blocks = 1048576LL;
  tent_warp_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)planes, (const float2*)coords, (float*)out,
      (uint8_t*)valid, total, M, coord_stride, H, W, fill);
  return (int)cudaGetLastError();
}
