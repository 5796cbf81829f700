// Bilinear grid sample, forward, value only: NHWC f32 image, normalized
// (x, y) coords, torch grid_sample semantics (align_corners=False, zero
// padding; coords pushed to 2.0 sample 0).
//
// Replaces: tcsfm/ops/warp_mxu.py::_make_kernel (with_grads=False), the
// Pallas kernel launched by grid_sample_mxu. The TPU kernel turned the
// gather into 0/1 selector matmuls over a DMA'd band of source rows,
// because the TPU has no fast gather. An f32 gather on the GPU is exact
// everywhere, so this kernel computes what the TPU kernel computes, not
// how: no band, no column chunks, no hi/lo or bf16 precision modes. It
// equals the unbanded XLA sampler tcsfm/geom/warp.py::grid_sample.
//
// Bound: memory. Each output pixel reads its 8-byte coordinate pair, its
// four taps (C floats each, adjacent in NHWC) and writes C floats; the
// arithmetic is ~30 flops a pixel. At the coupled solver's main-path shape
// [24, 192, 640, 3] one call must read img (35.39 MB) and coords
// (23.59 MB) and write out (35.39 MB): 94.37 MB, about 28.2 us at the
// H100's 3.35 TB/s. The solver launches it 3 times per forward.
//
// Design: one thread per output pixel, looping over the C channels, so
// neighbouring threads read neighbouring coordinates and write
// neighbouring outputs (coalesced), and a near-identity warp makes their
// taps neighbours too. The tap geometry (bilinear.cuh) and the blend use
// __fmul_rn/__fadd_rn in the order of the plain PyTorch version
// (grid_sample_plain in the wrapper module, ops/grid_sample.py), so the
// compiler does not contract them into FMAs and the two agree to the last
// bit.
//
// C interface for ctypes: no PyTorch headers. Launches on the caller's
// stream, allocates nothing, does not synchronise; returns
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;

template <int C>
__device__ __forceinline__ void sample_pixel(const float* __restrict__ img,
                                             float cx, float cy,
                                             float* __restrict__ out,
                                             int b, int H, int W, int c_rt) {
  const int nc = C > 0 ? C : c_rt;
  const BilinearTaps t = bilinear_taps(cx, cy, H, W);
  const float* base = img + (int64_t)b * H * W * nc;
  const float* p00 = base + t.o00 * nc;
  const float* p10 = base + t.o10 * nc;
  const float* p01 = base + t.o01 * nc;
  const float* p11 = base + t.o11 * nc;

  // an out-of-image tap contributes an exact 0, as the plain version's
  // masked gather (value * 0) does
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const float v00 = t.i00 ? __ldg(p00 + c) : 0.0f;
    const float v10 = t.i10 ? __ldg(p10 + c) : 0.0f;
    const float v01 = t.i01 ? __ldg(p01 + c) : 0.0f;
    const float v11 = t.i11 ? __ldg(p11 + c) : 0.0f;
    float acc = __fmul_rn(v00, t.w00);
    acc = __fadd_rn(acc, __fmul_rn(v10, t.w10));
    acc = __fadd_rn(acc, __fmul_rn(v01, t.w01));
    acc = __fadd_rn(acc, __fmul_rn(v11, t.w11));
    out[c] = acc;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
grid_sample_fwd_kernel(const float* __restrict__ img,
                       const float* __restrict__ coords,
                       float* __restrict__ out,
                       int B, int H, int W, int c_rt) {
  const int64_t n = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t hw = (int64_t)H * W;
  if (n >= (int64_t)B * hw) return;
  const int nc = C > 0 ? C : c_rt;
  const int b = (int)(n / hw);
  const float cx = __ldg(coords + 2 * n);
  const float cy = __ldg(coords + 2 * n + 1);
  sample_pixel<C>(img, cx, cy, out + n * nc, b, H, W, c_rt);
}

}  // namespace

extern "C" int tcsfm_grid_sample_fwd(const float* img, const float* coords,
                                     float* out, int B, int H, int W, int C,
                                     void* stream) {
  const int64_t pixels = (int64_t)B * H * W;
  if (pixels == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((pixels + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      grid_sample_fwd_kernel<1><<<blocks, kThreads, 0, s>>>(img, coords, out, B, H, W, C);
      break;
    case 3:
      grid_sample_fwd_kernel<3><<<blocks, kThreads, 0, s>>>(img, coords, out, B, H, W, C);
      break;
    case 4:
      grid_sample_fwd_kernel<4><<<blocks, kThreads, 0, s>>>(img, coords, out, B, H, W, C);
      break;
    default:
      grid_sample_fwd_kernel<0><<<blocks, kThreads, 0, s>>>(img, coords, out, B, H, W, C);
      break;
  }
  return (int)cudaGetLastError();
}
