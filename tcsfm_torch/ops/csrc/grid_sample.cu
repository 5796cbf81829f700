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
// taps neighbours too. The arithmetic uses __fmul_rn/__fadd_rn in the
// order of the plain PyTorch version (grid_sample_plain in the wrapper
// module, ops/grid_sample.py), so the compiler does not contract it into
// FMAs and the two agree to the last bit.
//
// C interface for ctypes: no PyTorch headers. Launches on the caller's
// stream, allocates nothing, does not synchronise; returns
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int C>
__device__ __forceinline__ void sample_pixel(const float* __restrict__ img,
                                             float cx, float cy,
                                             float* __restrict__ out,
                                             int b, int H, int W, int c_rt) {
  const int nc = C > 0 ? C : c_rt;
  // align_corners=False un-normalization: x = ((g + 1) * W - 1) / 2
  const float x = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(cx, 1.0f), (float)W), -1.0f), 0.5f);
  const float y = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(cy, 1.0f), (float)H), -1.0f), 0.5f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float x1 = __fadd_rn(x0, 1.0f);
  const float y1 = __fadd_rn(y0, 1.0f);
  const float wx1 = __fadd_rn(x, -x0);
  const float wx0 = __fadd_rn(1.0f, -wx1);
  const float wy1 = __fadd_rn(y, -y0);
  const float wy0 = __fadd_rn(1.0f, -wy1);

  // bounds are tested on the float index, before any int conversion, so
  // coordinates far outside the image (or pushed to 2.0) cannot overflow
  const float wm1 = (float)(W - 1);
  const float hm1 = (float)(H - 1);
  const bool vx0 = x0 >= 0.0f && x0 <= wm1;
  const bool vx1 = x1 >= 0.0f && x1 <= wm1;
  const bool vy0 = y0 >= 0.0f && y0 <= hm1;
  const bool vy1 = y1 >= 0.0f && y1 <= hm1;
  const bool i00 = vx0 && vy0, i10 = vx1 && vy0, i01 = vx0 && vy1, i11 = vx1 && vy1;

  const float w00 = __fmul_rn(wx0, wy0);
  const float w10 = __fmul_rn(wx1, wy0);
  const float w01 = __fmul_rn(wx0, wy1);
  const float w11 = __fmul_rn(wx1, wy1);

  const int ix0 = i00 || i01 ? (int)x0 : 0;
  const int ix1 = i10 || i11 ? (int)x1 : 0;
  const int iy0 = i00 || i10 ? (int)y0 : 0;
  const int iy1 = i01 || i11 ? (int)y1 : 0;
  const float* base = img + (int64_t)b * H * W * nc;
  const float* p00 = base + ((int64_t)iy0 * W + ix0) * nc;
  const float* p10 = base + ((int64_t)iy0 * W + ix1) * nc;
  const float* p01 = base + ((int64_t)iy1 * W + ix0) * nc;
  const float* p11 = base + ((int64_t)iy1 * W + ix1) * nc;

  // an out-of-image tap contributes an exact 0, as the plain version's
  // masked gather (value * 0) does
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const float v00 = i00 ? __ldg(p00 + c) : 0.0f;
    const float v10 = i10 ? __ldg(p10 + c) : 0.0f;
    const float v01 = i01 ? __ldg(p01 + c) : 0.0f;
    const float v11 = i11 ? __ldg(p11 + c) : 0.0f;
    float acc = __fmul_rn(v00, w00);
    acc = __fadd_rn(acc, __fmul_rn(v10, w10));
    acc = __fadd_rn(acc, __fmul_rn(v01, w01));
    acc = __fadd_rn(acc, __fmul_rn(v11, w11));
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
