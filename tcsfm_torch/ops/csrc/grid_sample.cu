// Bilinear grid sample, forward: NHWC f32 image, normalized (x, y)
// coords, torch grid_sample semantics (align_corners=False, zero padding;
// coords pushed to 2.0 sample 0). Two variants of one kernel:
//   - value only (tcsfm_grid_sample_fwd);
//   - value and its derivatives with respect to the normalized coords,
//     per channel (tcsfm_grid_sample_fwd_grads), the jvp of the refiners.
//
// Replaces: tcsfm/ops/warp_mxu.py::_make_kernel, the Pallas kernel
// launched by grid_sample_mxu (with_grads=False) and by
// grid_sample_mxu_with_grads (with_grads=True, the pallas_call at
// warp_mxu.py:526). The TPU kernel turned the gather into 0/1 selector
// matmuls over a DMA'd band of source rows, because the TPU has no fast
// gather, and read the derivatives off the same matmul results. An f32
// gather on the GPU is exact everywhere, so this kernel computes what the
// TPU kernel computes, not how: no band, no column chunks, no hi/lo or
// bf16 precision modes. It equals the unbanded XLA sampler
// tcsfm/geom/warp.py::grid_sample.
//
// The derivatives: with taps v00 v10 v01 v11 (0 outside the image) and
// weights wx1 = x - floor(x), wy1 = y - floor(y), for each channel
//   gx = (wy0*(v10 - v00) + wy1*(v11 - v01)) * (W/2)
//   gy = (wx0*(v01 - v00) + wx1*(v11 - v10)) * (H/2)
// which is autodiff of the plain forward (grid_sample_plain in
// ops/grid_sample.py). Convention: at an exactly integer y (or x) this is
// the one-sided difference v(y+1) - v(y); the Pallas kernel's tent
// derivative (warp_mxu.py:202-205) gives gy = 0 there. Following autodiff
// makes this kernel's jvp exactly the transpose of the backward kernels
// in grid_sample_bwd.cu, which follow it too; the two conventions agree
// off integer coordinates. Pushed coordinates have all four taps outside:
// out = gx = gy = 0 there.
//
// Bound: memory. Each output pixel reads its 8-byte coordinate pair, its
// four taps (C floats each, adjacent in NHWC) and writes C floats (3C with
// the derivatives); the arithmetic is ~30 flops a pixel for the value and
// ~15 more a channel for the derivatives. At the coupled solver's shape
// [24, 192, 640, 3] the value-only call must read img (35.39 MB) and
// coords (23.59 MB) and write out (35.39 MB): 94.37 MB, about 28.2 us at
// the H100's 3.35 TB/s. With the derivatives at the refiners' window
// batch [4, 192, 640, 3] it reads img (3 planes) and coords (2) and writes
// out, gx and gy (9): 14 f32 planes, 27.53 MB, about 8.2 us; at chain_ba's
// [10, 192, 640, 3] 68.81 MB, about 20.5 us.
//
// Design: one thread per output pixel, looping over the C channels, so
// neighbouring threads read neighbouring coordinates and write
// neighbouring outputs (coalesced), and a near-identity warp makes their
// taps neighbours too. The tap geometry (bilinear.cuh), the blend and the
// derivatives use __fmul_rn/__fadd_rn in the order of the plain PyTorch
// versions (grid_sample_plain, grid_sample_with_grads_plain), so the
// compiler does not contract them into FMAs and kernel and plain version
// agree to the last bit.
//
// C interface for ctypes: no PyTorch headers. Launches on the caller's
// stream on the given device (launch.cuh), allocates nothing, does not
// synchronise; returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

template <int C, bool kGrads>
__global__ void __launch_bounds__(kThreads)
grid_sample_fwd_kernel(const float* __restrict__ img,
                       const float* __restrict__ coords,
                       float* __restrict__ out,
                       float* __restrict__ gx,
                       float* __restrict__ gy,
                       int B, int H, int W, int c_rt) {
  const int64_t n = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t hw = (int64_t)H * W;
  if (n >= (int64_t)B * hw) return;
  const int nc = C > 0 ? C : c_rt;
  const int b = (int)(n / hw);
  const BilinearTaps t = bilinear_taps(__ldg(coords + 2 * n),
                                       __ldg(coords + 2 * n + 1), H, W);
  const float* base = img + (int64_t)b * hw * nc;
  const float* p00 = base + t.o00 * nc;
  const float* p10 = base + t.o10 * nc;
  const float* p01 = base + t.o01 * nc;
  const float* p11 = base + t.o11 * nc;
  const float sx = __fmul_rn((float)W, 0.5f);
  const float sy = __fmul_rn((float)H, 0.5f);

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
    out[n * nc + c] = acc;
    if (kGrads) {
      const float dwx = __fadd_rn(__fmul_rn(t.wy0, __fadd_rn(v10, -v00)),
                                  __fmul_rn(t.wy1, __fadd_rn(v11, -v01)));
      const float dwy = __fadd_rn(__fmul_rn(t.wx0, __fadd_rn(v01, -v00)),
                                  __fmul_rn(t.wx1, __fadd_rn(v11, -v10)));
      gx[n * nc + c] = __fmul_rn(dwx, sx);
      gy[n * nc + c] = __fmul_rn(dwy, sy);
    }
  }
}

template <bool kGrads>
int launch(const float* img, const float* coords, float* out, float* gx,
           float* gy, int B, int H, int W, int C, int device, void* stream) {
  const int64_t pixels = (int64_t)B * H * W;
  if (pixels == 0) return (int)cudaSuccess;
  DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return (int)scope.status();
  const unsigned blocks = (unsigned)((pixels + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      grid_sample_fwd_kernel<1, kGrads><<<blocks, kThreads, 0, s>>>(
          img, coords, out, gx, gy, B, H, W, C);
      break;
    case 3:
      grid_sample_fwd_kernel<3, kGrads><<<blocks, kThreads, 0, s>>>(
          img, coords, out, gx, gy, B, H, W, C);
      break;
    case 4:
      grid_sample_fwd_kernel<4, kGrads><<<blocks, kThreads, 0, s>>>(
          img, coords, out, gx, gy, B, H, W, C);
      break;
    default:
      grid_sample_fwd_kernel<0, kGrads><<<blocks, kThreads, 0, s>>>(
          img, coords, out, gx, gy, B, H, W, C);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out [B,H,W,C].
extern "C" int tcsfm_grid_sample_fwd(const float* img, const float* coords,
                                     float* out, int B, int H, int W, int C,
                                     int device, void* stream) {
  return launch<false>(img, coords, out, nullptr, nullptr, B, H, W, C,
                       device, stream);
}

// out, gx = d out / d coords[..., 0] and gy = d out / d coords[..., 1],
// each [B,H,W,C].
extern "C" int tcsfm_grid_sample_fwd_grads(const float* img,
                                           const float* coords, float* out,
                                           float* gx, float* gy, int B, int H,
                                           int W, int C, int device,
                                           void* stream) {
  return launch<true>(img, coords, out, gx, gy, B, H, W, C, device, stream);
}
