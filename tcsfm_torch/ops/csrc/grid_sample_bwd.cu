// Bilinear grid sample, backward: the gradient of the forward kernel
// (grid_sample.cu) with respect to the normalized coordinates, and, for
// the channels named by a mask, with respect to the image. NHWC f32,
// torch grid_sample semantics (align_corners=False, zero padding).
//
// Replaces: tcsfm/ops/warp_mxu_grad.py::_make_bwd_kernel, both of its
// pallas_calls (grid_sample_mxu_bwd), and the pixel-to-normalized scaling
// of tcsfm/ops/warp_mxu.py::_gsm_bwd:
//   - tcsfm_grid_sample_bwd_coords: grad_ch=() (the pallas_call at
//     warp_mxu_grad.py:303), the solver's pose-only warps;
//   - tcsfm_grid_sample_bwd: grad_ch non-empty (warp_mxu_grad.py:294),
//     the loss stack's packed image+depth warp, grad_ch=(3,).
// The TPU kernel built both gradients from banded selector matmuls, and
// accumulated d_img with sequential read-modify-write DMAs of a band
// (TPU grid steps run in order). Here one thread per output pixel
// computes its own d_coords from its four taps, and scatters d_img with
// atomicAdd, since blocks run in no order.
//
// What is computed: the autodiff of the plain forward (grid_sample_plain
// in ops/grid_sample.py), which is JAX's autodiff of the XLA sampler
// tcsfm/geom/warp.py::grid_sample. With taps v00 v10 v01 v11 (0 outside
// the image) and weights wx1 = x - floor(x), wy1 = y - floor(y):
//   d_cx = (W/2) * sum_c g_c * (wy0*(v10 - v00) + wy1*(v11 - v01))
//   d_cy = (H/2) * sum_c g_c * (wx0*(v01 - v00) + wx1*(v11 - v10))
//   d_img[tap, k] += g_c * w_tap  for the k-th masked channel c, in-image taps
// Convention: at an exactly integer y (or x) this is the one-sided
// difference v(y+1) - v(y) that autodiff of the plain forward gives. The
// Pallas kernel's tent derivative -sign(y - row) gives 0 there instead
// (warp_mxu_grad.py:132-133); the two agree off integer coordinates.
// Coordinates pushed to 2.0 have all four taps outside: their gradient is
// an exact 0, as the reference's detached push requires.
//
// Determinism: d_coords sums the channels in a fixed order, in the f32
// operations and order of grid_sample_bwd_plain (__fmul_rn/__fadd_rn, no
// FMA contraction), so kernel and plain version agree to the last bit.
// d_img is summed with atomics in an order that changes between runs.
//
// Bound: memory. At the solver's shape [24, 192, 640, 3] the coords-only
// kernel reads img (3 planes of 11.80 MB), coords (2) and g (3) and writes
// d_coords (2): 117.96 MB, about 35.2 us at the H100's 3.35 TB/s. At the
// loss warp's [24, 192, 640, 4] with one masked channel it reads img (4),
// coords (2) and g (4) and writes d_coords (2) and one d_img plane (1):
// 153.35 MB, about 45.8 us, not counting the zero-fill of d_img and the
// atomics' read-modify-write. Arithmetic is ~15 flops a channel a pixel.
// Only the masked channels of d_img exist: the caller never allocates or
// writes a gradient for data channels.
//
// C interface for ctypes: no PyTorch headers. Launches on the caller's
// stream on the given device (launch.cuh), allocates nothing (d_img
// arrives zeroed), does not synchronise; returns cudaGetLastError() of the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

template <int C, bool kImg>
__global__ void __launch_bounds__(kThreads)
grid_sample_bwd_kernel(const float* __restrict__ img,
                       const float* __restrict__ coords,
                       const float* __restrict__ g,
                       float* __restrict__ d_coords,
                       float* __restrict__ d_img,
                       unsigned grad_mask, int B, int H, int W, int c_rt,
                       int Cg) {
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
  const float* gp = g + n * nc;

  float acc_x = 0.0f;
  float acc_y = 0.0f;
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const float v00 = t.i00 ? __ldg(p00 + c) : 0.0f;
    const float v10 = t.i10 ? __ldg(p10 + c) : 0.0f;
    const float v01 = t.i01 ? __ldg(p01 + c) : 0.0f;
    const float v11 = t.i11 ? __ldg(p11 + c) : 0.0f;
    const float gc = __ldg(gp + c);
    const float dwx = __fadd_rn(__fmul_rn(t.wy0, __fadd_rn(v10, -v00)),
                                __fmul_rn(t.wy1, __fadd_rn(v11, -v01)));
    const float dwy = __fadd_rn(__fmul_rn(t.wx0, __fadd_rn(v01, -v00)),
                                __fmul_rn(t.wx1, __fadd_rn(v11, -v10)));
    acc_x = __fadd_rn(acc_x, __fmul_rn(gc, dwx));
    acc_y = __fadd_rn(acc_y, __fmul_rn(gc, dwy));
  }
  d_coords[2 * n] = __fmul_rn(acc_x, __fmul_rn((float)W, 0.5f));
  d_coords[2 * n + 1] = __fmul_rn(acc_y, __fmul_rn((float)H, 0.5f));

  if (kImg) {
    float* dbase = d_img + (int64_t)b * hw * Cg;
    int k = 0;
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      if (!((grad_mask >> c) & 1u)) continue;
      const float gc = __ldg(gp + c);
      if (t.i00) atomicAdd(dbase + t.o00 * Cg + k, __fmul_rn(gc, t.w00));
      if (t.i10) atomicAdd(dbase + t.o10 * Cg + k, __fmul_rn(gc, t.w10));
      if (t.i01) atomicAdd(dbase + t.o01 * Cg + k, __fmul_rn(gc, t.w01));
      if (t.i11) atomicAdd(dbase + t.o11 * Cg + k, __fmul_rn(gc, t.w11));
      ++k;
    }
  }
}

template <bool kImg>
int launch(const float* img, const float* coords, const float* g,
           float* d_coords, float* d_img, unsigned grad_mask, int B, int H,
           int W, int C, int Cg, int device, void* stream) {
  const int64_t pixels = (int64_t)B * H * W;
  if (pixels == 0) return (int)cudaSuccess;
  DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return (int)scope.status();
  const unsigned blocks = (unsigned)((pixels + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      grid_sample_bwd_kernel<1, kImg><<<blocks, kThreads, 0, s>>>(
          img, coords, g, d_coords, d_img, grad_mask, B, H, W, C, Cg);
      break;
    case 3:
      grid_sample_bwd_kernel<3, kImg><<<blocks, kThreads, 0, s>>>(
          img, coords, g, d_coords, d_img, grad_mask, B, H, W, C, Cg);
      break;
    case 4:
      grid_sample_bwd_kernel<4, kImg><<<blocks, kThreads, 0, s>>>(
          img, coords, g, d_coords, d_img, grad_mask, B, H, W, C, Cg);
      break;
    default:
      grid_sample_bwd_kernel<0, kImg><<<blocks, kThreads, 0, s>>>(
          img, coords, g, d_coords, d_img, grad_mask, B, H, W, C, Cg);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// d_coords [B,H,W,2] only: the gradient of sampling data channels.
extern "C" int tcsfm_grid_sample_bwd_coords(const float* img,
                                            const float* coords,
                                            const float* g, float* d_coords,
                                            int B, int H, int W, int C,
                                            int device, void* stream) {
  return launch<false>(img, coords, g, d_coords, nullptr, 0u, B, H, W, C, 0,
                       device, stream);
}

// d_coords [B,H,W,2] and d_img [B,H,W,Cg] (zeroed by the caller) for the
// Cg channels whose bits are set in grad_mask, in channel order.
extern "C" int tcsfm_grid_sample_bwd(const float* img, const float* coords,
                                     const float* g, float* d_coords,
                                     float* d_img, unsigned grad_mask, int B,
                                     int H, int W, int C, int Cg,
                                     int device, void* stream) {
  return launch<true>(img, coords, g, d_coords, d_img, grad_mask, B, H, W, C,
                      Cg, device, stream);
}
