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
// accumulated d_img band by band in VMEM, with read-modify-write DMAs of
// a band (TPU grid steps run in order). Here blocks run in no order, and
// each in-image tap adds its product to d_img with a global reduction,
// which the L2 executes natively in f32.
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
// reductions' read-modify-write in L2. Arithmetic is ~15 flops a channel
// a pixel. Only the masked channels of d_img exist: the caller never
// allocates or writes a gradient for data channels.
//
// Design, as the forward kernel's (grid_sample.cu), for what held back a
// thread-per-pixel kernel (a 64-bit division a pixel, 4-byte accesses at
// 8- and 12-byte strides, tap loads behind branches, d_img by scalar
// global atomics):
//   - A 3-D grid, (run column, tile row, image): no division. A block of
//     kWarps warps covers a tile of kWarps rows of one kRun-pixel column,
//     a warp the run of one row; images by a blockIdx.z stride loop.
//     Offsets inside an image are 32-bit (H*W*C < 2^31, checked at the
//     launch); 64-bit arithmetic only forms an image's and a run's base.
//   - Streamed 16-byte accesses: lane l loads float4 l of the run's
//     coords (__ldcs) and hands each pixel's pair to the lane that takes
//     it by warp shuffle; g arrives as float4s (__ldcs), for C = 4 one a
//     pixel, for C = 1, 3 through a per-warp shared-memory buffer;
//     d_coords leaves as float4s of two pixels' (dx, dy), regrouped by
//     shuffle, with __stcs. The streams are evict-first, so the image's
//     taps keep the L2.
//   - Unconditional tap loads, lane l taking pixels l and l + 32 of the
//     run: one load instruction reads 32 neighbouring pixels' taps, and an
//     out-of-image tap reads the image's first pixel and is then zeroed.
//     For C = 4 a tap is one 16-byte __ldg.
//   - d_img (the masked-channel instance) in the same pass: each in-image
//     tap's product goes to d_img with a global reduction (RED.E.ADD.F32),
//     a product that is exactly 0 (the loss's depth channel under the
//     config's defaults) not at all. Gathering a tile's or a warp's taps
//     in a shared-memory box first, then flushing it with sm_90's vector
//     reductions (red.global.add.v4.f32), ran slower on the card at the
//     training step's coordinates (PERF.md): its shared-memory f32
//     atomicAdd is a compare-and-swap loop (ATOMS.CAST.SPIN), while the
//     L2's f32 reduction is native, and the boxes cost barriers, shared
//     memory and, where a run's taps spread over many rows, overflow.
//   - __launch_bounds__(kThreads, kMinBlocks): both instances run fastest
//     at the 64 registers that allows (check -Xptxas -v after any edit).
//   - The vector path needs the run inside the row and 16-byte-aligned
//     coords, g and d_coords (C in {1, 3, 4}; for C = 4 an aligned image).
//     Elsewhere (a row's ragged end, a misaligned run, any other C) the
//     same lanes take a scalar path with the same arithmetic.
// tests/test_torch_grid_sample_bwd_walk.py emulates this walk on the CPU
// (it reads the constants below from this file).
//
// C interface for ctypes: no PyTorch headers. Launches on the caller's
// stream on the given device (launch.cuh), allocates nothing (d_img
// arrives zeroed), does not synchronise; returns cudaGetLastError() of the
// launch (cudaErrorInvalidValue, without a launch, where an image's
// offsets would not fit in 31 bits).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"
#include "launch.cuh"

namespace {

constexpr int kWarps = 8;                // warps in a block, a row each
constexpr int kLanePixels = 2;           // pixels a lane takes
constexpr int kRun = 32 * kLanePixels;   // pixels of a warp's run
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxImages = 65535;        // gridDim.z
constexpr int kMinBlocks = 4;            // blocks an SM: 64 registers a thread
// a lane loads kLanePixels / 2 float4s of the run's coords
static_assert(kLanePixels % 2 == 0, "a float4 holds two pixels' coords");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One channel's term of a pixel's d_coords, added in the plain version's
// order: the slopes of the channel's taps weighted by its g.
__device__ __forceinline__ void add_channel(const BilinearTaps32& t,
                                            float l00, float l10, float l01,
                                            float l11, float gc, float& ax,
                                            float& ay) {
  const float v00 = t.i00 ? l00 : 0.0f;
  const float v10 = t.i10 ? l10 : 0.0f;
  const float v01 = t.i01 ? l01 : 0.0f;
  const float v11 = t.i11 ? l11 : 0.0f;
  const float dwx = __fadd_rn(__fmul_rn(t.wy0, __fadd_rn(v10, -v00)),
                              __fmul_rn(t.wy1, __fadd_rn(v11, -v01)));
  const float dwy = __fadd_rn(__fmul_rn(t.wx0, __fadd_rn(v01, -v00)),
                              __fmul_rn(t.wx1, __fadd_rn(v11, -v10)));
  ax = __fadd_rn(ax, __fmul_rn(gc, dwx));
  ay = __fadd_rn(ay, __fmul_rn(gc, dwy));
}

// A pixel's d_img for the k-th masked channel (g_c = gc): each in-image
// tap's product gc * w added to the image's d_img (Cg floats a pixel) by a
// global reduction; a product that is exactly 0 is not added.
__device__ __forceinline__ void add_taps(const BilinearTaps32& t, float gc,
                                         float* dimg, int Cg, int k) {
  const bool in[4] = {t.i00, t.i10, t.i01, t.i11};
  const int o[4] = {t.o00, t.o10, t.o01, t.o11};
  const float w[4] = {t.w00, t.w10, t.w01, t.w11};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float v = __fmul_rn(gc, w[a]);
    if (in[a] && v != 0.0f) atomicAdd(dimg + o[a] * Cg + k, v);
  }
}

// C > 0 fixes the channel count at compile time; C = 0 takes c_rt. kImg:
// d_img for the channels of grad_mask, Cg of them.
template <int C, bool kImg>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
grid_sample_bwd_kernel(const float* __restrict__ img,
                       const float* __restrict__ coords,
                       const float* __restrict__ g,
                       float* __restrict__ d_coords,
                       float* __restrict__ d_img,
                       unsigned grad_mask, int B, int H, int W, int c_rt,
                       int Cg) {
  constexpr int NC = C > 0 ? C : 1;
  // per warp: the run's g on its way in (C = 1, 3)
  __shared__ __align__(16) float buf[kWarps][C == 1 || C == 3 ? kRun * C : 4];
  const int nc = C > 0 ? C : c_rt;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.y * kWarps + warp;
  const int x0 = blockIdx.x * kRun;
  if (row >= H) return;                       // a warp below the last row
  const int n = min(kRun, W - x0);
  const float sx = __fmul_rn((float)W, 0.5f);
  const float sy = __fmul_rn((float)H, 0.5f);
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const int64_t image = (int64_t)b * H * W;           // pixels before image b
    const int64_t px0 = image + (int64_t)row * W + x0;  // the run's first
    const float* im = img + image * nc;
    const float* cs = coords + 2 * px0;
    const float* gs = g + px0 * nc;
    float* ds = d_coords + 2 * px0;
    float* dimg = kImg ? d_img + image * Cg : nullptr;
    const bool vec = (C == 1 || C == 3 || C == 4) && n == kRun &&
                     aligned16(cs) && aligned16(gs) && aligned16(ds) &&
                     (C != 4 || aligned16(im));
    if (vec) {
      // the run's coords, float4 32 j + l in lane l; pixel 32 k + l's are
      // half of float4 16 k + l / 2, which lane (16 k + l / 2) % 32 holds
      const float4* cs4 = reinterpret_cast<const float4*>(cs);
      float4 c4[kLanePixels / 2];
#pragma unroll
      for (int j = 0; j < kLanePixels / 2; ++j)
        c4[j] = __ldcs(cs4 + 32 * j + lane);
      float2 xy[kLanePixels];
#pragma unroll
      for (int k = 0; k < kLanePixels; ++k) {
        const int src = (16 * k + (lane >> 1)) & 31;
        const float4 q = c4[k >> 1];
        const float ax = __shfl_sync(0xffffffffu, q.x, src);
        const float ay = __shfl_sync(0xffffffffu, q.y, src);
        const float bx = __shfl_sync(0xffffffffu, q.z, src);
        const float by = __shfl_sync(0xffffffffu, q.w, src);
        xy[k] = (lane & 1) ? make_float2(bx, by) : make_float2(ax, ay);
      }
      // g: for C = 4 a pixel's channels are one float4; for C = 1, 3 the
      // run's float4s go through the warp's buffer, the lanes taking them
      // in turn
      float gk[kLanePixels][NC];
      const float4* gs4 = reinterpret_cast<const float4*>(gs);
      if constexpr (C == 4) {
#pragma unroll
        for (int k = 0; k < kLanePixels; ++k) {
          const float4 q = __ldcs(gs4 + 32 * k + lane);
          gk[k][0] = q.x;
          gk[k][1] = q.y;
          gk[k][2] = q.z;
          gk[k][3] = q.w;
        }
      } else {
        float4* buf4 = reinterpret_cast<float4*>(buf[warp]);
        constexpr int kF4 = kRun * NC / 4;      // the run's g in float4s
#pragma unroll
        for (int j = 0; j < (kF4 + 31) / 32; ++j) {
          const int i = 32 * j + lane;
          if (kF4 % 32 == 0 || i < kF4) buf4[i] = __ldcs(gs4 + i);
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < kLanePixels; ++k)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            gk[k][c] = buf[warp][(32 * k + lane) * NC + c];
        __syncwarp();
      }
      float dx[kLanePixels], dy[kLanePixels];
#pragma unroll
      for (int k = 0; k < kLanePixels; ++k) {
        const BilinearTaps32 t = bilinear_taps32(xy[k].x, xy[k].y, H, W);
        float ax = 0.0f, ay = 0.0f;
        if constexpr (C == 4) {
          const float4* im4 = reinterpret_cast<const float4*>(im);
          const float4 q00 = __ldg(im4 + t.o00), q10 = __ldg(im4 + t.o10);
          const float4 q01 = __ldg(im4 + t.o01), q11 = __ldg(im4 + t.o11);
          add_channel(t, q00.x, q10.x, q01.x, q11.x, gk[k][0], ax, ay);
          add_channel(t, q00.y, q10.y, q01.y, q11.y, gk[k][1], ax, ay);
          add_channel(t, q00.z, q10.z, q01.z, q11.z, gk[k][2], ax, ay);
          add_channel(t, q00.w, q10.w, q01.w, q11.w, gk[k][3], ax, ay);
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c)
            add_channel(t, __ldg(im + t.o00 * NC + c),
                        __ldg(im + t.o10 * NC + c), __ldg(im + t.o01 * NC + c),
                        __ldg(im + t.o11 * NC + c), gk[k][c], ax, ay);
        }
        dx[k] = __fmul_rn(ax, sx);
        dy[k] = __fmul_rn(ay, sy);
        if constexpr (kImg) {
          int kk = 0;
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if ((grad_mask >> c) & 1u) add_taps(t, gk[k][c], dimg, Cg, kk++);
        }
      }
      // float4 32 j + l of the run's d_coords holds pixels 64 j + 2 l and
      // 64 j + 2 l + 1: slot 2 j + l / 16 of lanes 2 l % 32 and 2 l % 32 + 1
      float4* ds4 = reinterpret_cast<float4*>(ds);
      const int s = (2 * lane) & 31;
      const bool upper = lane >= 16;
#pragma unroll
      for (int j = 0; j < kLanePixels / 2; ++j) {
        const float ax = __shfl_sync(0xffffffffu, dx[2 * j], s);
        const float ay = __shfl_sync(0xffffffffu, dy[2 * j], s);
        const float bx = __shfl_sync(0xffffffffu, dx[2 * j], s + 1);
        const float by = __shfl_sync(0xffffffffu, dy[2 * j], s + 1);
        const float cx = __shfl_sync(0xffffffffu, dx[2 * j + 1], s);
        const float cy = __shfl_sync(0xffffffffu, dy[2 * j + 1], s);
        const float ex = __shfl_sync(0xffffffffu, dx[2 * j + 1], s + 1);
        const float ey = __shfl_sync(0xffffffffu, dy[2 * j + 1], s + 1);
        __stcs(ds4 + 32 * j + lane,
               upper ? make_float4(cx, cy, ex, ey)
                     : make_float4(ax, ay, bx, by));
      }
      continue;
    }
#pragma unroll
    for (int k = 0; k < kLanePixels; ++k) {
      const int p = 32 * k + lane;
      if (p >= n) break;
      const BilinearTaps32 t =
          bilinear_taps32(__ldcs(cs + 2 * p), __ldcs(cs + 2 * p + 1), H, W);
      float ax = 0.0f, ay = 0.0f;
      int kk = 0;
      const auto channel = [&](int c) {
        const float gc = __ldcs(gs + p * nc + c);
        add_channel(t, __ldg(im + t.o00 * nc + c), __ldg(im + t.o10 * nc + c),
                    __ldg(im + t.o01 * nc + c), __ldg(im + t.o11 * nc + c),
                    gc, ax, ay);
        if constexpr (kImg)
          if ((grad_mask >> c) & 1u) add_taps(t, gc, dimg, Cg, kk++);
      };
      if constexpr (C > 0) {
#pragma unroll
        for (int c = 0; c < C; ++c) channel(c);
      } else {
#pragma unroll 1
        for (int c = 0; c < nc; ++c) channel(c);
      }
      __stcs(ds + 2 * p, __fmul_rn(ax, sx));
      __stcs(ds + 2 * p + 1, __fmul_rn(ay, sy));
    }
  }
}

template <bool kImg>
int launch(const float* img, const float* coords, const float* g,
           float* d_coords, float* d_img, unsigned grad_mask, int B, int H,
           int W, int C, int Cg, int device, void* stream) {
  if ((int64_t)B * H * W * C == 0) return (int)cudaSuccess;
  if ((int64_t)H * W * C >= ((int64_t)1 << 31) ||
      (H + kWarps - 1) / kWarps > 65535)
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return (int)scope.status();
  const dim3 grid((W + kRun - 1) / kRun, (H + kWarps - 1) / kWarps,
                  B < kMaxImages ? B : kMaxImages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      grid_sample_bwd_kernel<1, kImg><<<grid, kThreads, 0, s>>>(
          img, coords, g, d_coords, d_img, grad_mask, B, H, W, C, Cg);
      break;
    case 3:
      grid_sample_bwd_kernel<3, kImg><<<grid, kThreads, 0, s>>>(
          img, coords, g, d_coords, d_img, grad_mask, B, H, W, C, Cg);
      break;
    case 4:
      grid_sample_bwd_kernel<4, kImg><<<grid, kThreads, 0, s>>>(
          img, coords, g, d_coords, d_img, grad_mask, B, H, W, C, Cg);
      break;
    default:
      grid_sample_bwd_kernel<0, kImg><<<grid, kThreads, 0, s>>>(
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
