// Bilinear grid sample, forward: NHWC f32 image, normalized (x, y)
// coords, torch grid_sample semantics (align_corners=False, zero padding;
// coords pushed to 2.0 sample 0). Two instances of one kernel:
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
// the H100's 3.35 TB/s; the card copies at ~2.65 TB/s (a 70.8 MB
// copy_), ~35.6 us for those bytes. With the derivatives at the
// refiners' window batch [4, 192, 640, 3] it reads img (3 planes) and
// coords (2) and writes out, gx and gy (9): 14 f32 planes, 27.53 MB,
// about 8.2 us, of which ~2.5 us is a launch's own floor; at chain_ba's
// [10, 192, 640, 3] 68.81 MB, about 20.5 us. The coords and the planes
// are streamed once; the image is read again by the taps of neighbouring
// pixels and rows, from L1 or L2, and scattered coordinates spread one
// warp's tap loads over many cache lines.
//
// Design, for what held back a thread-per-pixel kernel (one 64-bit
// division a pixel, 4-byte accesses at 8- and 12-byte strides, no cache
// policy, a 1-D grid):
//   - No 64-bit division: a 3-D grid, (run column, tile row, image). A
//     block knows its image and tile from blockIdx. Offsets inside one
//     image are 32-bit (H*W*C < 2^31, checked at the launch); 64-bit
//     arithmetic only forms an image's and a run's base pointers.
//   - 16-byte streamed accesses: a warp owns a run of kRun = 64
//     consecutive pixels of one row. Lane l loads float4 l of the run's
//     coords (__ldcs: streamed, evict first) and hands each pixel's pair to
//     the lane that samples it by warp shuffle; each output plane goes out
//     as 16-byte __stcs stores, lane-contiguous, through a per-warp
//     shared-memory buffer that regroups the lanes' pixels into float4s
//     (for C = 4 a pixel's channels are one float4 and go straight out).
//   - A coalesced gather with the loads in flight together: lane l samples
//     pixels l and l + 32 of the run, so one load instruction reads a
//     channel of 32 neighbouring pixels' taps, and all four taps of both
//     pixels are loaded unconditionally (an out-of-image tap reads the
//     image's first pixel and is replaced by 0), no branch between them.
//     The taps go through the non-coherent cache (__ldg) with the L2's
//     default policy, so the evict-first streams leave the image in L2.
//   - 2-D tiles, one image at a time: a block of kWarps = 8 warps covers 8
//     rows of one 64-pixel column, so the source rows y0 and y1 of
//     neighbouring output rows meet in one SM's L1; blockIdx.x is the
//     fastest index, so the tiles of one image run together and keep its
//     1.47 MB in L2 while its taps are read. The value-only instances
//     take 32 registers, so 8 blocks of 256 threads fill an SM; an
//     arrangement of the same code that took 40 (6 blocks) ran 2.7%
//     slower at the main path's coordinates, so check -Xptxas -v after
//     any edit. With the derivatives 48-62 registers.
//   - The vector path needs the run inside the row and 16-byte-aligned
//     coords and planes (C in {1, 3, 4}). Elsewhere (the ragged end of a
//     row, a run whose first pixel does not fall on 16 bytes, a tensor
//     with a storage offset, any other C) the same lanes take a scalar
//     path: 4-byte loads and stores of the same pixels, the same
//     arithmetic.
// On the card (PERF.md), at the coupled forward's own coordinates the
// kernel runs at about the copy rate above; scattered coordinates
// (chip_smoke.py's smoke_coords) are bound by the gather.
// The tap geometry (bilinear.cuh), the blend and the derivatives use
// __fmul_rn/__fadd_rn in the order of the plain PyTorch versions
// (grid_sample_plain, grid_sample_with_grads_plain), so the compiler does
// not contract them into FMAs and kernel and plain version agree to the
// last bit. tests/test_torch_grid_sample.py emulates this walk on the CPU
// (it reads the constants below from this file).
//
// C interface for ctypes: no PyTorch headers. Launches on the caller's
// stream on the given device (launch.cuh), allocates nothing, does not
// synchronise; returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue, without a launch, where an image's offsets
// would not fit in 31 bits).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"
#include "launch.cuh"

namespace {

constexpr int kWarps = 8;                // warps in a block, a row each
constexpr int kLanePixels = 2;           // pixels a lane samples
constexpr int kRun = 32 * kLanePixels;   // pixels of a warp's run
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxImages = 65535;        // gridDim.z
// a lane loads kLanePixels / 2 float4s of the run's coords
static_assert(kLanePixels % 2 == 0, "a float4 holds two pixels' coords");

struct Texel {
  float v, gx, gy;
};

// One channel of one pixel: the blend of its taps and, with kGrads, its
// derivatives. All four taps are loaded (an out-of-image tap's offset is
// 0, inside the image), so the loads go out back to back, and an
// out-of-image tap contributes an exact 0, as the plain version's masked
// gather (value * 0) does.
template <bool kGrads>
__device__ __forceinline__ Texel sample_channel(const BilinearTaps32& t,
                                                const float* p00,
                                                const float* p10,
                                                const float* p01,
                                                const float* p11, int c,
                                                float sx, float sy) {
  const float l00 = __ldg(p00 + c), l10 = __ldg(p10 + c);
  const float l01 = __ldg(p01 + c), l11 = __ldg(p11 + c);
  const float v00 = t.i00 ? l00 : 0.0f;
  const float v10 = t.i10 ? l10 : 0.0f;
  const float v01 = t.i01 ? l01 : 0.0f;
  const float v11 = t.i11 ? l11 : 0.0f;
  Texel r;
  float acc = __fmul_rn(v00, t.w00);
  acc = __fadd_rn(acc, __fmul_rn(v10, t.w10));
  acc = __fadd_rn(acc, __fmul_rn(v01, t.w01));
  r.v = __fadd_rn(acc, __fmul_rn(v11, t.w11));
  if constexpr (kGrads) {
    const float dwx = __fadd_rn(__fmul_rn(t.wy0, __fadd_rn(v10, -v00)),
                                __fmul_rn(t.wy1, __fadd_rn(v11, -v01)));
    const float dwy = __fadd_rn(__fmul_rn(t.wx0, __fadd_rn(v01, -v00)),
                                __fmul_rn(t.wx1, __fadd_rn(v11, -v10)));
    r.gx = __fmul_rn(dwx, sx);
    r.gy = __fmul_rn(dwy, sy);
  }
  return r;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One plane of the run (lane l holding pixels l + 32 k) out with 16-byte
// streaming stores: for C = 4 a pixel's float4 straight, else through the
// warp's buffer, the lanes taking the run's float4s in turn.
template <int C>
__device__ __forceinline__ void store_plane(float* buf,
                                            const float (&p)[kLanePixels][C],
                                            float* dst, int lane) {
  float4* dst4 = reinterpret_cast<float4*>(dst);
  if constexpr (C == 4) {
#pragma unroll
    for (int k = 0; k < kLanePixels; ++k)
      __stcs(dst4 + 32 * k + lane,
             make_float4(p[k][0], p[k][1], p[k][2], p[k][3]));
  } else {
#pragma unroll
    for (int k = 0; k < kLanePixels; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c) buf[(32 * k + lane) * C + c] = p[k][c];
    __syncwarp();
    const float4* buf4 = reinterpret_cast<const float4*>(buf);
    constexpr int kF4 = kRun * C / 4;      // the plane's float4s in the run
#pragma unroll
    for (int j = 0; j < (kF4 + 31) / 32; ++j) {
      const int i = 32 * j + lane;
      if (kF4 % 32 == 0 || i < kF4) __stcs(dst4 + i, buf4[i]);
    }
    __syncwarp();
  }
}

// A warp's run of n <= kRun pixels starting at the run's coords cs and
// planes os, xs, ys, sampling the image im (H x W x nc).
template <int C, bool kGrads>
__device__ __forceinline__ void sample_run(const float* __restrict__ im,
                                           const float* __restrict__ cs,
                                           float* __restrict__ os,
                                           float* __restrict__ xs,
                                           float* __restrict__ ys, int n,
                                           int H, int W, int nc, float* buf,
                                           int lane) {
  const float sx = __fmul_rn((float)W, 0.5f);
  const float sy = __fmul_rn((float)H, 0.5f);
  const bool vec = (C == 1 || C == 3 || C == 4) && n == kRun &&
                   aligned16(cs) && aligned16(os) &&
                   (!kGrads || (aligned16(xs) && aligned16(ys)));
  if (vec) {
    constexpr int NC = C > 0 ? C : 1;
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
    float v[kLanePixels][NC], dx[kLanePixels][NC], dy[kLanePixels][NC];
#pragma unroll
    for (int k = 0; k < kLanePixels; ++k) {
      const BilinearTaps32 t = bilinear_taps32(xy[k].x, xy[k].y, H, W);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const Texel r = sample_channel<kGrads>(t, im + t.o00 * NC,
                                               im + t.o10 * NC,
                                               im + t.o01 * NC,
                                               im + t.o11 * NC, c, sx, sy);
        v[k][c] = r.v;
        if constexpr (kGrads) {
          dx[k][c] = r.gx;
          dy[k][c] = r.gy;
        }
      }
    }
    store_plane<NC>(buf, v, os, lane);
    if constexpr (kGrads) {
      store_plane<NC>(buf, dx, xs, lane);
      store_plane<NC>(buf, dy, ys, lane);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kLanePixels; ++k) {
    const int p = 32 * k + lane;
    if (p >= n) break;
    const BilinearTaps32 t =
        bilinear_taps32(__ldcs(cs + 2 * p), __ldcs(cs + 2 * p + 1), H, W);
    const auto channel = [&](int c) {
      const Texel r = sample_channel<kGrads>(t, im + t.o00 * nc,
                                             im + t.o10 * nc, im + t.o01 * nc,
                                             im + t.o11 * nc, c, sx, sy);
      __stcs(os + p * nc + c, r.v);
      if constexpr (kGrads) {
        __stcs(xs + p * nc + c, r.gx);
        __stcs(ys + p * nc + c, r.gy);
      }
    };
    if constexpr (C > 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) channel(c);
    } else {
#pragma unroll 1
      for (int c = 0; c < nc; ++c) channel(c);
    }
  }
}

// C > 0 fixes the channel count at compile time; C = 0 takes c_rt.
template <int C, bool kGrads>
__global__ void __launch_bounds__(kThreads)
grid_sample_fwd_kernel(const float* __restrict__ img,
                       const float* __restrict__ coords,
                       float* __restrict__ out,
                       float* __restrict__ gx,
                       float* __restrict__ gy,
                       int B, int H, int W, int c_rt) {
  // per warp: one plane of its run on the way out (C = 1, 3)
  __shared__ __align__(16) float buf[kWarps][kRun * (C == 3 ? 3 : 1)];
  const int nc = C > 0 ? C : c_rt;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.y * kWarps + warp;
  const int x0 = blockIdx.x * kRun;
  if (row >= H || x0 >= W) return;
  const int n = min(kRun, W - x0);
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const int64_t image = (int64_t)b * H * W;      // pixels before image b
    const int64_t px0 = image + (int64_t)row * W + x0;  // the run's first
    sample_run<C, kGrads>(img + image * nc, coords + 2 * px0, out + px0 * nc,
                          kGrads ? gx + px0 * nc : nullptr,
                          kGrads ? gy + px0 * nc : nullptr, n, H, W, nc,
                          buf[warp], lane);
  }
}

template <bool kGrads>
int launch(const float* img, const float* coords, float* out, float* gx,
           float* gy, int B, int H, int W, int C, int device, void* stream) {
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
      grid_sample_fwd_kernel<1, kGrads><<<grid, kThreads, 0, s>>>(
          img, coords, out, gx, gy, B, H, W, C);
      break;
    case 3:
      grid_sample_fwd_kernel<3, kGrads><<<grid, kThreads, 0, s>>>(
          img, coords, out, gx, gy, B, H, W, C);
      break;
    case 4:
      grid_sample_fwd_kernel<4, kGrads><<<grid, kThreads, 0, s>>>(
          img, coords, out, gx, gy, B, H, W, C);
      break;
    default:
      grid_sample_fwd_kernel<0, kGrads><<<grid, kThreads, 0, s>>>(
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
