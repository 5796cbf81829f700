// The four bilinear taps of one output pixel, shared by the sampler's
// forward (grid_sample.cu) and backward (grid_sample_bwd.cu) kernels:
// torch grid_sample semantics (align_corners=False, zero padding), in the
// f32 operations and order of the plain PyTorch versions in
// ops/grid_sample.py. __fmul_rn/__fadd_rn keep the compiler from
// contracting them into FMAs, so kernel and plain version agree to the
// last bit. Offsets are 32-bit: each kernel checks at its launch that an
// image's offsets (H*W*C) fit in 31 bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct BilinearTaps32 {
  float wx0, wx1, wy0, wy1;   // 1-D weights
  float w00, w10, w01, w11;   // tap weights, w10 = wx1 * wy0
  bool i00, i10, i01, i11;    // tap inside the image
  int o00, o10, o01, o11;     // tap's pixel index in its image (0 when outside)
};

__device__ __forceinline__ BilinearTaps32 bilinear_taps32(float cx, float cy,
                                                          int H, int W) {
  BilinearTaps32 t;
  // align_corners=False un-normalization: x = ((g + 1) * W - 1) / 2
  const float x = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(cx, 1.0f), (float)W), -1.0f), 0.5f);
  const float y = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(cy, 1.0f), (float)H), -1.0f), 0.5f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float x1 = __fadd_rn(x0, 1.0f);
  const float y1 = __fadd_rn(y0, 1.0f);
  t.wx1 = __fadd_rn(x, -x0);
  t.wx0 = __fadd_rn(1.0f, -t.wx1);
  t.wy1 = __fadd_rn(y, -y0);
  t.wy0 = __fadd_rn(1.0f, -t.wy1);

  // bounds are tested on the float index, before any int conversion, so
  // coordinates far outside the image (or pushed to 2.0) cannot overflow
  const float wm1 = (float)(W - 1);
  const float hm1 = (float)(H - 1);
  const bool vx0 = x0 >= 0.0f && x0 <= wm1;
  const bool vx1 = x1 >= 0.0f && x1 <= wm1;
  const bool vy0 = y0 >= 0.0f && y0 <= hm1;
  const bool vy1 = y1 >= 0.0f && y1 <= hm1;
  t.i00 = vx0 && vy0;
  t.i10 = vx1 && vy0;
  t.i01 = vx0 && vy1;
  t.i11 = vx1 && vy1;

  t.w00 = __fmul_rn(t.wx0, t.wy0);
  t.w10 = __fmul_rn(t.wx1, t.wy0);
  t.w01 = __fmul_rn(t.wx0, t.wy1);
  t.w11 = __fmul_rn(t.wx1, t.wy1);

  const int ix0 = t.i00 || t.i01 ? (int)x0 : 0;
  const int ix1 = t.i10 || t.i11 ? (int)x1 : 0;
  const int iy0 = t.i00 || t.i10 ? (int)y0 : 0;
  const int iy1 = t.i01 || t.i11 ? (int)y1 : 0;
  t.o00 = iy0 * W + ix0;
  t.o10 = iy0 * W + ix1;
  t.o01 = iy1 * W + ix0;
  t.o11 = iy1 * W + ix1;
  return t;
}
