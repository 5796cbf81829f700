// The depth decoder's full-resolution tail, fused: from the last upconv's
// pre-ELU output x [N, 32, H, W] (NCHW f32) to the disparity
//   out = sigmoid(conv3(elu(conv2(elu(conv1(elu(x)))))))   [N, H, W, 1],
// each conv a 3x3 conv over its own input reflect-padded by one pixel:
// conv1 32->32 (iconv4), conv2 32->8 (feature_conv0), conv3 8->1
// (disp_head0). Weights are nn.Conv2d's OIHW.
//
// Replaces: experiments/decoder_tail.py::_tail_kernel, the Pallas kernel
// launched by _tail_forward (its pallas_call at decoder_tail.py:200). The
// TPU kernel worked on the upconv's subpixel "phase" layout on the
// half-resolution grid, where reflect padding becomes edge replication, so
// that its matmuls had 128-lane operands, and ran them in bf16. Both were
// TPU layout and precision devices: this kernel reads the full-resolution
// NCHW tensor the port's decoder produces on the card and computes in
// f32, as the
// literal reference (decoder_tail_reference, and decoder_tail_plain in
// ops/decoder_tail.py) does. What it keeps from the TPU kernel is the
// fusion: nothing full-resolution but x and out touches device memory.
//
// Bound: operations. Per output pixel the three convs take 9*32*32 +
// 9*32*8 + 9*8 = 11,592 multiply-adds; the pixel's bytes are 32 floats of
// x read and 1 written. At the coupled forward's shape [18, 32, 192, 640]
// that is 51.3 GFLOP (0.77 ms at the H100's 67 TFLOP/s of f32 outside the
// tensor cores) against 292 MB (0.087 ms at 3.35 TB/s).
//
// Design (a simple one; no tensor cores, no TMA): one block of 256
// threads per 16x16 output tile. The block stages elu(x) over the tile and
// a 3-pixel halo (22x22x32) and the weights in shared memory, computes
// f1 = elu(conv1) over the tile and a 2-pixel halo (20x20x32), then
// f2 = elu(conv2) over the tile and a 1-pixel halo (18x18x8, in the space
// elu(x) held), then writes sigmoid(conv3) for the tile's in-image pixels.
// Halo recompute: conv1 runs at 400 positions for 256 outputs (1.56x),
// conv2 at 324 (1.27x); 1.50x the multiply-adds overall. Each thread of
// conv1 and conv2 accumulates two pixels' output channels in registers and
// reads the weights as float4 broadcasts from shared memory. 159,696 bytes
// of shared memory a block: one block an SM, opted in above 48 KB with
// cudaFuncSetAttribute.
//
// Reflect padding per layer: the reference pads every intermediate anew,
// so f1 at row -1 is f1 at row 1, not conv1 of padded elu(x) at row -1.
// Every buffer cell at image coordinate g holds its layer's value at
// reflect(g) (-1 -> 1, n -> n-2; cells further out, which no output
// needs, are clamped to -1 or n first), and a cell is computed as the conv
// at reflect(g), reading the previous buffer at reflect(g) + {-1, 0, 1}.
// Those reads fall in the previous buffer for every cell an output needs;
// they are clamped into it for the rest. So all four borders of every
// tile, and images smaller than a tile, come out as the reference's.
//
// The sums run over (input channel, tap) in their own order, with FMAs:
// kernel and plain version differ by f32 rounding, not bit for bit.
//
// C interface for ctypes: no PyTorch headers. Launches on the caller's
// stream on the given device (launch.cuh), allocates nothing, does not
// synchronise; returns the first error of the attribute call or the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kC1 = 32;     // channels of x and of f1
constexpr int kC2 = 8;      // channels of f2
constexpr int kTileH = 16;
constexpr int kTileW = 16;
constexpr int kThreads = 256;

// a layer's buffer: the tile and its halo (3 for elu(x), 2 f1, 1 f2)
constexpr int kH0 = kTileH + 6, kW0 = kTileW + 6;
constexpr int kH1 = kTileH + 4, kW1 = kTileW + 4;
constexpr int kH2 = kTileH + 2, kW2 = kTileW + 2;

// shared memory, in floats: the weights tap-major, w[(ci*9 + tap)*Cout +
// co], then the biases, then elu(x) (reused for f2), then f1, each
// [channel][row][column]
constexpr int kSw1 = 0;
constexpr int kSw2 = kSw1 + 9 * kC1 * kC1;
constexpr int kSw3 = kSw2 + 9 * kC1 * kC2;
constexpr int kSb1 = kSw3 + 9 * kC2;
constexpr int kSb2 = kSb1 + kC1;
constexpr int kSb3 = kSb2 + kC2;
constexpr int kSf0 = (kSb3 + 1 + 3) / 4 * 4;          // float4-aligned
constexpr int kSf1 = kSf0 + kC1 * kH0 * kW0;
constexpr int kSmemFloats = kSf1 + kC1 * kH1 * kW1;
constexpr int kSmemBytes = kSmemFloats * 4;
static_assert(kC2 * kH2 * kW2 <= kC1 * kH0 * kW0, "f2 fits where elu(x) was");
static_assert(kSmemBytes <= 232448, "a block's shared memory on sm_90");

__device__ __forceinline__ float elu(float v) {
  return v > 0.0f ? v : expm1f(v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The in-image coordinate whose value a one-pixel reflect pad shows at g.
__device__ __forceinline__ int reflect(int g, int n) {
  g = clampi(g, -1, n);
  return g < 0 ? -g : (g >= n ? 2 * n - 2 - g : g);
}

// Weights and biases into shared memory, and elu(x) over the tile and a
// 3-pixel halo, each cell at its reflected coordinate.
__device__ __forceinline__ void stage_inputs(
    float* smem, const float* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, int n, int r0, int c0, int H, int W,
    int tid) {
  // OIHW index co*(Cin*9) + (ci*9 + tap) -> tap-major (ci*9 + tap)*Cout + co
  for (int i = tid; i < 9 * kC1 * kC1; i += kThreads) {
    const int co = i / (9 * kC1);
    smem[kSw1 + (i - co * 9 * kC1) * kC1 + co] = __ldg(w1 + i);
  }
  for (int i = tid; i < 9 * kC1 * kC2; i += kThreads) {
    const int co = i / (9 * kC1);
    smem[kSw2 + (i - co * 9 * kC1) * kC2 + co] = __ldg(w2 + i);
  }
  for (int i = tid; i < 9 * kC2; i += kThreads) smem[kSw3 + i] = __ldg(w3 + i);
  if (tid < kC1) smem[kSb1 + tid] = __ldg(b1 + tid);
  if (tid < kC2) smem[kSb2 + tid] = __ldg(b2 + tid);
  if (tid == 0) smem[kSb3] = __ldg(b3);

  const float* xn = x + (int64_t)n * kC1 * H * W;
  float* f0 = smem + kSf0;
  for (int i = tid; i < kC1 * kH0 * kW0; i += kThreads) {
    const int ci = i / (kH0 * kW0);
    const int rc = i - ci * (kH0 * kW0);
    const int r = rc / kW0;
    const int gr = reflect(r0 - 3 + r, H);
    const int gc = reflect(c0 - 3 + rc - r * kW0, W);
    f0[i] = elu(__ldg(xn + ((int64_t)ci * H + gr) * W + gc));
  }
}

// One 3x3 layer from the buffer src [CIN][SH][SW] (halo (SH - kTileH)/2)
// to the buffer dst [COUT][DH][DW] (halo one less), each thread taking PX
// cells; or, with kLast, the tile's in-image sigmoid outputs into out_n
// [H, W].
template <int CIN, int COUT, int PX, int SH, int SW, int DH, int DW,
          bool kLast>
__device__ __forceinline__ void conv_stage(const float* src, const float* sw,
                                           const float* sb, float* dst,
                                           float* __restrict__ out_n, int r0,
                                           int c0, int H, int W, int tid) {
  constexpr int kSrcHalo = (SH - kTileH) / 2;
  constexpr int kDstHalo = (DH - kTileH) / 2;
  constexpr int kCells = DH * DW;
  constexpr int kSlots = (kCells + PX - 1) / PX;
  for (int s = tid; s < kSlots; s += kThreads) {
    int off[PX][9];             // the 3x3 taps' offsets in a source plane
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      const int p = min(s + k * kSlots, kCells - 1);
      const int i = p / DW;
      const int j = p - i * DW;
      const int qr = reflect(r0 - kDstHalo + i, H) - (r0 - kSrcHalo);
      const int qc = reflect(c0 - kDstHalo + j, W) - (c0 - kSrcHalo);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          off[k][dy * 3 + dx] = clampi(qr + dy - 1, 0, SH - 1) * SW +
                                clampi(qc + dx - 1, 0, SW - 1);
        }
      }
    }
    float acc[PX][COUT];
#pragma unroll
    for (int k = 0; k < PX; ++k) {
#pragma unroll
      for (int co = 0; co < COUT; ++co) acc[k][co] = sb[co];
    }
#pragma unroll 1
    for (int ci = 0; ci < CIN; ++ci) {
      const float* plane = src + ci * SH * SW;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        float v[PX];
#pragma unroll
        for (int k = 0; k < PX; ++k) v[k] = plane[off[k][t]];
        const float* wt = sw + (ci * 9 + t) * COUT;
        if constexpr (COUT % 4 == 0) {
#pragma unroll
          for (int co = 0; co < COUT; co += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(wt + co);
#pragma unroll
            for (int k = 0; k < PX; ++k) {
              acc[k][co] = fmaf(v[k], w4.x, acc[k][co]);
              acc[k][co + 1] = fmaf(v[k], w4.y, acc[k][co + 1]);
              acc[k][co + 2] = fmaf(v[k], w4.z, acc[k][co + 2]);
              acc[k][co + 3] = fmaf(v[k], w4.w, acc[k][co + 3]);
            }
          }
        } else {
#pragma unroll
          for (int co = 0; co < COUT; ++co) {
#pragma unroll
            for (int k = 0; k < PX; ++k) {
              acc[k][co] = fmaf(v[k], wt[co], acc[k][co]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      const int p = s + k * kSlots;
      if (p >= kCells) continue;
      if constexpr (kLast) {
        const int gr = r0 + p / DW;
        const int gc = c0 + p % DW;
        if (gr < H && gc < W) out_n[(int64_t)gr * W + gc] = sigmoid(acc[k][0]);
      } else {
#pragma unroll
        for (int co = 0; co < COUT; ++co) dst[co * kCells + p] = elu(acc[k][co]);
      }
    }
  }
}

__device__ __forceinline__ void stage_conv1(float* smem, int r0, int c0,
                                            int H, int W, int tid) {
  conv_stage<kC1, kC1, 2, kH0, kW0, kH1, kW1, false>(
      smem + kSf0, smem + kSw1, smem + kSb1, smem + kSf1, nullptr, r0, c0, H,
      W, tid);
}

__device__ __forceinline__ void stage_conv2(float* smem, int r0, int c0,
                                            int H, int W, int tid) {
  conv_stage<kC1, kC2, 2, kH1, kW1, kH2, kW2, false>(
      smem + kSf1, smem + kSw2, smem + kSb2, smem + kSf0, nullptr, r0, c0, H,
      W, tid);
}

__device__ __forceinline__ void stage_conv3(float* smem, float* out_n, int r0,
                                            int c0, int H, int W, int tid) {
  conv_stage<kC2, 1, 1, kH2, kW2, kTileH, kTileW, true>(
      smem + kSf0, smem + kSw3, smem + kSb3, nullptr, out_n, r0, c0, H, W,
      tid);
}

__global__ void __launch_bounds__(kThreads, 1)
decoder_tail_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ w3,
                    const float* __restrict__ b3, float* __restrict__ out,
                    int H, int W) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * kTileH;
  const int c0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x;
  stage_inputs(smem, x, w1, b1, w2, b2, w3, b3, n, r0, c0, H, W, tid);
  __syncthreads();
  stage_conv1(smem, r0, c0, H, W, tid);
  __syncthreads();          // elu(x) is dead: conv2 writes f2 in its place
  stage_conv2(smem, r0, c0, H, W, tid);
  __syncthreads();
  stage_conv3(smem, out + (int64_t)n * H * W, r0, c0, H, W, tid);
}

}  // namespace

// x [N, 32, H, W]; w1 [32, 32, 3, 3], b1 [32]; w2 [8, 32, 3, 3], b2 [8];
// w3 [1, 8, 3, 3], b3 [1]; out [N, H, W, 1]; all contiguous. H, W >= 2;
// N <= 65535.
extern "C" int tcsfm_decoder_tail_fwd(const float* x, const float* w1,
                                      const float* b1, const float* w2,
                                      const float* b2, const float* w3,
                                      const float* b3, float* out, int N,
                                      int H, int W, int device, void* stream) {
  if ((int64_t)N * H * W == 0) return (int)cudaSuccess;
  DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return (int)scope.status();
  const cudaError_t attr = cudaFuncSetAttribute(
      decoder_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((W + kTileW - 1) / kTileW),
                  (unsigned)((H + kTileH - 1) / kTileH), (unsigned)N);
  decoder_tail_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, w2, b2, w3, b3, out, H, W);
  return (int)cudaGetLastError();
}
