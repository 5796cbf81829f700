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
// NCHW tensor the port's decoder produces on the card and is as accurate
// as f32, as the literal reference (decoder_tail_reference, and
// decoder_tail_plain in ops/decoder_tail.py) is. What it keeps from the
// TPU kernel is the fusion: nothing full-resolution but x and out touches
// device memory.
//
// Bound: operations. Per output pixel the three convs take 9*32*32 +
// 9*32*8 + 9*8 = 11,592 multiply-adds; the pixel's bytes are 32 floats of
// x read and 1 written. At the coupled forward's shape [18, 32, 192, 640]
// that is 51.3 GFLOP against 292 MB (0.087 ms at 3.35 TB/s). Done as f32
// FMAs that is 0.77 ms at the H100's 67 TFLOP/s; done f32-accurately on
// the tensor cores (three TF32 products for each f32 one, below) it is
// 0.31 ms at their 495 TFLOP/s of TF32.
//
// Design. One 256-thread block an SM loops over 12x32 output tiles
// (persistent). For each tile it builds elu(x) over the tile and a 3-pixel
// halo (18x38, held as 18x40), f1 = elu(conv1) over the tile and a
// 2-pixel halo (16x36x32), f2 = elu(conv2) over the tile and a 1-pixel
// halo (14x34x8), and writes sigmoid(conv3) for the tile's in-image
// pixels. Against the five limits of this kernel's first version (one
// block per 16x16 tile, all f32 FMAs), step by step:
// 1. Tensor cores instead of FMAs. conv1 (79.5% of the multiply-adds) and
//    conv2 (19.9%) are implicit GEMMs on mma.sync.m16n8k8 TF32 with K = 9
//    taps x 32 input channels, tap-major, 8 channels a k-step. conv1 takes
//    the weights as A (M = its 32 output channels, two M-tiles) and the
//    cells as B (72 N-tiles of 8 cells, 9 a warp), so each activation a
//    lane loads and splits feeds all 32 output channels; conv2 takes the
//    cells as A (30 M-tiles of 16, 476 cells padded to 480; 4 a warp,
//    warps 6 and 7 repeat one and drop it) and its 8 output channels as
//    one N-tile. The accumulators (2 x 72 a thread in conv1) stay in
//    registers across the whole K loop. f32 accuracy: each operand v is
//    split into hi + lo, hi rounded to nearest with TF32's 11 significant
//    bits, and a*b is taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (3xTF32,
//    ~2^-22 relative a product), accumulated in f32: the hi*hi products in
//    one accumulator, the two small cross products in another, added at
//    the end (the tensor core accumulates more coarsely than an f32 FMA;
//    kept apart, the large sum takes a third of the MMAs, and the small
//    one's errors are 2^-11 smaller). The split is Veltkamp's, in four f32
//    operations: a cvt.rna.tf32.f32 runs on the slower conversion pipe,
//    and two of them an element slowed the whole kernel far more than
//    these four operations do. The weights are split once, when staged;
//    the activations when loaded. conv3 (8->1, 0.6%) stays on FMAs.
// 2. Reflect padding. Every buffer cell at image coordinate g holds its
//    layer's value at reflect(g) (-1 -> 1, n -> n-2; cells further out,
//    which no output needs, are clamped to -1 or n first) and is computed
//    as the conv at reflect(g), reading the previous buffer at reflect(g)
//    + {-1, 0, 1}. Those reads always fall inside the previous buffer, so
//    a lane keeps one offset per fragment row and adds each tap's
//    constant offset: the fragments stay regular, and all four borders and
//    images smaller than a tile come out as the reference's.
// 3. Bank conflicts. A fragment of activations reads 8 consecutive cells
//    (lane / 4) in 4 channel planes (lane % 4); each plane's stride is
//    padded to 8 (mod 32) words (744 for elu(x), 584 for f1), so the 32
//    lanes fall on 32 banks except where a row of cells wraps. The split
//    weights are stored in fragment order, a float4 a lane: conflict-free
//    128-bit loads, four per k-step for conv1, one for conv2.
// 4. Asynchronous staging. x streams through a ring of two 8-channel
//    stages (conv1's K in four chunks) with cp.async: while the block runs
//    a chunk's MMAs, the next chunk, or at the end of a tile the next
//    tile's first chunk, is in flight, so conv2, conv3 and the epilogues
//    also overlap a load. Interior tiles copy 16-byte row pieces (hence
//    the 40-wide rows, aligned at c0 - 4; it needs W % 4 == 0); border
//    tiles, and any W not a multiple of 4, 4-byte elements at reflected
//    coordinates. Each thread applies ELU in place to the elements it
//    copied once they have landed; one barrier a chunk publishes them.
// 5. Weights once per block. The grid is one block per SM (as many as fit)
//    looping over the N x tiles in a fixed stride, so the split weights
//    (92 KB) are staged once per block instead of once per tile; any N
//    and any tile count are taken.
// Halo recompute: conv1 runs at 576 cells for 384 outputs (1.50x), conv2
// at 480 (1.25x); 1.45x the multiply-adds overall (1.50x with 16x16
// tiles). Shared memory: 230,048 bytes a block (one block an SM), opted in
// with cudaFuncSetAttribute.
//
// Kernel and plain version differ by rounding (the 3xTF32 products, the
// ELU's polynomial and fast exponential, another summation order), not bit
// for bit.
//
// C interface for ctypes: no PyTorch headers. Launches on the caller's
// stream on the given device (launch.cuh), allocates nothing, does not
// synchronise; returns the first error of the setup calls or the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kC1 = 32;     // channels of x and of f1
constexpr int kC2 = 8;      // channels of f2
constexpr int kTaps = 9;
constexpr int kTileH = 12;
constexpr int kTileW = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkC = 8;                  // channels of x a stage holds
constexpr int kChunks = kC1 / kChunkC;
constexpr int kStages = 2;
constexpr int kKSteps = kTaps * kC1 / 8;    // K = 288 in k-steps of 8

// elu(x): rows r0-3 .. r0+kTileH+2, columns c0-4 .. c0+kTileW+3 (one more
// on the left than the conv needs, so an interior row starts 16-byte
// aligned); f1: the tile +-2; f2: the tile +-1. Plane strides of elu(x)
// and f1 are 8 (mod 32) words (fragment loads without bank conflicts).
constexpr int kH0 = kTileH + 6, kW0 = kTileW + 8, kP0 = 744;
constexpr int kH1 = kTileH + 4, kW1 = kTileW + 4, kP1 = 584;
constexpr int kH2 = kTileH + 2, kW2 = kTileW + 2, kP2 = kH2 * kW2;
constexpr int kCells1 = kH1 * kW1;
constexpr int kCells2 = kH2 * kW2;
constexpr int kNPer1 = kCells1 / 8 / kWarps;      // conv1: N-tiles a warp
constexpr int kMTiles2 = (kCells2 + 15) / 16;
constexpr int kMPer2 = (kMTiles2 + kWarps - 1) / kWarps;
static_assert(kP0 % 32 == 8 && kP0 % 4 == 0 && kP0 >= kH0 * kW0, "kP0");
static_assert(kP1 % 32 == 8 && kP1 >= kCells1, "kP1");
static_assert(kCells1 % (8 * kWarps) == 0, "conv1's cells over the warps");
static_assert(kW0 % 4 == 0 && kTileW % 4 == 0, "16-byte rows");

// shared memory, in floats: conv1's weights as A fragments [k-step][M-tile]
// [hi, lo][lane] float4, conv2's as B fragments [k-step][lane] float4,
// conv3's [ci][tap], the ring of elu(x) stages [stage][ci][kP0], f1
// [ci][kP1], f2 [ci][kP2]
constexpr int kSw1 = 0;
constexpr int kSw2 = kSw1 + kKSteps * 2 * 2 * 32 * 4;
constexpr int kSw3 = kSw2 + kKSteps * 32 * 4;
constexpr int kSx = (kSw3 + kC2 * kTaps + 3) / 4 * 4;
constexpr int kStage = kChunkC * kP0;
constexpr int kSf1 = kSx + kStages * kStage;
constexpr int kSf2 = kSf1 + kC1 * kP1;
constexpr int kSmemFloats = kSf2 + kC2 * kP2;
constexpr int kSmemBytes = kSmemFloats * 4;
static_assert(kSmemBytes <= 232448, "a block's shared memory on sm_90");

// ELU. Below 0, expm1 as a degree-6 Taylor polynomial on [-0.25, 0]
// (truncation < 1.2e-8 of the result) and as the fast exponential less 1
// further out, where |result| > 0.22; chosen by selects, without branches.
__device__ __forceinline__ float elu(float v) {
  float p = fmaf(v, 1.0f / 720.0f, 1.0f / 120.0f);
  p = fmaf(p, v, 1.0f / 24.0f);
  p = fmaf(p, v, 1.0f / 6.0f);
  p = fmaf(p, v, 0.5f);
  p = fmaf(p, v, 1.0f);
  const float e = __expf(v) - 1.0f;
  return v > 0.0f ? v : (v < -0.25f ? e : p * v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// The in-image coordinate whose value a one-pixel reflect pad shows at g.
__device__ __forceinline__ int reflect(int g, int n) {
  g = g < -1 ? -1 : (g > n ? n : g);
  return g < 0 ? -g : (g >= n ? 2 * n - 2 - g : g);
}

// v = hi + lo, hi rounded to nearest with TF32's 11 significant bits
// (Veltkamp's split, s = 13: four full-rate f32 operations, where a
// cvt.rna.tf32.f32 runs on the slow conversion pipe; the _rn intrinsics
// keep the compiler from fusing them), lo = v - hi exactly. lo has up to
// 12 significant bits; the tensor core reads its 11 high ones, so a*b is
// kept to ~2^-22 relative.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(v, 8193.0f);
  const float h = __fsub_rn(c, __fsub_rn(c, v));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(v, h));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b in 3xTF32: d += a_hi b_hi, and the two small products into their
// own accumulator, so that the tensor core's f32 accumulation of the large
// sum is not also charged with theirs
__device__ __forceinline__ void mma3(float (&d)[4], float (&cross)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(cross, al, bh0, bh1);
  mma(cross, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

__device__ __forceinline__ void bits(float4 v, uint32_t (&r)[4]) {
  r[0] = __float_as_uint(v.x);
  r[1] = __float_as_uint(v.y);
  r[2] = __float_as_uint(v.z);
  r[3] = __float_as_uint(v.w);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

struct Tile {
  int n, r0, c0;
};

// The phase probe, left out of the library: ops/tail_probe.py builds this
// file with -DTCSFM_TAIL_PROBE, and warp 0 of each block then adds the
// clock cycles of each phase (up to each mark) into tail_probe_cycles: 0
// wait for a chunk + ELU, 1 barrier + next copy, 2 conv1's MMAs, 3 f1's
// epilogue, 4 conv2, 5 conv3.
constexpr int kProbePhases = 6;
#ifdef TCSFM_TAIL_PROBE
__device__ unsigned long long tail_probe_cycles[kProbePhases];
struct Probe {
  long long last;
  long long cycles[kProbePhases] = {};
  __device__ Probe() { last = clock64(); }
  __device__ void mark(int k) {
    const long long now = clock64();
    cycles[k] += now - last;
    last = now;
  }
  __device__ void flush(int tid) {
    if (tid != 0) return;
    for (int k = 0; k < kProbePhases; ++k) {
      atomicAdd(&tail_probe_cycles[k], (unsigned long long)cycles[k]);
    }
  }
};
#else
struct Probe {
  __device__ void mark(int) {}
  __device__ void flush(int) {}
};
#endif

__device__ __forceinline__ Tile tile_at(int t, int tiles_h, int tiles_w) {
  const int per_image = tiles_h * tiles_w;
  const int n = t / per_image;
  const int rc = t - n * per_image;
  const int r = rc / tiles_w;
  return {n, r * kTileH, (rc - r * tiles_w) * kTileW};
}

// Whether a tile's elu(x) rows are copied as 16-byte pieces: its columns
// c0 - 4 .. c0 + kTileW + 3 lie in the image, and rows start aligned.
__device__ __forceinline__ bool wide_copies(Tile tl, int W, bool aligned) {
  return aligned && tl.c0 >= 4 && tl.c0 + kTileW + 4 <= W;
}

// conv1's weights [32, 32, 3, 3] as split A fragments (M = output
// channels, two M-tiles): a lane's (co g, k t), (co g + 8, k t),
// (co g, k t + 4), (co g + 8, k t + 4), hi then lo.
__device__ __forceinline__ void stage_a1(float4* dst,
                                         const float* __restrict__ w,
                                         int tid) {
  for (int i = tid; i < kKSteps * 2 * 32; i += kThreads) {
    const int lane = i & 31;
    const int s = i >> 6;
    const int co = ((i >> 5) & 1) * 16 + (lane >> 2);
    const int ci = (s % kChunks) * 8 + (lane & 3);
    const float* wt = w + (co * kC1 + ci) * kTaps + s / kChunks;
    constexpr int kCo8 = 8 * kC1 * kTaps, kCi4 = 4 * kTaps;
    uint32_t h[4], l[4];
    split(__ldg(wt), h[0], l[0]);
    split(__ldg(wt + kCo8), h[1], l[1]);
    split(__ldg(wt + kCi4), h[2], l[2]);
    split(__ldg(wt + kCo8 + kCi4), h[3], l[3]);
    float4* d = dst + (i >> 5) * 64 + lane;
    d[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                       __uint_as_float(h[2]), __uint_as_float(h[3]));
    d[32] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                        __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// conv2's weights [8, 32, 3, 3] as split B fragments (N = its 8 output
// channels): a lane's float4 (hi(k t), hi(k t + 4), lo(k t), lo(k t + 4))
// of column co = g.
__device__ __forceinline__ void stage_b2(float4* dst,
                                         const float* __restrict__ w,
                                         int tid) {
  for (int i = tid; i < kKSteps * 32; i += kThreads) {
    const int lane = i & 31;
    const int s = i >> 5;
    const int ci = (s % kChunks) * 8 + (lane & 3);
    const float* wt = w + ((lane >> 2) * kC1 + ci) * kTaps + s / kChunks;
    uint32_t h0, l0, h1, l1;
    split(__ldg(wt), h0, l0);
    split(__ldg(wt + 4 * kTaps), h1, l1);
    dst[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                         __uint_as_float(l0), __uint_as_float(l1));
  }
}

// Start copying x's channels [8 chunk, 8 chunk + 8) over the tile's elu(x)
// region into a stage, as 16-byte pieces (wide) or as 4-byte elements at
// reflected coordinates. One commit group. elu_own later visits the same
// elements with the same thread.
__device__ __forceinline__ void issue_chunk(float* dst,
                                            const float* __restrict__ x,
                                            Tile tl, int chunk, int H, int W,
                                            bool wide, int tid) {
  const float* xc = x + ((int64_t)tl.n * kC1 + chunk * kChunkC) * H * W;
  if (wide) {
    constexpr int kQ = kW0 / 4;
    for (int i = tid; i < kChunkC * kH0 * kQ; i += kThreads) {
      const int ch = i / (kH0 * kQ);
      const int rq = i - ch * (kH0 * kQ);
      const int r = rq / kQ;
      const int gr = reflect(tl.r0 - 3 + r, H);
      const int c = tl.c0 - 4 + 4 * (rq - r * kQ);
      cp_async16(dst + ch * kP0 + 4 * rq, xc + ((int64_t)ch * H + gr) * W + c);
    }
  } else {
    for (int i = tid; i < kChunkC * kH0 * kW0; i += kThreads) {
      const int ch = i / (kH0 * kW0);
      const int rc = i - ch * (kH0 * kW0);
      const int r = rc / kW0;
      const int gr = reflect(tl.r0 - 3 + r, H);
      const int gc = reflect(tl.c0 - 4 + rc - r * kW0, W);
      cp_async4(dst + ch * kP0 + rc, xc + ((int64_t)ch * H + gr) * W + gc);
    }
  }
  cp_async_commit();
}

// ELU in place over the elements this thread copied (its own copies are
// complete and visible to it after cp_async_wait_all), so that one barrier
// then publishes the activated chunk.
__device__ __forceinline__ void elu_own(float* stage, bool wide, int tid) {
  if (wide) {
    constexpr int kQ = kH0 * kW0 / 4;
    for (int i = tid; i < kChunkC * kQ; i += kThreads) {
      const int ch = i / kQ;
      float4* p = reinterpret_cast<float4*>(stage + ch * kP0) + (i - ch * kQ);
      float4 v = *p;
      v.x = elu(v.x);
      v.y = elu(v.y);
      v.z = elu(v.z);
      v.w = elu(v.w);
      *p = v;
    }
  } else {
    for (int i = tid; i < kChunkC * kH0 * kW0; i += kThreads) {
      const int ch = i / (kH0 * kW0);
      float* p = stage + ch * kP0 + (i - ch * (kH0 * kW0));
      *p = elu(*p);
    }
  }
}

// The offset in elu(x) of the top-left tap of f1's cell m (computed at its
// reflected coordinate), and the same in f1 for f2's cell m (clamped to
// the last cell for conv2's padding rows).
__device__ __forceinline__ int base1(int m, Tile tl, int H, int W) {
  const int i = m / kW1;
  const int qr = reflect(tl.r0 - 2 + i, H) - (tl.r0 - 3);
  const int qc = reflect(tl.c0 - 2 + m - i * kW1, W) - (tl.c0 - 4);
  return (qr - 1) * kW0 + qc - 1;
}

__device__ __forceinline__ int base2(int m, Tile tl, int H, int W) {
  m = min(m, kCells2 - 1);
  const int i = m / kW2;
  const int qr = reflect(tl.r0 - 1 + i, H) - (tl.r0 - 2);
  const int qc = reflect(tl.c0 - 1 + m - i * kW2, W) - (tl.c0 - 2);
  return (qr - 1) * kW1 + qc - 1;
}

// conv1's k-steps of one chunk (its 9 taps x 8 channels) for this warp's
// kNPer1 N-tiles of 8 cells and both M-tiles of output channels. The
// activations are the B operand: a lane loads cell g of an N-tile in
// channel planes t and t + 4.
__device__ __forceinline__ void conv1_chunk(float (&acc)[kNPer1][2][4],
                                            float (&cross)[kNPer1][2][4],
                                            const float* xs,
                                            const int (&base)[kNPer1],
                                            const float4* wa, int chunk,
                                            int lane) {
  const float* planes = xs + (lane & 3) * kP0;
#pragma unroll 1    // unrolled, the taps' hoisted loads spill registers
  for (int tap = 0; tap < kTaps; ++tap) {
    const int toff = (tap / 3) * kW0 + tap % 3;
    const float4* ws = wa + (tap * kChunks + chunk) * 128 + lane;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      bits(ws[mt * 64], ah[mt]);
      bits(ws[mt * 64 + 32], al[mt]);
    }
#pragma unroll
    for (int ni = 0; ni < kNPer1; ++ni) {
      uint32_t bh0, bl0, bh1, bl1;
      split(planes[base[ni] + toff], bh0, bl0);
      split(planes[4 * kP0 + base[ni] + toff], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma3(acc[ni][mt], cross[ni][mt], ah[mt], al[mt], bh0, bh1, bl0,
             bl1);
      }
    }
  }
}

// conv2 for this warp's M-tiles of cells (the activations are the A
// operand, its 8 output channels one N-tile): f1 -> f2 (ELU applied),
// cells < kCells2.
__device__ __forceinline__ void conv2_tile(const float* f1, float* f2,
                                           const float4* wb,
                                           const float* __restrict__ b2,
                                           Tile tl, int H, int W, int warp,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  int base[kMPer2][2];
  float acc[kMPer2][4], cross[kMPer2][4] = {};
#pragma unroll
  for (int mi = 0; mi < kMPer2; ++mi) {
    const int m = (warp + mi * kWarps) * 16 + g;
    base[mi][0] = base2(m, tl, H, W);
    base[mi][1] = base2(m + 8, tl, H, W);
    acc[mi][0] = acc[mi][2] = __ldg(b2 + 2 * t);
    acc[mi][1] = acc[mi][3] = __ldg(b2 + 2 * t + 1);
  }
  const float* planes = f1 + t * kP1;
#pragma unroll
  for (int tap = 0; tap < kTaps; ++tap) {
    const int toff = (tap / 3) * kW1 + tap % 3;
#pragma unroll
    for (int cb = 0; cb < kChunks; ++cb) {
      const float4 b = wb[(tap * kChunks + cb) * 32 + lane];
      const float* p = planes + cb * 8 * kP1 + toff;
#pragma unroll
      for (int mi = 0; mi < kMPer2; ++mi) {
        uint32_t ah[4], al[4];
        split(p[base[mi][0]], ah[0], al[0]);
        split(p[base[mi][1]], ah[1], al[1]);
        split(p[4 * kP1 + base[mi][0]], ah[2], al[2]);
        split(p[4 * kP1 + base[mi][1]], ah[3], al[3]);
        mma3(acc[mi], cross[mi], ah, al, __float_as_uint(b.x),
             __float_as_uint(b.y), __float_as_uint(b.z),
             __float_as_uint(b.w));
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < kMPer2; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = (warp + mi * kWarps) * 16 + g + 8 * r;
      if (m < kCells2) {
        f2[2 * t * kP2 + m] = elu(acc[mi][2 * r] + cross[mi][2 * r]);
        f2[(2 * t + 1) * kP2 + m] =
            elu(acc[mi][2 * r + 1] + cross[mi][2 * r + 1]);
      }
    }
  }
}

// sigmoid(conv3) for the tile's in-image pixels. An in-image pixel's taps
// are f2's cells around it, which hold the reflect-padded values.
__device__ __forceinline__ void conv3_out(const float* f2, const float* w3,
                                          float b3, float* __restrict__ out_n,
                                          Tile tl, int H, int W, int tid) {
  for (int p = tid; p < kTileH * kTileW; p += kThreads) {
    const int i = p / kTileW;
    const int j = p - i * kTileW;
    if (tl.r0 + i >= H || tl.c0 + j >= W) continue;
    float acc = b3;
#pragma unroll
    for (int ci = 0; ci < kC2; ++ci) {
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        acc = fmaf(f2[ci * kP2 + (i + tap / 3) * kW2 + j + tap % 3],
                   w3[ci * kTaps + tap], acc);
      }
    }
    out_n[(int64_t)(tl.r0 + i) * W + tl.c0 + j] = sigmoid(acc);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
decoder_tail_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ w3,
                    const float* __restrict__ b3, float* __restrict__ out,
                    int H, int W, int tiles_h, int tiles_w, int tiles,
                    bool aligned) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float4* wa1 = reinterpret_cast<const float4*>(smem + kSw1);
  const float4* wb2 = reinterpret_cast<const float4*>(smem + kSw2);
  float* f1 = smem + kSf1;
  float* f2 = smem + kSf2;

  int tile = blockIdx.x;
  Tile tl = tile_at(tile, tiles_h, tiles_w);
  issue_chunk(smem + kSx, x, tl, 0, H, W, wide_copies(tl, W, aligned), tid);
  // the weights, once: visible to all after the first chunk's barrier
  stage_a1(reinterpret_cast<float4*>(smem + kSw1), w1, tid);
  stage_b2(reinterpret_cast<float4*>(smem + kSw2), w2, tid);
  for (int i = tid; i < kC2 * kTaps; i += kThreads) {
    smem[kSw3 + i] = __ldg(w3 + i);
  }
  const float bias3 = __ldg(b3);

  Probe probe;
  int q = 0;  // chunks consumed; chunk q lies in stage q % 2
  for (; tile < tiles; tile += gridDim.x) {
    tl = tile_at(tile, tiles_h, tiles_w);
    const bool wide = wide_copies(tl, W, aligned);
    int base[kNPer1];
    float acc[kNPer1][2][4], cross[kNPer1][2][4] = {};
#pragma unroll
    for (int ni = 0; ni < kNPer1; ++ni) {
      base[ni] = base1((warp * kNPer1 + ni) * 8 + g, tl, H, W);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        acc[ni][mt][0] = acc[ni][mt][1] = __ldg(b1 + mt * 16 + g);
        acc[ni][mt][2] = acc[ni][mt][3] = __ldg(b1 + mt * 16 + g + 8);
      }
    }
    for (int c = 0; c < kChunks; ++c, ++q) {
      float* xs = smem + kSx + (q & 1) * kStage;
      cp_async_wait_all();
      elu_own(xs, wide, tid);
      probe.mark(0);
      // chunk q is activated for every thread, and every thread is done
      // with chunk q - 1, whose stage the next copy fills
      __syncthreads();
      const int next = c + 1 < kChunks ? tile : tile + gridDim.x;
      if (next < tiles) {
        const Tile nt = tile_at(next, tiles_h, tiles_w);
        issue_chunk(smem + kSx + ((q + 1) & 1) * kStage, x, nt,
                    (c + 1) % kChunks, H, W, wide_copies(nt, W, aligned),
                    tid);
      }
      probe.mark(1);
      conv1_chunk(acc, cross, xs, base, wa1, c, lane);
      probe.mark(2);
    }
#pragma unroll
    for (int ni = 0; ni < kNPer1; ++ni) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int co = mt * 16 + g + 8 * r;
          const int m = (warp * kNPer1 + ni) * 8 + 2 * t;
          f1[co * kP1 + m] =
              elu(acc[ni][mt][2 * r] + cross[ni][mt][2 * r]);
          f1[co * kP1 + m + 1] =
              elu(acc[ni][mt][2 * r + 1] + cross[ni][mt][2 * r + 1]);
        }
      }
    }
    __syncthreads();
    probe.mark(3);
    conv2_tile(f1, f2, wb2, b2, tl, H, W, warp, lane);
    __syncthreads();
    probe.mark(4);
    conv3_out(f2, smem + kSw3, bias3, out + (int64_t)tl.n * H * W, tl, H, W,
              tid);
    probe.mark(5);
  }
  probe.flush(tid);
}


// ---------------------------------------------------------------------------
// The bfloat16 tail: what the Pallas kernel computes (_tail_kernel with
// _tail_forward's casts), for a depth net that computes in bfloat16. x is
// bf16 [N, 32, H, W]; elu(x) is taken in f32 and rounded to bf16; each of
// conv1 and conv2 multiplies bf16 operands (the weights rounded to bf16)
// into f32 accumulators that start at the f32 bias; f1 = elu(conv1) and
// f2 = elu(conv2) are rounded to bf16 before the next conv reads them;
// conv3 multiplies f2 by its bf16-rounded weights in f32 FMAs (exact
// products) plus the f32 bias; out = sigmoid(conv3) in f32.
//
// Bound at [18, 32, 192, 640]: the same 51.3 GFLOP as above, 52 us at the
// H100's 989 TFLOP/s of dense bf16; 142 MB of bf16 x read and 8.8 MB of
// out written, 45 us at 3.35 TB/s.
//
// Design for Hopper. The first version (mma.sync m16n8k16, two blocks an
// SM on 12x32 tiles, x by plain 2-byte loads, five block-wide barriers a
// tile, 728-735 us) spent 49.6% of warp 0's cycles loading x and taking its
// ELU with no load overlapping any compute, 32.7% in its MMAs, 12.2% in the
// f1 and f2 epilogues and 4.4% in conv3 (ops/tail_probe.py --dtype
// bfloat16 on an H100). Here one persistent block an SM walks over 16x32
// output tiles in a fixed stride:
// 1. x in flight. A producer warp keeps a ring of two stages filled, each
//    16 channels of the tile's 22x48 box of x (33,792 bytes; rows r0-3 ..,
//    columns c0-8 ..), with a full and an empty mbarrier a stage. Where
//    W % 8 == 0 (x's row stride a multiple of 16 bytes) and x is 16-byte
//    aligned, one thread fills a stage by TMA from a 3-D tensor map over
//    [N*32, H, W] (cuTensorMapEncodeTiled, reached through the runtime's
//    cudaGetDriverEntryPointByVersion: the library links no libcuda);
//    other widths are copied by the warp's own loads. A TMA box's first
//    column must lie on 16 bytes (a box at column c0-3 raised an illegal
//    instruction on an H100; rows and columns outside the image are fine,
//    and read as zeros, which no cell takes), hence c0-8 and the width of
//    48. While the consumers compute a tile, both stages of the next one
//    arrive. The producer's warpgroup gives its registers to the two
//    consumer warpgroups (setmaxnreg: 24 and 240 a thread).
// 2. One grid for the three convs. elu(x), f1 and f2 lie on one grid 38
//    positions wide (the tile +-3 wide), so that a tap (dy, dx) is the
//    same shift, 38 dy + dx positions, at every position; each is stored
//    by 8-channel groups, a position's group in 16 bytes. The consumers
//    turn each arrived stage into elu(x) on the grid, each position at its
//    reflected coordinate of the box, and release the stage.
// 3. conv1 and conv2 on wgmma (m64n32k16 and m64n8k16, bf16 into f32)
//    with both operands in shared memory: A is 64 consecutive grid
//    positions, eight of them (128 bytes) a core matrix, the channel groups
//    one group apart along K, so a tap only moves A's start address; B,
//    the weights, is staged once per block in wgmma's K-major core-matrix
//    layout (stage_wgmma_b). K = 9 taps x 32 channels in 18 k-steps of 16.
//    Each warpgroup takes 6 M-tiles of each conv (f1's 20x38 positions,
//    f2's 18x38, padded to 768) and issues all 108 of a conv's wgmmas
//    before its one wait. Every position is computed alike from its
//    shifted neighbours, so f1 and f2 get their reflect padding by copy:
//    at a border tile the positions one row or column outside the image
//    take their reflection's values (reflect_border). With A from
//    registers instead (ldmatrix at per-row addresses, which needed an
//    80-byte cell stride) the probe's build ran 377-384 us, against 361-369
//    us for this form (both with an ELU on the bare fast exponential). At
//    N = 32 and 8 both forms are bound by shared memory: a wgmma m64n32k16
//    reads 3 KB of operands for 65,536 operations (the card's rate for it
//    with both operands in shared memory: ops/tail_probe.py).
// 4. Barriers. The 256 consumer threads meet at three named barriers a
//    tile (elu(x), f1, f2 complete; two more at border tiles, around the
//    reflect copies) where the first version took five block-wide ones,
//    and the producer waits on none of them. Each thread fences its
//    stores of elu(x) and f1 to the async proxy (fence_async_smem) before
//    the barrier after which wgmma reads them. conv3 (8 -> 1) and the
//    sigmoid stay on f32 FMAs, two output pixels a thread.
// Halo recompute: conv1 and conv2 at 768 positions each, conv3 at 512
// pixels, for 512 outputs: 1.50x the multiply-adds. A taller tile would
// recompute less, but its ring and grids do not fit the 227 KB a block
// has (24x32: 272 KB). Shared memory: 206,016 bytes, one block an SM. The
// ELUs are elu_bf16: the accuracy of the f32 kernel's elu(), whose
// polynomial near 0 keeps the relative error small where exp(v) - 1
// cancels, in fewer instructions. They are issue-bound SIMT work beside the
// wgmmas, and they take registers: ptxas compiles the kernel to 168
// registers a thread (-Xptxas -v; the consumers' setmaxnreg to 240
// notwithstanding) and spilled an unrolled conv's hoisted descriptors once
// the ELUs were exact, so conv_wgmma walks its k-steps at run time.

constexpr int kBfTileH = 16;
constexpr int kBfTileW = 32;
constexpr int kBfConsumers = 256;              // two warpgroups
// and a producer warpgroup, of which one warp loads: a whole warpgroup, so
// that it can give its registers to the consumers (setmaxnreg)
constexpr int kBfThreads = kBfConsumers + 128;
constexpr int kBfProducerRegs = 24;
constexpr int kBfConsumerRegs = 240;
static_assert(128 * kBfProducerRegs + kBfConsumers * kBfConsumerRegs <= 65536,
              "the register file");
constexpr int kBfKSteps = kTaps * kC1 / 16;   // K = 288 in k-steps of 16
constexpr int kBfStageC = 16;                 // channels of x a stage holds
// elu(x), f1 and f2 lie on one grid kBfGW positions wide: position
// i kBfGW + j is (image row, column) (r0 - 3 + i, c0 - 3 + j) of elu(x),
// (r0 - 2 + i, c0 - 2 + j) of f1 and (r0 - 1 + i, c0 - 1 + j) of f2, so
// that a conv's tap (dy, dx) is the shift dy kBfGW + dx for every position.
// Each is stored by 8-channel groups, a position's group in 16 bytes.
constexpr int kBfGW = kBfTileW + 6;
constexpr int kBfXH = kBfTileH + 6, kBfF1H = kBfTileH + 4,
              kBfF2H = kBfTileH + 2;
constexpr int kBfCellsX = kBfXH * kBfGW;
// positions a warpgroup computes of conv1 and of conv2, in M-tiles of 64
constexpr int kBfMt1 = (kBfF1H * kBfGW + 127) / 128;
constexpr int kBfMt2 = (kBfF2H * kBfGW + 127) / 128;
constexpr int kBfGroupX = kBfCellsX * 16;        // bytes of a group
constexpr int kBfGroup1 = 128 * kBfMt1 * 16;
// x's box: kBfXH rows from r0 - 3, kBfBoxW columns from c0 - 8 (TMA's
// columns start and end on 16 bytes)
constexpr int kBfBoxW = 48;
constexpr int kBfPlane = kBfXH * kBfBoxW;         // a channel of the box
constexpr int kBfStageBytes = kBfStageC * kBfPlane * 2;
// shared memory, in bytes from a 128-byte aligned base: the ring, conv1's
// and conv2's weights (stage_wgmma_b), elu(x) (4 groups), f1 (4 groups),
// f2 (one group), conv3's weights (f32), the mbarriers (full and empty, a
// pair a stage). A conv's last M-tiles read past the end of a group's
// positions (into the next group, or past the source into the next
// buffer) for positions that no output takes; each output row of a wgmma
// depends on its own row of A only.
constexpr int kBfSRing = 0;
constexpr int kBfSB1 = kBfSRing + 2 * kBfStageBytes;
constexpr int kBfSB2 = kBfSB1 + kBfKSteps * 32 * kC1;
constexpr int kBfSX = kBfSB2 + kBfKSteps * 32 * kC2;
constexpr int kBfSF1 = kBfSX + 4 * kBfGroupX;
constexpr int kBfSF2 = kBfSF1 + 4 * kBfGroup1;
constexpr int kBfSW3 = kBfSF2 + 128 * kBfMt2 * 16;
constexpr int kBfSBar = kBfSW3 + kC2 * kTaps * 4;
constexpr int kBfSmemBytes = kBfSBar + 4 * 8 + 128;   // + the alignment
static_assert(kBfSmemBytes <= 232448, "a block's shared memory on sm_90");
static_assert(kBfStageBytes % 128 == 0 && kBfSB1 % 128 == 0 &&
                  kBfSB2 % 128 == 0 && kBfSX % 128 == 0 &&
                  kBfSF1 % 128 == 0 && kBfSF2 % 128 == 0 &&
                  kBfSW3 % 16 == 0 && kBfSBar % 8 == 0,
              "TMA, wgmma and mbarrier alignment");
static_assert(kBfGW + 5 <= kBfBoxW && kBfBoxW * 2 % 16 == 0 &&
                  kBfTileW % 8 == 0,
              "the box of x: columns c0 - 8 .., 16-byte aligned");
static_assert(128 * kBfMt1 >= kBfF1H * kBfGW &&
                  128 * kBfMt2 >= kBfF2H * kBfGW &&
                  kBfSX + 3 * kBfGroupX + (128 * kBfMt1 + 2 * kBfGW + 2) * 16 <=
                      kBfSBar &&
                  kBfSF1 + 3 * kBfGroup1 + (128 * kBfMt2 + 2 * kBfGW + 2) * 16 <=
                      kBfSBar,
              "M-tiles cover the grid, and their reads stay in shared memory");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ELU for the bf16 kernel, as accurate as elu() in fewer instructions: below
// -0.25 the fast exponential less 1, as elu() takes it there (the result
// exceeds 0.22 in magnitude, so the exponential's few-ulp error stays near
// 1e-6 of it); above, v + u^2 q(u) with u = min(v, 0), where q is a
// degree-3 minimax fit of (expm1(u) - u) / u^2 on [-0.25, 0] (relative
// error < 7e-8 of expm1 in f32, tests/test_torch_bf16_tail.py), which gives
// v itself above 0. Every ELU of the tail (x, f1, f2) goes through it, so
// its instructions weigh: a select fewer than elu(), and an exponential
// without the denormal scaling (below -87 it flushes to 0, and the result
// is -1 either way).
constexpr float kEluC2 = 0.4999999702f, kEluC3 = 0.1666615009f,
                kEluC4 = 0.0415637195f, kEluC5 = 0.0076686833f;
__device__ __forceinline__ float elu_bf16(float v) {
  const float u = fminf(v, 0.0f);
  float q = fmaf(u, kEluC5, kEluC4);
  q = fmaf(q, u, kEluC3);
  q = fmaf(q, u, kEluC2);
  const float p = fmaf(q * u, u, v);
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * 1.4426950408889634f));
  return v < -0.25f ? e - 1.0f : p;
}

// --- Hopper building blocks: wgmma with both operands in shared memory,
// TMA, mbarriers ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma's shared-memory matrix descriptor, no swizzle: 8x16-byte core
// matrices, `lbo` bytes apart along K and `sbo` bytes apart along N.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}
// Keeps the compiler from moving an accumulator's reads and writes across
// the asynchronous wgmma that owns it (CUTLASS's warpgroup_fence_operand).
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] += A[64 x 16] B[16 x N]: bf16 in, f32 accumulators, both
// operands through their shared-memory descriptors (K-major). A thread's
// accumulators: warp w of the warpgroup holds rows 16w..16w+15; for each 8
// columns j, (row g, col 8j + 2t, +1) then (row g + 8, the same), g = lane
// / 4, t = lane % 4.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t desc_a,
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}

template <int kN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[kN / 2],
                                           uint64_t desc_a, uint64_t desc_b) {
  if constexpr (kN == 32) {
    wgmma_n32(d, desc_a, desc_b);
  } else {
    static_assert(kN == 8, "conv1's N = 32, conv2's N = 8");
    wgmma_n8(d, desc_a, desc_b);
  }
}

// A conv's weights [cout, 32, 3, 3] (f32 OIHW) as wgmma B operands, rounded
// to bf16: k-step s = 2 tap + half takes input channels 16 half .. + 15 at
// that tap; its [16 x cout] slice lies at s * 32 cout bytes, K-major in
// core matrices of 8 output channels x 8 input channels (16-byte rows),
// kWgLbo apart along K and kWgSbo apart along N.
constexpr int kWgLbo = 128, kWgSbo = 256;
template <int kCout>
__device__ __forceinline__ void stage_wgmma_b(unsigned char* dst,
                                              const float* __restrict__ w,
                                              int tid, int threads) {
  for (int i = tid; i < kBfKSteps * kCout * 8; i += threads) {
    const int kp = i & 7, co = (i >> 3) % kCout, s = i / (8 * kCout);
    const int kk = 2 * kp, ci = (s & 1) * 16 + kk;
    const float* wt = w + (co * kC1 + ci) * kTaps + (s >> 1);
    *reinterpret_cast<uint32_t*>(dst + s * 32 * kCout + (co >> 3) * kWgSbo +
                                 (kk >> 3) * kWgLbo + (co & 7) * 16 +
                                 (kk & 7) * 2) =
        pack_bf16(__ldg(wt), __ldg(wt + kTaps));
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A box of the 3-D tensor map at (column, row, plane) into shared memory,
// completing on `bar` by its bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// Orders this thread's ordinary shared-memory stores before the reads of
// the async proxy (wgmma's descriptors, TMA) that follow a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The consumers' barrier (named barrier 1, the producer warp not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kBfConsumers) : "memory");
}

// The bf16 kernel's phase probe (ops/tail_probe.py --dtype bfloat16), as the
// f32 kernel's: warp 0 of each block adds the clock cycles up to each mark
// into tail_bf16_probe_cycles, kBfProbePhases of them (named in
// tail_probe.PHASES_BF16).
constexpr int kBfProbePhases = 10;
#ifdef TCSFM_TAIL_PROBE
__device__ unsigned long long tail_bf16_probe_cycles[kBfProbePhases];
struct BfProbe {
  long long last;
  long long cycles[kBfProbePhases] = {};
  __device__ BfProbe() { last = clock64(); }
  __device__ void mark(int k) {
    const long long now = clock64();
    cycles[k] += now - last;
    last = now;
  }
  __device__ void flush(int tid) {
    if (tid != 0) return;
    for (int k = 0; k < kBfProbePhases; ++k) {
      atomicAdd(&tail_bf16_probe_cycles[k], (unsigned long long)cycles[k]);
    }
  }
};
#else
struct BfProbe {
  __device__ void mark(int) {}
  __device__ void flush(int) {}
};
#endif

__device__ __forceinline__ Tile bf_tile_at(int t, int tiles_h, int tiles_w) {
  const int per_image = tiles_h * tiles_w;
  const int n = t / per_image;
  const int rc = t - n * per_image;
  const int r = rc / tiles_w;
  return {n, r * kBfTileH, (rc - r * tiles_w) * kBfTileW};
}

// The producer's copy of a stage where TMA does not apply: channels
// [16 half, 16 half + 16) of the tile's box of x, its in-image cells (the
// others are never read), by the warp's 32 lanes.
__device__ __forceinline__ void copy_box(__nv_bfloat16* dst,
                                         const __nv_bfloat16* __restrict__ x,
                                         Tile tl, int half, int H, int W,
                                         int lane) {
  const __nv_bfloat16* xc =
      x + ((int64_t)tl.n * kC1 + half * kBfStageC) * H * W;
  for (int i = lane; i < kBfStageC * kBfPlane; i += 32) {
    const int ch = i / kBfPlane;
    const int rc = i - ch * kBfPlane;
    const int r = rc / kBfBoxW;
    const int gr = tl.r0 - 3 + r, gc = tl.c0 - 8 + rc - r * kBfBoxW;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
      dst[i] = xc[((int64_t)ch * H + gr) * W + gc];
    }
  }
}

// elu(x) of one item of a stage: item i (< 2 kBfCellsX) is channels 8 (i /
// kBfCellsX) .. + 7 of the stage's 16 at grid position i % kBfCellsX, read
// from the box at the position's reflected coordinate (8 two-byte loads
// across the stage's planes) and stored as its 16 bytes of their group.
__device__ __forceinline__ void convert_item(unsigned char* xs,
                                             const __nv_bfloat16* stage,
                                             Tile tl, int half, int H, int W,
                                             int i) {
  const int g8 = i >= kBfCellsX;
  const int cell = i - g8 * kBfCellsX;
  const int r = cell / kBfGW, c = cell - r * kBfGW;
  int rr = r, cc = c + 5;    // where the tile's elu(x) region is in the image
  if (tl.r0 < 3 || tl.r0 + kBfTileH + 3 > H || tl.c0 < 3 ||
      tl.c0 + kBfTileW + 3 > W) {
    rr = reflect(tl.r0 - 3 + r, H) - (tl.r0 - 3);
    cc = reflect(tl.c0 - 3 + c, W) - (tl.c0 - 8);
  }
  const __nv_bfloat16* src = stage + 8 * g8 * kBfPlane + rr * kBfBoxW + cc;
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = elu_bf16(__bfloat162float(src[k * kBfPlane]));
  }
  *reinterpret_cast<uint4*>(xs + (2 * half + g8) * kBfGroupX + cell * 16) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// Reflect padding on a grid of `rows` rows from image (r0, c0), kGroups
// groups `group` bytes apart: each position one row or column outside the
// image (row -1 or H, column -1 or W) takes the values of its reflection
// (row 1 or H - 2, column 1 or W - 2), which a conv computed from in-image
// taps; positions further out feed no output. The convs compute every
// position alike from its shifted neighbours, so this is their padding.
template <int kGroups>
__device__ __forceinline__ void reflect_border(unsigned char* f, int group,
                                               int rows, int r0, int c0,
                                               int H, int W, int ctid) {
  for (int p = ctid; p < rows * kBfGW; p += kBfConsumers) {
    const int i = p / kBfGW;
    const int gr = r0 + i, gc = c0 + p - i * kBfGW;
    const bool in_r = gr >= 0 && gr < H, in_c = gc >= 0 && gc < W;
    if (gr < -1 || gr > H || gc < -1 || gc > W || (in_r && in_c)) continue;
    const int src = (reflect(gr, H) - r0) * kBfGW + reflect(gc, W) - c0;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      *reinterpret_cast<uint4*>(f + k * group + p * 16) =
          *reinterpret_cast<const uint4*>(f + k * group + src * 16);
    }
  }
}

// sigmoid(conv3) at pixel p of the tile, if it lies in the image: f2's 3x3
// positions around it (8 bf16 channels in 16 bytes a position) by the
// bf16-rounded weights w3 [tap][ci] (shared memory) in f32 FMAs.
__device__ __forceinline__ void conv3_pixel(const unsigned char* f2,
                                            const float* w3, float bias3,
                                            float* __restrict__ out, Tile tl,
                                            int H, int W, int p) {
  const int i = p / kBfTileW, j = p - i * kBfTileW;
  if (tl.r0 + i >= H || tl.c0 + j >= W) return;
  float s = bias3;
#pragma unroll
  for (int tap = 0; tap < kTaps; ++tap) {
    const uint4 v = *reinterpret_cast<const uint4*>(
        f2 + ((i + tap / 3) * kBfGW + j + tap % 3) * 16);
    const float4 wa = reinterpret_cast<const float4*>(w3)[2 * tap];
    const float4 wb = reinterpret_cast<const float4*>(w3)[2 * tap + 1];
    const float wt[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s = fmaf(__uint_as_float(words[k] << 16), wt[2 * k], s);
      s = fmaf(__uint_as_float(words[k] & 0xFFFF0000u), wt[2 * k + 1], s);
    }
  }
  out[((int64_t)tl.n * H + tl.r0 + i) * W + tl.c0 + j] = sigmoid(s);
}

// A conv of kMt consecutive M-tiles on wgmma: acc[j] += A B over the 18
// k-steps, A through desc_a (the first M-tile: 64 consecutive grid
// positions of the source, kGroup bytes a group) plus the M-tile's 64
// positions, the k-step's tap shift and its channel groups, B through
// desc_b (stage_wgmma_b's slices, 2 kN 16-byte units apart). The offsets
// are constants added to one descriptor (its start address field does not
// overflow in 227 KB). All 18 kMt wgmmas go out before the one wait.
template <int kN, int kMt, int kGroup>
__device__ __forceinline__ void conv_wgmma(float (&acc)[kMt][kN / 2],
                                           uint64_t desc_a, uint64_t desc_b) {
#pragma unroll
  for (int j = 0; j < kMt; ++j) fence_regs(acc[j]);
  wgmma_fence();
  // k-steps at run time: unrolled, ptxas hoists all 18 kMt descriptors out
  // of the tile loop and spills them once the ELUs take registers
#pragma unroll 1
  for (int s = 0; s < kBfKSteps; ++s) {
    const int tap = s >> 1;
    const uint32_t a_off =
        (((tap / 3) * kBfGW + tap % 3) * 16 + (s & 1) * 2 * kGroup) >> 4;
#pragma unroll
    for (int j = 0; j < kMt; ++j) {
      wgmma_bf16<kN>(acc[j], desc_a + (uint64_t)(64 * j + a_off),
                     desc_b + (uint64_t)(2 * kN * s));
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < kMt; ++j) fence_regs(acc[j]);
}

__global__ void __launch_bounds__(kBfThreads, 1)
decoder_tail_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __nv_bfloat16* __restrict__ x,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ w3,
                         const float* __restrict__ b3,
                         float* __restrict__ out, int H, int W, int tiles_h,
                         int tiles_w, int tiles, int tma) {
  extern __shared__ __align__(128) unsigned char smem_bf_raw[];
  unsigned char* sm =
      smem_bf_raw + ((128 - (smem_addr(smem_bf_raw) & 127)) & 127);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const uint32_t bars = smem_addr(sm + kBfSBar);    // full 0, 1; empty 0, 1
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bars + 8 * i, tma ? 1 : 32);
      mbar_init(bars + 16 + 8 * i, kBfConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kBfConsumers / 32) {
    // the producer warpgroup gives up registers; its first warp loads both
    // halves of each of this block's tiles, in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kBfProducerRegs));
    if (warp != kBfConsumers / 32) return;
    int q = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Tile tl = bf_tile_at(tile, tiles_h, tiles_w);
      for (int half = 0; half < 2; ++half, ++q) {
        const int st = q & 1;
        mbar_wait(bars + 16 + 8 * st, ((q >> 1) & 1) ^ 1);
        unsigned char* dst = sm + kBfSRing + st * kBfStageBytes;
        if (tma) {
          if (lane == 0) {
            mbar_expect_tx(bars + 8 * st, kBfStageBytes);
            tma_load_3d(smem_addr(dst), &x_map, tl.c0 - 8, tl.r0 - 3,
                        tl.n * kC1 + half * kBfStageC, bars + 8 * st);
          }
        } else {
          copy_box(reinterpret_cast<__nv_bfloat16*>(dst), x, tl, half, H, W,
                   lane);
          mbar_arrive(bars + 8 * st);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg, its warp wl. They stage the weights while
  // the producer's first loads are in flight
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kBfConsumerRegs));
  stage_wgmma_b<kC1>(sm + kBfSB1, w1, tid, kBfConsumers);
  stage_wgmma_b<kC2>(sm + kBfSB2, w2, tid, kBfConsumers);
  float* w3s = reinterpret_cast<float*>(sm + kBfSW3);   // [tap][ci]
  for (int i = tid; i < kC2 * kTaps; i += kBfConsumers) {
    w3s[(i % kTaps) * kC2 + i / kTaps] = round_bf16(__ldg(w3 + i));
  }
  fence_async_smem();    // the weights are read by wgmma
  consumers_sync();
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* xs = sm + kBfSX;
  unsigned char* f1 = sm + kBfSF1;
  unsigned char* f2 = sm + kBfSF2;
  const uint64_t desc1 = wgmma_desc(smem_addr(sm + kBfSB1), kWgLbo, kWgSbo);
  const uint64_t desc2 = wgmma_desc(smem_addr(sm + kBfSB2), kWgLbo, kWgSbo);
  // A: this warpgroup's first M-tile of consecutive grid positions, 8 of
  // them (16 bytes apart) a core matrix, the groups kBfGroup* apart along K
  const uint64_t desc_x =
      wgmma_desc(smem_addr(xs + kBfMt1 * wg * 64 * 16), kBfGroupX, 128);
  const uint64_t desc_f1 =
      wgmma_desc(smem_addr(f1 + kBfMt2 * wg * 64 * 16), kBfGroup1, 128);
  const float bias3 = __ldg(b3);
  BfProbe probe;
  int q = 0;    // stages consumed; the q-th lies in stage q % 2
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = bf_tile_at(tile, tiles_h, tiles_w);
    for (int half = 0; half < 2; ++half, ++q) {
      mbar_wait(bars + 8 * (q & 1), (q >> 1) & 1);
      probe.mark(0);
      const __nv_bfloat16* stage = reinterpret_cast<const __nv_bfloat16*>(
          sm + kBfSRing + (q & 1) * kBfStageBytes);
      for (int i = tid; i < 2 * kBfCellsX; i += kBfConsumers) {
        convert_item(xs, stage, tl, half, H, W, i);
      }
      mbar_arrive(bars + 16 + 8 * (q & 1));
      probe.mark(1);
    }
    fence_async_smem();
    consumers_sync();    // elu(x) complete
    probe.mark(2);

    // conv1 at the warpgroup's positions of f1's grid
    {
      float acc[kBfMt1][16];
#pragma unroll
      for (int j = 0; j < kBfMt1; ++j) {
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
          acc[j][4 * n8] = acc[j][4 * n8 + 2] = __ldg(b1 + 8 * n8 + 2 * t);
          acc[j][4 * n8 + 1] = acc[j][4 * n8 + 3] =
              __ldg(b1 + 8 * n8 + 2 * t + 1);
        }
      }
      conv_wgmma<kC1, kBfMt1, kBfGroupX>(acc, desc_x, desc1);
      probe.mark(3);
#pragma unroll
      for (int j = 0; j < kBfMt1; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = (kBfMt1 * wg + j) * 64 + 16 * wl + g + 8 * r;
#pragma unroll
          for (int n8 = 0; n8 < 4; ++n8) {
            *reinterpret_cast<uint32_t*>(f1 + n8 * kBfGroup1 + m * 16 +
                                         4 * t) =
                pack_bf16(elu_bf16(acc[j][4 * n8 + 2 * r]),
                          elu_bf16(acc[j][4 * n8 + 2 * r + 1]));
          }
        }
      }
    }
    probe.mark(4);
    fence_async_smem();
    consumers_sync();    // f1 complete
    if (tl.r0 == 0 || tl.c0 == 0 || tl.r0 + kBfF1H - 2 >= H ||
        tl.c0 + kBfGW - 2 >= W) {
      reflect_border<4>(f1, kBfGroup1, kBfF1H, tl.r0 - 2, tl.c0 - 2, H, W,
                        tid);
      fence_async_smem();
      consumers_sync();
    }
    probe.mark(5);

    // conv2 at the warpgroup's positions of f2's grid
    {
      float acc[kBfMt2][4];
#pragma unroll
      for (int j = 0; j < kBfMt2; ++j) {
        acc[j][0] = acc[j][2] = __ldg(b2 + 2 * t);
        acc[j][1] = acc[j][3] = __ldg(b2 + 2 * t + 1);
      }
      conv_wgmma<kC2, kBfMt2, kBfGroup1>(acc, desc_f1, desc2);
      probe.mark(6);
#pragma unroll
      for (int j = 0; j < kBfMt2; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = (kBfMt2 * wg + j) * 64 + 16 * wl + g + 8 * r;
          *reinterpret_cast<uint32_t*>(f2 + m * 16 + 4 * t) = pack_bf16(
              elu_bf16(acc[j][2 * r]), elu_bf16(acc[j][2 * r + 1]));
        }
      }
    }
    probe.mark(7);
    consumers_sync();    // f2 complete
    if (tl.r0 == 0 || tl.c0 == 0 || tl.r0 + kBfF2H - 1 >= H ||
        tl.c0 + kBfGW - 1 >= W) {
      reflect_border<1>(f2, 0, kBfF2H, tl.r0 - 1, tl.c0 - 1, H, W, tid);
      consumers_sync();
    }
    probe.mark(8);
    for (int p = tid; p < kBfTileH * kBfTileW; p += kBfConsumers) {
      conv3_pixel(f2, w3s, bias3, out, tl, H, W, p);
    }
    probe.mark(9);
  }
  probe.flush(tid);
}

#ifdef TCSFM_TAIL_PROBE
// The rate of wgmma m64nNk16 bf16 with both operands from shared memory:
// two warpgroups a block, each with 4 independent accumulators (as the
// tail's convs keep several M-tiles in flight), 8 k-steps into each per
// commit group, one group left in flight.
template <int kN>
__global__ void __launch_bounds__(256) wgmma_rate_kernel(float* out,
                                                          int iters) {
  __shared__ __align__(128) unsigned char sb[32 * kN];
  __shared__ __align__(128) uint32_t sa[64 * 8];
  for (int i = threadIdx.x; i < 8 * kN; i += 256) {
    reinterpret_cast<uint32_t*>(sb)[i] = 0x3c003c00u;
  }
  for (int i = threadIdx.x; i < 64 * 8; i += 256) sa[i] = 0x3c003c00u;
  fence_async_smem();
  __syncthreads();
  float acc[4][kN / 2] = {};
  const uint64_t desc_a = wgmma_desc(smem_addr(sa), 64 * 16, 128);
  const uint64_t desc_b = wgmma_desc(smem_addr(sb), kWgLbo, kWgSbo);
#pragma unroll
  for (int j = 0; j < 4; ++j) fence_regs(acc[j]);
  wgmma_fence();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_bf16<kN>(acc[j], desc_a, desc_b);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    fence_regs(acc[j]);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) s += acc[j][i];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
#endif

// cuTensorMapEncodeTiled's signature (CUDA 12.0), reached through the
// runtime's cudaGetDriverEntryPoint: the library links no libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// x's tensor map for the bf16 kernel: [N * 32, H, W] bf16 (W % 8 == 0, x
// 16-byte aligned), boxes of kBfStageC planes x kBfXH rows x kBfBoxW
// columns, cells outside the tensor read as zeros.
cudaError_t bf16_x_map(CUtensorMap* map, const void* x, int N, int H, int W) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorNotSupported;
    }
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N * kC1};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2};
  const cuuint32_t box[3] = {kBfBoxW, kBfXH, kBfStageC};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// x [N, 32, H, W]; w1 [32, 32, 3, 3], b1 [32]; w2 [8, 32, 3, 3], b2 [8];
// w3 [1, 8, 3, 3], b3 [1]; out [N, H, W, 1]; all contiguous. H, W >= 2.
extern "C" int tcsfm_decoder_tail_fwd(const float* x, const float* w1,
                                      const float* b1, const float* w2,
                                      const float* b2, const float* w3,
                                      const float* b3, float* out, int N,
                                      int H, int W, int device, void* stream) {
  if ((int64_t)N * H * W == 0) return (int)cudaSuccess;
  DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return (int)scope.status();
  cudaError_t err = cudaFuncSetAttribute(
      decoder_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decoder_tail_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int64_t tiles = (int64_t)N * tiles_h * tiles_w;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t grid = tiles < (int64_t)sms * per_sm ? tiles
                                                      : (int64_t)sms * per_sm;
  const bool aligned = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  decoder_tail_kernel<<<(unsigned)grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, w2, b2, w3, b3, out, H, W, tiles_h, tiles_w, (int)tiles,
      aligned);
  return (int)cudaGetLastError();
}
// The bfloat16 tail: x bf16 [N, 32, H, W]; the weights and biases f32 (as
// the f32 entry point's); out f32 [N, H, W, 1]; all contiguous. H, W >= 2.
// x arrives by TMA where W % 8 == 0 and x is 16-byte aligned, else by the
// kernel's own loads; a tensor map that cannot be made returns its error.
extern "C" int tcsfm_decoder_tail_bf16_fwd(const void* x, const float* w1,
                                           const float* b1, const float* w2,
                                           const float* b2, const float* w3,
                                           const float* b3, float* out, int N,
                                           int H, int W, int device,
                                           void* stream) {
  if ((int64_t)N * H * W == 0) return (int)cudaSuccess;
  DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return (int)scope.status();
  cudaError_t err = cudaFuncSetAttribute(
      decoder_tail_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBfSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decoder_tail_bf16_kernel, kBfThreads, kBfSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles_h = (H + kBfTileH - 1) / kBfTileH;
  const int tiles_w = (W + kBfTileW - 1) / kBfTileW;
  const int64_t tiles = (int64_t)N * tiles_h * tiles_w;
  if (tiles > INT32_MAX || (int64_t)N * kC1 > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t grid = tiles < (int64_t)sms * per_sm ? tiles
                                                      : (int64_t)sms * per_sm;
  CUtensorMap map{};
  const int tma = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (tma) {
    err = bf16_x_map(&map, x, N, H, W);
    if (err != cudaSuccess) return (int)err;
  }
  decoder_tail_bf16_kernel<<<(unsigned)grid, kBfThreads, kBfSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const __nv_bfloat16*>(x), w1, b1, w2, b2, w3, b3, out,
      H, W, tiles_h, tiles_w, (int)tiles, tma);
  return (int)cudaGetLastError();
}

#ifdef TCSFM_TAIL_PROBE
// The probe's cycles (reset first when `reset`), kProbePhases of them.
extern "C" int tcsfm_decoder_tail_probe(unsigned long long* cycles,
                                        int reset) {
  if (reset) {
    const unsigned long long zero[kProbePhases] = {};
    return (int)cudaMemcpyToSymbol(tail_probe_cycles, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(cycles, tail_probe_cycles,
                                   sizeof(tail_probe_cycles));
}
#endif

#ifdef TCSFM_TAIL_PROBE
// The bf16 kernel's probe cycles (reset first when `reset`),
// kBfProbePhases of them.
extern "C" int tcsfm_decoder_tail_bf16_probe(unsigned long long* cycles,
                                             int reset) {
  if (reset) {
    const unsigned long long zero[kBfProbePhases] = {};
    return (int)cudaMemcpyToSymbol(tail_bf16_probe_cycles, zero,
                                   sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(cycles, tail_bf16_probe_cycles,
                                   sizeof(tail_bf16_probe_cycles));
}

// wgmma_rate_kernel<n> on `blocks` blocks of 256 threads, n 32 or 8.
extern "C" int tcsfm_wgmma_rate(float* out, int n, int blocks, int iters,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 32) {
    wgmma_rate_kernel<32><<<blocks, 256, 0, st>>>(out, iters);
  } else if (n == 8) {
    wgmma_rate_kernel<8><<<blocks, 256, 0, st>>>(out, iters);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#endif
