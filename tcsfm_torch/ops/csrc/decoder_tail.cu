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
// Design: the f32 kernel's tiling (12x32 tiles, base1/base2's reflected
// cells, one persistent grid over the tiles), conv1 and conv2 on
// mma.sync.m16n8k16 bf16 with f32 accumulation (one product a multiply-
// add; conv1 takes the weights as A and the cells as B, conv2 the cells as
// A and its weights as B, as above), K = 9 taps x 32 channels in 18
// k-steps of 16. Activations are stored cell-major, a cell's 32 bf16
// channels as 16 words (channel pairs) in a 20-word stride: a fragment's 8
// cells x 4 pairs then fall on 32 banks. x is read with plain loads, two
// channels a thread, and activated as it is stored; f1 is written over
// elu(x) and f2 over f1, each behind a barrier (the accumulators are in
// registers), so that a block needs 81 KB and two blocks share an SM.
// No cp.async ring: that and wgmma/TMA are later work.

constexpr int kBfWords = 20;                 // words a cell (16 + 4 pad)
constexpr int kBfKSteps = kTaps * kC1 / 16;  // 18
constexpr int kBfThreads = 256;
constexpr int kBfSw1 = 0;                               // uint4 [18][2][32]
constexpr int kBfSw2 = kBfSw1 + kBfKSteps * 2 * 32 * 4; // uint2 [18][32]
constexpr int kBfSw3 = kBfSw2 + kBfKSteps * 32 * 2;     // f32 [8 * 9]
constexpr int kBfSx = (kBfSw3 + kC2 * kTaps + 3) / 4 * 4;
constexpr int kBfSmemWords = kBfSx + kH0 * kW0 * kBfWords;
constexpr int kBfSmemBytes = kBfSmemWords * 4;
static_assert(kCells1 <= kH0 * kW0 && kC2 * kP2 <= kCells1 * kBfWords,
              "f1 and f2 fit over elu(x)");
static_assert(kBfSmemBytes * 2 <= 232448, "two blocks an SM");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint4 a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The weights once per block: conv1's [32, 32, 3, 3] as A fragments (k-step
// s = tap * 2 + half; a lane's rows co g, g + 8 of its M-tile and columns
// ci 16 half + 2t (+1), + 8), conv2's [8, 32, 3, 3] as B fragments (column
// co g, rows ci 16 half + 2t (+1), + 8), conv3's [1, 8, 3, 3] rounded.
__device__ __forceinline__ void stage_bf16_weights(
    uint32_t* smem, const float* __restrict__ w1,
    const float* __restrict__ w2, const float* __restrict__ w3, int tid) {
  uint4* a1 = reinterpret_cast<uint4*>(smem + kBfSw1);
  for (int i = tid; i < kBfKSteps * 2 * 32; i += kBfThreads) {
    const int lane = i & 31, mt = (i >> 5) & 1, s = i >> 6;
    const int co = mt * 16 + (lane >> 2);
    const int ci = (s & 1) * 16 + 2 * (lane & 3);
    const float* w = w1 + (co * kC1 + ci) * kTaps + (s >> 1);
    constexpr int kCo8 = 8 * kC1 * kTaps;
    a1[i] = make_uint4(
        pack_bf16(__ldg(w), __ldg(w + kTaps)),
        pack_bf16(__ldg(w + kCo8), __ldg(w + kCo8 + kTaps)),
        pack_bf16(__ldg(w + 8 * kTaps), __ldg(w + 9 * kTaps)),
        pack_bf16(__ldg(w + kCo8 + 8 * kTaps), __ldg(w + kCo8 + 9 * kTaps)));
  }
  uint2* b2 = reinterpret_cast<uint2*>(smem + kBfSw2);
  for (int i = tid; i < kBfKSteps * 32; i += kBfThreads) {
    const int lane = i & 31, s = i >> 5;
    const int ci = (s & 1) * 16 + 2 * (lane & 3);
    const float* w = w2 + ((lane >> 2) * kC1 + ci) * kTaps + (s >> 1);
    b2[i] = make_uint2(pack_bf16(__ldg(w), __ldg(w + kTaps)),
                       pack_bf16(__ldg(w + 8 * kTaps), __ldg(w + 9 * kTaps)));
  }
  float* w3s = reinterpret_cast<float*>(smem + kBfSw3);
  for (int i = tid; i < kC2 * kTaps; i += kBfThreads) {
    w3s[i] = round_bf16(__ldg(w3 + i));
  }
}

// elu(x) over the tile's 18x40 region (cells at reflected coordinates, as
// the f32 kernel's), two channels a thread, as packed bf16 words.
__device__ __forceinline__ void load_elu_x_bf16(
    uint32_t* xs, const __nv_bfloat16* __restrict__ x, Tile tl, int H, int W,
    int tid) {
  constexpr int kCells0 = kH0 * kW0;
  const __nv_bfloat16* xn = x + (int64_t)tl.n * kC1 * H * W;
  const int64_t plane = (int64_t)H * W;
  for (int i = tid; i < kC1 / 2 * kCells0; i += kBfThreads) {
    const int pair = i / kCells0;
    const int cell = i - pair * kCells0;
    const int r = cell / kW0;
    const int gr = reflect(tl.r0 - 3 + r, H);
    const int gc = reflect(tl.c0 - 4 + cell - r * kW0, W);
    const __nv_bfloat16* p = xn + 2 * pair * plane + (int64_t)gr * W + gc;
    xs[cell * kBfWords + pair] =
        pack_bf16(elu(__bfloat162float(p[0])), elu(__bfloat162float(p[plane])));
  }
}

__global__ void __launch_bounds__(kBfThreads, 2)
decoder_tail_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ w3,
                         const float* __restrict__ b3,
                         float* __restrict__ out, int H, int W, int tiles_h,
                         int tiles_w, int tiles) {
  extern __shared__ uint4 smem_bf[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_bf);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint4* a1 = reinterpret_cast<const uint4*>(smem + kBfSw1);
  const uint2* b2s = reinterpret_cast<const uint2*>(smem + kBfSw2);
  const float* w3s = reinterpret_cast<const float*>(smem + kBfSw3);
  uint32_t* xs = smem + kBfSx;
  // f1 (bf16, cell-major like elu(x)) and f2 (f32 planes) over elu(x)
  __nv_bfloat16* f1 = reinterpret_cast<__nv_bfloat16*>(xs);
  float* f2 = reinterpret_cast<float*>(xs);
  stage_bf16_weights(smem, w1, w2, w3, tid);
  const float bias3 = __ldg(b3);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_at(tile, tiles_h, tiles_w);
    __syncthreads();    // the last tile's conv3 is done with f2
    load_elu_x_bf16(xs, x, tl, H, W, tid);
    __syncthreads();

    // conv1: this warp's kNPer1 N-tiles of 8 f1 cells, both M-tiles
    int base[kNPer1];
    float acc[kNPer1][2][4];
#pragma unroll
    for (int ni = 0; ni < kNPer1; ++ni) {
      base[ni] = base1((warp * kNPer1 + ni) * 8 + g, tl, H, W);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        acc[ni][mt][0] = acc[ni][mt][1] = __ldg(b1 + mt * 16 + g);
        acc[ni][mt][2] = acc[ni][mt][3] = __ldg(b1 + mt * 16 + g + 8);
      }
    }
#pragma unroll 1
    for (int s = 0; s < kBfKSteps; ++s) {
      const int tap = s >> 1;
      const int off = ((tap / 3) * kW0 + tap % 3) * kBfWords + (s & 1) * 8 + t;
      const uint4 a_lo = a1[(s * 2) * 32 + lane];
      const uint4 a_hi = a1[(s * 2 + 1) * 32 + lane];
#pragma unroll
      for (int ni = 0; ni < kNPer1; ++ni) {
        const uint32_t* p = xs + base[ni] * kBfWords + off;
        const uint32_t b0 = p[0], b1v = p[4];
        mma_bf16(acc[ni][0], a_lo, b0, b1v);
        mma_bf16(acc[ni][1], a_hi, b0, b1v);
      }
    }
    __syncthreads();    // every warp is done reading elu(x)
#pragma unroll
    for (int ni = 0; ni < kNPer1; ++ni) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int co = mt * 16 + g + 8 * r;
          const int m = (warp * kNPer1 + ni) * 8 + 2 * t;
          f1[m * 2 * kBfWords + co] =
              __float2bfloat16_rn(elu(acc[ni][mt][2 * r]));
          f1[(m + 1) * 2 * kBfWords + co] =
              __float2bfloat16_rn(elu(acc[ni][mt][2 * r + 1]));
        }
      }
    }
    __syncthreads();

    // conv2: this warp's M-tiles of 16 f2 cells, its 8 channels one N-tile
    const uint32_t* f1w = xs;
    int cb[kMPer2][2];
    float acc2[kMPer2][4];
#pragma unroll
    for (int mi = 0; mi < kMPer2; ++mi) {
      const int m = (warp + mi * kWarps) * 16 + g;
      cb[mi][0] = base2(m, tl, H, W) * kBfWords;
      cb[mi][1] = base2(m + 8, tl, H, W) * kBfWords;
      acc2[mi][0] = acc2[mi][2] = __ldg(b2 + 2 * t);
      acc2[mi][1] = acc2[mi][3] = __ldg(b2 + 2 * t + 1);
    }
#pragma unroll 1
    for (int s = 0; s < kBfKSteps; ++s) {
      const int tap = s >> 1;
      const int off = ((tap / 3) * kW1 + tap % 3) * kBfWords + (s & 1) * 8 + t;
      const uint2 b = b2s[s * 32 + lane];
#pragma unroll
      for (int mi = 0; mi < kMPer2; ++mi) {
        const uint32_t* p0 = f1w + cb[mi][0] + off;
        const uint32_t* p1 = f1w + cb[mi][1] + off;
        mma_bf16(acc2[mi], make_uint4(p0[0], p1[0], p0[4], p1[4]), b.x, b.y);
      }
    }
    __syncthreads();    // every warp is done reading f1
#pragma unroll
    for (int mi = 0; mi < kMPer2; ++mi) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = (warp + mi * kWarps) * 16 + g + 8 * r;
        if (m < kCells2) {
          f2[2 * t * kP2 + m] = round_bf16(elu(acc2[mi][2 * r]));
          f2[(2 * t + 1) * kP2 + m] = round_bf16(elu(acc2[mi][2 * r + 1]));
        }
      }
    }
    __syncthreads();
    conv3_out(f2, w3s, bias3, out + (int64_t)tl.n * H * W, tl, H, W, tid);
  }
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
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int64_t tiles = (int64_t)N * tiles_h * tiles_w;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t grid = tiles < (int64_t)sms * per_sm ? tiles
                                                      : (int64_t)sms * per_sm;
  decoder_tail_bf16_kernel<<<(unsigned)grid, kBfThreads, kBfSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), w1, b1, w2, b2, w3, b3, out, H,
      W, tiles_h, tiles_w, (int)tiles);
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
