"""Where the fused decoder tail kernels' time goes, on the card.

    python -m tcsfm_torch.ops.tail_probe [--dtype float32|bfloat16] [--iters 20]

Builds ``csrc/decoder_tail.cu`` a second time with ``-DTCSFM_TAIL_PROBE``
(the library's own build leaves the probe out) and runs the kernel of the
given dtype (the f32 kernel, or the bf16 one on bf16 x) at the coupled
forward's shape [18, 32, 192, 640]: its time (CUDA events), its largest
difference from its plain version, and the share of warp 0's clock cycles
in each phase of the kernel, summed over every block. Then the rates of the
tensor-core instructions on this card: for float32 ``mma.sync.m16n8k8``
TF32, the f32 kernel's; for bfloat16 ``mma.sync.m16n8k16`` bf16 (8
independent MMAs a warp, 8 warps a block, one block an SM) and the bf16
kernel's ``wgmma`` m64n32k16 and m64n8k16 with both operands in shared
memory (two warpgroups a block, 4 independent accumulators each). Needs the
card.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from tcsfm_torch.ops import _build
from tcsfm_torch.ops import decoder_tail as dt

PHASES = ("wait for a chunk + ELU", "barrier + next copy", "conv1 MMAs",
          "f1 epilogue", "conv2", "conv3")
# the bf16 kernel's marks (BfProbe in csrc/decoder_tail.cu)
PHASES_BF16 = ("wait for x (full mbarrier)", "ELU into the grid",
               "barrier: elu(x) complete", "conv1 wgmma", "f1 epilogue",
               "barrier + f1's reflect pad", "conv2 wgmma", "f2 epilogue",
               "barrier + f2's reflect pad", "conv3 + store")
SHAPE = (18, 32, 192, 640)
MMA_ITERS = 20000
WGMMA_ITERS = 4000
MMA_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// 8 independent m16n8k8 TF32 MMAs a warp, `iters` times.
__global__ void __launch_bounds__(256) mma_rate(float* out, int iters) {
  float acc[8][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = 3u * a0, b0 = 5u * a0;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
            "+f"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(7u), "r"(9u), "r"(b0), "r"(11u));
    }
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) {
    s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// 8 independent m16n8k16 bf16 MMAs a warp, `iters` times.
__global__ void __launch_bounds__(256) mma_bf16_rate(float* out, int iters) {
  float acc[8][4] = {};
  const uint32_t a = 0x3c003c00u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
            "+f"(acc[j][3])
          : "r"(a), "r"(a), "r"(a), "r"(a), "r"(a), "r"(a));
    }
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) {
    s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int tcsfm_mma_rate(float* out, int blocks, int iters, int bf16,
                              void* stream) {
  if (bf16) {
    mma_bf16_rate<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        out, iters);
  } else {
    mma_rate<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out,
                                                                   iters);
  }
  return (int)cudaGetLastError();
}
"""


def _events_ms(fn, iters: int) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _raise_on(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def probe_library() -> ctypes.CDLL:
    """``csrc/decoder_tail.cu`` alone with the probe compiled in."""
    lib = ctypes.CDLL(str(_build.build([_build.CSRC / "decoder_tail.cu"],
                                       ("-DTCSFM_TAIL_PROBE",),
                                       "libtail_probe.so")))
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in ("tcsfm_decoder_tail_fwd", "tcsfm_decoder_tail_bf16_fwd"):
        getattr(lib, fn).argtypes = [p] * 8 + [i, i, i, i, p]
    lib.tcsfm_decoder_tail_probe.argtypes = [p, i]
    lib.tcsfm_decoder_tail_bf16_probe.argtypes = [p, i]
    lib.tcsfm_wgmma_rate.argtypes = [p, i, i, i, p]
    return lib


def tail_phases(lib, iters: int, bf16: bool) -> None:
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(*SHAPE) * 0.5).astype(np.float32)).cuda()
    ws = [torch.from_numpy(a.astype(np.float32)).cuda() for a in (
        rng.randn(32, 32, 3, 3) * 0.08, rng.randn(32) * 0.1,
        rng.randn(8, 32, 3, 3) * 0.08, rng.randn(8) * 0.1,
        rng.randn(1, 8, 3, 3) * 0.2, rng.randn(1) * 0.1)]
    if bf16:
        x = x.to(torch.bfloat16)
    n, _, h, w = SHAPE
    out = torch.empty(n, h, w, 1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    fwd = (lib.tcsfm_decoder_tail_bf16_fwd if bf16
           else lib.tcsfm_decoder_tail_fwd)
    cycles_of = (lib.tcsfm_decoder_tail_bf16_probe if bf16
                 else lib.tcsfm_decoder_tail_probe)
    phases = PHASES_BF16 if bf16 else PHASES

    def run():
        _raise_on(fwd(x.data_ptr(), *[t.data_ptr() for t in ws],
                      out.data_ptr(), n, h, w, x.device.index, stream),
                  "probe launch")

    run()
    torch.backends.cudnn.allow_tf32 = False
    plain = dt.decoder_tail_plain_bf16 if bf16 else dt.decoder_tail_plain
    err = (out - plain(x, *ws)).abs().max().item()
    cycles = (ctypes.c_ulonglong * len(phases))()
    _raise_on(cycles_of(cycles, 1), "probe reset")
    ms = _events_ms(run, iters)
    _raise_on(cycles_of(cycles, 0), "probe read")
    total = sum(cycles)
    kind = "bf16" if bf16 else "f32"
    print(f"{torch.cuda.get_device_name(0)}: {kind} decoder tail with the "
          f"probe, {list(SHAPE)}: {ms * 1e3:.2f} us a launch over "
          f"{iters + 1}, max|probe build - plain| {err:.3e}; warp 0's cycles "
          f"by phase:")
    for name, c in zip(phases, cycles):
        print(f"  {name:<28} {c / total:6.1%}")


def mma_rate(bf16: bool) -> None:
    src = _build.BUILD_ROOT / "mma_rate.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(MMA_SOURCE)
    lib = ctypes.CDLL(str(_build.build([src], name="libmma_rate.so")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tcsfm_mma_rate.argtypes = [p, i, i, i, p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = _events_ms(lambda: _raise_on(lib.tcsfm_mma_rate(
        out.data_ptr(), sms, MMA_ITERS, int(bf16), stream), "mma_rate"), 3)
    k = 16 if bf16 else 8
    flops = 2 * 16 * 8 * k * 8 * MMA_ITERS * 8 * sms
    kind = "m16n8k16 bf16" if bf16 else "m16n8k8 TF32"
    print(f"mma.sync.{kind}, 8 independent MMAs a warp, 8 warps on each of "
          f"{sms} SMs: {flops / ms / 1e9:.1f} TFLOP/s")


def wgmma_rate(lib) -> None:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for n in (32, 8):
        ms = _events_ms(lambda: _raise_on(lib.tcsfm_wgmma_rate(
            out.data_ptr(), n, sms, WGMMA_ITERS, stream), "wgmma rate"), 3)
        flops = 2 * 64 * n * 16 * 4 * 8 * WGMMA_ITERS * 2 * sms
        print(f"wgmma m64n{n}k16 bf16 (both operands in shared memory), two "
              f"warpgroups of 4 independent accumulators on each of {sms} "
              f"SMs: {flops / ms / 1e9:.1f} TFLOP/s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tail_probe needs an NVIDIA card")
    bf16 = args.dtype == "bfloat16"
    lib = probe_library()
    tail_phases(lib, args.iters, bf16)
    mma_rate(bf16)
    if bf16:
        wgmma_rate(lib)


if __name__ == "__main__":
    main()
