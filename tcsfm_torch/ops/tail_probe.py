"""Where the fused decoder tail kernel's time goes, on the card.

    python -m tcsfm_torch.ops.tail_probe [--iters 20]

Builds ``csrc/decoder_tail.cu`` a second time with ``-DTCSFM_TAIL_PROBE``
(the library's own build leaves the probe out) and runs it at the coupled
forward's shape [18, 32, 192, 640]: its time (CUDA events), and the share
of warp 0's clock cycles in each phase of the kernel, summed over every
block. Then measures the rate of ``mma.sync.m16n8k8`` TF32 on this card
(independent MMAs, 8 warps a block, one block an SM), the ceiling of the
kernel's two tensor-core phases. Needs the card.
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
SHAPE = (18, 32, 192, 640)
MMA_ITERS = 20000
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
extern "C" int tcsfm_mma_rate(float* out, int blocks, int iters,
                              void* stream) {
  mma_rate<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
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


def tail_phases(iters: int) -> None:
    lib = ctypes.CDLL(str(_build.build([_build.CSRC / "decoder_tail.cu"],
                                       ("-DTCSFM_TAIL_PROBE",),
                                       "libtail_probe.so")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tcsfm_decoder_tail_fwd.argtypes = [p] * 8 + [i, i, i, i, p]
    lib.tcsfm_decoder_tail_probe.argtypes = [p, i]
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(*SHAPE) * 0.5).astype(np.float32)).cuda()
    ws = [torch.from_numpy(a.astype(np.float32)).cuda() for a in (
        rng.randn(32, 32, 3, 3) * 0.08, rng.randn(32) * 0.1,
        rng.randn(8, 32, 3, 3) * 0.08, rng.randn(8) * 0.1,
        rng.randn(1, 8, 3, 3) * 0.2, rng.randn(1) * 0.1)]
    n, _, h, w = SHAPE
    out = x.new_empty(n, h, w, 1)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.tcsfm_decoder_tail_fwd(
            x.data_ptr(), *[t.data_ptr() for t in ws], out.data_ptr(), n, h,
            w, x.device.index, stream)
        if rc:
            raise RuntimeError(f"probe launch failed: CUDA error {rc}")

    run()
    torch.backends.cudnn.allow_tf32 = False
    err = (out - dt.decoder_tail_plain(x, *ws)).abs().max().item()
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    lib.tcsfm_decoder_tail_probe(cycles, 1)
    ms = _events_ms(run, iters)
    lib.tcsfm_decoder_tail_probe(cycles, 0)
    total = sum(cycles)
    print(f"{torch.cuda.get_device_name(0)}: decoder tail with the probe, "
          f"{list(SHAPE)}: {ms * 1e3:.2f} us a launch over {iters + 1}, "
          f"max|probe build - plain| {err:.3e}; warp 0's cycles by phase:")
    for name, c in zip(PHASES, cycles):
        print(f"  {name:<24} {c / total:6.1%}")


def mma_rate() -> None:
    src = _build.BUILD_ROOT / "mma_rate.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(MMA_SOURCE)
    lib = ctypes.CDLL(str(_build.build([src], name="libmma_rate.so")))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tcsfm_mma_rate.argtypes = [p, i, i, p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = _events_ms(lambda: lib.tcsfm_mma_rate(out.data_ptr(), sms,
                                              MMA_ITERS, stream), 3)
    flops = 2 * 16 * 8 * 8 * 8 * MMA_ITERS * 8 * sms
    print(f"mma.sync.m16n8k8 TF32, 8 independent MMAs a warp, 8 warps on "
          f"each of {sms} SMs: {flops / ms / 1e9:.1f} TFLOP/s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tail_probe needs an NVIDIA card")
    tail_phases(args.iters)
    mma_rate()


if __name__ == "__main__":
    main()
