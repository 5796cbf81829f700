"""Disparity/depth conversion and the flip-merge post-processing
(counterpart of ``tcsfm/utils/helpers.py``), and the device rule of the
port's entry points.

``disp_to_depth`` keeps a bfloat16 disparity (a bfloat16 net's) in
bfloat16, as JAX does: its Python-float constants are weakly typed in
both frameworks, so the depth reaches the geometry bfloat16-rounded
(``tcsfm/utils/helpers.py:12-20``). JAX rounds such a constant to
bfloat16 before it multiplies (16.29 becomes 16.25), torch would not:
``weak`` rounds it as JAX does."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def weak(c: float, like: torch.Tensor) -> float:
    """The Python scalar ``c`` as JAX's weak typing applies it to ``like``:
    rounded to bfloat16 first where ``like`` is bfloat16 (a torch op would
    apply it unrounded, in float32, and round only its result), unchanged
    otherwise."""
    if like.dtype == torch.bfloat16:
        return float(torch.tensor(c, dtype=torch.bfloat16))
    return c


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: float):
    """Sigmoid disparity → (scaled_disp, depth).

    d = 1 / (1/max + (1/min - 1/max) * disp)
    """
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = (weak(min_disp, disp)
                   + weak(max_disp - min_disp, disp) * disp)
    return scaled_disp, 1.0 / scaled_disp


def depth_to_disp(depth: torch.Tensor, min_depth: float, max_depth: float):
    """Inverse of ``disp_to_depth``."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return ((1.0 / depth - weak(min_disp, depth))
            / weak(max_disp - min_disp, depth))


def post_process_disparity(l_disp: torch.Tensor,
                           r_disp: torch.Tensor) -> torch.Tensor:
    """Monodepth1 flip-merge post-processing.

    l_disp, r_disp: [B, H, W]: disparity of the image and of the flipped
    image (already un-flipped). Blends with edge-favouring ramp masks.
    """
    w = l_disp.shape[-1]
    m_disp = 0.5 * (l_disp + r_disp)
    # jnp.linspace's float32 (float64 under x64): a bfloat16 disparity's
    # blend promotes to float32, as JAX's does
    ramp = torch.linspace(0.0, 1.0, w, device=l_disp.device,
                          dtype=torch.promote_types(l_disp.dtype,
                                                    torch.float32)
                          )[None, None, :]
    l_mask = 1.0 - (20.0 * (ramp - 0.05)).clamp(0.0, 1.0)
    r_mask = l_mask.flip(-1)
    return r_mask * l_disp + l_mask * r_disp + (1.0 - l_mask - r_mask) * m_disp


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as a numpy array; a bfloat16 tensor (numpy has no
    bfloat16) as float32, which holds its values exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device with no card present raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return device


def to_device(batch: Dict[str, np.ndarray], keys, device: torch.device,
              dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """``batch[k]`` for ``k`` in ``keys`` on ``device``; to a card through
    pinned memory without waiting for the copy."""
    device, out = torch.device(device), {}
    for k in keys:
        t = torch.from_numpy(np.ascontiguousarray(batch[k])).to(dtype)
        out[k] = (t.pin_memory().to(device, non_blocking=True)
                  if device.type == "cuda" else t)
    return out
