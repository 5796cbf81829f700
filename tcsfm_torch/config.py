"""The port's own copy of the configuration the coupled forward and the
training step read.

Mirrors ``tcsfm/config.py`` (``RESOLUTIONS``, ``Config``) for the fields
the port uses, with the same names and defaults, so ``Config.from_json``
reads what the JAX package's ``Config.to_json`` writes (unknown keys are
skipped). ``flow_type='classical'`` (8-channel pose input) is not ported
yet: ``from_json`` refuses it. The port does not import ``tcsfm``: its
``__init__`` pulls in JAX.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Tuple

# Image resolutions of the reference preprocessing (tcsfm/config.py:17-22).
RESOLUTIONS = {
    "low": (128, 448),
    "med": (192, 640),
    "high": (256, 832),
}


@dataclass
class Config:
    """Model, solver, optimisation and loss settings."""

    num_scales: int = 1               # disparity scales the depth net emits
    img_resolution: str = "med"       # key into RESOLUTIONS
    img_per_sample: int = 3           # 1 target + (img_per_sample-1) sources
    iterations: int = 4               # coupled egomotion iterations
    minibatch: int = 6

    # optimisation (tcsfm/config.py:47-54)
    lr: float = 1e-4
    pose_lr_mult: float = 2.0         # pose net trains at 2x depth lr
    wd: float = 0.0                   # > 0 selects AdamW
    num_epochs: int = 20
    lr_decay_epoch: int = 7           # halve lr every N epochs
    freeze_depthnet: bool = False
    freeze_posenet: bool = False

    # depth range (1/30 metric scale, as in tcsfm/config.py)
    min_depth: float = 0.06
    max_depth: float = 80.0 / 30.0

    # losses (tcsfm/config.py:61-77); the paper's KITTI training runs with
    # the depth-consistency terms off
    l_reconstruction: bool = True
    l_ssim: bool = True
    l1_weight: float = 0.15
    l_ssim_weight: float = 0.85
    with_auto_mask: bool = True
    l_pose_consist: bool = True
    l_pose_consist_weight: float = 5.0
    l_inverse: bool = True
    l_depth_consist: bool = False
    l_depth_consist_weight: float = 0.14
    with_depth_mask: bool = False
    l_smooth: bool = True
    l_smooth_weight: float = 0.05

    @property
    def image_size(self) -> Tuple[int, int]:
        return RESOLUTIONS[self.img_resolution]

    @property
    def num_source_imgs(self) -> int:
        return self.img_per_sample - 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        if d.get("flow_type", "none") != "none":
            raise NotImplementedError(
                f"flow_type={d['flow_type']!r} is not ported yet")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})
