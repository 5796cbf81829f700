"""The port's own copy of the configuration the coupled forward reads.

Mirrors ``tcsfm/config.py`` (``RESOLUTIONS``, ``Config``) for the fields
this slice uses, with the same names and defaults, so ``Config.from_json``
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
    """Model and solver settings of the coupled forward."""

    num_scales: int = 1               # disparity scales the depth net emits
    img_resolution: str = "med"       # key into RESOLUTIONS
    img_per_sample: int = 3           # 1 target + (img_per_sample-1) sources
    iterations: int = 4               # coupled egomotion iterations
    minibatch: int = 6
    # depth range (1/30 metric scale, as in tcsfm/config.py)
    min_depth: float = 0.06
    max_depth: float = 80.0 / 30.0

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
