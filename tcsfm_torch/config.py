"""The port's own copy of the configuration the coupled forward and the
training step read.

Mirrors ``tcsfm/config.py`` (``RESOLUTIONS``, ``Config``) for the fields
the port uses (the model, data, optimisation, loss, ``remat_coupled`` and
checkpoint fields), with the same names and defaults, so ``Config.from_json``
reads what the JAX package's ``Config.to_json`` writes (unknown keys are
skipped), and ``PFTOptions`` with the fields PFT reads.
``flow_type='classical'`` feeds the pose net two Farneback flow channels
(8 input channels, ``pose_input_channels``) on the one-shot pose paths,
as in the JAX package (``ops/flow.py``). ``compute_dtype`` is the JAX
package's field with its default: ``"bfloat16"`` runs both networks'
convolutions in bfloat16 on float32 parameters (geometry, sampler and
pose composition stay float32), ``"float32"`` runs them in float32 with
TF32 off; ``to_json`` writes the value, so either package reads a file
the other wrote as the same run. ``json_notes`` names the keys of a file
the JAX package wrote that the port does not read (its TPU sampler
fields), and the CLIs print it. ``mesh_shape``/``mesh_axes`` are read
and written as the JAX package's; the port's data parallelism takes its
ranks from the launcher (``tcsfm_torch.dist``), not from them.
``l_ssim=False`` is refused by both constructors: the loss stack's diff
image then keeps its 3 channels, which the JAX package's loss cannot take
either. The port does not import ``tcsfm``: its ``__init__`` pulls in JAX.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import List, Tuple

# the networks' compute dtypes the port takes (tcsfm/config.py:80)
COMPUTE_DTYPES = ("float32", "bfloat16")

# Image resolutions of the reference preprocessing (tcsfm/config.py:17-22).
RESOLUTIONS = {
    "low": (128, 448),
    "med": (192, 640),
    "high": (256, 832),
}


@dataclass
class Config:
    """Model, solver, optimisation and loss settings."""

    flow_type: str = "none"           # 'none' | 'classical' (8-ch pose input)
    num_scales: int = 1               # disparity scales the depth net emits
    img_resolution: str = "med"       # key into RESOLUTIONS
    img_per_sample: int = 3           # 1 target + (img_per_sample-1) sources
    iterations: int = 4               # coupled egomotion iterations

    # data (tcsfm/config.py:37-45)
    data_dir: str = ""
    data_format: str = "odometry"     # 'odometry' | 'eigen' | 'scannet'
    train_seq: Tuple[str, ...] = ("00_02", "02_02")
    val_seq: Tuple[str, ...] = ("05_02",)
    test_seq: Tuple[str, ...] = ("09_02",)
    augment_motion: bool = False
    minibatch: int = 6
    skip: int = 1                     # keep every `skip`-th window
    correction_rate: int = 1          # frame decimation inside windows

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
    camera_height: float = 1.70       # metres (KITTI); used by scale recovery

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

    # the networks' conv dtype (tcsfm/config.py:80); parameters, optimizer
    # state, geometry and the sampler stay float32
    compute_dtype: str = "bfloat16"

    # torch.utils.checkpoint each coupled iteration in the training step:
    # the backward recomputes the pose net and the warp of each iteration
    # instead of keeping their activations (tcsfm/config.py:105)
    remat_coupled: bool = True

    # distribution (tcsfm/config.py:108-109): carried for the config file;
    # the ranks come from the launcher (tcsfm_torch.dist.make_mesh)
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)

    # checkpointing (tcsfm/config.py:112-115)
    ckpt_dir: str = "results/default"
    load_from_checkpoint: bool = False
    load_best_model: bool = False
    pretrained_dir: str = ""

    def __post_init__(self):
        if not self.l_ssim:
            raise NotImplementedError(
                "l_ssim=False is not supported: without SSIM the photometric "
                "diff image keeps 3 channels and the loss cannot be formed "
                "(the JAX package's loss fails on it too)")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: the "
                             f"port computes in one of {COMPUTE_DTYPES}")

    @property
    def image_size(self) -> Tuple[int, int]:
        return RESOLUTIONS[self.img_resolution]

    @property
    def dtype(self) -> "torch.dtype":
        """``compute_dtype`` as a torch dtype."""
        import torch

        return getattr(torch, self.compute_dtype)

    @property
    def num_source_imgs(self) -> int:
        return self.img_per_sample - 1

    @property
    def pose_input_channels(self) -> int:
        return 8 if self.flow_type == "classical" else 6

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in names})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())


def json_notes(s: str) -> List[str]:
    """Lines naming the keys of the config JSON ``s`` that ``Config`` has
    no field for (the JAX package's TPU sampler settings)."""
    d = json.loads(s)
    names = {f.name for f in dataclasses.fields(Config)}
    unread = sorted(set(d) - names)
    if unread:
        return ["config keys the port does not read: " + ", ".join(unread)]
    return []


@dataclass
class PFTOptions:
    """Inference-time parameter-fine-tuning hyperparameters
    (``tcsfm/config.py:162-199``): the fields that ``solver.pft`` reads,
    with JAX's names and defaults. What to optimize is
    ``PFTOptimizer``'s ``mode`` argument, so JAX's six ``optimize_*``
    switches and its unread ``mode`` field have no counterpart here."""

    epochs: int = 20
    lr: float = 2e-4
    optimizer: str = "adam"           # 'adam' | 'sgd'
    avg_final_epochs: int = 5
    num_source_imgs: int = 2

    # loss switches
    diff_img_argmin: bool = True
    automasking: bool = True
    l_inverse_reconstruction: bool = True
    l_depth_consist: bool = True
    l_depth_consist_weight: float = 0.15
    l_depth_init: bool = True
    l_depth_init_weight: float = 0.1
    l_smooth: bool = False
    l_smooth_weight: float = 0.05
    l_pose_consist: bool = False

    def replace(self, **kw) -> "PFTOptions":
        return dataclasses.replace(self, **kw)
