"""The reference's torch checkpoints and torchvision's resnet18 weights onto
the port's networks (counterpart of ``tcsfm/models/torch_import.py``).

The reference warm-starts training from pretrained torch checkpoints
(README.md:54; utils/learning_helpers.py:29-48 loads ``pose_state_dict`` /
``depth_state_dict``). The port's modules carry the reference's names
(``models/depth.py``, ``pose.py``, ``resnet.py``), so the map is the
identity on names: the reference's depth keys sit under
``encoder.encoder.*`` as the port's do (the JAX package mounts the resnet
one level higher, as ``encoder``), and the decoder's indexed Sequentials
(``depth_upconvs.i.1.conv``, ``iconvs.i.0.conv``, ``feature_convs.i.0.conv``,
``predict_disps.i.0.conv``) are the port's own. The converters still walk
the JAX converter's key list (``tcsfm/models/torch_import.py:38-113``) and
take exactly those keys, counting the decoder's stages from the keys as it
does: a missing key raises, and every other key of the input is dropped,
as JAX's converter drops it (``num_batches_tracked``, torchvision's
``fc.*``). Each value becomes a float32 CPU tensor, a copy. BatchNorm's
running statistics are taken as stored; Flax's update rule
(``layers.BatchNorm2d``) governs only later updates. ``num_batches_tracked``
comes back as 0, as ``convert.from_flax`` gives it.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]
BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _t(x) -> torch.Tensor:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _counted(sd: Mapping, prefix: str, suffix: str) -> int:
    """The number of indexed stages ``prefix.i.suffix`` in ``sd``."""
    return sum(1 for k in sd if k.startswith(prefix) and k.endswith(suffix))


def depth_keys(sd: Mapping) -> List[str]:
    """The keys JAX's ``convert_depth_state_dict`` reads from ``sd`` (a
    reference depth state dict), BatchNorm running statistics included."""
    keys = ["encoder.encoder.conv1.weight"]
    keys += [f"encoder.encoder.bn1.{k}" for k in BN_KEYS]
    for layer in range(1, 5):
        for block in range(2):
            t = f"encoder.encoder.layer{layer}.{block}"
            keys += [f"{t}.conv1.weight"] + [f"{t}.bn1.{k}" for k in BN_KEYS]
            keys += [f"{t}.conv2.weight"] + [f"{t}.bn2.{k}" for k in BN_KEYS]
            if f"{t}.downsample.0.weight" in sd:
                keys += [f"{t}.downsample.0.weight"]
                keys += [f"{t}.downsample.1.{k}" for k in BN_KEYS]
    for i in range(_counted(sd, "depth_upconvs.", ".1.conv.weight")):
        for prefix in (f"depth_upconvs.{i}.1", f"iconvs.{i}.0"):
            keys += [f"{prefix}.conv.weight", f"{prefix}.conv.bias"]
    for i in range(_counted(sd, "feature_convs.", ".0.conv.weight")):
        for prefix in (f"feature_convs.{i}.0", f"predict_disps.{i}.0"):
            keys += [f"{prefix}.conv.weight", f"{prefix}.conv.bias"]
    return keys


def _with_counters(out: StateDict) -> StateDict:
    """``num_batches_tracked`` = 0 beside every BatchNorm's running mean."""
    for k in [k for k in out if k.endswith(".running_mean")]:
        out[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def convert_depth_state_dict(sd: Mapping) -> StateDict:
    """Reference depth_model state dict → the port's ``DepthNet``
    ``state_dict`` (parameters and running statistics)."""
    return _with_counters({k: _t(sd[k]) for k in depth_keys(sd)})


def convert_pose_state_dict(sd: Mapping) -> StateDict:
    """Reference pose_model state dict → the port's ``PoseNet``
    ``state_dict``. Layout (models/pose_models.py:105-114): convN =
    Sequential(conv2d_wn, GroupNorm, ReLU); pose_pred = 1x1 Conv2d."""
    keys = [f"conv{i}.{j}.{k}" for i in range(1, 8) for j in (0, 1)
            for k in ("weight", "bias")]
    keys += ["pose_pred.weight", "pose_pred.bias"]
    return {k: _t(sd[k]) for k in keys}


def convert_torchvision_resnet18(sd: Mapping) -> StateDict:
    """A raw torchvision resnet18 state dict (ImageNet pretrained) → the
    ``encoder.encoder.*`` entries of a ``DepthNet`` ``state_dict``; ``fc.*``
    is dropped (depth_models.py:110-119, README.md:54)."""
    renamed = {f"encoder.encoder.{k}": v for k, v in sd.items()
               if not k.startswith("fc.")}
    return convert_depth_state_dict(renamed)


def warm_start_encoder(depth_sd: Mapping[str, torch.Tensor],
                       encoder_sd: Mapping[str, torch.Tensor]) -> StateDict:
    """``depth_sd`` with its encoder's entries replaced by ``encoder_sd``'s
    (the decoder and the heads keep their values)."""
    out = dict(depth_sd)
    for k, v in encoder_sd.items():
        if not k.startswith("encoder."):
            raise KeyError(f"{k} is not an encoder entry")
        out[k] = v
    return out


def convert_reference_checkpoint(ckpt: Mapping) -> Dict:
    """A whole reference checkpoint dict (run_mono_training.py:228-234) →
    ``{"depth": state_dict, "pose": state_dict, "epoch", "best_val_loss"}``."""
    return {
        "depth": convert_depth_state_dict(ckpt["depth_state_dict"]),
        "pose": convert_pose_state_dict(ckpt["pose_state_dict"]),
        "epoch": ckpt.get("epoch", 0),
        "best_val_loss": ckpt.get("best_val_loss", float("inf")),
    }
