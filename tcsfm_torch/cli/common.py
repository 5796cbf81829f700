"""What the port's checkpoint-reading CLIs share: the configuration of a
model directory and the networks with its weights."""

from __future__ import annotations

import os
from typing import Tuple

import torch

from tcsfm_torch.config import Config, json_notes
from tcsfm_torch.infer import build_models
from tcsfm_torch.models.depth import DepthNet
from tcsfm_torch.models.pose import PoseNet
from tcsfm_torch.train.checkpoint import load_checkpoint


def load_config(model_dir: str, default: Config) -> Config:
    """``model_dir``'s ``config.json``, printing the keys the port does not
    read (``config.json_notes``); ``default`` without a directory. The
    networks compute in its ``compute_dtype`` (``load_nets``)."""
    if not model_dir:
        return default
    with open(os.path.join(model_dir, "config.json")) as f:
        text = f.read()
    for note in json_notes(text):
        print(note)
    return Config.from_json(text)


def load_nets(model_dir: str, device) -> Tuple[DepthNet, PoseNet]:
    """The networks on ``device`` in eval mode, computing in the model's
    ``compute_dtype``: ``model_dir``'s best model (or its latest
    checkpoint), or with no directory the seeded init of
    ``infer.build_models`` in float32, as the JAX CLIs' defaults compute
    (generator seed 0; the JAX CLIs' init draws other numbers)."""
    cfg = (Config.load(os.path.join(model_dir, "config.json")) if model_dir
           else Config(compute_dtype="float32"))
    depth_net, pose_net = build_models(
        cfg, device=device, generator=torch.Generator().manual_seed(0))
    if model_dir:
        load_checkpoint(model_dir, (depth_net, pose_net), load_best=True)
    return depth_net, pose_net
