"""JAX-package parameters → the port's ``state_dict``s.

The inverse of ``tcsfm/models/torch_import.py:38-113``, kept as the port's
own copy (it imports nothing of ``tcsfm``). The input is the JAX package's
nested parameter trees as numpy (or array-like) leaves: ``params["depth"]``,
``params["pose"]`` and the depth net's ``batch_stats``, as
``tcsfm.train.trainer.create_train_state`` makes them. HWIO kernels become
OIHW; BatchNorm ``scale``/``bias``/``mean``/``var`` become
``weight``/``bias``/``running_mean``/``running_var``; each pose stage's
GroupNorm becomes ``conv{i}.1``. The keys are the reference checkpoint's,
so a converted or reference state dict loads with ``load_state_dict``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))  # a copy


def _conv_w(k) -> torch.Tensor:
    """flax HWIO → torch OIHW."""
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _bn(sd: StateDict, prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def depth_state_dict(params: Mapping, batch_stats: Mapping) -> StateDict:
    """DepthNet params + batch_stats trees → DepthNet ``state_dict``."""
    sd: StateDict = {}
    enc, est = params["encoder"], batch_stats["encoder"]
    sd["encoder.encoder.conv1.weight"] = _conv_w(enc["conv1"]["kernel"])
    _bn(sd, "encoder.encoder.bn1", enc["bn1"], est["bn1"])
    for layer in range(1, 5):
        for block in range(2):
            f, fs = enc[f"layer{layer}_{block}"], est[f"layer{layer}_{block}"]
            t = f"encoder.encoder.layer{layer}.{block}"
            sd[f"{t}.conv1.weight"] = _conv_w(f["Conv_0"]["kernel"])
            _bn(sd, f"{t}.bn1", f["BatchNorm_0"], fs["BatchNorm_0"])
            sd[f"{t}.conv2.weight"] = _conv_w(f["Conv_1"]["kernel"])
            _bn(sd, f"{t}.bn2", f["BatchNorm_1"], fs["BatchNorm_1"])
            if "Conv_2" in f:
                sd[f"{t}.downsample.0.weight"] = _conv_w(f["Conv_2"]["kernel"])
                _bn(sd, f"{t}.downsample.1", f["BatchNorm_2"],
                    fs["BatchNorm_2"])

    def refl_conv(flax_name: str, torch_prefix: str) -> None:
        c = params[flax_name]["Conv_0"]
        sd[f"{torch_prefix}.conv.weight"] = _conv_w(c["kernel"])
        sd[f"{torch_prefix}.conv.bias"] = _t(c["bias"])

    i = 0
    while f"upconv{i}" in params:
        refl_conv(f"upconv{i}", f"depth_upconvs.{i}.1")
        refl_conv(f"iconv{i}", f"iconvs.{i}.0")
        i += 1
    i = 0
    while f"feature_conv{i}" in params:
        refl_conv(f"feature_conv{i}", f"feature_convs.{i}.0")
        refl_conv(f"disp_head{i}", f"predict_disps.{i}.0")
        i += 1
    return sd


def pose_state_dict(params: Mapping) -> StateDict:
    """PoseNet params tree → PoseNet ``state_dict``."""
    sd: StateDict = {}
    i = 1
    while f"conv{i}" in params:
        c = params[f"conv{i}"]
        sd[f"conv{i}.0.weight"] = _conv_w(c["WSConv_0"]["kernel"])
        sd[f"conv{i}.0.bias"] = _t(c["WSConv_0"]["bias"])
        gn = c["GroupNorm16_0"]["GroupNorm_0"]
        sd[f"conv{i}.1.weight"] = _t(gn["scale"])
        sd[f"conv{i}.1.bias"] = _t(gn["bias"])
        i += 1
    sd["pose_pred.weight"] = _conv_w(params["pose_pred"]["kernel"])
    sd["pose_pred.bias"] = _t(params["pose_pred"]["bias"])
    return sd


def from_flax(params: Mapping, batch_stats: Mapping
              ) -> Tuple[StateDict, StateDict]:
    """``{"depth", "pose"}`` params + depth batch_stats →
    (depth ``state_dict``, pose ``state_dict``)."""
    return (depth_state_dict(params["depth"], batch_stats),
            pose_state_dict(params["pose"]))
