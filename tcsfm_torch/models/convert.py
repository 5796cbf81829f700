"""JAX-package parameters ↔ the port's ``state_dict``s.

The inverse of ``tcsfm/models/torch_import.py:38-113``, kept as the port's
own copy (it imports nothing of ``tcsfm``). The input is the JAX package's
nested parameter trees as numpy (or array-like) leaves: ``params["depth"]``,
``params["pose"]`` and the depth net's ``batch_stats``, as
``tcsfm.train.trainer.create_train_state`` makes them. HWIO kernels become
OIHW; BatchNorm ``scale``/``bias``/``mean``/``var`` become
``weight``/``bias``/``running_mean``/``running_var``; each pose stage's
GroupNorm becomes ``conv{i}.1``. The keys are the reference checkpoint's,
so a converted or reference state dict loads with ``load_state_dict``.
``grads_from_flax`` maps a gradient tree the same way, so gradients
compare key by key. ``to_flax`` is the inverse of ``from_flax``: the port's
``state_dict``s as the Flax trees, numpy float32 leaves, which is what the
checkpoints of both packages hold (``train/checkpoint.py``);
``depth_to_flax`` and ``pose_to_flax`` map one net's tensors, and map
Adam's moments, which are laid out as the parameters are, onto optax's
trees.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))  # a copy


def _conv_w(k) -> torch.Tensor:
    """flax HWIO → torch OIHW."""
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _bn(sd: StateDict, prefix: str, params: Mapping,
        stats: Optional[Mapping]) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    if stats is not None:
        sd[f"{prefix}.running_mean"] = _t(stats["mean"])
        sd[f"{prefix}.running_var"] = _t(stats["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def depth_state_dict(params: Mapping,
                     batch_stats: Optional[Mapping]) -> StateDict:
    """DepthNet params + batch_stats trees → DepthNet ``state_dict``; with
    ``batch_stats`` None, the parameters' entries only."""
    sd: StateDict = {}
    enc = params["encoder"]
    est = (batch_stats or {}).get("encoder")
    sd["encoder.encoder.conv1.weight"] = _conv_w(enc["conv1"]["kernel"])
    _bn(sd, "encoder.encoder.bn1", enc["bn1"],
        None if est is None else est["bn1"])
    for layer in range(1, 5):
        for block in range(2):
            name = f"layer{layer}_{block}"
            f = enc[name]

            def stats(bn):
                return None if est is None else est[name][bn]

            t = f"encoder.encoder.layer{layer}.{block}"
            sd[f"{t}.conv1.weight"] = _conv_w(f["Conv_0"]["kernel"])
            _bn(sd, f"{t}.bn1", f["BatchNorm_0"], stats("BatchNorm_0"))
            sd[f"{t}.conv2.weight"] = _conv_w(f["Conv_1"]["kernel"])
            _bn(sd, f"{t}.bn2", f["BatchNorm_1"], stats("BatchNorm_1"))
            if "Conv_2" in f:
                sd[f"{t}.downsample.0.weight"] = _conv_w(f["Conv_2"]["kernel"])
                _bn(sd, f"{t}.downsample.1", f["BatchNorm_2"],
                    stats("BatchNorm_2"))

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


def grads_from_flax(grads: Mapping) -> Dict[str, StateDict]:
    """A JAX gradient tree ``{"depth", "pose"}`` (the params' structure) →
    ``{"depth": {name: grad}, "pose": {name: grad}}`` under the names of the
    port's ``named_parameters()``, laid out as the port's parameters are."""
    return {"depth": depth_state_dict(grads["depth"], None),
            "pose": pose_state_dict(grads["pose"])}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _conv_k(w: torch.Tensor) -> np.ndarray:
    """torch OIHW → flax HWIO."""
    return np.ascontiguousarray(_np(w).transpose(2, 3, 1, 0))


def depth_to_flax(sd: Mapping[str, torch.Tensor]
                  ) -> Tuple[Dict, Optional[Dict]]:
    """A DepthNet ``state_dict`` → (its Flax params tree, its batch_stats
    tree), numpy float32 leaves. Without running statistics in ``sd`` (a
    dict of the parameters' names only, such as Adam's moments) the
    batch_stats tree is None."""
    has_stats = "encoder.encoder.bn1.running_mean" in sd
    enc: Dict = {
        "conv1": {"kernel": _conv_k(sd["encoder.encoder.conv1.weight"])}}
    est: Dict = {}

    def bn(prefix: str):
        return ({"bias": _np(sd[f"{prefix}.bias"]),
                 "scale": _np(sd[f"{prefix}.weight"])},
                {"mean": _np(sd[f"{prefix}.running_mean"]),
                 "var": _np(sd[f"{prefix}.running_var"])}
                if has_stats else None)

    enc["bn1"], est["bn1"] = bn("encoder.encoder.bn1")
    for layer in range(1, 5):
        for block in range(2):
            t = f"encoder.encoder.layer{layer}.{block}"
            f: Dict = {"Conv_0": {"kernel": _conv_k(sd[f"{t}.conv1.weight"])},
                       "Conv_1": {"kernel": _conv_k(sd[f"{t}.conv2.weight"])}}
            s: Dict = {}
            f["BatchNorm_0"], s["BatchNorm_0"] = bn(f"{t}.bn1")
            f["BatchNorm_1"], s["BatchNorm_1"] = bn(f"{t}.bn2")
            if f"{t}.downsample.0.weight" in sd:
                f["Conv_2"] = {
                    "kernel": _conv_k(sd[f"{t}.downsample.0.weight"])}
                f["BatchNorm_2"], s["BatchNorm_2"] = bn(f"{t}.downsample.1")
            enc[f"layer{layer}_{block}"], est[f"layer{layer}_{block}"] = f, s
    depth: Dict = {"encoder": enc}

    def refl_conv(flax_name: str, torch_prefix: str) -> None:
        depth[flax_name] = {"Conv_0": {
            "bias": _np(sd[f"{torch_prefix}.conv.bias"]),
            "kernel": _conv_k(sd[f"{torch_prefix}.conv.weight"])}}

    i = 0
    while f"depth_upconvs.{i}.1.conv.weight" in sd:
        refl_conv(f"upconv{i}", f"depth_upconvs.{i}.1")
        refl_conv(f"iconv{i}", f"iconvs.{i}.0")
        i += 1
    i = 0
    while f"feature_convs.{i}.0.conv.weight" in sd:
        refl_conv(f"feature_conv{i}", f"feature_convs.{i}.0")
        refl_conv(f"disp_head{i}", f"predict_disps.{i}.0")
        i += 1
    return depth, ({"encoder": est} if has_stats else None)


def pose_to_flax(pose_sd: Mapping[str, torch.Tensor]) -> Dict:
    """A PoseNet ``state_dict`` (or a dict of tensors under its parameters'
    names) → its Flax params tree, numpy float32 leaves."""
    pose: Dict = {}
    i = 1
    while f"conv{i}.0.weight" in pose_sd:
        pose[f"conv{i}"] = {
            "GroupNorm16_0": {"GroupNorm_0": {
                "bias": _np(pose_sd[f"conv{i}.1.bias"]),
                "scale": _np(pose_sd[f"conv{i}.1.weight"])}},
            "WSConv_0": {"bias": _np(pose_sd[f"conv{i}.0.bias"]),
                         "kernel": _conv_k(pose_sd[f"conv{i}.0.weight"])}}
        i += 1
    pose["pose_pred"] = {"bias": _np(pose_sd["pose_pred.bias"]),
                         "kernel": _conv_k(pose_sd["pose_pred.weight"])}
    return pose


def to_flax(depth_sd: Mapping[str, torch.Tensor],
            pose_sd: Mapping[str, torch.Tensor]
            ) -> Tuple[Dict, Dict]:
    """(depth ``state_dict``, pose ``state_dict``) → (``{"depth", "pose"}``
    params, depth batch_stats), the trees of ``create_train_state`` with
    numpy float32 leaves. ``from_flax`` of the result gives every parameter
    and running statistic back bit for bit; ``num_batches_tracked``, which
    Flax does not keep (and the port's BatchNorm, with its momentum set,
    does not read), comes back as 0."""
    depth, stats = depth_to_flax(depth_sd)
    return {"depth": depth, "pose": pose_to_flax(pose_sd)}, stats
