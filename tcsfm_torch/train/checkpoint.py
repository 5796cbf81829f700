"""Checkpoints that the JAX package and the port both read (counterpart of
``tcsfm/train/checkpoint.py``).

The layout and the payload are the JAX package's: ``checkpoint.msgpack``
in ``ckpt_dir``, copied to ``best_model/best_model.msgpack`` when
``is_best``, and ``config.json`` beside it; the payload is a msgpack map
with ``epoch``, ``best_val_loss``, ``step``, ``params`` (``{"depth",
"pose"}``) and ``batch_stats``, the Flax trees that ``models.convert``
maps onto the port's networks. The encoding is ``flax.serialization``'s
(``msgpack_serialize`` / ``msgpack_restore``): arrays as msgpack ext type 1
holding a packed ``(shape, dtype name, C-order bytes)``, numpy scalars as
ext type 3, complex numbers as ext type 2; the reader also takes Flax's
``{"__msgpack_chunked_array__": ...}`` form of leaves over 2**30 bytes
(the writer has no leaf near that size to chunk). The port carries its
own reader and writer for that subset of msgpack (maps, arrays, strings,
bin, ints, floats, bools, nil, ext), since neither ``msgpack`` nor
``flax`` is installed where the port runs.

The optimizer state: a ``train.trainer.TrainState`` is saved with
``opt_state``, torch Adam's state as optax's ``multi_transform`` state
(``tcsfm/train/trainer.py:52-70``) in the form
``flax.serialization.to_state_dict`` gives it: ``{"inner_states":
{label: {"inner_state": chain}}}`` for the labels ``depth`` and ``pose``.
The chain of a trained net is ``{"0": {"count", "mu", "nu"}, "1":
{"count"}}`` (Adam, then the schedule), with ``"1": {}`` (the weight decay)
and the schedule as ``"2"`` when ``cfg.wd > 0``; a frozen net's is ``{}``.
Each label's ``mu`` and ``nu`` hold the whole params tree with the other
label's subtree as ``{}`` (optax's ``MaskedNode``), mapped from torch's
``exp_avg`` and ``exp_avg_sq`` by ``models.convert``'s map of the
parameters; the counts are int32 scalars: Adam's is torch's per-parameter
``step``, the schedule's is ``TrainState.step``, which sets the port's
halving schedule. ``load_checkpoint(load_best=False)`` resumes all of it
(and ``step``, ``epoch + 1`` and ``best_val_loss``) from a file that either
package wrote. A tuple of networks is saved without ``opt_state``: such a
file loads with ``load_best=True`` only.
"""

from __future__ import annotations

import os
import shutil
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tcsfm_torch.config import Config
from tcsfm_torch.models.convert import (depth_state_dict, depth_to_flax,
                                        from_flax, pose_state_dict,
                                        pose_to_flax, to_flax)
from tcsfm_torch.models.depth import DepthNet
from tcsfm_torch.models.pose import PoseNet

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------------
# msgpack: the subset flax.serialization writes
# --------------------------------------------------------------------------


def _pack_len(out: list, n: int, fix: Optional[Tuple[int, int]],
              codes: Tuple[int, int, int]) -> None:
    """A length header: the fix form (base, limit) when it fits, else the
    8/16/32-bit form (``codes``; 0 where the form does not exist)."""
    if fix is not None and n < fix[1]:
        out.append(bytes([fix[0] | n]))
    elif codes[0] and n < 2 ** 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 2 ** 16:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 2 ** 32:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack object of {n} entries or bytes")


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 128 or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">BB", 2 ** 8), (0xCD, ">BH", 2 ** 16),
                               (0xCE, ">BI", 2 ** 32), (0xCF, ">BQ", 2 ** 64)):
            if v < lim:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(f"{v} does not fit msgpack's uint64")
    else:
        for code, fmt, lim in ((0xD0, ">Bb", 2 ** 7), (0xD1, ">Bh", 2 ** 15),
                               (0xD2, ">Bi", 2 ** 31), (0xD3, ">Bq", 2 ** 63)):
            if v >= -lim:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(f"{v} does not fit msgpack's int64")


def _pack_ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack(">Bb", fixed[n], code))
    else:
        _pack_len(out, n, None, (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", code))
    out.append(data)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: packed (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"cannot serialize an array of dtype {arr.dtype}")
    out: list = []
    _pack(out, (list(arr.shape), arr.dtype.name, arr.tobytes("C")))
    return b"".join(out)


def _pack(out: list, x: Any) -> None:
    """Appends the msgpack encoding of ``x`` to ``out``."""
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif type(x) is str:
        data = x.encode("utf-8")
        _pack_len(out, len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif type(x) in (bytes, bytearray, memoryview):
        data = bytes(x)
        _pack_len(out, len(data), None, (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif type(x) in (list, tuple):
        _pack_len(out, len(x), (0x90, 16), (0, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif type(x) is dict:
        _pack_len(out, len(x), (0x80, 16), (0, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif type(x) is complex:
        inner: list = []
        _pack(inner, (x.real, x.imag))
        _pack_ext(out, _EXT_COMPLEX, b"".join(inner))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def msgpack_serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts, lists,
    Python scalars, strings, numpy arrays and numpy scalars."""
    out: list = []
    _pack(out, tree)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw          # strings stay bytes (flax's inner arrays)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).read()
            return complex(re, im)
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return {self.read(): self.read() for _ in range(b & 0x0F)}
        if b < 0xA0:
            return [self.read() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        scalar = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                  0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalar:
            return self.unpack(scalar[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H",
                   0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in lengths:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        n = self.unpack(lengths[b])
        if b <= 0xC6:
            return bytes(self.take(n))
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return self.str_(n)
        if b <= 0xDD:
            return [self.read() for _ in range(n)]
        return {self.read(): self.read() for _ in range(n)}


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: a C-order array from its packed
    (shape, dtype name, bytes)."""
    shape, name, buf = _Reader(data, raw=True).read()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported: the port's "
                         "parameters are float32")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunked_leaves(x: Any) -> Any:
    if isinstance(x, dict):
        if _CHUNKED in x:
            n = len(x["chunks"])
            shape = [x["shape"][str(i)] for i in range(len(x["shape"]))]
            return np.concatenate([x["chunks"][str(i)] for i in range(n)]
                                  ).reshape(shape)
        return {k: _unchunked_leaves(v) for k, v in x.items()}
    return x


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the tree ``data`` encodes."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunked_leaves(tree)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _nets_of(state) -> Tuple[DepthNet, PoseNet]:
    """The networks of a ``train.trainer.TrainState`` or of the tuple
    ``(depth_net, pose_net)``."""
    if isinstance(state, tuple):
        return state
    return state.depth_net, state.pose_net


LABELS = ("depth", "pose")


def _trained(state) -> Tuple[str, ...]:
    """The labels of the nets ``state``'s optimizer trains (a frozen net
    has no param group)."""
    if state.optimizer is None:
        return ()
    return tuple(g["name"] for g in state.optimizer.param_groups)


def _moment_tree(label: str, moments: Dict[str, torch.Tensor]) -> Dict:
    """One label's Adam moments (by parameter name) as optax's masked
    params tree: the label's net mapped as its parameters are, the other
    label's subtree empty."""
    tree = (depth_to_flax(moments)[0] if label == "depth"
            else pose_to_flax(moments))
    return {k: (tree if k == label else {}) for k in LABELS}


def opt_state_tree(state) -> Dict:
    """``state``'s torch Adam state as optax's ``multi_transform`` state
    tree (module docstring)."""
    trained = _trained(state)
    nets = dict(zip(LABELS, _nets_of(state)))
    inner = {}
    for label in LABELS:
        if label not in trained:
            inner[label] = {"inner_state": {}}
            continue
        adam = state.optimizer.state
        params = dict(nets[label].named_parameters())
        steps = {float(adam[p]["step"]) for p in params.values() if p in adam}
        if len(steps) > 1:
            raise ValueError(f"the {label} net's parameters have taken "
                             f"different numbers of Adam steps {steps}; "
                             f"optax keeps one count a label")
        count = np.asarray(int(steps.pop()) if steps else 0, np.int32)
        chain = {"0": {"count": count, **{
            key: _moment_tree(label, {
                n: adam[p][name] if p in adam else torch.zeros_like(p)
                for n, p in params.items()})
            for key, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}}}
        if state.cfg.wd:
            chain["1"] = {}
        chain[str(len(chain))] = {"count": np.asarray(state.step, np.int32)}
        inner[label] = {"inner_state": chain}
    return {"inner_states": inner}


def _load_opt_state(state, tree: Any, step: int) -> None:
    """Puts optax's ``multi_transform`` state ``tree`` into ``state``'s
    torch Adam; raises, before it changes anything, where its keys or
    shapes are not those of ``state``'s optimizer or a schedule's count is
    not ``step``."""
    _same_tree(opt_state_tree(state), tree, "opt_state")
    chains = {label: tree["inner_states"][label]["inner_state"]
              for label in _trained(state)}
    for label, chain in chains.items():
        schedule = int(chain[str(len(chain) - 1)]["count"])
        if schedule != step:
            raise ValueError(f"the {label} schedule's count {schedule} is "
                             f"not the checkpoint's step {step}: the port's "
                             f"schedule runs on the step")
    nets = dict(zip(LABELS, _nets_of(state)))
    for label, chain in chains.items():
        adam = chain["0"]
        mu, nu = (depth_state_dict(adam[k]["depth"], None)
                  if label == "depth" else pose_state_dict(adam[k]["pose"])
                  for k in ("mu", "nu"))
        count = torch.tensor(float(adam["count"]), dtype=torch.float32)
        for name, p in nets[label].named_parameters():
            state.optimizer.state[p] = {
                "step": count.clone(),
                "exp_avg": mu[name].to(p.device, p.dtype),
                "exp_avg_sq": nu[name].to(p.device, p.dtype)}


def save_checkpoint(ckpt_dir: str, state, epoch: int,
                    best_val_loss: float, cfg: Optional[Config] = None,
                    is_best: bool = False) -> str:
    """Write ``state`` (a ``train.trainer.TrainState``, or the tuple
    ``(depth_net, pose_net)``) as the JAX package's checkpoint:
    ``checkpoint.msgpack``, ``best_model/best_model.msgpack`` when
    ``is_best``, and ``config.json`` when ``cfg`` is given. A
    ``TrainState``'s optimizer state is written as ``opt_state`` (module
    docstring); a tuple's file has none, and the JAX package's
    ``load_checkpoint`` reads it with ``load_best=True`` only. Returns the
    checkpoint's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    depth_net, pose_net = _nets_of(state)
    params, batch_stats = to_flax(depth_net.state_dict(),
                                  pose_net.state_dict())
    payload = {
        "epoch": int(epoch),
        "best_val_loss": float(best_val_loss),
        "step": np.asarray(getattr(state, "step", 0), np.int32),
        "params": params,
        "batch_stats": batch_stats,
    }
    if not isinstance(state, tuple):
        payload["opt_state"] = opt_state_tree(state)
    path = os.path.join(ckpt_dir, "checkpoint.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack_serialize(payload))
    if cfg is not None:
        cfg.save(os.path.join(ckpt_dir, "config.json"))
    if is_best:
        best_dir = os.path.join(ckpt_dir, "best_model")
        os.makedirs(best_dir, exist_ok=True)
        shutil.copyfile(path, os.path.join(best_dir, "best_model.msgpack"))
    return path


def _same_tree(ours: Any, theirs: Any, path: str = "") -> None:
    """Raises where ``theirs`` has other keys or leaf shapes than ``ours``
    (Flax's ``from_state_dict`` refuses a tree with other keys)."""
    if isinstance(ours, dict):
        if not isinstance(theirs, dict) or set(ours) != set(theirs):
            got = sorted(theirs) if isinstance(theirs, dict) else type(theirs)
            raise ValueError(f"checkpoint tree at {path or '/'}: keys "
                             f"{got}, the networks have {sorted(ours)}")
        for k in ours:
            _same_tree(ours[k], theirs[k], f"{path}/{k}")
    elif np.shape(theirs) != ours.shape:
        raise ValueError(f"checkpoint leaf {path}: shape {np.shape(theirs)}, "
                         f"the networks have {ours.shape}")


def load_checkpoint(ckpt_dir: str, state, load_best: bool = False
                    ) -> Tuple[Any, int, float]:
    """Load a checkpoint (written by either package) into ``state``'s
    networks in place; returns (state, start_epoch, best_val_loss).

    ``load_best=True`` reads ``best_model/best_model.msgpack``, or the
    latest checkpoint where there is no best model, and returns epoch 1
    and a best_val_loss of 1e5, as the JAX package does; the optimizer
    state and the step stay as they are. ``load_best=False`` resumes
    ``checkpoint.msgpack`` into a ``train.trainer.TrainState``: the
    weights, the optimizer state and the step, and returns the saved epoch
    + 1 and best_val_loss; it raises where ``state`` is a tuple of
    networks or the file holds no ``opt_state``.
    """
    if load_best:
        path = os.path.join(ckpt_dir, "best_model", "best_model.msgpack")
        if not os.path.exists(path):
            fallback = os.path.join(ckpt_dir, "checkpoint.msgpack")
            if os.path.exists(fallback):
                print(f"no best_model in {ckpt_dir}; loading latest "
                      f"checkpoint instead")
                path = fallback
    else:
        if isinstance(state, tuple):
            raise ValueError("load_best=False resumes training: pass a "
                             "train.trainer.TrainState, not a tuple of "
                             "networks")
        path = os.path.join(ckpt_dir, "checkpoint.msgpack")
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())

    depth_net, pose_net = _nets_of(state)
    params, batch_stats = to_flax(depth_net.state_dict(),
                                  pose_net.state_dict())
    _same_tree(params, payload["params"], "params")
    _same_tree(batch_stats, payload["batch_stats"], "batch_stats")
    depth_sd, pose_sd = from_flax(payload["params"], payload["batch_stats"])
    if not load_best:
        if "opt_state" not in payload:
            raise ValueError(f"{path} holds no opt_state (a tuple of "
                             f"networks was saved): load it with "
                             f"load_best=True")
        step = int(payload["step"])
        _load_opt_state(state, payload["opt_state"], step)
        state.step = step
    depth_net.load_state_dict(depth_sd)
    pose_net.load_state_dict(pose_sd)
    if load_best:
        return state, 1, 1e5
    return state, int(payload["epoch"]) + 1, float(payload["best_val_loss"])
