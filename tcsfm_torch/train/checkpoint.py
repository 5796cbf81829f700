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

What is missing: the optimizer state. The JAX package also saves optax's
``opt_state`` and resumes from it with ``load_best=False``; the port does
not map torch Adam's state onto optax's ``multi_transform`` tree yet (that
comes with the training CLI), so ``save_checkpoint`` writes no
``opt_state`` and ``load_checkpoint(load_best=False)`` raises. What
``load_best=True`` reads, both packages read from either's files.
"""

from __future__ import annotations

import os
import shutil
import struct
from typing import Any, Optional, Tuple

import numpy as np

from tcsfm_torch.config import Config
from tcsfm_torch.models.convert import from_flax, to_flax
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


def save_checkpoint(ckpt_dir: str, state, epoch: int,
                    best_val_loss: float, cfg: Optional[Config] = None,
                    is_best: bool = False) -> str:
    """Write ``state``'s networks (a ``train.trainer.TrainState``, or the
    tuple ``(depth_net, pose_net)``) as the JAX package's checkpoint:
    ``checkpoint.msgpack``, ``best_model/best_model.msgpack`` when
    ``is_best``, and ``config.json`` when ``cfg`` is given. The optimizer
    state is not written (module docstring), so the JAX package's
    ``load_checkpoint`` reads these files with ``load_best=True`` only.
    Returns the checkpoint's path."""
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
    and a best_val_loss of 1e5, as the JAX package does. Resuming with
    ``load_best=False`` needs the optimizer state, which the port does not
    map yet: it raises ``NotImplementedError``.
    """
    if not load_best:
        raise NotImplementedError(
            "load_best=False resumes training with the optimizer state; "
            "mapping torch Adam's state onto optax's tree comes with the "
            "port's training CLI. Load the weights with load_best=True.")
    path = os.path.join(ckpt_dir, "best_model", "best_model.msgpack")
    if not os.path.exists(path):
        fallback = os.path.join(ckpt_dir, "checkpoint.msgpack")
        if os.path.exists(fallback):
            print(f"no best_model in {ckpt_dir}; loading latest "
                  f"checkpoint instead")
            path = fallback
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())

    depth_net, pose_net = _nets_of(state)
    params, batch_stats = to_flax(depth_net.state_dict(),
                                  pose_net.state_dict())
    _same_tree(params, payload["params"], "params")
    _same_tree(batch_stats, payload["batch_stats"], "batch_stats")
    depth_sd, pose_sd = from_flax(payload["params"], payload["batch_stats"])
    depth_net.load_state_dict(depth_sd)
    pose_net.load_state_dict(pose_sd)
    return state, 1, 1e5
