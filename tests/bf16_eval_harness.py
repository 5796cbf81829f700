"""Shared pieces of the bfloat16 evaluation tests
(``test_torch_bf16_eval*.py``, ``test_torch_bf16_model_dirs.py``,
``test_torch_bf16_seqpft*.py``): one model
directory each package's CLIs read, and the port's runs with the images
one f32 ulp up and one down.

The weights are seeded port nets with trained-like conditioning
(``chip_smoke.condition_like_trained``: f32 does not resolve the coupled
path at the raw init, ROADMAP §3), saved by the port with a
``config.json`` that says ``"compute_dtype": "bfloat16"`` (iterations 2,
img_resolution low), and again with ``"float32"``: the same checkpoint.

The rule is ``tests/test_torch_bf16_slice.py``'s: a quantity of the
port's bfloat16 run lies within ``FRACTION`` x the larger of JAX's
bfloat16-vs-float32 gap and the port's one-ulp spread (its bfloat16 run
again with every image one f32 ulp up, and one down, as it reaches the
card: ``nudged``). The gap is read against the port's float32 run from the
float32 directory, which stands in for JAX's: each CLI's float32 run is
held to JAX's float32 run within 1e-5 to 1e-4 by its own test
(``test_torch_vo.py``, ``test_torch_depth_eval_cli.py``,
``test_torch_sequential_pft.py``), far below any gap here, and a JAX
float32 run of each would cost another XLA compile.
"""

from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import pytest
import torch

import chip_smoke
from tcsfm_torch.config import Config
from tcsfm_torch.eval import vo
from tcsfm_torch.infer import build_models
from tcsfm_torch.train.checkpoint import save_checkpoint
from tcsfm_torch.utils import helpers

FRACTION = 3.0
IMAGE_KEYS = ("target_img", "source_imgs")
DIRECTIONS = (2.0, -1.0)


def write_model_dirs(root, seed=3):
    """{"bfloat16": dir, "float32": dir}: one checkpoint, two configs."""
    depth_net, pose_net = build_models(
        Config(compute_dtype="float32"), device="cpu",
        generator=torch.Generator().manual_seed(seed))
    chip_smoke.condition_like_trained(depth_net, torch)
    dirs = {}
    for dtype in ("bfloat16", "float32"):
        d = os.path.join(str(root), dtype)
        cfg = Config(compute_dtype=dtype, iterations=2, img_resolution="low")
        save_checkpoint(d, (depth_net, pose_net), epoch=1, best_val_loss=1.0,
                        cfg=cfg, is_best=True)
        dirs[dtype] = d
    return dirs


@contextlib.contextmanager
def nudged(direction):
    """Every image the port's evaluation paths move to their device
    (``utils.helpers.to_device``) one f32 ulp toward ``direction``."""
    to_device = helpers.to_device

    def moved(batch, keys, device, dtype=torch.float32):
        out = to_device(batch, keys, device, dtype)
        for k in IMAGE_KEYS:
            if k in out:
                out[k] = torch.nextafter(out[k], torch.full_like(
                    out[k], direction))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(helpers, "to_device", moved)
        mp.setattr(vo, "to_device", moved)
        yield


@contextlib.contextmanager
def weights_as_arguments():
    """``jax.jit`` with what a jitted function closes over passed to the
    program as arguments: the JAX package's evaluation CLIs jit their
    forwards with the weights closed over, and XLA constant-folds a program
    with a model's weights in it (``evaluate_scannet``'s JAX run took 95 s
    cold on an x86 CPU, 25 s with the weights as arguments). The
    function is traced (``jax.make_jaxpr``) once a static-argument value
    and argument shape, and its jaxpr run jitted with its constants as
    arguments: the same operations on the same values. The folded program
    rounds what its folder evaluates otherwise: its bfloat16 Eigen metrics
    read 4e-5 (abs_rel, relative) from these, a tenth of their gap."""
    import jax

    jit = jax.jit

    def lifted(fun=None, *, static_argnames=(), **kw):
        if fun is None:
            return functools.partial(lifted, static_argnames=static_argnames,
                                     **kw)
        static = ((static_argnames,) if isinstance(static_argnames, str)
                  else tuple(static_argnames))
        cache = {}

        def call(*args, **kwargs):
            fixed = {k: v for k, v in kwargs.items() if k in static}
            free = {k: v for k, v in kwargs.items() if k not in static}
            flat, tree = jax.tree_util.tree_flatten((args, free))
            key = (tuple(sorted(fixed.items())), tree,
                   tuple((np.shape(a), str(np.result_type(a)))
                         for a in flat))
            if key not in cache:
                closed, shape = jax.make_jaxpr(
                    lambda a, f: fun(*a, **f, **fixed),
                    return_shape=True)(args, free)
                cache[key] = (closed.consts, jit(functools.partial(
                    jax.core.eval_jaxpr, closed.jaxpr)),
                    jax.tree_util.tree_structure(shape))
            consts, run, out = cache[key]
            return jax.tree_util.tree_unflatten(out, run(consts, *flat))

        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", lifted)
        yield


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def finite(a):
    a = np.asarray(a, np.float64).ravel()
    return a[np.isfinite(a)]


def held(parity, gap, spread, what, fraction=FRACTION):
    """The limit for ``parity``; asserts it and prints the reading."""
    limit = fraction * max(gap, spread)
    print(f"{what}: parity {parity:.3e}, gap {gap:.3e}, spread {spread:.3e}"
          f" ({parity / max(gap, spread):.3g} x the larger, limit "
          f"{limit:.3e})")
    assert parity <= limit, what
    return limit


def hold(port, jax_ref, port32, moved, what, fault=None,
         fraction=FRACTION):
    """Relative L2 of the port's bfloat16 ``port`` against JAX's bfloat16
    ``jax_ref`` within ``fraction`` x the larger of the gap (``jax_ref``
    against the port's float32 ``port32``) and the spread (``moved``, the
    one-ulp runs, against ``port``); a planted ``fault`` (a wrong value in
    the port's place) must fail the limit."""
    limit = held(rel(port, jax_ref), rel(jax_ref, port32),
                 max(rel(m, port) for m in moved), what, fraction)
    if fault is not None:
        got = rel(fault, jax_ref)
        print(f"  planted fault: {got:.3e}")
        assert got > limit, what
    return limit


def hold_metrics(ours, ref, f32, moved, what):
    """Each metric of a CLI's dict, relative, within ``FRACTION`` x the
    larger of its own gap and spread; a planted fault, the metric ten times
    its value (a unit off by a factor 10, mm for cm), fails each limit."""
    def apart(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)

    assert sorted(ours) == sorted(ref)
    for k in sorted(ref):
        r = float(ref[k])
        limit = held(apart(ours[k], r), apart(r, f32[k]),
                     max(apart(m[k], ours[k]) for m in moved), f"{what} {k}")
        assert apart(10 * float(ours[k]), r) > limit, f"{what} {k}"
