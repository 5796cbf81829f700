"""Shared runs for the bfloat16 PFT tests (``test_torch_bf16_pft*.py``):
one window through the JAX package's ``PFTOptimizer`` and through the
port's, with the loss's inputs at every forward and the first step's
gradients and update recorded.

The setting: 64x96 (the pose net trains in 'pose' mode, and torch's CPU
bfloat16 conv backward returns NaN weight gradients at 1x1 inputs,
ROADMAP §3), B=2, S=2, 2 coupled iterations, seeded port weights with
trained-like conditioning (``chip_smoke.condition_like_trained``: f32
does not resolve the coupled path at the raw init) converted by
``to_flax``, smooth images (``chip_smoke.smooth_inputs``).

JAX runs ``jax.jit(optimize_window)``, as ``optimize_window_jit`` does,
with the module's ``optax`` and ``compute_optimization_loss`` replaced by
recording wrappers (``jax.debug.callback``): at each ``tx.update`` the
gradient, the parameters and what ``apply_updates`` makes of them, and
the loss's inputs at every forward. One JAX program costs ~15 s of
tracing and 20-30 s of XLA compile on this CPU, so the tests make three:
the 'encoder', 'depth_pred' and 'bottleneck' windows. The 'encoder'
program is joint (``joint``): the decoder's and the pose net's weights
are trainable too, and get a zero update, so the window is 'encoder''s
(its losses and poses equal the bare program's bit for bit) while its
first step holds the first gradient and Adam update of every weight group:
those of 'all_depth', 'decoder' and 'pose' (``first_step_runs``). The
port's own first step in each of those modes is held against them.

What a test compares (``mode_runs``): JAX's bfloat16 run (``jax``), the
port's bfloat16 run (``port``), the port's float32 run (``port32``), and
the port's bfloat16 run with the images one f32 ulp up and one down
(``moved``, its one-ulp spread). JAX's bfloat16-vs-float32 ``gap`` is read
against the port's float32 run, which stands in for JAX's (a JAX float32
window would cost another program): before any update the two packages'
float32 runs agree to within a tenth of every gap read here
(``test_torch_pft_jax.py`` holds their float32 windows in float64 within
5e-5); after an update float32 PFT does not reproduce itself, and the gap
read against the port's float32 window holds that part too.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from tcsfm.config import Config as JaxConfig
from tcsfm.config import PFTOptions as JaxPFTOptions
from tcsfm.models.depth import DepthNet as JaxDepthNet
from tcsfm.models.pose import PoseNet as JaxPoseNet
from tcsfm.solver import pft as jax_pft
from tcsfm_torch.config import Config, PFTOptions
from tcsfm_torch.infer import build_models
from tcsfm_torch.models.convert import (depth_to_flax, from_flax,
                                         pose_to_flax, to_flax)
from tcsfm_torch.ops.grid_sample import grid_sample_plain
from tcsfm_torch.solver import pft

H, W, B, S, ITERS = 64, 96, 2, 2, 2
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FIELDS = ("losses", "poses_opt", "poses_inv_opt", "disp_opt", "scale_init",
          "scale_opt", "poses_init", "poses_inv_init")
OUT_FIELDS = ("diff_img", "valid_mask", "weight_mask", "poses",
              "auto_mask_error", "auto_mask")


def weights(seed=3):
    """Seeded port nets, conditioned, as Flax trees (params, batch_stats)
    with float32 numpy leaves."""
    depth_net, pose_net = build_models(
        Config(compute_dtype="float32", num_scales=1), device="cpu",
        generator=torch.Generator().manual_seed(seed))
    chip_smoke.condition_like_trained(depth_net, torch)
    return to_flax(depth_net.state_dict(), pose_net.state_dict())


def window(seed=0):
    tgt, src, K = chip_smoke.smooth_inputs(torch, B, S, H, W, seed)
    return {"target_img": tgt, "source_imgs": src, "intrinsics": K}


def one_ulp(batch, direction):
    """``batch`` with every image moved one f32 ulp toward ``direction``."""
    return {k: np.nextafter(v, np.float32(direction)).astype(np.float32)
            if k != "intrinsics" else v for k, v in batch.items()}


def _np(tree):
    """A tree of arrays (bfloat16 too) as float64 numpy."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


class Record:
    """What one run's wrappers saw: per forward, the loss's inputs; per
    update, the gradient and the parameters before it; per
    ``apply_updates``, the parameters after it. Trees of float64 numpy,
    keyed as JAX's trainable tree (``{"enc": ...}``, ``{"disp": ...}``)."""

    def __init__(self):
        self.loss_inputs, self.grads, self.params, self.applied = [], [], [], []
        self.dtypes = {}


def _jax_optax(rec: Record, frozen=()):
    """``optax`` with an ``adam`` that records, at each update, the
    gradient, the parameters and the parameters its update gives
    (``apply_updates``); the groups named in ``frozen`` get a zero update
    (their gradient and the update they would take are recorded)."""

    def adam(lr):
        inner = optax.adam(lr)

        def update(grads, state, params=None):
            rec.dtypes["grad"] = {str(a.dtype) for a in
                                  jax.tree_util.tree_leaves(grads)}
            rec.dtypes["moments"] = {str(a.dtype) for a in
                                     jax.tree_util.tree_leaves(state)}
            updates, state = inner.update(grads, state, params)
            jax.debug.callback(
                lambda g, p, a: (rec.grads.append(_np(g)),
                                 rec.params.append(_np(p)),
                                 rec.applied.append(_np(a))),
                grads, params, optax.apply_updates(params, updates),
                ordered=True)
            return {k: jax.tree_util.tree_map(jnp.zeros_like, v)
                    if k in frozen else v
                    for k, v in updates.items()}, state

        return optax.GradientTransformation(inner.init, update)

    shim = types.SimpleNamespace(**{k: getattr(optax, k) for k in dir(optax)
                                    if not k.startswith("__")})
    shim.adam = adam
    return shim


def _jax_joint_partition():
    """JAX's ``partition_params`` for 'encoder' mode with the decoder's and
    the pose net's weights trainable too (``{"enc", "dec", "pose"}``), so
    that one program gives every weight mode's first gradient."""

    def partition(mode, depth_params, pose_params, skips=None,
                  disparities=None):
        assert mode == "encoder", mode
        trainable = {"enc": depth_params["encoder"],
                     "dec": {k: v for k, v in depth_params.items()
                             if k != "encoder"},
                     "pose": pose_params}

        def rebuild(t):
            return (dict(t["dec"], encoder=t["enc"]), t["pose"], skips,
                    disparities)

        return trainable, rebuild

    return partition


def _loss_recorder(rec: Record, original, to_numpy):
    def recording(opts, target_img, target_disparity, init_target_disparity,
                  fwd, inv):
        rec.dtypes["disparity"] = str(target_disparity.dtype)
        rec.dtypes["diff_img"] = str(fwd.diff_img.dtype)
        record = (target_disparity, init_target_disparity,
                  {k: getattr(fwd, k) for k in OUT_FIELDS},
                  {k: getattr(inv, k) for k in OUT_FIELDS})
        to_numpy(lambda r: rec.loss_inputs.append(r), record)
        return original(opts, target_img, target_disparity,
                        init_target_disparity, fwd, inv)

    return recording


def jax_window(mode, compute_dtype, batch, params, stats, epochs,
               avg_final_epochs, monkeypatch, joint=False):
    """JAX's ``PFTOptimizer(mode).optimize_window`` jitted, on one window;
    (result as float64 numpy by ``FIELDS``, Record). With ``joint`` (in
    'encoder' mode) the decoder's and the pose net's weights are trainable
    too but frozen (``JOINT``): the window is 'encoder''s, and the Record's
    first step holds every weight group's gradient and update."""
    rec = Record()
    monkeypatch.setattr(jax_pft, "optax", _jax_optax(
        rec, frozen=("dec", "pose") if joint else ()))
    if joint:
        monkeypatch.setattr(jax_pft, "partition_params",
                            _jax_joint_partition())
    monkeypatch.setattr(jax_pft, "compute_optimization_loss", _loss_recorder(
        rec, jax_pft.compute_optimization_loss,
        lambda f, r: jax.debug.callback(lambda x: f(_np(x)), r,
                                        ordered=True)))
    dtype = jnp.dtype(compute_dtype)
    jcfg = JaxConfig(compute_dtype=compute_dtype, iterations=ITERS,
                     num_scales=1, use_mxu_warp=False)
    opts = JaxPFTOptions(epochs=epochs, avg_final_epochs=avg_final_epochs,
                         num_source_imgs=S)
    opt = jax_pft.PFTOptimizer(jcfg, opts, JaxDepthNet(num_scales=1,
                                                       dtype=dtype),
                               JaxPoseNet(dtype=dtype), mode=mode)
    run = jax.jit(lambda b, dp, pp, bs: opt.optimize_window(b, dp, pp, bs))
    res = run(jax.tree_util.tree_map(jnp.asarray, batch), params["depth"],
              params["pose"], stats)
    jax.effects_barrier()
    monkeypatch.undo()
    return {k: np.asarray(getattr(res, k), np.float64) for k in FIELDS}, rec


def _port_tree(win, tensors):
    """``tensors`` (by ``partition_params``' names: trainable tensors or
    their gradients) as JAX's trainable tree: Flax names and layouts under
    ``enc``, ``dec`` and ``pose``, NHWC skips under ``s3`` and ``s4``."""
    t = {k: v.detach().double() for k, v in tensors.items()}
    out = {k: t[k].numpy() for k in ("disp",) if k in t}
    out.update({k: t[k].permute(0, 2, 3, 1).numpy() for k in ("s3", "s4")
                if k in t})
    pose = {k[len("pose."):]: v for k, v in t.items() if k.startswith("pose.")}
    if pose:
        out["pose"] = _np(pose_to_flax(pose))
    depth = {k[len("depth."):]: v for k, v in t.items()
             if k.startswith("depth.")}
    if depth:
        full = _np(depth_to_flax({k: depth.get(k, torch.zeros_like(v))
                                  for k, v in
                                  win.depth_net.named_parameters()})[0])
        if any(k.startswith("encoder.") for k in depth):
            out["enc"] = full["encoder"]
        if any(not k.startswith("encoder.") for k in depth):
            out["dec"] = {k: v for k, v in full.items() if k != "encoder"}
    return out


def _record_first_step(rec, opt, win, grads, make_optimizer):
    """The first step's gradient, parameters and the parameters the
    mode's optimizer (``make_optimizer``, ``PFTOptimizer._make_optimizer``,
    on copies) steps them to."""
    names = list(win.trainable)
    params = list(win.trainable.values())
    rec.dtypes["grad"] = {str(g.dtype) for g in grads}
    rec.grads.append(_port_tree(win, dict(zip(names, grads))))
    rec.params.append(_port_tree(win, win.trainable))
    copies = [p.detach().clone() for p in params]
    for c, g in zip(copies, grads):
        c.grad = g.detach()
    tx = make_optimizer(opt, copies)
    tx.step()
    rec.applied.append(_port_tree(win, dict(zip(names, copies))))
    rec.dtypes["moments"] = {
        str(v.dtype) for st in tx.state.values() for v in st.values()
        if torch.is_tensor(v) and v.is_floating_point()}


def _record_loss_inputs(rec, monkeypatch):
    monkeypatch.setattr(pft, "compute_optimization_loss", _loss_recorder(
        rec, pft.compute_optimization_loss,
        lambda f, r: f(jax.tree_util.tree_map(
            lambda t: t.detach().double().numpy(), r))))


def _port_optimizer(mode, compute_dtype, params, stats, epochs,
                    avg_final_epochs):
    depth_sd, pose_sd = from_flax(params, stats)
    depth_net, pose_net = build_models(
        Config(compute_dtype=compute_dtype, num_scales=1), device="cpu")
    depth_net.load_state_dict(depth_sd)
    pose_net.load_state_dict(pose_sd)
    assert depth_net.compute_dtype == DTYPES[compute_dtype]
    return pft.PFTOptimizer(
        Config(compute_dtype=compute_dtype, iterations=ITERS),
        PFTOptions(epochs=epochs, avg_final_epochs=avg_final_epochs,
                   num_source_imgs=S), depth_net, pose_net, mode=mode)


def _port_joint_partition(original):
    """``partition_params`` for 'encoder' mode with the decoder's and the
    pose net's weights trainable too (their gradients recorded), as
    ``_jax_joint_partition``; ``port_window`` steps the encoder alone."""

    def partition(mode, depth_net, pose_net, skips=None, disparities=None):
        assert mode == "encoder", mode
        trainable, skips, disparities = original(mode, depth_net, pose_net,
                                                 skips, disparities)
        extra = {f"depth.{k}": v for k, v in depth_net.named_parameters()
                 if not k.startswith("encoder.")}
        extra.update({f"pose.{k}": v for k, v in pose_net.named_parameters()})
        for v in extra.values():
            v.requires_grad_(True)
        return dict(trainable, **extra), skips, disparities

    return partition


def port_window(mode, compute_dtype, batch, params, stats, epochs,
                avg_final_epochs, monkeypatch, joint=False):
    """The port's ``PFTOptimizer(mode).optimize_window`` on the CPU with
    the plain sampler; (result as float64 numpy by ``FIELDS``, Record).
    With ``joint`` the decoder's and the pose net's weights are trainable
    but never stepped, as in ``jax_window``."""
    rec = Record()
    _record_loss_inputs(rec, monkeypatch)
    gradients = pft.PFTOptimizer._gradients
    make_optimizer = pft.PFTOptimizer._make_optimizer
    prepare = pft.PFTOptimizer._prepare

    def recording_prepare(self, batch, device):
        self._win = prepare(self, batch, device)
        return self._win

    def recording_gradients(self, loss, ps):
        grads = gradients(self, loss, ps)
        if not rec.grads:
            _record_first_step(rec, self, self._win, grads, make_optimizer)
        return grads

    def own_optimizer(self, ps):
        return make_optimizer(self, [p for k, p in self._win.trainable.items()
                                     if k.startswith("depth.encoder.")])

    monkeypatch.setattr(pft.PFTOptimizer, "_prepare", recording_prepare)
    monkeypatch.setattr(pft.PFTOptimizer, "_gradients", recording_gradients)
    if joint:
        monkeypatch.setattr(pft, "partition_params",
                            _port_joint_partition(pft.partition_params))
        monkeypatch.setattr(pft.PFTOptimizer, "_make_optimizer",
                            own_optimizer)
    opt = _port_optimizer(mode, compute_dtype, params, stats, epochs,
                          avg_final_epochs)
    res = opt.optimize_window(batch, device="cpu", sampler=grid_sample_plain)
    monkeypatch.undo()
    rec.dtypes["disp_opt"] = str(res.disp_opt.dtype)
    return {k: torch.as_tensor(getattr(res, k)).double().numpy()
            for k in FIELDS}, rec


def port_first_step(mode, batch, params, stats):
    """The port's bfloat16 ``PFTOptimizer(mode)``'s first step alone (its
    forward and gradients, and its optimizer's first update on copies):
    a Record."""
    rec = Record()
    opt = _port_optimizer(mode, "bfloat16", params, stats, 2, 1)
    with pytest.MonkeyPatch.context() as mp:
        _record_loss_inputs(rec, mp)
        win = opt._prepare(batch, torch.device("cpu"))
        loss, _ = opt._forward(win, grid_sample_plain)
        grads = opt._gradients(loss, list(win.trainable.values()))
    _record_first_step(rec, opt, win, grads,
                       pft.PFTOptimizer._make_optimizer)
    return rec


_OFF = dict(l_inverse_reconstruction=False, l_depth_consist=False,
            l_depth_init=False, l_smooth=False, l_pose_consist=False)
# each term as the loss with its switch on less the loss without it
TERMS = {"reconstruct_forward": (dict(_OFF), None),
         "reconstruct_inverse": (dict(_OFF, l_inverse_reconstruction=True),
                                 dict(_OFF)),
         "depth_consist": (dict(_OFF, l_inverse_reconstruction=True,
                                l_depth_consist=True),
                           dict(_OFF, l_inverse_reconstruction=True)),
         "depth_init": (dict(_OFF, l_depth_init=True), dict(_OFF)),
         "total": ({}, None)}


def loss_terms(loss_input):
    """The PFT loss's terms at one forward, from what
    ``compute_optimization_loss`` received (either package's), by the
    port's ``compute_optimization_loss`` in float64: {term: value}."""
    from tcsfm_torch.solver.coupled import CoupledOutputs

    disp, init, fwd, inv = jax.tree_util.tree_map(torch.from_numpy,
                                                  loss_input)
    outs = [CoupledOutputs(img_rec=None, **o) for o in (fwd, inv)]
    img = torch.zeros(disp.shape[:3] + (3,), dtype=torch.float64)

    def loss(kw):
        return float(pft.compute_optimization_loss(
            PFTOptions(num_source_imgs=S, **kw), img, disp, init, *outs))

    return {k: loss(on) - (loss(off) if off is not None else 0.0)
            for k, (on, off) in TERMS.items()}


def leaves_by_group(tree):
    """A trainable tree's leaves flattened by group: ``encoder`` and
    ``decoder`` (depth weights), ``pose``, ``disp``, ``s3``, ``s4``; and
    the span of each leaf in its group's vector, largest first."""
    groups = {}
    for key, sub in tree.items():
        if key in ("enc", "dec", "depth"):
            parts = ({"encoder": sub["encoder"],
                      "decoder": {k: v for k, v in sub.items()
                                  if k != "encoder"}} if key == "depth"
                     else {"encoder" if key == "enc" else "decoder": sub})
        else:
            parts = {key: sub}
        for name, part in parts.items():
            leaves = [np.ravel(a) for a in jax.tree_util.tree_leaves(part)]
            ends = np.cumsum([0] + [a.size for a in leaves])
            spans = sorted((slice(ends[i], ends[i + 1])
                            for i in range(len(leaves))),
                           key=lambda sl: sl.start - sl.stop)
            groups[name] = (np.concatenate(leaves), spans)
    return groups


def mode_runs(mode, epochs, avg_final_epochs, params, stats, batch,
              joint=False):
    """JAX's bfloat16 window and the port's bfloat16, float32 and one-ulp
    runs of it: {"jax", "port", "port32", "moved": [up, down]}, each a
    (result, Record) pair; ``joint`` as ``jax_window``'s."""

    def run(fn, dtype, b):
        with pytest.MonkeyPatch.context() as mp:
            return fn(mode, dtype, b, params, stats, epochs,
                      avg_final_epochs, mp, joint=joint)

    return {"jax": run(jax_window, "bfloat16", batch),
            "port": run(port_window, "bfloat16", batch),
            "port32": run(port_window, "float32", batch),
            "moved": [run(port_window, "bfloat16", one_ulp(batch, d))
                      for d in (2.0, -1.0)]}


# the weight groups a mode trains, as JAX's joint trainable tree's keys
GROUPS = {"all_depth": ("enc", "dec"), "decoder": ("dec",),
          "pose": ("pose",)}


def first_step_runs(joint_runs, mode, params, stats, batch):
    """``mode``'s first step (a mode that trains weights) as ``mode_runs``
    gives a window's: the port's own bfloat16 first step in that mode, and
    the joint 'encoder' runs' first steps cut to the mode's weight groups
    for JAX, the port's float32 run and the one-ulp runs. At the first step
    every mode's forward gives the same loss from the same weights (the
    skips 'decoder' decodes from are the encoder's output, the disparity
    'pose' holds fixed is the net's), so its gradient is the joint one's
    cut to its groups, and Adam's update is elementwise."""
    keys = GROUPS[mode]

    def cut(run):
        rec, view = run[1], Record()
        view.loss_inputs, view.dtypes = rec.loss_inputs[:1], rec.dtypes
        view.grads, view.params, view.applied = (
            [{k: t[k] for k in keys}] for t in (rec.grads[0], rec.params[0],
                                                 rec.applied[0]))
        return None, view

    return {"jax": cut(joint_runs["jax"]),
            "port": (None, port_first_step(mode, batch, params, stats)),
            "port32": cut(joint_runs["port32"]),
            "moved": [cut(m) for m in joint_runs["moved"]]}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def one_minus_cos(a, b) -> float:
    return 1.0 - float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def held(parity, gap, spread, fraction, what):
    """(limit, ok): ``parity`` within ``fraction`` x the larger of ``gap``
    and ``spread``; prints the reading."""
    limit = fraction * max(gap, spread)
    print(f"{what}: parity {parity:.3e}, gap {gap:.3e}, spread {spread:.3e}"
          f" ({parity / max(gap, spread):.3g} x the larger, limit "
          f"{limit:.3e})")
    return limit, parity <= limit


def first_step_terms(runs):
    """{term: (parity, gap, spread)} of the loss at the first forward,
    relative; terms that are 0 in JAX's run (depth_init before any update
    where the disparity is the initial one) are left out and must be 0 in
    the port's."""
    terms = {k: loss_terms(r[1].loss_inputs[0]) for k, r in
             (("jax", runs["jax"]), ("port", runs["port"]),
              ("port32", runs["port32"]))}
    moved = [loss_terms(m[1].loss_inputs[0]) for m in runs["moved"]]
    out = {}
    for k, j16 in terms["jax"].items():
        ours = terms["port"][k]
        if j16 == 0.0:
            assert ours == 0.0, k
            continue
        out[k] = (abs(ours - j16) / abs(j16),
                  abs(j16 - terms["port32"][k]) / abs(terms["port32"][k]),
                  max(abs(m[k] - ours) / abs(ours) for m in moved))
    return out


def first_step_gradients(runs):
    """{group: (gradients by run, spans)} at the first step; runs "jax",
    "port", "port32" and "moved" (a list)."""
    def groups(r):
        return leaves_by_group(r[1].grads[0])

    g = {k: groups(runs[k]) for k in ("jax", "port", "port32")}
    moved = [groups(m) for m in runs["moved"]]
    return {name: ({k: g[k][name][0] for k in g} | {
        "moved": [m[name][0] for m in moved]}, g["port"][name][1])
        for name in g["jax"]}


def first_updates(runs):
    """{group: (updates by run, spans)}: the first step's change of each
    trainable element."""
    def update(r):
        new, old = (leaves_by_group(t) for t in (r[1].applied[0],
                                                 r[1].params[0]))
        return {k: new[k][0] - old[k][0] for k in new}, \
            {k: v[1] for k, v in new.items()}

    u = {k: update(runs[k]) for k in ("jax", "port", "port32")}
    moved = [update(m)[0] for m in runs["moved"]]
    return {name: ({k: u[k][0][name] for k in u} | {
        "moved": [m[name] for m in moved]}, u["port"][1][name])
        for name in u["jax"][0]}


def half_zeroed(v, spans):
    """``v`` with every second leaf, by size, zeroed (every second element
    of a group of one leaf)."""
    v = v.copy()
    if len(spans) == 1:
        v[::2] = 0.0
    for sl in spans[::2] if len(spans) > 1 else ():
        v[sl] = 0.0
    return v


def sign_flips(update, ref, mask) -> float:
    return float(np.mean(np.sign(update[mask]) != np.sign(ref[mask])))


# the bounds, as multiples of the larger of JAX's bfloat16-vs-float32 gap
# and the port's one-ulp spread (the test files' docstrings give the
# readings)
TERM_FRACTION = 10.0
GRAD_FRACTION = 2.0
UPDATE_FRACTION = 2.0
WINDOW_FRACTION = 3.0
TERM_FAULT = 1.25        # a loss term's weight 25% off


def assert_first_step_losses(runs):
    for k, (par, gap, spread) in first_step_terms(runs).items():
        limit, ok = held(par, gap, spread, TERM_FRACTION, f"loss term {k}")
        assert ok, k
        # planted fault: the port's term with its weight 25% off
        assert abs((1 + par) * TERM_FAULT - 1) > limit or \
            abs((1 - par) * TERM_FAULT - 1) > limit, k


def assert_first_step_gradients(runs):
    for name, (g, spans) in first_step_gradients(runs).items():
        spread = max(one_minus_cos(m, g["port"]) for m in g["moved"])
        limit, ok = held(one_minus_cos(g["port"], g["jax"]),
                         one_minus_cos(g["jax"], g["port32"]), spread,
                         GRAD_FRACTION, f"{name} gradient, 1 - cos")
        assert ok, name
        control = one_minus_cos(half_zeroed(g["port"], spans), g["jax"])
        print(f"{name} gradient with half its leaves zeroed: 1 - cos "
              f"{control:.3e}")
        assert control > limit, name


def assert_first_updates(runs):
    """The first update's signs, on the elements whose sign JAX's bfloat16
    and the float32 run share, against the port's one-ulp spread; and on
    bfloat16 leaves, which updates round away (zero) where JAX's do."""
    for name, (u, spans) in first_updates(runs).items():
        agree = (np.sign(u["jax"]) == np.sign(u["port32"])) & (u["jax"] != 0)
        spread = max(sign_flips(m, u["port"], agree) for m in u["moved"])
        flips = sign_flips(u["port"], u["jax"], agree)
        limit = UPDATE_FRACTION * spread
        print(f"{name} update, on the {agree.mean():.1%} of elements whose "
              f"sign JAX's bf16 and the f32 run share: signs differ on "
              f"{flips:.2%} (spread {spread:.2%}, limit {limit:.2%})")
        assert flips <= limit, name
        control = sign_flips(half_zeroed(u["port"], spans), u["jax"], agree)
        print(f"{name} update with half its leaves unchanged: {control:.2%}")
        assert limit < control, name
        if not (u["port32"] != 0).all() or (u["jax"] != 0).all():
            continue
        # a bfloat16 leaf: an update rounds away where JAX's does
        zeros = float(np.mean((u["port"] == 0) != (u["jax"] == 0)))
        spread = max(float(np.mean((m == 0) != (u["port"] == 0)))
                     for m in u["moved"])
        limit = UPDATE_FRACTION * max(spread, 1.0 / u["jax"].size)
        print(f"{name}: {np.mean(u['jax'] == 0):.1%} of JAX's updates round "
              f"away; the port rounds away differently on {zeros:.3%} "
              f"(spread {spread:.3%}, limit {limit:.3%})")
        assert zeros <= limit, name
        # planted fault: no update rounds away
        kept = np.where(u["port"] == 0, -np.sign(u["port32"]), u["port"])
        assert float(np.mean((kept == 0) != (u["jax"] == 0))) > limit


def window_faults(res, rec):
    """Planted faults of a window's result (and its Record), by field: the
    losses without their depth-consistency term (a term left out of the
    total), the forward and inverse poses swapped, the raw sigmoid output
    in place of the scaled disparity (``disp_to_depth`` left out), the
    scale of a depth taken as metric already (x30)."""
    cfg = Config()
    lo, hi = 1.0 / cfg.max_depth, 1.0 / cfg.min_depth
    consist = np.array([loss_terms(x)["depth_consist"]
                        for x in rec.loss_inputs])
    return {"losses": res["losses"] - consist,
            "poses_opt": res["poses_inv_opt"],
            "poses_inv_opt": res["poses_opt"],
            "poses_init": res["poses_inv_init"],
            "poses_inv_init": res["poses_init"],
            "disp_opt": (res["disp_opt"] - lo) / (hi - lo),
            "scale_init": res["scale_init"] * 30.0,
            "scale_opt": res["scale_opt"] * 30.0}


def assert_window(runs, fraction=WINDOW_FRACTION):
    """Every field of the window's result within ``fraction`` x the
    larger of gap and spread, and each planted fault past its limit; all
    fields are read before any is asserted. The gap is read against the
    port's float32 window, which stands in for JAX's: after an update the
    two packages' float32 windows part by about as much as the gap
    (float32 PFT does not reproduce itself, PERF.md §7), so the gap read
    here holds that part too."""
    port, jax_res = runs["port"][0], runs["jax"][0]
    port32 = runs["port32"][0]
    faults = window_faults(port, runs["port"][1])
    failed = []
    for f in FIELDS:
        spread = max(rel(m[0][f], port[f]) for m in runs["moved"])
        limit, ok = held(rel(port[f], jax_res[f]), rel(jax_res[f], port32[f]),
                         spread, fraction, f"window {f}")
        failed += [] if ok else [f]
        if f in faults:
            fault = rel(faults[f], jax_res[f])
            print(f"  planted fault: {fault:.3e}")
            failed += [] if fault > limit else [f"{f} (planted fault)"]
    assert not failed, failed
