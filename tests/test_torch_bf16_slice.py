"""The slice in bfloat16: the port's coupled forward and one training step
with ``compute_dtype="bfloat16"`` against the JAX package's, on CPU.

JAX's seeded ``create_train_state`` weights under trained-like
conditioning (``tests/test_torch_coupled.py``'s ``_condition``: a
variance-preserving decoder and a far-field disparity head) go to both
sides through ``from_flax``; the images are smooth (bilinear from a 9x13
grid). Each bound is a multiple of JAX's own gap between its bfloat16 and
its float32 run on the same inputs (``tests/test_torch_bf16.py`` says why a
network's bfloat16 runs in the two frameworks differ by about sqrt(2) x
that gap: independent roundings of the same size), measured beside it in
the printout:

* the coupled forward at 64x96, B=2, S=2, 4 iterations: the disparity and
  the pose chain at each iteration, relative L2 within 2 x gap (measured:
  disparity 1.19 x, chain 0.55-1.15 x);
* one training step at 96x160, B=2 (where the inverse term clears its
  10,000-pixel guard), ``remat_coupled`` on, at 2 solver iterations (one
  warp inside the solver, so its sampler and its remat are on the
  gradient's path), where bfloat16 resolves the step's gradient: at the
  config's 4 the solver iterates on bfloat16 poses and the gradient is
  noise (JAX's
  own bfloat16-vs-float32 1 - cos 0.126, the port's one-ulp spread 0.139,
  a gradient with the depth net's part zeroed reads 0.158 against JAX's;
  the Adam update 0.92 from JAX's float32 one where no update reads 1.0);
  at 2, 1 - cos 0.016. Its spread: the port's bfloat16 step again with
  the images one f32 ulp up and one down (one in ~65,000 bfloat16
  roundings of the networks' inputs flips). Each quantity within
  FRACTION x the larger of JAX's gap and that spread (parity / gap /
  spread):
  - each loss term, relative; ``mean_disp``/``std_disp`` in bfloat16 as
    JAX reports them: l_pose_consist 3.10e-3 / 1.64e-3 / 3.56e-3,
    l_reconstruct_forward 3.19e-4 / 5.71e-4 / 7.31e-4,
    l_reconstruct_inverse 7.79e-5 / 6.76e-4 / 3.76e-4, l_smooth
    3.98e-4 / 4.67e-4 / 1.64e-4, total 6.20e-4 / 3.35e-4 / 5.59e-4 (1.11
    x), mean_disp and std_disp equal;
  - the gradient's direction by network, 1 - cos(port, JAX) of each net's
    flattened gradient (float32 on both sides; f32 resolves it only to
    ~1e-2 relative, ``tests/test_torch_train.py``): depth 4.60e-2 /
    5.87e-2 / 4.66e-2, pose 1.25e-2 / 1.57e-2 / 1.27e-2. The pose net holds
    99.8% of the gradient's norm, so one direction for both would not see
    the depth net's part. Control: the net's gradient with every second
    leaf (by size) zeroed reads 0.33 (depth) and 0.32 (pose), past the
    limits of 0.118 and 0.031, and the test asserts it;
  - the Adam update, two ways. The optimizer: JAX's Adam on the port's
    own gradient gives the port's new parameters within 5e-5 of the lr
    beyond one f32 ulp of the parameter (``tests/test_torch_train.py``'s
    rule; measured 6.9e-6). The update against JAX's: a first Adam step is
    nearly lr x sign(gradient), so on the elements whose sign JAX's
    bfloat16 and float32 steps share (depth 86.6%, pose 95.2%) the share
    whose sign the port's differs in, within FRACTION x the port's own
    one-ulp spread of it (depth 7.11% against 8.71%, pose 2.53% against
    2.87%; no update reads 100%, every second leaf unchanged 62% and 58%,
    asserted);
* the step at the config's 4 iterations: its losses only, within
  FOUR_ITERATION_FRACTION = 5 x the larger of gap and spread (measured
  0.03-3.46 x; the forward reconstruction term 3.46 x: 3.52e-3 / 1.02e-3 /
  9.90e-4, and it moves 1.3e-3 between one CPU thread and four).
Planted faults (each in a copy of the port): the smoothness term left out
of the total fails the losses at both iteration counts (total 70.6 x and
7.5 x) and the depth net's direction (0.427); the pose net's gradients
zeroed fail its direction and its update; the depth net's lr doubled fails
the optimizer check (1.0 of the lr).
* the loss stack alone on the same bfloat16 disparities, both configs'
  depth terms: within 1e-5 (its test's docstring).
The gradients and Adam's moments are float32, as JAX's are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcsfm.config import Config as JaxConfig
from tcsfm.losses.photometric import compute_losses as jax_compute_losses
from tcsfm.models.depth import DepthNet as JaxDepthNet
from tcsfm.models.pose import PoseNet as JaxPoseNet
from tcsfm.solver.coupled import solve_disp as jax_solve_disp
from tcsfm.solver.coupled import solve_pose_iteratively as jax_spi
from tcsfm.train.trainer import TrainState as JaxTrainState
from tcsfm.train.trainer import create_train_state as jax_create_train_state
from tcsfm.train.trainer import forward_loss as jax_forward_loss
from tcsfm.train.trainer import make_optimizer as jax_make_optimizer
from tcsfm.utils.helpers import disp_to_depth as jax_disp_to_depth
from tcsfm_torch import infer
from tcsfm_torch.config import Config
from tcsfm_torch.losses.photometric import compute_losses
from tcsfm_torch.models.convert import from_flax
from tcsfm_torch.train import trainer
from test_torch_bf16 import check_parity, rel
from test_torch_coupled import _condition, _inputs
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import _batch, _tree

BF16 = torch.bfloat16
DTYPES = {"float32": torch.float32, "bfloat16": BF16}
FRACTION = 2.0
FOUR_ITERATION_FRACTION = 5.0
ADAM_TOL = 5e-5
ITERS = 4
STEP_ITERS = 2


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(compute_dtype="float32", img_resolution="low",
                     use_mxu_warp=False, iterations=ITERS)
    state, _, _ = jax_create_train_state(jcfg, jax.random.PRNGKey(0),
                                         steps_per_epoch=10)
    params, stats = _tree(state.params), _tree(state.batch_stats)
    params["depth"] = _condition(params["depth"])
    return params, stats


def _jax_slice(dtype, cfg):
    """JAX's forward as a jitted function of (params, stats, tgt, src, K):
    the disparity and the pose chain. The weights are arguments, not
    constants, which XLA would spend minutes folding."""
    depth_model = JaxDepthNet(dtype=dtype)
    pose_model = JaxPoseNet(dtype=dtype)

    def run(params, stats, tgt, src, K):
        disps = jax_solve_disp(lambda x: depth_model.apply(
            {"params": params["depth"], "batch_stats": stats}, x), tgt, src)
        depths = jnp.stack([
            jax_disp_to_depth(d[0], cfg.min_depth, cfg.max_depth)[1]
            for d in disps])
        _, _, out = jax_spi(ITERS, depths, lambda x: pose_model.apply(
            {"params": params["pose"]}, x), tgt, src, K, return_errors=True)
        return disps[0][0], jnp.concatenate([out["fwd"].poses,
                                             out["inv"].poses])

    return jax.jit(run)


def _port_nets(params, stats, compute_dtype):
    depth_net, pose_net = infer.build_models(
        Config(compute_dtype=compute_dtype), device="cpu")
    depth_sd, pose_sd = from_flax(params, stats)
    depth_net.load_state_dict(depth_sd)
    pose_net.load_state_dict(pose_sd)
    return depth_net, pose_net


def test_coupled_forward_matches_jax(weights):
    params, stats = weights
    cfg = Config(iterations=ITERS)
    tgt, src, K = _inputs(0)
    ref, out = {}, {}
    for name, jdtype in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        ref[name] = _jax_slice(jdtype, cfg)(params, stats, tgt, src, K)
        nets = _port_nets(params, stats, name)
        _, _, disp, chain = infer.coupled_forward(
            *nets, tgt, src, K, cfg.replace(compute_dtype=name), device="cpu")
        out[name] = (disp, chain)
    assert out["bfloat16"][0].dtype == BF16
    assert out["bfloat16"][1].dtype == torch.float32
    check_parity(ref["float32"][0], ref["bfloat16"][0], out["float32"][0],
                 out["bfloat16"][0], FRACTION, "disparity")
    for it in range(ITERS):
        check_parity(ref["float32"][1][:, it], ref["bfloat16"][1][:, it],
                     out["float32"][1][:, it], out["bfloat16"][1][:, it],
                     FRACTION, f"pose chain, iteration {it}")


def _jax_config(compute_dtype, iterations):
    return JaxConfig(compute_dtype=compute_dtype, img_resolution="low",
                     use_mxu_warp=False, iterations=iterations)


def _jax_train_state(params, stats, jcfg):
    tx = jax_make_optimizer(jcfg, 10)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=stats, opt_state=tx.init(params), tx=tx)


def _jax_step(params, stats, batch, compute_dtype, iterations):
    """JAX's losses, gradients and Adam-updated parameters after one step."""
    jcfg = _jax_config(compute_dtype, iterations)
    depth_model = JaxDepthNet(dtype=jnp.dtype(compute_dtype))
    pose_model = JaxPoseNet(dtype=jnp.dtype(compute_dtype))
    state = _jax_train_state(params, stats, jcfg)

    def loss_fn(p, stats, batch):
        losses, _, _ = jax_forward_loss(jcfg, depth_model, pose_model, p,
                                        stats, batch, train=True)
        return losses["total"], losses

    @jax.jit
    def step(state, batch):
        grads, losses = jax.grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, batch)
        return grads, losses, state.apply_gradients(grads=grads).params

    grads, losses, new = step(state, batch)
    return _tree(grads), losses, _tree(new)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in
                           jax.tree_util.tree_leaves(tree)])


def _port_step(params, stats, batch, compute_dtype, iterations):
    state = trainer.create_train_state(
        Config(compute_dtype=compute_dtype, iterations=iterations),
        device="cpu", steps_per_epoch=10)
    depth_sd, pose_sd = from_flax(params, stats)
    state.depth_net.load_state_dict(depth_sd)
    state.pose_net.load_state_dict(pose_sd)
    losses = trainer.train_step(state, batch)
    return state, losses


def _port_trees(state):
    """The port's gradients and parameters as Flax trees (``to_flax``)."""
    from tcsfm_torch.models.convert import to_flax

    def sd(net, grad):
        return {k: (p.grad if grad else p).detach() for k, p in
                net.named_parameters()}

    return [to_flax(sd(state.depth_net, g), sd(state.pose_net, g))[0]
            for g in (True, False)]


IMAGE_KEYS = ("target_img", "target_img_aug", "source_imgs",
              "source_imgs_aug")


def _one_ulp(batch, direction):
    """``batch`` with every image moved one f32 ulp toward ``direction``."""
    return {k: np.nextafter(v, np.float32(direction)).astype(np.float32)
            if k in IMAGE_KEYS else v for k, v in batch.items()}


def _step_runs(params, stats, iterations, port_f32):
    """JAX's step in each dtype from the same weights, the port's bf16
    step (and its f32 one if ``port_f32``), and the port's bf16 step again
    with the images one ulp up and one down (its own spread)."""
    batch = _batch(0, 96, 160)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    out = {}
    for name in DTYPES:
        grads, losses, new = _jax_step(params, stats, jbatch, name,
                                       iterations)
        out[name] = dict(grads=grads, losses=losses, new=new)
        if name == "bfloat16" or port_f32:
            state, port_losses = _port_step(params, stats, batch, name,
                                            iterations)
            port_grads, port_new = _port_trees(state)
            out[name].update(port_grads=port_grads, port_losses=port_losses,
                             port_new=port_new, state=state)
    out["moved"] = []
    for direction in (2.0, -1.0):
        state, losses = _port_step(params, stats, _one_ulp(batch, direction),
                                   "bfloat16", iterations)
        out["moved"].append(dict(zip(("port_grads", "port_new"),
                                     _port_trees(state)),
                                 port_losses=losses))
    return params, stats, out


@pytest.fixture(scope="module")
def steps(weights):
    return _step_runs(*weights, STEP_ITERS, port_f32=True)


def _held(parity, gap, spread, fraction, what):
    """parity within ``fraction`` x the larger of the gap and the
    spread; returns the limit."""
    limit = fraction * max(gap, spread)
    print(f"{what}: parity {parity:.3e}, gap {gap:.3e}, spread "
          f"{spread:.3e} ({parity / max(gap, spread):.3g} x the larger, "
          f"limit {limit:.3e})")
    assert parity <= limit, what
    return limit


def _check_losses(out, fraction):
    f32, bf16 = out["float32"], out["bfloat16"]
    assert set(bf16["port_losses"]) == set(bf16["losses"])
    assert float(bf16["losses"]["l_reconstruct_inverse"]) > 0
    for k in ("mean_disp", "std_disp"):
        assert bf16["losses"][k].dtype == jnp.bfloat16
        assert bf16["port_losses"][k].dtype == BF16
    for k in sorted(bf16["losses"]):
        ours = float(bf16["port_losses"][k])
        if k == "l_depth":          # off in the default config: 0 both ways
            assert ours == 0.0
            continue
        j16, j32 = float(bf16["losses"][k]), float(f32["losses"][k])
        spread = max(abs(float(m["port_losses"][k]) - ours) / abs(ours)
                     for m in out["moved"])
        _held(abs(ours - j16) / abs(j16), abs(j16 - j32) / abs(j32), spread,
              fraction, f"loss {k}")


def test_step_losses_match_jax(steps):
    _check_losses(steps[2], FRACTION)


def test_step_losses_match_jax_at_four_iterations(weights):
    """The step at the config's 4 iterations: its losses only (the
    docstring says why its gradient is held at 2)."""
    _check_losses(_step_runs(*weights, ITERS, port_f32=False)[2],
                  FOUR_ITERATION_FRACTION)


def test_step_state_stays_float32(steps):
    state = steps[2]["bfloat16"]["state"]
    for net in (state.depth_net, state.pose_net):
        for p in net.parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    for moments in state.optimizer.state.values():
        assert all(v.dtype == torch.float32 for v in moments.values()
                   if torch.is_tensor(v) and v.is_floating_point())


def _by_net(tree, net):
    """The flattened leaves of one network (``"depth"`` or ``"pose"``),
    and the slice of each leaf in that vector, largest leaf first."""
    leaves = [np.asarray(a, np.float64).ravel()
              for a in jax.tree_util.tree_leaves(tree[net])]
    ends = np.cumsum([0] + [a.size for a in leaves])
    spans = sorted((slice(ends[i], ends[i + 1]) for i in range(len(leaves))),
                   key=lambda sl: sl.start - sl.stop)
    return np.concatenate(leaves), spans


def _half_zeroed(v, spans):
    """``v`` with every second leaf, by size, zeroed: about half of the
    parameters lose their gradient or update."""
    v = v.copy()
    for sl in spans[::2]:
        v[sl] = 0.0
    return v


def _one_minus_cos(a, b) -> float:
    return 1.0 - float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("net", ["depth", "pose"])
def test_step_gradient_direction_matches_jax(steps, net):
    out = steps[2]
    jb, spans = _by_net(out["bfloat16"]["grads"], net)
    jf = _by_net(out["float32"]["grads"], net)[0]
    pb = _by_net(out["bfloat16"]["port_grads"], net)[0]
    spread = max(_one_minus_cos(_by_net(m["port_grads"], net)[0], pb)
                 for m in out["moved"])
    limit = _held(_one_minus_cos(pb, jb), _one_minus_cos(jb, jf), spread,
                  FRACTION, f"{net} net gradient, 1 - cos")
    control = _one_minus_cos(_half_zeroed(pb, spans), jb)
    print(f"{net} net gradient with half its leaves zeroed: 1 - cos "
          f"{control:.3e}")
    assert control > limit, "the limit does not see half a gradient lost"


def _sign_flips(update, ref, mask) -> float:
    return float(np.mean(np.sign(update[mask]) != np.sign(ref[mask])))


@pytest.mark.parametrize("net", ["depth", "pose"])
def test_step_adam_update_matches_jax(steps, net):
    params, stats, out = steps
    old = _by_net(params, net)[0]

    def update(tree):
        return _by_net(tree, net)[0] - old

    j16, j32 = update(out["bfloat16"]["new"]), update(out["float32"]["new"])
    port = update(out["bfloat16"]["port_new"])
    spans = _by_net(params, net)[1]
    # the optimizer: JAX's Adam on the port's own gradient gives the port's
    # new parameters within tests/test_torch_train.py's rule (from zero
    # parameters there; here the sum rounds too, so one f32 ulp of the
    # parameter on top)
    jcfg = _jax_config("bfloat16", STEP_ITERS)
    lr = jcfg.lr * (jcfg.pose_lr_mult if net == "pose" else 1.0)
    state = _jax_train_state(params, stats, jcfg)
    grads = jax.tree_util.tree_map(jnp.asarray,
                                   out["bfloat16"]["port_grads"])
    adam = _by_net(_tree(state.apply_gradients(grads=grads).params), net)[0]
    ulp = np.spacing(np.abs(adam).astype(np.float32)).astype(np.float64)
    adam_err = (np.abs(port + old - adam) - ulp).max() / lr
    print(f"{net} net: the port's new parameters vs JAX's Adam on the "
          f"port's gradient, beyond one f32 ulp of the parameter at most "
          f"{adam_err:.3e} of the lr (limit {ADAM_TOL})")
    assert adam_err <= ADAM_TOL
    # the update against JAX's, on the elements whose sign JAX's bf16 and
    # f32 steps share: the share of them whose sign the port's differs in
    agree = (np.sign(j16) == np.sign(j32)) & (j16 != 0)
    spread = max(_sign_flips(update(m["port_new"]), port, agree)
                 for m in out["moved"])
    limit = FRACTION * spread
    flips = _sign_flips(port, j16, agree)
    print(f"{net} net update, on the {agree.mean():.1%} of elements whose "
          f"sign JAX's bf16 and f32 steps share: signs differ on "
          f"{flips:.2%} (the port's one-ulp spread {spread:.2%}, limit "
          f"{limit:.2%}; JAX's bf16 vs f32 differ on "
          f"{_sign_flips(j16, j32, j16 != 0):.2%} of all); relative L2 "
          f"{rel(port[agree], j16[agree]):.3f} (no update reads 1.0)")
    assert flips <= limit
    control = _sign_flips(_half_zeroed(port, spans), j16, agree)
    print(f"{net} net update with half its leaves unchanged: signs differ "
          f"on {control:.2%}")
    assert limit < control < 1.0 and _sign_flips(0 * port, j16, agree) == 1


@pytest.mark.parametrize("terms", ["defaults", "depth terms on"])
def test_losses_on_bf16_disparities_match_jax(terms):
    """The loss stack alone on the same bfloat16 disparities (and f32
    poses): JAX's ``compute_losses`` and the port's at 96x160. The
    disparities enter both as the same bfloat16 numbers, and
    ``disp_to_depth`` rounds its constants to bfloat16 as JAX's weak
    typing does (``utils.helpers.weak``), so both compute the same depths
    and the terms agree as the float32 runs do: relative 1e-5 (measured at
    most 1.8e-6, the float32 runs 1.9e-6), where the bfloat16 run moves the
    smoothness term by 8.3e-4 from the float32 one (held above 10 x the
    bound). Without ``weak`` the inverse term sat 1.1e-4 from JAX's."""
    kw = {} if terms == "defaults" else dict(l_depth_consist=True,
                                             with_depth_mask=True)
    b, s, h, w = 2, 2, 96, 160
    batch = _batch(0, h, w)
    rng = np.random.RandomState(3)
    lo = torch.from_numpy(rng.rand((s + 1) * b, 1, 9, 13))
    disp = (0.05 + 0.1 * torch.nn.functional.interpolate(
        lo, size=(h, w), mode="bilinear", align_corners=True)).reshape(
            s + 1, b, 1, h, w).permute(0, 1, 3, 4, 2).float().numpy()
    poses = (rng.randn(s, b, 6) * 0.01).astype(np.float32)
    poses_inv = -poses + (rng.randn(s, b, 6) * 1e-3).astype(np.float32)
    args = [batch["source_imgs"], batch["target_img"], poses, poses_inv]
    ref, out = {}, {}
    for name, dtype in DTYPES.items():
        jcfg = JaxConfig(compute_dtype=name, use_mxu_warp=False, **kw)
        jd = [[jnp.asarray(disp[f]).astype(name)] for f in range(s + 1)]
        ref[name] = jax.jit(lambda *a, c=jcfg: jax_compute_losses(c, *a))(
            *args, jd, batch["intrinsics_aug"])
        out[name] = compute_losses(
            Config(compute_dtype=name, **kw),
            *map(torch.from_numpy, args),
            [[torch.from_numpy(disp[f]).to(dtype)] for f in range(s + 1)],
            torch.from_numpy(batch["intrinsics_aug"]))
    assert float(ref["bfloat16"]["l_reconstruct_inverse"]) > 0
    for k in ref["bfloat16"]:
        j, p = float(ref["bfloat16"][k]), float(out["bfloat16"][k])
        assert abs(p - j) <= 1e-5 * abs(j), (k, p, j)
    smooth = (float(ref["bfloat16"]["l_smooth"]),
              float(ref["float32"]["l_smooth"]))
    assert abs(smooth[0] - smooth[1]) > 10 * 1e-5 * smooth[1]
