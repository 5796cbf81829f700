"""The port's data-parallel training step on two gloo ranks against the
JAX package's one-device step on the same global batch, on the CPU.

One launch of two ranks (``tcsfm_torch.dist.mesh.launch``, the workers in
``tests/torch_dist_ranks.py``) for the whole module. Weights: seeded JAX
``create_train_state`` params with trained-like conditioning
(``test_torch_coupled._condition``), converted by ``from_flax``; the
batch of ``tests/test_torch_train.py``: B=2 (one image a rank), S=2, 4
iterations.

The size is 96x160, not 64x128: the inverse term's groups must keep more
than the guard's 10,000 valid pixels over the global batch and fewer on
one rank. At 64x128 about 42% of a group's pixels are valid (6,932 of
16,384 for two images), so the global term is 0 there too and the trap
would not be tested; at 96x160 two images keep more than 10,000 and one
image, 15,360 pixels at most, about 6,500.

* Every reported loss term within 1e-5 of JAX's, on both ranks alike;
  ``l_reconstruct_inverse`` is not 0, while the port's one-rank loss on
  one rank's single image has it at 0 (the guard's trap is live).
* The 40 BatchNorm running statistics within 1e-5 of JAX's (global
  statistics: per-rank ones at one image a rank are far off).
* The f32 gradients within 5e-2 relative L2 of JAX's (the limit of
  ``tests/test_torch_train.py``: f32 resolves this gradient to ~1e-2);
  the float64 two-rank gradient within 1e-9 of the port's one-rank
  float64 gradient on the global batch.
* The weights after Adam bit-equal on the two ranks.
* ``dryrun_multichip(2)`` in the same launch: the window-sharded
  ``sequence_ba`` within 1e-6 of the unsharded call. The scaling curve of
  ``measure_scaling([1, 2])``, built by its ``scaling_rows`` from
  ``step_seconds`` on the same two ranks and in a one-rank gloo group of
  this process (no launch of its own): finite rows, efficiency 1 at the
  first.

JAX's step runs in this process while the ranks run, so the module pays
for the slower of the two.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_ranks
from tcsfm.train.trainer import create_train_state as jax_create_train_state
from tcsfm.config import Config as JaxConfig
from tcsfm_torch.config import Config
from tcsfm_torch.dist.mesh import free_port, init_group, launch
from tcsfm_torch.dist.scaling import scaling_rows, step_seconds
from tcsfm_torch.models.convert import (depth_state_dict, from_flax,
                                        grads_from_flax)
from tcsfm_torch.ops import grid_sample as gs
from tcsfm_torch.train import trainer
from test_torch_coupled import _condition
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import ZERO_GRAD, _batch, _jax_step, _tree

H, W = 96, 160
LOSS_TOL = 1e-5
STATS_TOL = 1e-5
GRAD_TOL_F32 = 5e-2
GRAD_TOL_F64 = 1e-9
BA_TOL = 1e-6


def _port_nets(depth_sd, pose_sd, dtype=torch.float32):
    state = trainer.create_train_state(Config(compute_dtype="float32"),
                                       device="cpu")
    state.depth_net.load_state_dict(
        {k: torch.from_numpy(v) for k, v in depth_sd.items()})
    state.pose_net.load_state_dict(
        {k: torch.from_numpy(v) for k, v in pose_sd.items()})
    return state.depth_net.to(dtype), state.pose_net.to(dtype)


def _one_rank_f64(depth_sd, pose_sd, batch):
    """The port's one-process float64 gradient of ``forward_loss`` (plain
    sampler) on the global batch: (total, gradients by name)."""
    depth_net, pose_net = _port_nets(depth_sd, pose_sd, torch.float64)
    batch = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    losses, _ = trainer.forward_loss(Config(compute_dtype="float32"),
                                     depth_net, pose_net, batch,
                                     train=True, sampler=gs.grid_sample_plain)
    losses["total"].backward()
    return losses["total"].item(), {
        k: g.numpy() for k, g in
        torch_dist_ranks.named_grads(depth_net, pose_net).items()}


def _one_image_losses(depth_sd, pose_sd, batch):
    """The port's one-process losses on the first image of ``batch``."""
    depth_net, pose_net = _port_nets(depth_sd, pose_sd)
    one = {k: torch.from_numpy(v[:, :1] if k.startswith("source") else v[:1])
           for k, v in batch.items()}
    losses, _ = trainer.forward_loss(Config(compute_dtype="float32"),
                                     depth_net, pose_net, one,
                                     train=True)
    return {k: v.item() for k, v in losses.items()}


def _one_rank_scaling_part():
    """``step_seconds`` in a one-rank gloo group of this process: the
    scaling curve's first row, as ``measure_scaling``'s one-rank launch
    gives it."""
    init_group(0, 1, f"127.0.0.1:{free_port()}", "cpu")
    try:
        return step_seconds(*torch_dist_ranks.SCALING_ARGS)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def run():
    """JAX's step on the global batch and the scaling curve's one-rank part
    in this process while the two ranks run beside it: every result the
    module's tests read."""
    jcfg = JaxConfig(compute_dtype="float32", img_resolution="low",
                     use_mxu_warp=False)
    state, depth_model, pose_model = jax_create_train_state(
        jcfg, jax.random.PRNGKey(0), steps_per_epoch=10)
    params, stats = _tree(state.params), _tree(state.batch_stats)
    params["depth"] = _condition(params["depth"])
    batch = _batch(0, H, W)
    depth_sd, pose_sd = ({k: v.numpy() for k, v in sd.items()}
                         for sd in from_flax(params, stats))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, torch_dist_ranks.step_rank, 2,
                            (depth_sd, pose_sd, batch), device="cpu")
        grads, (losses, new_stats) = _jax_step(jcfg, depth_model,
                                               pose_model)(
            params, stats, jax.tree_util.tree_map(jax.numpy.asarray, batch))
        flat = grads_from_flax(_tree(grads))
        out = dict(
            params=params, stats=stats, new_stats=_tree(new_stats),
            grads={f"{net}.{k}": v.numpy() for net, g in flat.items()
                   for k, v in g.items()},
            losses={k: float(v) for k, v in losses.items()},
            one_rank_f64=_one_rank_f64(depth_sd, pose_sd, batch),
            one_image=_one_image_losses(depth_sd, pose_sd, batch))
        one = [_one_rank_scaling_part()]
        out["ranks"] = ranks.result()
        out["scaling"] = scaling_rows(
            {1: one, 2: [r["scaling"] for r in out["ranks"]]},
            torch_dist_ranks.SCALING_ARGS[0])
    return out


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_two_ranks_take_one_image_each(run):
    assert [r["rows"] for r in run["ranks"]] == [1, 1]


def test_losses_are_the_global_batch_s(run):
    ranks = run["ranks"]
    for r in ranks:
        assert set(r["losses"]) == set(run["losses"])
        for k, v in run["losses"].items():
            assert abs(r["losses"][k] - v) <= LOSS_TOL, (k, r["losses"][k], v)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["losses"]["l_reconstruct_inverse"] > 0
    assert run["losses"]["l_reconstruct_inverse"] > 0


def test_one_image_alone_trips_the_guard(run):
    """One rank's image through the port's one-process loss: its inverse
    groups keep fewer than 10,000 valid pixels, so the term is 0; only the
    global count of the distributed step keeps it."""
    assert run["one_image"]["l_reconstruct_inverse"] == 0.0
    assert run["one_image"]["l_reconstruct_forward"] > 0


def test_batch_stats_are_the_global_batch_s(run):
    expect = depth_state_dict(run["params"]["depth"], run["new_stats"])
    old = depth_state_dict(run["params"]["depth"], run["stats"])
    stats = run["ranks"][0]["stats"]
    assert len(stats) == 40
    for k, v in stats.items():
        np.testing.assert_allclose(v, expect[k].numpy(), atol=STATS_TOL,
                                   rtol=STATS_TOL, err_msg=k)
        assert not np.array_equal(v, old[k].numpy()), k


def _check(grads, ref, limit):
    assert set(grads) == set(ref)
    largest = max(np.linalg.norm(g) for g in ref.values())
    for k, r in ref.items():
        g = grads[k]
        assert g.shape == r.shape, k
        if k == ".".join(ZERO_GRAD):
            # analytically zero (a one-channel-a-group GroupNorm follows)
            assert np.linalg.norm(g) <= 1e-6 * largest, k
        else:
            assert _rel_l2(g, r) <= limit, (k, _rel_l2(g, r))


def test_f32_grads_match_jax(run):
    _check(run["ranks"][0]["grads"], run["grads"], GRAD_TOL_F32)


def test_f64_grads_equal_the_one_rank_step(run):
    """The float64 gradient of ``forward_loss`` (plain sampler) summed over
    the two ranks against the port's one-process gradient on the global
    batch."""
    total, grads = run["one_rank_f64"]
    assert abs(run["ranks"][0]["total64"] - total) <= 1e-12
    _check(run["ranks"][0]["grads64"], grads, GRAD_TOL_F64)


def test_weights_after_adam_are_equal_on_both_ranks(run):
    assert run["ranks"][0]["digest"] == run["ranks"][1]["digest"]


def test_dryrun_multichip_two_ranks(run):
    dry = [r["dryrun"] for r in run["ranks"]]
    assert [d["rank"] for d in dry] == [0, 1]
    assert all(d["processes"] == 2 and d["ba_windows"] == 4 for d in dry)
    assert dry[0]["loss"] == dry[1]["loss"] and np.isfinite(dry[0]["loss"])
    assert max(d["ba_err"] for d in dry) <= BA_TOL


def test_measure_scaling_one_and_two_ranks(run):
    rows = run["scaling"]
    assert [(r["n_devices"], r["global_batch"]) for r in rows] == [(1, 1),
                                                                   (2, 2)]
    assert rows[0]["efficiency"] == 1.0
    for r in rows:
        assert all(np.isfinite(v) and v > 0 for v in r.values())
