"""Functions that spawned gloo ranks run for the port's distribution tests
(``tcsfm_torch.dist.mesh.launch`` imports this module in each rank).

No JAX here: a rank imports only torch and the port, so it starts in a
few seconds. Each function returns numpy arrays and numbers, by rank.
"""

import copy
import hashlib
import sys

import torch

from tcsfm_torch.cli import train as cli
from tcsfm_torch.config import Config
from tcsfm_torch.dist.dryrun import dryrun_multichip
from tcsfm_torch.dist.mesh import make_mesh, shard_batch
from tcsfm_torch.dist.scaling import step_seconds
from tcsfm_torch.ops import grid_sample as gs
from tcsfm_torch.train import trainer

# step_seconds' arguments for the scaling rows: one image a rank at 32x64,
# one iteration, one timed step, two sources, gloo
SCALING_ARGS = (1, (32, 64), 1, 1, 2, "cpu")


def _load(net, state_dict):
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         state_dict.items()})


def named_grads(depth_net, pose_net):
    return {f"{n}.{k}": p.grad for n, m in (("depth", depth_net),
                                            ("pose", pose_net))
            for k, p in m.named_parameters()}


def digest(*nets) -> str:
    """sha256 of every parameter's and buffer's bytes."""
    h = hashlib.sha256()
    for net in nets:
        for k, v in net.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def step_rank(depth_sd, pose_sd, batch):
    """One rank of the 2-rank step: the f32 distributed training step from
    the given weights on this rank's rows of ``batch`` (the global one),
    then the float64 distributed gradient of ``forward_loss`` from the
    same weights (plain sampler), then ``dryrun_multichip(2)``, then this
    rank's part of the scaling curve's two-rank row. Rank 0
    returns the gradients and statistics; every rank its losses and a
    digest of its weights after Adam."""
    mesh = make_mesh(2, device="cpu")
    state = trainer.create_train_state(Config(), mesh=mesh,
                                       steps_per_epoch=10)
    _load(state.depth_net, depth_sd)
    _load(state.pose_net, pose_sd)
    depth64, pose64 = (copy.deepcopy(m).double()
                       for m in (state.depth_net, state.pose_net))
    local = shard_batch(mesh, batch)
    losses = trainer.train_step(state, local, mesh=mesh)
    out = {"losses": {k: float(v) for k, v in losses.items()},
           "rows": local["target_img"].shape[0],
           "digest": digest(state.depth_net, state.pose_net)}
    if mesh.rank == 0:
        out["grads"] = named_grads(state.depth_net, state.pose_net)
        out["stats"] = {k: v for k, v in state.depth_net.state_dict().items()
                        if "running" in k}

    batch64 = {k: v.double() for k, v in local.items()}
    losses64, _ = trainer.forward_loss(Config(), depth64, pose64, batch64,
                                       train=True,
                                       sampler=gs.grid_sample_plain,
                                       mesh=mesh)
    losses64["total"].backward()
    trainer.all_reduce_grads(mesh, depth64, pose64)
    out["total64"] = float(trainer.reported(losses64, mesh)["total"])
    if mesh.rank == 0:
        out["grads64"] = named_grads(depth64, pose64)
    out["dryrun"] = dryrun_multichip(2, device="cpu")
    out["scaling"] = step_seconds(*SCALING_ARGS)
    return out


def cli_rank(argv):
    """``cli.train.main(argv)`` on this rank, TensorBoard kept out (its
    import pulls TensorFlow): its step count and a digest of its weights
    at the end."""
    sys.modules["torch.utils.tensorboard"] = None
    loop = cli.main(argv)
    return {"step": loop.state.step,
            "digest": digest(loop.state.depth_net, loop.state.pose_net)}
