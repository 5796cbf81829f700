"""The port's distribution layer (``tcsfm_torch.dist.mesh``) and the config
fields it reads, on the CPU without spawning a rank.

* ``initialize_distributed`` starts nothing for one process; ``make_mesh``
  raises where the count is not the launch's world size.
* ``shard_batch``: the rows of ranks 0 and 1 concatenate to the global
  batch, on axis 0 and on axis 1 for the source-major keys; a
  process-sliced ``BatchLoader`` gives each rank the same rows.
* In a one-rank gloo group in this process: BatchNorm's two-pass global
  statistics (``_global_forward``, through the differentiable all-reduce)
  against the one-card path, and the distributed training step at world
  size 1 bit-equal to the plain step.
* ``Config.replace``/``PFTOptions.replace`` as JAX's; a JAX config file
  loads with ``mesh_shape``/``mesh_axes`` read.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from tcsfm.config import Config as JaxConfig
from tcsfm.config import PFTOptions as JaxPFTOptions
from tcsfm_torch.config import Config, PFTOptions, json_notes
from tcsfm_torch.data.loader import BatchLoader
from tcsfm_torch.dist import mesh as dm
from tcsfm_torch.models.layers import BatchNorm2d
from tcsfm_torch.train import trainer
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_initialize_distributed_is_a_no_op_alone(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert dm.initialize_distributed(device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert dm.initialize_distributed(device="cpu") is False
    assert dm.initialize_distributed(num_processes=1, device="cpu") is False
    assert not dist.is_initialized()
    assert dm.process_info() == (0, 1)
    mesh = dm.make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.device, mesh.group) == (
        1, 0, torch.device("cpu"), None)


def test_make_mesh_raises_on_a_world_size_mismatch():
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        dm.make_mesh(2, device="cpu")


def _global_batch(b=4, s=2, seed=0):
    rng = np.random.RandomState(seed)
    return {"target_img": rng.rand(b, 3, 5, 3).astype(np.float32),
            "source_imgs": rng.rand(s, b, 3, 5, 3).astype(np.float32),
            "intrinsics_aug": rng.rand(b, 3, 3).astype(np.float32),
            "dt": rng.rand(s, b).astype(np.float32),
            "scale": np.float32(2.0)}


def _mesh(rank, world=2):
    return dm.Mesh(world, rank, torch.device("cpu"))


def test_batch_spec():
    assert dm.batch_spec("target_img", 4) == 0
    assert dm.batch_spec("source_imgs", 5) == 1
    assert dm.batch_spec("dt", 2) == 1
    assert dm.batch_spec("dt", 1) is None
    assert dm.batch_spec("scale", 0) is None


def test_shard_batch_rows_concatenate_to_the_global_batch():
    batch = _global_batch()
    parts = [dm.shard_batch(_mesh(r), batch) for r in (0, 1)]
    for k, v in batch.items():
        axis = dm.batch_spec(k, np.ndim(v))
        if axis is None:
            for p in parts:
                assert p[k].item() == v
            continue
        assert [p[k].shape[axis] for p in parts] == [v.shape[axis] // 2] * 2
        np.testing.assert_array_equal(
            np.concatenate([p[k].numpy() for p in parts], axis=axis), v)
    with pytest.raises(ValueError, match="does not split"):
        dm.shard_batch(_mesh(0, 3), batch)


class _Windows:
    """Eight windows of distinct values, in the loader's per-sample layout."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return {"target_img": np.full((3, 5, 3), i, np.float32),
                "source_imgs": np.full((2, 3, 5, 3), 10 + i, np.float32),
                "intrinsics_aug": np.full((3, 3), 20 + i, np.float32)}


def test_process_sliced_loader_gives_shard_batch_s_rows():
    kw = dict(shuffle=True, seed=3, prefetch=0, decode_threads=0)
    whole = list(BatchLoader(_Windows(), 4, **kw))
    local = [list(BatchLoader(_Windows(), 4, process_index=r,
                              process_count=2, **kw)) for r in (0, 1)]
    assert len(whole) == len(local[0]) == len(local[1]) == 2
    for i, batch in enumerate(whole):
        batch.pop("_valid")
        for r in (0, 1):
            rows = dm.shard_process_local_batch(_mesh(r), local[r][i])
            want = dm.shard_batch(_mesh(r), batch)
            for k in want:
                assert torch.equal(rows[k], want[k]), (i, r, k)


@pytest.fixture
def one_rank_group():
    """A gloo group of one rank in this process, destroyed after."""
    dm.init_group(0, 1, f"127.0.0.1:{dm.free_port()}", device="cpu")
    try:
        yield dm.make_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_batchnorm_global_statistics_two_pass(one_rank_group):
    """``_global_forward`` (the path of two or more ranks) in a one-rank
    group against the one-card path: output, running statistics and
    gradients, in float64."""
    torch.manual_seed(0)
    x = torch.randn(3, 4, 5, 6, dtype=torch.float64) * 2 + 1
    outs = []
    for path in ("one card", "global"):
        bn = BatchNorm2d(4).double().train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 2.0, 4))
            bn.bias.copy_(torch.linspace(-1.0, 1.0, 4))
        xi = x.clone().requires_grad_(True)
        y = (bn(xi) if path == "one card"
             else bn._global_forward(xi, one_rank_group))
        (y * torch.cos(y)).sum().backward()
        outs.append((y.detach(), xi.grad, bn.weight.grad, bn.bias.grad,
                     bn.running_mean.clone(), bn.running_var.clone()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    # Flax's rule: 0.9 old (mean 0, var 1) + 0.1 the biased batch values
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(outs[1][4], 0.1 * mean)
    torch.testing.assert_close(outs[1][5], 0.9 + 0.1 * var)


def test_world_size_one_step_is_the_plain_step(one_rank_group):
    """The distributed step in a one-rank group (its collectives run and
    copy) bit-equal to the step with no mesh: losses, gradients, weights
    and BatchNorm statistics."""
    batch = chip_smoke.train_batch(torch, 2, 2, 32, 64, seed=1, device="cpu")
    runs = []
    for mesh in (None, one_rank_group):
        state = trainer.create_train_state(
            Config(iterations=2), device="cpu",
            generator=torch.Generator().manual_seed(2))
        losses = trainer.train_step(state, batch, mesh=mesh)
        runs.append((losses, {f"{n}.{k}": v for n, m in (
            ("depth", state.depth_net), ("pose", state.pose_net))
            for k, v in m.state_dict().items()},
            {k: p.grad for k, p in state.depth_net.named_parameters()}))
    (l0, t0, g0), (l1, t1, g1) = runs
    assert list(l0) == list(l1)
    for a, b in ((l0, l1), (t0, t1), (g0, g1)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_config_replace_as_jax():
    changes = dict(iterations=2, lr=3e-5, minibatch=4, mesh_shape=(4,))
    port, jax_cfg = Config().replace(**changes), JaxConfig().replace(**changes)
    for f in dataclasses.fields(Config):
        assert getattr(port, f.name) == getattr(jax_cfg, f.name), f.name
    assert Config().iterations == 4        # a new object; the old unchanged
    opts = dict(epochs=3, lr=1e-3, l_smooth=True)
    port, jax_opts = PFTOptions().replace(**opts), JaxPFTOptions().replace(
        **opts)
    for f in dataclasses.fields(PFTOptions):
        assert getattr(port, f.name) == getattr(jax_opts, f.name), f.name
    with pytest.raises(TypeError):
        Config().replace(no_such_field=1)


def test_jax_config_file_mesh_fields_are_read():
    text = JaxConfig(mesh_shape=(8,), mesh_axes=("data",)).to_json()
    cfg = Config.from_json(text)
    assert (cfg.mesh_shape, cfg.mesh_axes) == ((8,), ("data",))
    notes = "\n".join(json_notes(text))
    assert "mesh_shape" not in notes and "mesh_axes" not in notes
    assert "use_mxu_warp" in notes
    assert json.loads(cfg.to_json())["mesh_shape"] == [8]
