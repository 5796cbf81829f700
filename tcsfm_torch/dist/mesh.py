"""Ranks, the data mesh and batch sharding on ``torch.distributed``
(counterpart of ``tcsfm/dist/mesh.py``).

The JAX package shards one global batch over a ``jax.sharding.Mesh`` and
lets XLA insert the reductions. Here each card is one process (a rank), as
``torchrun`` starts them: a rank holds its contiguous rows of the global
batch, the networks are replicated, and the code that must see the global
batch (BatchNorm's statistics, the losses' masked means, the gradients)
reduces across ranks explicitly. The collectives are NCCL on the card and
gloo on the CPU, library collectives as XLA's are.

Batch conventions (the JAX package's):
  * target-like arrays [B, ...] shard on axis 0;
  * source-major arrays [S, B, ...] shard on axis 1;
  * arrays with no batch axis, parameters and optimizer state are
    replicated.

``launch`` starts a group of ranks on one host with the ``spawn`` method
(the tests' gloo groups, ``dist.scaling``'s curve) and returns what each
rank's function returned.
"""

from __future__ import annotations

import os
import queue as queue_mod
import socket
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# keys whose batch dim is axis 1 (source-major packing)
_SOURCE_MAJOR = (
    "source_imgs", "source_imgs_aug", "gt_lie_alg", "gt_lie_alg_aug",
    "vo_lie_alg", "vo_lie_alg_aug", "dt",
)

_TIMEOUT = timedelta(minutes=10)


def _wants_cpu(device) -> bool:
    return device is not None and torch.device(device).type == "cpu"


def init_group(rank: int, world_size: int, address: str,
               device=None) -> None:
    """Join the process group at ``address`` (``host:port``) as ``rank`` of
    ``world_size``: NCCL on the card (``cuda:LOCAL_RANK``, the rank on one
    host), gloo only where ``device`` is the CPU. An NCCL failure raises;
    nothing falls back to gloo or to the CPU."""
    if _wants_cpu(device):
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for the NCCL "
                               "group; pass device='cpu' for a gloo group")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world_size, rank=rank,
                            timeout=_TIMEOUT)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> bool:
    """Join the launcher's process group when several processes are
    configured; a no-op otherwise.

    Configuration comes from the arguments or from ``torchrun``'s
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``; ``LOCAL_RANK`` picks the card). A single process
    (``num_processes`` None or 1) starts nothing and returns False, so
    every caller degrades to the one-card case. ``device='cpu'`` asks for
    a gloo group; otherwise it is NCCL on the card, and its failure
    raises. Returns True iff the process is in a group (this call or an
    earlier one started it).
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if (num_processes or 1) <= 1:
        return False
    if process_id is None:
        if not env.get("RANK"):
            raise ValueError("a group of several processes needs this "
                             "process's rank (process_id or RANK)")
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    init_group(process_id, num_processes, coordinator_address, device)
    return True


def process_info() -> Tuple[int, int]:
    """(rank, world_size) of this process; (0, 1) outside a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


@dataclass(frozen=True)
class Mesh:
    """The data axis: ``world_size`` ranks, this process's ``rank``, its
    ``device`` and the process ``group`` (None outside a group: then
    nothing is reduced; in a group the collectives run, at world size 1
    too, where they copy)."""

    world_size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks, in place, with no gradient."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The data mesh of the launcher's ranks. ``n_devices`` None takes the
    world size; any other count must equal it (the launcher fixes the
    number of processes). The rank's device is ``cuda:LOCAL_RANK``, or
    the CPU where ``device`` is the CPU or the group is gloo."""
    rank, world = process_info()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices needs {n_devices} ranks, and "
            f"this launch has {world}: start one process a card, e.g. "
            f"torchrun --nproc_per_node {n_devices}")
    group = dist.group.WORLD if dist.is_initialized() else None
    if _wants_cpu(device) or (group is not None
                              and dist.get_backend() == "gloo"):
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the port on the CPU")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return Mesh(world, rank, dev, group)


def batch_spec(key: str, ndim: int) -> Optional[int]:
    """The batch axis of ``key`` in an array of ``ndim`` dimensions: 1 for
    the source-major keys, else 0; None where the array has no such axis
    (replicated)."""
    axis = 1 if key in _SOURCE_MAJOR else 0
    return None if ndim <= axis else axis


def _put(v, device) -> torch.Tensor:
    t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v, order="C"))
    return t.to(device).contiguous()


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """This rank's contiguous rows of a global host batch, on its device:
    rows ``rank * B/world .. (rank + 1) * B/world`` of each key's batch
    axis; replicated entries whole."""
    out = {}
    for k, v in batch.items():
        axis = batch_spec(k, np.ndim(v))
        if axis is not None:
            n = v.shape[axis]
            if n % mesh.world_size:
                raise ValueError(f"{k}: a batch of {n} does not split over "
                                 f"{mesh.world_size} ranks")
            per = n // mesh.world_size
            idx = [slice(None)] * np.ndim(v)
            idx[axis] = slice(mesh.rank * per, (mesh.rank + 1) * per)
            v = v[tuple(idx)]
        out[k] = _put(v, mesh.device)
    return out


def shard_process_local_batch(mesh: Mesh, batch: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """This rank's rows as a process-sliced ``BatchLoader`` gave them
    (``process_index=rank``, ``process_count=world_size``), on its
    device. With one rank the rows are the global batch, as
    ``shard_batch`` gives them."""
    return {k: _put(v, mesh.device) for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, differentiable: the gradient of each rank's
    input is the sum over the ranks of the output's gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the mesh's ranks, with its gradient (BatchNorm's
    global statistics); ``x`` itself outside a group."""
    if mesh.group is None:
        return x
    return _AllReduceSum.apply(x, mesh.group)


# ---------------------------------------------------------------------------
# one host's group of spawned ranks
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A TCP port free on this host now (bound and released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host(x):
    """Tensors as numpy arrays, through lists, tuples and dicts: a result
    crosses the queue by plain pickling, not by shared memory, which the
    rank that made it would have to outlive."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def _rank_main(rank, world, port, device, fn, args, results):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        if _wants_cpu(device):
            torch.set_num_threads(1)
        init_group(rank, world, f"127.0.0.1:{port}", device)
        try:
            out = fn(*args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        results.put((rank, True, _host(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, world_size: int, args: Sequence = (),
           device=None, timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks of one host, in a
    group on a free local port (NCCL on cards ``0..world_size-1``, gloo
    one thread a rank where ``device`` is the CPU), and return each rank's
    result, by rank. ``fn`` must be importable (a module-level function)
    and its arguments and result picklable; tensors in the result come
    back as numpy arrays. A failed rank raises here with its traceback."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, port, device, fn, tuple(args),
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: Dict[int, Tuple[bool, Any]] = {}
    deadline = time.monotonic() + timeout
    try:
        grace = None
        while len(got) < world_size:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                # a rank that exited without reporting (killed, or failed
                # to start) never will: stop waiting for it, after a grace
                # for a result still in the pipe
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None}
                if dead:
                    grace = grace or time.monotonic() + 10.0
                    if time.monotonic() > grace:
                        raise RuntimeError(
                            f"ranks exited without a result (rank: exit "
                            f"code) {dead}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no result from ranks "
                                       f"{sorted(set(range(world_size)) - set(got))}"
                                       f" within {timeout} s") from None
                continue
            got[rank] = (ok, out)
            if not ok:
                break
    finally:
        for p in procs:
            p.join(timeout=30 if len(got) == world_size else 1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    failed = {r: out for r, (ok, out) in got.items() if not ok}
    if failed:
        raise RuntimeError("ranks failed:\n" + "\n".join(
            f"rank {r}:\n{tb}" for r, tb in sorted(failed.items())))
    return [got[r][1] for r in range(world_size)]
