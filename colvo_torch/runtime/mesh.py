"""Data parallel over ``torch.distributed`` (port of ``colvo/runtime/mesh.py``).

The reference shards the batch over a 1-D device mesh and lets GSPMD
insert the collectives, so its loss is the loss of the global batch. The
port runs one process a rank (``torchrun``, or ``python -m
torch.distributed.run``), NCCL on the card and gloo on the CPU, and keeps
that contract by hand:

* every rank draws the global batch from the same seed, with the same
  augmentation, and keeps its own rows (``shard_batch``);
* the loss's batch-level reductions are global: :meth:`Mesh.sum` and
  :meth:`Mesh.mean` all-reduce a partial sum in the forward and pass the
  gradient through unchanged in the backward, so every rank computes the
  same total from global sums and counts, and its gradient is its own
  rows' contribution;
* the gradients are all-reduced with SUM before the global-norm clip
  (:meth:`Mesh.all_reduce_grads`), so the clip and Adam see the global
  gradient and the weights stay replicated;
* the initial weights are broadcast from rank 0 (``replicate_tree``).

At world size 1 the reductions are ``torch.sum`` and ``torch.mean`` and
the gradient all-reduce is the identity.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Mapping, Optional

import torch
import torch.distributed as dist

from colvo_torch.config import MeshConfig

# Variables a torch.distributed launcher sets; with none of them the
# process is alone and nothing is initialised.
_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def maybe_init_distributed(backend: Optional[str] = None) -> bool:
    """Join the process group when launched by ``torchrun`` (or anything
    that sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``). Call once at process start (``cli train`` does).
    The backend is NCCL where CUDA is available, else gloo; ``backend``
    overrides it (gloo on the card lets two ranks share one device, which
    NCCL refuses). Under NCCL the rank's device is ``cuda:LOCAL_RANK``.
    A no-op without the launcher's variables. Returns whether a process
    group is up."""
    if dist.is_initialized():
        return True
    if not any(v in os.environ for v in _LAUNCH_VARS):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def cross_process_barrier(name: str, timeout_s: float = 600.0) -> bool:
    """Block until every rank reaches this barrier (no-op alone). ``name``
    is for the reader; gloo honours ``timeout_s``, NCCL its group's
    timeout. Returns whether a barrier was performed."""
    del name
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return False
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s))
    else:
        dist.barrier()
    return True


class _GlobalSum(torch.autograd.Function):
    """All-reduce (SUM) forward, identity backward: the rank's gradient of
    a function of global sums is its own rows' contribution, and the
    gradient all-reduce adds the ranks'."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


class Mesh:
    """The data-parallel group: ``size`` ranks, this one ``rank``. Every
    batch-level reduction of the loss goes through :meth:`sum` or
    :meth:`mean`."""

    def __init__(self, size: int = 1, rank: int = 0, axis_name: str = "data"):
        self.size, self.rank, self.axis_name = size, rank, axis_name

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over every rank's ``x``: ``torch.sum`` at size 1."""
        if self.size == 1:
            return torch.sum(x)
        return _GlobalSum.apply(torch.sum(x))

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over every rank's ``x`` (equal shapes on every rank):
        ``torch.mean`` at size 1."""
        if self.size == 1:
            return torch.mean(x)
        return self.sum(x) / (x.numel() * self.size)

    def all_reduce_grads(self, grads: List[torch.Tensor]) -> None:
        """Sum the ranks' gradients in place, in one flat all-reduce (the
        identity at size 1, which runs it all the same when a group is up)."""
        if not dist.is_initialized() or not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The data-parallel group of this process: every rank of the process
    group (``mesh.data_parallel=-1``), or exactly ``data_parallel`` ranks,
    which must be the world size. Alone, a mesh of one."""
    cfg = cfg or MeshConfig()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = cfg.data_parallel if cfg.data_parallel > 0 else world
    if n != world:
        raise ValueError(f"mesh.data_parallel={cfg.data_parallel} but the process group has "
                         f"WORLD_SIZE={world} ranks; launch {n} ranks (torchrun "
                         f"--nproc_per_node={n}) or set mesh.data_parallel=-1")
    return Mesh(n, rank, cfg.axis_name)


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> dict:
    """This rank's rows ``[r·B/W, (r+1)·B/W)`` of every batched entry of a
    global batch (numpy arrays or tensors); ``k`` is shared."""
    if mesh.size == 1:
        return dict(batch)
    b = batch["frames"].shape[0]
    if b % mesh.size:
        raise ValueError(f"data.batch_size={b} does not split over {mesh.size} ranks")
    lo, hi = mesh.rank * b // mesh.size, (mesh.rank + 1) * b // mesh.size
    return {key: v if key == "k" else v[lo:hi] for key, v in batch.items()}


def replicate_tree(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast every parameter and buffer of ``module`` from rank 0, in
    place (nothing to do at size 1)."""
    if mesh.size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module
