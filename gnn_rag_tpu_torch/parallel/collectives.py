"""The process mesh and its collectives: what the retriever's trainer
(``parallel.mesh``) and the LLM reader's tensor parallelism
(``llm.sharding``) share.

Ranks are laid out as JAX lays out its devices (``reshape(dp, tp)``:
rank = dp coordinate * tp + tp coordinate). Every collective here is an
``all_reduce`` (an all-gather is a zero-padded all-reduce), the one
reduction that ``gloo`` also runs on CUDA tensors, so the same code runs
over ``nccl`` (one card a rank), over ``gloo`` on the CPU, and over
``gloo`` with two ranks on one card (NCCL refuses two ranks on one device).
Every collective is a no-op over a group of one, so a one-process run is a
mesh of one rank (``local_mesh``) and takes the same code path.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass
class Mesh:
    """The dp x tp layout of the ranks of one process group, seen from one
    rank: its coordinates, its device and the groups of its row (tp) and
    column (dp)."""
    dp: int
    tp: int
    rank: int
    device: torch.device
    dp_group: object
    tp_group: object

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def size(self) -> int:
        return self.dp * self.tp


def local_mesh(device) -> Mesh:
    """The mesh of one process on ``device``: dp = tp = 1, no groups."""
    return Mesh(dp=1, tp=1, rank=0, device=torch.device(device),
                dp_group=None, tp_group=None)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              backend: Optional[str] = None, device="cuda") -> Mesh:
    """The mesh of the running process group, initialising it from the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when it is not initialised yet. ``backend`` None means
    ``nccl`` on a CUDA ``device`` and ``gloo`` on the CPU; ``device``
    "cuda" means ``cuda:$LOCAL_RANK``. ``dp * tp`` must be the world size
    (``dp`` None: world size // tp)."""
    dev = _device(device)
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "make_mesh: no process group: torch.distributed is not "
                "initialised and RANK / WORLD_SIZE are unset (launch with "
                "torchrun --nproc_per_node=N)")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda"
                                            else "gloo"))
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"make_mesh: the process group runs "
                         f"{dist.get_backend()}, not {backend}")
    n, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != world size ({n})")
    # every rank creates every group, in the same order
    tp_groups = [dist.new_group(list(range(d * tp, (d + 1) * tp)))
                 for d in range(dp)]
    dp_groups = [dist.new_group(list(range(t, n, tp))) for t in range(tp)]
    return Mesh(dp=dp, tp=tp, rank=rank, device=dev,
                dp_group=dp_groups[rank % tp], tp_group=tp_groups[rank // tp])


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of ``mesh`` (a no-op for one rank)."""
    if mesh.size > 1:
        dist.barrier()


def all_reduce_(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (None: every rank); a no-op for a
    group of one (``size``)."""
    if size > 1:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, size: int, rank: int,
               dim: int) -> torch.Tensor:
    """Concatenate the ``size`` ranks' ``t`` along ``dim`` (rank order), as
    a zero-padded all-reduce."""
    if size == 1:
        return t
    shape = list(t.shape)
    k = shape[dim]
    shape[dim] = k * size
    full = torch.zeros(shape, dtype=t.dtype, device=t.device)
    full.narrow(dim, rank * k, k).copy_(t)
    return all_reduce_(full, group, size)


def shard_of(t: torch.Tensor, size: int, rank: int, dim: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``dim`` (``size`` equal parts)."""
    k = t.shape[dim] // size
    return t.narrow(dim, rank * k, k)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """This rank's rows of a batch of ``batch_size`` rows: a batch is
    sharded on its leading axis over dp."""
    if batch_size % mesh.dp:
        raise ValueError(f"batch of {batch_size} rows does not divide over "
                         f"dp {mesh.dp} (make_batch(..., batch_pad_to=...))")
    k = batch_size // mesh.dp
    return slice(mesh.dp_rank * k, (mesh.dp_rank + 1) * k)


def replicate(mesh: Mesh, tree):
    """Broadcast every tensor of ``tree`` (a tensor, a tuple/list of tensors
    or Nones, or a module's parameters and buffers) from rank 0, in place;
    returns ``tree``."""
    if mesh.size == 1:
        return tree
    if isinstance(tree, nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, torch.Tensor):
        tensors = [tree]
    else:
        tensors = [t for t in tree if t is not None]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return tree


# --------------------------------------------------------- the gradients
def all_reduce_grads_(grads: List[Optional[torch.Tensor]], group, size: int,
                      div: float) -> None:
    """Sum ``grads`` (Nones skipped) over ``group`` of ``size`` ranks in one
    flat all-reduce and divide them by ``div``, in place."""
    grads = [g for g in grads if g is not None]
    if not grads or size == 1:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce_(flat, group, size)
    flat /= div
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def sync_grads(mesh: Mesh, replicated: List[torch.Tensor],
               sharded: List[torch.Tensor], average_dp: bool,
               partial: List[torch.Tensor] = ()) -> None:
    """Reduce the gradients of one step in place: a replicated parameter's
    over every rank, divided by tp (its tp copies saw the same rows); a
    sharded parameter's (each tp rank's own slice) over dp; a ``partial``
    one's (a whole parameter that feeds only each tp rank's part of the
    model, ``llm.sharding.partial_grad_names``) over every rank, not
    divided by tp. ``average_dp``: divide by dp as well (a loss that is a
    mean over the rows of each dp rank); else the dp sum (a loss already
    divided by the global count)."""
    dp_div = mesh.dp if average_dp else 1
    all_reduce_grads_(replicated, None, mesh.size, mesh.tp * dp_div)
    all_reduce_grads_(sharded, mesh.dp_group, mesh.dp, dp_div)
    all_reduce_grads_(list(partial), None, mesh.size, dp_div)


def clip_by_global_norm_(mesh: Mesh, replicated: List[torch.Tensor],
                         sharded: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` over a mesh: the squared norm of the
    tp-sharded gradients is summed over tp before it joins the replicated
    ones' (every gradient that ``sync_grads`` left whole and equal on each
    tp rank, the partial ones too: each counted once), then every gradient
    is scaled by ``max_norm / norm`` when the norm is at least
    ``max_norm``, in place and on the device. Returns the norm before the
    clip (a device scalar)."""
    replicated = [g for g in replicated if g is not None]
    sharded = [g for g in sharded if g is not None]
    dev = (replicated or sharded)[0].device
    sq = torch.zeros((), device=dev)
    if replicated:
        sq = sq + torch.stack(torch._foreach_norm(replicated)).square().sum()
    if sharded:
        sh = torch.stack(torch._foreach_norm(sharded)).square().sum()
        sq = sq + all_reduce_(sh, mesh.tp_group, mesh.tp)
    norm = sq.sqrt()
    torch._foreach_mul_(replicated + sharded,
                        torch.where(norm < max_norm, 1.0, max_norm / norm))
    return norm
