"""Process mesh and sharding rules, the port of gnn_rag_tpu/parallel/mesh.py.

The GNN stage's scale-out (SURVEY.md §2.3): every rank holds the model and
a shard of the *question batch*; large tables can also be sharded over a
tensor axis. JAX runs one process over a device mesh and GSPMD inserts the
collectives; here every rank is a process of ``torch.distributed`` and the
collectives are written out, so that a run keeps the numbers of one device.

Axes, ranks laid out as JAX lays out its devices (``reshape(dp, tp)``:
rank = dp coordinate * tp + tp coordinate):

* ``dp`` — data parallel over questions: ``shard_batch`` gives each dp rank
  its rows of the global padded batch; gradients are reduced over dp;
* ``tp`` — tensor axis: ``shard_params`` stores a large parameter as this
  rank's slice, all-gathered where the model uses it. The tp ranks of one
  dp coordinate hold the same rows, as the devices of a GSPMD tp axis do.

The mesh itself and its collectives (``make_mesh``, ``replicate``, the
gradient reductions and the clip) are in ``parallel.collectives``, which the
LLM reader shares; this module holds what is the retriever's: its batch,
its parameters and its forwards over the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from ..data.batch import GraphBatch
from ..data.kernel_layout import DirectionLayout, KernelLayout
from .collectives import (Mesh, all_gather, all_reduce_, batch_sharding,
                          local_mesh, make_mesh, replicate, shard_of)

__all__ = ["Mesh", "local_mesh", "make_mesh", "batch_sharding", "replicate",
           "shard_batch", "shard_params", "sharded_params", "full_state_dict",
           "load_full_state_", "make_sharded_forward", "sharded_forward",
           "shard_rel_hidden", "param_axis", "MIN_SHARD_SIZE"]

# a parameter of fewer elements stays whole over tp (_param_spec's default)
MIN_SHARD_SIZE = 16_384


class GatherFromTP(torch.autograd.Function):
    """Forward: the whole parameter from the tp ranks' slices. Backward: the
    tp ranks of one dp coordinate computed the same rows, so each holds the
    whole gradient: it is summed over tp and divided by tp (a plain sum
    would count it tp times; the mean keeps the shards of every rank
    consistent where atomics round differently), and this rank's slice is
    returned."""

    @staticmethod
    def forward(ctx, shard, mesh: Mesh, dim: int):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(shard, mesh.tp_group, mesh.tp, mesh.tp_rank, dim)

    @staticmethod
    def backward(ctx, grad):
        m = ctx.mesh
        grad = all_reduce_(grad.contiguous().clone(), m.tp_group, m.tp) / m.tp
        return shard_of(grad, m.tp, m.tp_rank, ctx.dim).contiguous(), None, None


# ------------------------------------------------------------- the batch
def _rows(x, mesh: Mesh):
    return None if x is None else x[batch_sharding(mesh, x.shape[0])]


def shard_batch(mesh: Mesh, batch: GraphBatch) -> GraphBatch:
    """This dp rank's rows of the GLOBAL padded batch (numpy or torch
    leaves), so every rank keeps the global E/F buckets. Each row's kernel
    layout is that row's own, padded to the (E, F) bucket's chunk count,
    so the rows of the layout are the layout the rank's rows build. A dp
    of one keeps the whole batch."""
    if mesh.dp == 1:
        return batch
    fields = {f.name: _rows(getattr(batch, f.name), mesh)
              for f in dataclasses.fields(batch) if f.name != "layout"}
    layout = batch.layout
    if layout is not None:
        layout = KernelLayout(
            fwd=DirectionLayout(*(_rows(a, mesh) for a in layout.fwd)),
            inv=DirectionLayout(*(_rows(a, mesh) for a in layout.inv)),
            num_entities=layout.num_entities)
    return GraphBatch(**fields, layout=layout)


# ------------------------------------------------------- tensor sharding
def param_axis(shape: Tuple[int, ...], tp: int, min_shard_size: int
               ) -> Optional[int]:
    """``_param_spec`` (gnn_rag_tpu/parallel/mesh.py:52-63): the axis a
    parameter of ``shape`` is sharded on over tp — its largest axis that
    divides by tp and holds at least tp*8, for a parameter of at least
    ``min_shard_size`` elements — or None (replicated)."""
    size = int(np.prod(shape)) if len(shape) else 1
    if len(shape) == 0 or size < min_shard_size or tp <= 1:
        return None
    for a in sorted(range(len(shape)), key=lambda a: -shape[a]):
        if shape[a] % tp == 0 and shape[a] >= tp * 8:
            return a
    return None


class _TPSlice(nn.Module):
    """The parametrization of a tp-sharded parameter: stored as this rank's
    slice (``right_inverse``), used whole (``forward``)."""

    def __init__(self, mesh: Mesh, dim: int):
        super().__init__()
        self.mesh, self.dim = mesh, dim

    def forward(self, shard):
        return GatherFromTP.apply(shard, self.mesh, self.dim)

    def right_inverse(self, full):
        return shard_of(full, self.mesh.tp, self.mesh.tp_rank, self.dim).clone()


def _owner(model: nn.Module, name: str):
    module_name, _, attr = name.rpartition(".")
    return (model.get_submodule(module_name) if module_name else model), attr


def shard_params(mesh: Mesh, model: nn.Module) -> Dict[str, int]:
    """Tensor-shard the large parameters of ``model`` over tp, in place, by
    the rule of ``param_axis`` (at least ``MIN_SHARD_SIZE`` elements); the rest stay whole (replicated). A sharded
    parameter is stored as this rank's slice and all-gathered where the
    model reads it (``torch.nn.utils.parametrize``; run a forward under
    ``parametrize.cached()`` to gather each once). Recurrent layers keep
    their parameters whole (cuDNN reads them as one flat buffer). Returns
    {parameter name: sharded axis}; ``full_state_dict`` and
    ``load_full_state_`` read and write the model with whole tensors."""
    sharded = {}
    if mesh.tp == 1:
        model._tp_sharded = sharded
        return sharded
    for name, p in list(model.named_parameters()):
        owner, attr = _owner(model, name)
        if isinstance(owner, nn.RNNBase):
            continue
        axis = param_axis(tuple(p.shape), mesh.tp, MIN_SHARD_SIZE)
        if axis is None:
            continue
        parametrize.register_parametrization(owner, attr, _TPSlice(mesh, axis),
                                             unsafe=True)
        sharded[name] = axis
    model._tp_sharded = sharded
    return sharded


def sharded_params(model: nn.Module) -> List[nn.Parameter]:
    """The stored slices of the tp-sharded parameters of ``model``."""
    out = []
    for name in getattr(model, "_tp_sharded", {}):
        owner, attr = _owner(model, name)
        out.append(owner.parametrizations[attr].original)
    return out


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The state_dict of ``model`` with every tp-sharded parameter gathered
    whole under its own name (every rank must call it)."""
    out = {}
    sharded = getattr(model, "_tp_sharded", {})
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if ".parametrizations." in name:
                continue
            out[name] = t
        for name in sharded:
            owner, attr = _owner(model, name)
            out[name] = getattr(owner, attr).detach().clone()
    return out


def load_full_state_(model: nn.Module, state: Dict[str, torch.Tensor],
                     partial: bool = False) -> None:
    """Copy whole tensors into ``model`` in place (this rank's slice into a
    tp-sharded parameter). ``partial``: skip names the model lacks or whose
    shape differs (the reference's strict=False)."""
    sharded = getattr(model, "_tp_sharded", {})
    own = {n: t for n, t in model.state_dict(keep_vars=True).items()
           if ".parametrizations." not in n}
    with torch.no_grad():
        for name, t in state.items():
            if name in sharded:
                owner, attr = _owner(model, name)
                param = owner.parametrizations[attr]
                full_shape = list(param.original.shape)
                full_shape[sharded[name]] *= param[0].mesh.tp
                if list(t.shape) != full_shape:
                    if partial:
                        continue
                    raise ValueError(f"{name}: shape {tuple(t.shape)} vs "
                                     f"{tuple(full_shape)}")
                param.original.copy_(param[0].right_inverse(t.to(param.original)))
            elif name in own and (tuple(own[name].shape) == tuple(t.shape)):
                own[name].copy_(t)
            elif not partial:
                raise KeyError(f"{name}: not in the model or of another shape")


# ----------------------------------------------------------- forwards
def make_sharded_forward(model: nn.Module, rel_args, mesh: Mesh):
    """Data-parallel eval forward: the model's parameters broadcast from rank
    0, every GraphBatch leaf sharded over dp. Returns forward_fn(batch) for
    ``train.Evaluator``: each rank runs its rows and the ranks all-gather
    ``pred_dist`` (the loss is the dp mean), so every rank returns the
    global (loss, pred, pred_dist). The caller pads batches to a multiple
    of the dp size (``make_batch(..., batch_pad_to=...)``)."""
    replicate(mesh, model)
    rel_args = tuple(None if a is None else
                     replicate(mesh, torch.as_tensor(a, device=mesh.device))
                     for a in rel_args)

    def forward_fn(batch):
        return sharded_forward(mesh, model, batch, rel_args)

    return forward_fn


def sharded_forward(mesh: Mesh, model: nn.Module, batch: GraphBatch,
                    rel_args, **kw):
    """(loss, pred, pred_dist[, attn]) of the global numpy ``batch``: this
    rank's rows through ``model``, the outputs gathered over dp."""
    with parametrize.cached():
        out = model(shard_batch(mesh, batch).to(mesh.device), *rel_args, **kw)
    loss = all_reduce_(out[0].detach().float().clone(), mesh.dp_group,
                       mesh.dp) / mesh.dp
    rest = [all_gather(t.contiguous(), mesh.dp_group, mesh.dp, mesh.dp_rank, 0)
            for t in out[1:]]
    return (loss, *rest)


def shard_rel_hidden(mesh: Mesh, rel_hidden):
    """This tp rank's rows of a relation token-state table [R+1, Lr, Dw]
    (the whole table when its rows do not divide by tp);
    ``all_gather(shard, mesh.tp_group, mesh.tp, mesh.tp_rank, 0)`` rebuilds
    it."""
    if rel_hidden is None:
        return None
    if rel_hidden.shape[0] % mesh.tp:
        return rel_hidden
    return shard_of(rel_hidden, mesh.tp, mesh.tp_rank, 0)
