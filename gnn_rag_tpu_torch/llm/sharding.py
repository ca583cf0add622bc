"""Megatron tensor parallelism for the LLM reader, the port of
gnn_rag_tpu/llm_tpu/sharding.py.

Mesh axes: ``dp`` (batch) and ``tp`` (tensor), one process a rank
(``parallel.collectives``). The reference reaches multi-GPU scale only through
deepspeed ZeRO-3 for the finetune (scripts/train.sh:8). JAX states the
rules as GSPMD partition specs and XLA inserts the collectives; here
``shard_llm_`` cuts a built ``LlamaLM`` into one tp rank's part, in place,
by the same rules, and the model runs the collectives itself:

* q/k/v projections are column-parallel over heads (``n_heads`` and
  ``n_kv_heads`` must divide by tp), o_proj row-parallel, its output
  all-reduced;
* MLP gate/up column-parallel over the intermediate axis, down_proj
  row-parallel;
* ``tok_emb`` vocabulary-parallel (ids outside this rank's rows masked,
  looked up, all-reduced) and ``lm_head`` column-parallel over the
  vocabulary, its logits all-gathered before the loss;
* norms replicated.

Weights are ``[out, in]`` (TLinear, and QuantLinear's int8 ``weight_q``,
which JAX stores ``[in, out]`` as ``kernel_q``: the same megatron axis
either way). A column-parallel QuantLinear also keeps its outputs' scales.
An axis that does not divide by tp stays whole, as JAX falls back to
replication: the intermediate axis (the MLP then runs unsharded) or the
vocabulary (embedding and head unsharded). The row-parallel sums run in
float32 (one rounding to the compute type after them, as one matmul's).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..parallel.collectives import Mesh, all_gather, all_reduce_, shard_of


class CopyToTP(torch.autograd.Function):
    """Forward: the identity (the input of a column-parallel layer is the
    same on every tp rank). Backward: the ranks' partial input gradients
    summed over tp."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, grad):
        m = ctx.mesh
        return all_reduce_(grad.contiguous().clone(), m.tp_group, m.tp), None


class ReduceFromTP(torch.autograd.Function):
    """Forward: the row-parallel partial outputs summed over tp, in float32.
    Backward: the identity."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        return all_reduce_(x.float().contiguous(), mesh.tp_group,
                           mesh.tp).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class GatherLastFromTP(torch.autograd.Function):
    """Forward: the tp ranks' slices of the last axis concatenated.
    Backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        return all_gather(x.contiguous(), mesh.tp_group, mesh.tp, mesh.tp_rank,
                          x.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        m = ctx.mesh
        return shard_of(grad, m.tp, m.tp_rank, grad.dim() - 1).contiguous(), None


COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "lm_head")
ROW = ("o_proj", "down_proj")


def param_spec(name: str, shape) -> Optional[int]:
    """The axis of the state_dict entry ``name`` (of ``shape``) that tp
    shards, or None (replicated): the vocabulary axis of ``tok_emb`` and
    ``lm_head``, the output (head, intermediate) axis of the column-parallel
    projections and the input axis of the row-parallel ones; a
    column-parallel QuantLinear's ``scale`` with its outputs; norms none."""
    module, _, leaf = name.rpartition(".")
    owner = module.rpartition(".")[2]
    if len(shape) == 1:
        return 0 if leaf == "scale" and owner in COLUMN else None
    if owner == "tok_emb" or owner in COLUMN:
        return 0
    if owner in ROW:
        return 1
    return None


def shard_llm_(model: nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Cut ``model`` (a whole ``LlamaLM``) into tp rank ``mesh.tp_rank``'s
    part, in place: each tensor ``param_spec`` names is replaced by its
    slice, and the attention, MLP and vocabulary modules are told their
    mesh. Returns {state_dict name: sharded axis}. Refuses head counts that
    do not divide by tp."""
    cfg, tp = model.cfg, mesh.tp
    if tp == 1:
        model._tp_sharded = {}
        return {}
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"tp {tp} must divide n_heads {cfg.n_heads} and "
                         f"n_kv_heads {cfg.n_kv_heads}")
    mlp_split = cfg.intermediate % tp == 0
    vocab_split = cfg.vocab_size % tp == 0
    for block in model.blocks():
        block.attn.tp = mesh
        block.attn.n_heads //= tp
        block.attn.n_kv_heads //= tp
        if mlp_split:
            block.mlp.tp = mesh
    if vocab_split:
        model.vocab_tp = mesh
    sharded = {}
    for name, t in list(model.state_dict(keep_vars=True).items()):
        axis = param_spec(name, tuple(t.shape))
        owner = name.rpartition(".")[0].rpartition(".")[2]
        if axis is None or (owner in ("gate_proj", "up_proj", "down_proj")
                            and not mlp_split) or (
                owner in ("tok_emb", "lm_head") and not vocab_split):
            continue
        module_name, _, leaf = name.rpartition(".")
        module = model.get_submodule(module_name)
        piece = shard_of(t.data, tp, mesh.tp_rank, axis).clone()
        if isinstance(t, nn.Parameter):
            setattr(module, leaf, nn.Parameter(piece, requires_grad=t.requires_grad))
        else:
            setattr(module, leaf, piece)
        sharded[name] = axis
    model._tp_sharded = sharded
    return sharded


def full_llm_state(model: nn.Module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The whole state_dict of a tp-sharded model, its slices all-gathered
    (every tp rank must call it)."""
    out = {}
    sharded = getattr(model, "_tp_sharded", {})
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name in sharded:
                t = all_gather(t.contiguous(), mesh.tp_group, mesh.tp,
                               mesh.tp_rank, sharded[name])
            out[name] = t
    return out


def local_llm_state(model: nn.Module, mesh: Optional[Mesh],
                    state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This tp rank's slices of a whole state_dict, for
    ``model.load_state_dict``."""
    sharded = getattr(model, "_tp_sharded", {})
    return {n: (shard_of(t, mesh.tp, mesh.tp_rank, sharded[n]).clone()
                if n in sharded else t) for n, t in state.items()}
