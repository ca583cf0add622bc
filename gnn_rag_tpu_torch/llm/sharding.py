"""Megatron tensor parallelism for the LLM reader, the port of
gnn_rag_tpu/llm_tpu/sharding.py.

Mesh axes: ``dp`` (batch) and ``tp`` (tensor), one process a rank
(``parallel.collectives``). The reference reaches multi-GPU scale only through
deepspeed ZeRO-3 for the finetune (scripts/train.sh:8). JAX states the
rules as GSPMD partition specs and XLA inserts the collectives; here
``shard_llm_`` cuts a built ``LlamaLM`` into one tp rank's part, in place,
by the same rules, and the model runs the collectives itself:

* q/k/v projections are column-parallel over heads, o_proj row-parallel,
  its output all-reduced. Where tp divides ``n_heads`` but not
  ``n_kv_heads`` (one kv head at tp 2, say), k_proj and v_proj stay whole
  on every rank and each rank's query heads read the kv heads they read in
  the whole model (``kv_heads_of_rank``); their gradients are then each
  rank's part, summed over tp (``partial_grad_names``). Where tp does not
  divide ``n_heads``, the whole attention runs on every rank, as a whole
  MLP does;
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
replication: the heads (the attention then runs unsharded), the kv heads
alone (k_proj and v_proj whole), the intermediate axis (the MLP then runs
unsharded) or the vocabulary (embedding and head unsharded). The
row-parallel sums run in float32 (one rounding to the compute type after
them, as one matmul's).
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


def kv_heads_of_rank(n_heads: int, n_kv_heads: int, tp: int,
                     tp_rank: int) -> list:
    """The kv head that each of tp rank ``tp_rank``'s ``n_heads / tp`` query
    heads reads in the whole model (GQA: query head g reads kv head g //
    (n_heads / n_kv_heads))."""
    local, group = n_heads // tp, n_heads // n_kv_heads
    return [(tp_rank * local + h) // group for h in range(local)]


def partial_grad_names(model: nn.Module) -> frozenset:
    """The parameters of a ``shard_llm_`` model that stay whole on every tp
    rank but feed only this rank's part of the model (k_proj and v_proj
    where tp divides the query heads and not the kv heads): each rank's
    gradient is its part, so the gradients are summed over tp (and dp), not
    divided by tp as those of a weight every rank computes whole. The
    trainers (``SFTTrainer``, ``LoRATrainer``) read this set."""
    return getattr(model, "_tp_partial", frozenset())


def shard_llm_(model: nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Cut ``model`` (a whole ``LlamaLM``) into tp rank ``mesh.tp_rank``'s
    part, in place: each tensor ``param_spec`` names is replaced by its
    slice, and the attention, MLP and vocabulary modules are told their
    mesh. Returns {state_dict name: sharded axis}; the parameters left whole
    whose gradients are partial are ``partial_grad_names(model)``. An axis
    that does not divide by tp stays whole: the attention's heads (the
    whole attention on every rank), its kv heads alone (k_proj and v_proj
    whole, each query head reading its kv head of the whole model), the
    intermediate axis, the vocabulary."""
    cfg, tp = model.cfg, mesh.tp
    model._tp_partial = frozenset()
    if tp == 1:
        model._tp_sharded = {}
        return {}
    heads_split = cfg.n_heads % tp == 0
    kv_split = heads_split and cfg.n_kv_heads % tp == 0
    mlp_split = cfg.intermediate % tp == 0
    vocab_split = cfg.vocab_size % tp == 0
    kv_index = None if kv_split or not heads_split else torch.tensor(
        kv_heads_of_rank(cfg.n_heads, cfg.n_kv_heads, tp, mesh.tp_rank),
        device=model.tok_emb.weight.device)
    for block in model.blocks():
        if heads_split:
            block.attn.tp = mesh
            block.attn.n_heads //= tp
            if kv_split:
                block.attn.n_kv_heads //= tp
            block.attn.kv_index = kv_index
        if mlp_split:
            block.mlp.tp = mesh
    if vocab_split:
        model.vocab_tp = mesh
    split = {"q_proj": heads_split, "o_proj": heads_split,
             "k_proj": kv_split, "v_proj": kv_split, "gate_proj": mlp_split,
             "up_proj": mlp_split, "down_proj": mlp_split,
             "tok_emb": vocab_split, "lm_head": vocab_split}
    sharded, partial = {}, set()
    for name, t in list(model.state_dict(keep_vars=True).items()):
        axis = param_spec(name, tuple(t.shape))
        owner = name.rpartition(".")[0].rpartition(".")[2]
        if axis is None:
            continue
        if not split.get(owner, True):
            if (kv_index is not None and owner in ("k_proj", "v_proj")
                    and isinstance(t, nn.Parameter)):
                partial.add(name)
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
    model._tp_partial = frozenset(partial)
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
