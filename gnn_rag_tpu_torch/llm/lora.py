"""LoRA adapters for the LLM reader, the port of gnn_rag_tpu/llm_tpu/lora.py.

The reference's peft usage: a LoraConfig on q_proj/v_proj
(joint_finetuning.py:97-106) and the adapter merge (llm/src/utils/
merge_peft.py:1-17). Adapters are a dict of (A, B) factors, one pair for
each matched weight of a ``LlamaLM`` state_dict; ``merge_lora`` folds them
into the base weights, so the merged state_dict serves without adapter
logic, and ``LoRATrainer`` trains only them: the base is frozen, each step
runs the model through ``torch.func.functional_call`` over the merged
state_dict, so the gradient reaches A and B through the merge.

Over a mesh the base may be tp-sharded (``llm.sharding.shard_llm_``): the
adapters stay whole and replicated, each rank merges its slice of the
update into its slice of the weight, and the adapters' gradients are summed
over every rank (the loss divides by the global mask count): each tp rank's
gradient of a sharded weight's adapter covers its slice, and each dp rank's
its rows. So is the adapter of a weight that ``shard_llm_`` leaves whole
but that feeds only each tp rank's query heads (k_proj and v_proj where tp
does not divide the kv heads, ``sharding.partial_grad_names``): each rank's
gradient is its part. Any other weight that ``shard_llm_`` leaves whole (an
axis that does not divide by tp) gives the same whole gradient on every tp
rank, so its adapter's sum is divided by tp. Without a mesh the trainer
runs on a mesh of one rank.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ..parallel import collectives as coll
from .model import LlamaLM
from .sharding import partial_grad_names
from .sft import completion_loss

DEFAULT_TARGETS = ("q_proj", "v_proj")


def _match(name: str, targets: Sequence[str]) -> bool:
    return any(t in name for t in targets) and "weight" in name


def init_lora(model: LlamaLM, generator: torch.Generator, r: int = 8,
              targets: Sequence[str] = DEFAULT_TARGETS
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{name: {"a": [in, r], "b": [r, out]}}`` for every state_dict entry
    whose name holds a target and "weight", on the model's device: A drawn
    from ``randn / r`` (the JAX package divides by r, not sqrt(r)), B zero,
    so the adapter starts as a no-op; weights are ``[out, in]``."""
    lora = {}
    for name, w in model.state_dict().items():
        if not _match(name, targets):
            continue
        d_out, d_in = w.shape
        a = torch.randn((d_in, r), generator=generator, device=w.device) / r
        lora[name] = {"a": a, "b": torch.zeros((r, d_out), device=w.device)}
    return lora


def merge_lora(state: Mapping[str, torch.Tensor],
               lora: Mapping[str, Mapping[str, torch.Tensor]],
               alpha: float = 16.0, r: int = 8, mesh=None,
               sharded: Optional[Mapping[str, int]] = None
               ) -> Dict[str, torch.Tensor]:
    """Fold adapters into a state_dict: ``W + (alpha / r) * (A @ B).T`` in
    W's type for every adapted ``[out, in]`` weight; where ``sharded``
    ({name: axis}) names the weight, ``state`` holds tp rank
    ``mesh.tp_rank``'s slice and takes that slice of the update."""
    scale = alpha / r
    out = dict(state)
    for name, ab in lora.items():
        w = state[name]
        delta = ((ab["a"] @ ab["b"]) * scale).T
        if sharded and name in sharded:
            delta = coll.shard_of(delta, mesh.tp, mesh.tp_rank, sharded[name])
        out[name] = w + delta.to(w.dtype)
    return out


class _Loss(nn.Module):
    """The completion-only loss of a model as a module, so that
    ``functional_call`` swaps the merged weights in for the whole loss."""

    def __init__(self, model: LlamaLM):
        super().__init__()
        self.model = model

    def forward(self, tokens, loss_mask, count=None):
        return completion_loss(self.model, tokens, loss_mask, count)


class LoRATrainer:
    """SFT steps that differentiate only the adapters (the port of
    ``lora_train_step_factory``): the completion-only loss of ``llm.sft``,
    ``torch.optim.Adam`` (eps 1e-8 outside the square root, no weight
    decay: optax.adam), the model's parameters frozen."""

    def __init__(self, model: LlamaLM, lora, lr: float, alpha: float = 16.0,
                 r: int = 8, mesh=None):
        """``mesh``: the run's mesh when ``model`` is one rank's part (its
        ``shard_llm_`` slices) and each step gets this dp rank's rows."""
        self.mesh = mesh or coll.local_mesh(next(model.parameters()).device)
        self.sharded = getattr(model, "_tp_sharded", {})
        partial = partial_grad_names(model)
        for p in model.parameters():
            p.requires_grad_(False)
        self.base = model.state_dict(keep_vars=True)
        self.loss_fn = _Loss(model)
        self.lora, self.alpha, self.r = lora, alpha, r
        self.params = [t.requires_grad_() for ab in lora.values()
                       for t in (ab["a"], ab["b"])]
        # the adapters whose gradient is each tp rank's part (of sharded
        # weights, and of whole ones that feed only the rank's heads), then
        # those of weights every rank computes whole
        self.split = [[t for name, ab in lora.items()
                       if (name in self.sharded or name in partial) == part
                       for t in (ab["a"], ab["b"])] for part in (True, False)]
        self.opt = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)

    def loss(self, tokens, loss_mask, count=None):
        merged = merge_lora(self.base, self.lora, self.alpha, self.r,
                            self.mesh, self.sharded)
        return torch.func.functional_call(
            self.loss_fn, {f"model.{k}": v for k, v in merged.items()},
            (tokens, loss_mask, count))

    def train_step(self, tokens, loss_mask):
        """One step on a batch on the device; returns the loss (a device
        scalar; over a mesh, the global batch's)."""
        for p in self.params:
            p.grad = None
        mesh = self.mesh
        count = coll.all_reduce_(loss_mask[:, 1:].sum(), mesh.dp_group, mesh.dp)
        loss = self.loss(tokens, loss_mask, count)
        loss.backward()
        for params, div in zip(self.split, (1, mesh.tp)):
            coll.all_reduce_grads_([p.grad for p in params], None, mesh.size, div)
        loss = coll.all_reduce_(loss.detach().clone(), mesh.dp_group, mesh.dp)
        self.opt.step()
        return loss.detach()
