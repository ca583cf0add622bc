"""LoRA adapters for the LLM reader, the port of gnn_rag_tpu/llm_tpu/lora.py.

The reference's peft usage: a LoraConfig on q_proj/v_proj
(joint_finetuning.py:97-106) and the adapter merge (llm/src/utils/
merge_peft.py:1-17). Adapters are a dict of (A, B) factors, one pair for
each matched weight of a ``LlamaLM`` state_dict; ``merge_lora`` folds them
into the base weights, so the merged state_dict serves without adapter
logic, and ``LoRATrainer`` trains only them: the base is frozen, each step
runs the model through ``torch.func.functional_call`` over the merged
state_dict, so the gradient reaches A and B through the merge.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch
from torch import nn

from .model import LlamaLM
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
               alpha: float = 16.0, r: int = 8) -> Dict[str, torch.Tensor]:
    """Fold adapters into a state_dict: ``W + (alpha / r) * (A @ B).T`` in
    W's type for every adapted ``[out, in]`` weight."""
    scale = alpha / r
    out = dict(state)
    for name, ab in lora.items():
        w = state[name]
        out[name] = w + ((ab["a"] @ ab["b"]) * scale).T.to(w.dtype)
    return out


class _Loss(nn.Module):
    """The completion-only loss of a model as a module, so that
    ``functional_call`` swaps the merged weights in for the whole loss."""

    def __init__(self, model: LlamaLM):
        super().__init__()
        self.model = model

    def forward(self, tokens, loss_mask):
        return completion_loss(self.model, tokens, loss_mask)


class LoRATrainer:
    """SFT steps that differentiate only the adapters (the port of
    ``lora_train_step_factory``): the completion-only loss of ``llm.sft``,
    ``torch.optim.Adam`` (eps 1e-8 outside the square root, no weight
    decay: optax.adam), the model's parameters frozen."""

    def __init__(self, model: LlamaLM, lora, lr: float, alpha: float = 16.0,
                 r: int = 8):
        for p in model.parameters():
            p.requires_grad_(False)
        self.base = model.state_dict(keep_vars=True)
        self.loss_fn = _Loss(model)
        self.lora, self.alpha, self.r = lora, alpha, r
        self.params = [t.requires_grad_() for ab in lora.values()
                       for t in (ab["a"], ab["b"])]
        self.opt = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)

    def loss(self, tokens, loss_mask):
        merged = merge_lora(self.base, self.lora, self.alpha, self.r)
        return torch.func.functional_call(
            self.loss_fn, {f"model.{k}": v for k, v in merged.items()},
            (tokens, loss_mask))

    def train_step(self, tokens, loss_mask):
        """One step on a batch on the device; returns the loss (a device
        scalar)."""
        for p in self.params:
            p.grad = None
        loss = self.loss(tokens, loss_mask)
        loss.backward()
        self.opt.step()
        return loss.detach()
