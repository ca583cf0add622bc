"""Greedy decoding of the LLM reader with a kv cache, the port of
``Decoder.greedy_batch`` / ``greedy`` (gnn_rag_tpu/llm_tpu/generate.py).

Prompts are batched LEFT-padded so every row's last prompt token sits at the
same cache slot; RoPE positions count each row's real tokens, and a kv-slot
validity mask keeps the pads out of attention. The prefill and every step
run the model with a cache and ``kv_valid``, so attention takes the plain
path (the flash kernels are for cache-free forwards). The loop runs on the
host, one forward per new token, and stops once every row has emitted
``eos_id``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .model import LlamaLM


def _left_pad(prompts: List[List[int]], pad_to_multiple: int = 32,
              pad_id: int = 0, budget: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad a ragged prompt batch -> (tokens [B, L], mask [B, L]); L
    rounds up to a multiple of ``pad_to_multiple`` unless that would exceed
    ``budget`` (max_len - max_new_tokens)."""
    L = max(len(p) for p in prompts)
    Lb = -(-L // pad_to_multiple) * pad_to_multiple
    L = Lb if budget is None or Lb <= budget else L
    B = len(prompts)
    toks = np.full((B, L), pad_id, np.int32)
    mask = np.zeros((B, L), np.float32)
    for i, p in enumerate(prompts):
        toks[i, L - len(p):] = p
        mask[i, L - len(p):] = 1.0
    return toks, mask


class Decoder:
    """Batched kv-cache greedy decoder over a ``LlamaLM`` (on its device)."""

    def __init__(self, model: LlamaLM, max_len: int = 512):
        self.model = model
        self.max_len = max_len
        self.device = model.tok_emb.weight.device

    def prefill(self, tokens, mask):
        """Run the left-padded prompt batch through a fresh cache ->
        (logits [B, L, V], caches, kv_valid [B, max_len])."""
        B, L = tokens.shape
        caches = self.model.init_kv_cache(B, self.max_len)
        positions = ((torch.cumsum(mask, dim=1) - 1.0) * mask).long()  # pads -> 0
        kv_valid = torch.zeros((B, self.max_len), device=self.device)
        kv_valid[:, :L] = mask
        logits, caches = self.model(tokens, positions=positions,
                                    kv_caches=caches, cache_index=0,
                                    kv_valid=kv_valid)
        return logits, caches, kv_valid

    @torch.no_grad()
    def _greedy(self, tokens, mask, max_new: int, eos_id: int) -> np.ndarray:
        B, L = tokens.shape
        logits, caches, kv_valid = self.prefill(tokens, mask)
        true_len = mask.sum(dim=1).long()
        cur = logits[:, -1].argmax(dim=-1)
        out = torch.zeros((B, max_new), dtype=torch.long, device=self.device)
        out[:, 0] = cur
        done = cur == eos_id
        for i in range(1, max_new):
            if bool(done.all()):
                break
            slot = L + i - 1
            kv_valid[:, slot] = 1.0
            step_logits, caches = self.model(
                cur[:, None], positions=(true_len + i - 1)[:, None],
                kv_caches=caches, cache_index=slot, kv_valid=kv_valid)
            nxt = step_logits[:, -1].argmax(dim=-1)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            out[:, i] = nxt
            done = done | (nxt == eos_id)
            cur = nxt
        return out.cpu().numpy()

    def greedy_batch(self, prompts: List[List[int]], max_new_tokens: int = 128,
                     eos_id: Optional[int] = None) -> List[List[int]]:
        toks, mask = _left_pad(prompts, budget=self.max_len - max_new_tokens)
        if toks.shape[1] + max_new_tokens > self.max_len:
            raise ValueError(f"prompt length {toks.shape[1]} + {max_new_tokens} "
                             f"new tokens exceeds max_len {self.max_len}")
        out = self._greedy(torch.from_numpy(toks).long().to(self.device),
                           torch.from_numpy(mask).to(self.device),
                           max_new_tokens, -1 if eos_id is None else eos_id)
        res = []
        for row in out:
            seq = row.tolist()
            if eos_id is not None and eos_id in seq:
                seq = seq[: seq.index(eos_id) + 1]
            res.append(seq)
        return res

    def greedy(self, prompt_tokens: List[int], max_new_tokens: int = 128,
               eos_id: Optional[int] = None) -> List[int]:
        return self.greedy_batch([prompt_tokens], max_new_tokens, eos_id)[0]
