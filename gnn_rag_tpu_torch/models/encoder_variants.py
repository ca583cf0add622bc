"""Question-encoder architecture variants beyond the BERT family.

Port of ``gnn_rag_tpu.models.encoder_variants``. The reference selects among
seven HF encoders by name (bert_encoder.py:29-59): bert / roberta / simcse /
relbert share the BERT architecture (``encoders.TransformerQuestionEncoder``,
roberta with pad-aware positions), while t5 (T5EncoderModel semantics,
encode_question uses ``.encoder``, bert_encoder.py:95-98) and sbert2 (MPNet)
need their own blocks. The modules follow the JAX package's numerics and
its parameter names (``tok_emb``, ``rel_bias``, ``q_{i}``, ...); their
linears keep HF's ``[out, in]`` weights, so ``utils.hf_import`` maps a
checkpoint onto their ``state_dict`` as it is. Like every frozen encoder
here they run once, outside the train step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.softmax import VERY_NEG_NUMBER


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5/MPNet bidirectional relative-position bucketing (HF t5
    ``_relative_position_bucket`` with bidirectional=True)."""
    num_buckets //= 2
    ret = (rel_pos > 0).long() * num_buckets
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(n.clamp(min=1).float() / max_exact)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).long()
    val_large = val_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n.long(), val_large)


class T5RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale


class T5Encoder(nn.Module):
    """T5 encoder stack (pre-RMSNorm, unscaled attention, shared relative
    position bias on every layer, ReLU feed-forward, no biases anywhere)."""

    def __init__(self, vocab_size: int = 32128, hidden: int = 512,
                 layers: int = 6, heads: int = 8, head_dim: int = 64,
                 intermediate: int = 2048, num_buckets: int = 32,
                 max_distance: int = 128, eps: float = 1e-6):
        super().__init__()
        self.hidden, self.layers, self.heads = hidden, layers, heads
        self.head_dim = head_dim
        self.num_buckets, self.max_distance = num_buckets, max_distance
        inner = heads * head_dim
        self.tok_emb = nn.Embedding(vocab_size, hidden)
        # shared relative attention bias (HF: layer 0 owns the table)
        self.rel_bias = nn.Embedding(num_buckets, heads)
        for i in range(layers):
            self.add_module(f"ln_attn_{i}", T5RMSNorm(hidden, eps))
            for name in ("q", "k", "v"):
                self.add_module(f"{name}_{i}", nn.Linear(hidden, inner, bias=False))
            self.add_module(f"o_{i}", nn.Linear(inner, hidden, bias=False))
            self.add_module(f"ln_ffn_{i}", T5RMSNorm(hidden, eps))
            self.add_module(f"wi_{i}", nn.Linear(hidden, intermediate, bias=False))
            self.add_module(f"wo_{i}", nn.Linear(intermediate, hidden, bias=False))
        self.final_ln = T5RMSNorm(hidden, eps)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L = tokens.shape
        H, hd = self.heads, self.head_dim
        x = self.tok_emb(tokens.long())
        pos = torch.arange(L, device=tokens.device)
        bucket = relative_position_bucket(pos[None, :] - pos[:, None],   # k - q
                                          self.num_buckets, self.max_distance)
        pos_bias = self.rel_bias(bucket).permute(2, 0, 1)[None]         # [1,H,L,L]
        attn_mask = (1.0 - mask[:, None, None, :]) * VERY_NEG_NUMBER
        for i in range(self.layers):
            lyr = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            h = lyr("ln_attn")(x)
            q = lyr("q")(h).reshape(B, L, H, hd)
            k = lyr("k")(h).reshape(B, L, H, hd)
            v = lyr("v")(h).reshape(B, L, H, hd)
            # T5 attention is NOT scaled by sqrt(d)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) + pos_bias + attn_mask
            probs = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, H * hd)
            x = x + lyr("o")(ctx)
            h = lyr("ln_ffn")(x)
            x = x + lyr("wo")(torch.relu(lyr("wi")(h)))
        return self.final_ln(x)


class MPNetEncoder(nn.Module):
    """MPNet encoder (sbert2 / all-mpnet-base-v2): BERT-style post-LN blocks
    with a T5-style shared relative position bias added to the scaled
    attention scores, and RoBERTa-style pad-aware absolute positions."""

    def __init__(self, vocab_size: int = 30527, hidden: int = 768,
                 layers: int = 12, heads: int = 12, intermediate: int = 3072,
                 max_len: int = 512, num_buckets: int = 32,
                 max_distance: int = 128, pad_idx: int = 1,
                 eps: float = 1e-12):
        super().__init__()
        self.hidden, self.layers, self.heads = hidden, layers, heads
        self.max_len, self.pad_idx = max_len, pad_idx
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.tok_emb = nn.Embedding(vocab_size, hidden)
        self.pos_emb = nn.Embedding(max_len, hidden)
        self.emb_ln = nn.LayerNorm(hidden, eps=eps)
        self.rel_bias = nn.Embedding(num_buckets, heads)
        for i in range(layers):
            for name in ("q", "k", "v", "attn_out"):
                self.add_module(f"{name}_{i}", nn.Linear(hidden, hidden))
            self.add_module(f"ln1_{i}", nn.LayerNorm(hidden, eps=eps))
            self.add_module(f"ffn1_{i}", nn.Linear(hidden, intermediate))
            self.add_module(f"ffn2_{i}", nn.Linear(intermediate, hidden))
            self.add_module(f"ln2_{i}", nn.LayerNorm(hidden, eps=eps))

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L = tokens.shape
        H, hd = self.heads, self.hidden // self.heads
        x = self.tok_emb(tokens.long())
        # pad-aware positions: cumsum over non-pad + pad_idx (hf mpnet/roberta)
        m = mask.long()
        pos = (torch.cumsum(m, dim=1) * m + self.pad_idx).clamp(max=self.max_len - 1)
        x = self.emb_ln(x + self.pos_emb(pos))
        bucket = relative_position_bucket(pos[:, None, :] - pos[:, :, None],
                                          self.num_buckets, self.max_distance)
        pos_bias = self.rel_bias(bucket).permute(0, 3, 1, 2)             # [B,H,L,L]
        attn_mask = (1.0 - mask[:, None, None, :]) * VERY_NEG_NUMBER
        for i in range(self.layers):
            lyr = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            q = lyr("q")(x).reshape(B, L, H, hd)
            k = lyr("k")(x).reshape(B, L, H, hd)
            v = lyr("v")(x).reshape(B, L, H, hd)
            scores = (torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
                      + pos_bias + attn_mask)
            probs = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, self.hidden)
            x = lyr("ln1")(x + lyr("attn_out")(ctx))
            h = lyr("ffn2")(F.gelu(lyr("ffn1")(x), approximate="none"))
            x = lyr("ln2")(x + h)
        return x
