"""LLaMA-family decoder-only LM, the port of gnn_rag_tpu/llm_tpu/model.py.

Pre-RMSNorm blocks, rotary position embeddings (rotate-half, with the
optional "condense" position interpolation), grouped-query attention, SwiGLU
MLP, untied or tied ``lm_head``. Parameters are float32 and the blocks
compute in ``cfg.dtype``, with the JAX package's casts: projections round
both operands to ``cfg.dtype``; RMSNorm returns float32 for a bfloat16 input
(flax promotes against its float32 scale, model.py:72) while the residual
stream stays in ``cfg.dtype``; the logits are float32.

Names follow the flax tree (``tok_emb``, ``layer_{i}.attn.q_proj``,
``layer_{i}.mlp.gate_proj``, ``input_norm``, ``post_attn_norm``,
``final_norm``, ``lm_head``), and every projection keeps TDense's
``[out, in]`` layout as ``nn.Linear.weight``, so ``bridge.llama_from_flax``
copies kernels without a transpose.

Attention takes the flash kernels (``llm.flash_attention``) only where they
apply (``flash_applies``): ``use_flash``, CUDA tensors, no kv cache, no
``kv_valid``, head dim a multiple of 128 up to 2304 in float32 and up to
4096 in bfloat16 or float16 (``flash_attention.HEAD_DIMS``). Everything
else (the JAX model's Pallas rule also takes every larger multiple of 128
in any type, gnn_rag_tpu/llm_tpu/model.py:199-200) goes through the plain
``reference_attention``, which computes what the JAX model computes
there.

``quant="int8"`` builds every projection and the head as ``llm.quant.
QuantLinear`` (int8 weight, per-output scale; the parameters come from
``quant.quantize_state_dict``). ``remat=True`` runs each block under
``torch.utils.checkpoint`` (non-reentrant) when there is no kv cache and
autograd is on: a block's activations are recomputed in the backward, so
one block's are alive at a time (the cache-free forward, with the flash
kernels, runs twice a block).

Megatron tensor parallelism (``llm.sharding.shard_llm_``) turns a built
model into one tp rank's part, in place: ``Attention`` keeps its local head
counts (the flash kernels run at H/tp heads; a whole k_proj and v_proj
where tp does not divide the kv heads, each query head reading its kv head
through ``kv_index``; the whole attention where tp does not divide the
heads), column-parallel projections their output slice, row-parallel ones
their input slice with an all-reduce after them; the vocabulary-parallel
embedding and head are set on ``LlamaLM.vocab_tp``. Each module reads its
``tp`` (a ``parallel.collectives.Mesh`` or None) at run time; None is the
one-device model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import flash_attention as _fa
from . import sharding as _sh
from .quant import QuantLinear


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    intermediate: int = 11008
    rope_theta: float = 10000.0
    rope_condense: float = 1.0      # >1 extends context by interpolation
    max_seq_len: int = 4096
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    use_flash: bool = True          # flash kernels when shapes allow
    tie_embeddings: bool = False    # logits = h @ tok_emb.T (no lm_head)
    remat: bool = False             # recompute each block in the backward
    quant: str = "none"             # "int8": weight-only int8 projections

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def _dtype(cfg: LlamaConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale


def rope_frequencies(head_dim: int, positions: torch.Tensor, theta: float,
                     condense: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, L] int -> (cos, sin) [B, L, head_dim/2] float32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    t = positions.float() / condense
    freqs = t[..., None] * inv_freq[None, None, :]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin):
    """x [B, L, H, D]; cos/sin [B, L, D/2]; rotate-half (split) form."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def flash_applies(use_flash: bool, head_dim: int, dtype: torch.dtype,
                  device_type: str, cached: bool, masked: bool) -> bool:
    """Whether attention over q of ``head_dim``, ``dtype`` on
    ``device_type`` runs the flash kernels: the kernels take head dim 128,
    256, .. (a multiple of 128) up to 2304 in float32 and up to 4096 in
    bfloat16 or float16 on the card (``flash_attention.HEAD_DIMS``; past
    256 in clusters of up to sixteen blocks that split the depth), and
    neither a kv cache (``cached``) nor ``kv_valid`` (``masked``); float32
    past 2304 and 16-bit head dims past 4096 (past the JAX kernels' own
    estimated ceilings) run ``reference_attention``."""
    return (use_flash and not cached and not masked and device_type == "cuda"
            and head_dim in _fa.HEAD_DIMS.get(dtype, ()))


def reference_attention(q, k, v, causal_offset: int = 0, kv_valid=None):
    """Plain attention, q [B,L,H,D], k/v [B,S,H,D]: causal mask with the
    query positions shifted by ``causal_offset``; ``kv_valid`` [B, S]
    (optional) marks with 0 the kv slots never attended (left padding)."""
    L, S, D = q.shape[1], k.shape[1], q.shape[3]
    scores = (torch.einsum("blhd,bshd->bhls", q, k)
              / torch.tensor(math.sqrt(D), dtype=q.dtype))
    q_pos = torch.arange(L, device=q.device)[:, None] + causal_offset
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = (k_pos <= q_pos)[None, None]
    if kv_valid is not None:
        mask = mask & (kv_valid > 0)[:, None, None, :]
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhls,bshd->blhd", probs, v)


class TLinear(nn.Linear):
    """Bias-free projection computing in ``dtype``: both operands are cast
    to it (flax's ``promote_dtype``), the weight kept ``[out, in]``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__(in_features, out_features, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))


def _dense(cfg: LlamaConfig):
    """The projection class of ``cfg``: ``TLinear``, or ``QuantLinear``
    under ``quant="int8"``; both take (in, out, compute dtype)."""
    return QuantLinear if cfg.quant == "int8" else TLinear


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        H, KV, D, dt = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, _dtype(cfg)
        dense = _dense(cfg)
        self.q_proj = dense(cfg.dim, H * D, dt)
        self.k_proj = dense(cfg.dim, KV * D, dt)
        self.v_proj = dense(cfg.dim, KV * D, dt)
        self.o_proj = dense(H * D, cfg.dim, dt)
        self.n_heads, self.n_kv_heads = H, KV     # this tp rank's heads
        self.tp = None
        # a tp rank's query heads that read kv heads of a whole k_proj and
        # v_proj: the kv head of each (llm.sharding.kv_heads_of_rank); None:
        # query head h reads kv head h // (n_heads / n_kv_heads)
        self.kv_index = None

    def forward(self, x, cos, sin, kv_cache=None, cache_index=None,
                kv_valid=None):
        cfg = self.cfg
        B, L, _ = x.shape
        H, KV, D = self.n_heads, self.n_kv_heads, cfg.head_dim
        if self.tp is not None:
            x = _sh.CopyToTP.apply(x, self.tp)
        q = apply_rope(self.q_proj(x).view(B, L, H, D), cos, sin)
        k = apply_rope(self.k_proj(x).view(B, L, KV, D), cos, sin)
        v = self.v_proj(x).view(B, L, KV, D)
        if kv_cache is not None:
            # decode: write the new k/v at cache_index (in place), attend to
            # the whole cache
            ck, cv = kv_cache
            ck[:, cache_index:cache_index + L] = k
            cv[:, cache_index:cache_index + L] = v
            k_all, v_all, offset, new_cache = ck, cv, cache_index, (ck, cv)
        else:
            k_all, v_all, offset, new_cache = k, v, 0, None
        if self.kv_index is not None:
            k_all = k_all.index_select(2, self.kv_index)
            v_all = v_all.index_select(2, self.kv_index)
        elif KV != H:
            k_all = k_all.repeat_interleave(H // KV, dim=2)
            v_all = v_all.repeat_interleave(H // KV, dim=2)
        if flash_applies(cfg.use_flash, D, q.dtype, q.device.type,
                         kv_cache is not None, kv_valid is not None):
            out = _fa.flash_attention(q, k_all, v_all)
        else:
            out = reference_attention(q, k_all, v_all, offset, kv_valid)
        out = self.o_proj(out.reshape(B, L, H * D))
        if self.tp is not None:
            out = _sh.ReduceFromTP.apply(out, self.tp)
        return out, new_cache


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        dt, dense = _dtype(cfg), _dense(cfg)
        self.gate_proj = dense(cfg.dim, cfg.intermediate, dt)
        self.up_proj = dense(cfg.dim, cfg.intermediate, dt)
        self.down_proj = dense(cfg.intermediate, cfg.dim, dt)
        self.tp = None

    def forward(self, x):
        if self.tp is None:
            return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        x = _sh.CopyToTP.apply(x, self.tp)
        out = self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        return _sh.ReduceFromTP.apply(out, self.tp)


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.attn = Attention(cfg)
        self.post_attn_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.mlp = MLP(cfg)

    def forward(self, x, cos, sin, kv_cache=None, cache_index=None,
                kv_valid=None):
        attn_out, new_cache = self.attn(self.input_norm(x), cos, sin,
                                        kv_cache, cache_index, kv_valid)
        x = x + attn_out
        x = x + self.mlp(self.post_attn_norm(x))
        return x, new_cache


class LlamaLM(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"LlamaLM: quant {cfg.quant!r} is not 'none' or 'int8'")
        if cfg.dim % cfg.n_heads or cfg.n_heads % cfg.n_kv_heads:
            raise ValueError(f"LlamaLM: dim {cfg.dim}, n_heads {cfg.n_heads} "
                             f"and n_kv_heads {cfg.n_kv_heads} must divide")
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.dim)
        for i in range(cfg.n_layers):
            setattr(self, f"layer_{i}", Block(cfg))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        if not cfg.tie_embeddings:
            self.lm_head = _dense(cfg)(cfg.dim, cfg.vocab_size, torch.float32)
        self.vocab_tp = None    # the tp mesh of a vocabulary-parallel model

    def embed(self, tokens):
        """The token embeddings, float32 (vocabulary-parallel: this rank's
        rows looked up, the others' zero, summed over tp)."""
        if self.vocab_tp is None:
            return self.tok_emb(tokens)
        n = self.tok_emb.weight.shape[0]
        lo = self.vocab_tp.tp_rank * n
        local = (tokens >= lo) & (tokens < lo + n)
        emb = self.tok_emb(torch.where(local, tokens - lo, 0))
        emb = emb * local[..., None]
        return _sh.ReduceFromTP.apply(emb, self.vocab_tp)

    def head_logits(self, x):
        """float32 logits [..., V] of the final hidden states ``x``
        (vocabulary-parallel: this rank's columns, all-gathered)."""
        if self.vocab_tp is not None:
            x = _sh.CopyToTP.apply(x, self.vocab_tp)
        if self.cfg.tie_embeddings:
            logits = x.float() @ self.tok_emb.weight.float().T
        else:
            logits = self.lm_head(x.float())
        if self.vocab_tp is not None:
            logits = _sh.GatherLastFromTP.apply(logits, self.vocab_tp)
        return logits

    def blocks(self) -> List[Block]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_layers)]

    def forward(self, tokens, positions=None, kv_caches=None,
                cache_index: Optional[int] = None, kv_valid=None,
                return_hidden: bool = False):
        """tokens [B, L] -> (logits [B, L, V] float32, caches). With
        ``kv_caches`` (``init_kv_cache``) decodes at ``cache_index``;
        ``kv_valid`` [B, S] masks kv slots; ``return_hidden`` returns the
        final-norm hidden states instead of the logits."""
        cfg = self.cfg
        B, L = tokens.shape
        if positions is None:
            positions = torch.arange(L, device=tokens.device)[None, :].expand(B, L)
            if cache_index is not None:
                positions = positions + cache_index
        x = self.embed(tokens).to(_dtype(cfg))
        cos, sin = rope_frequencies(cfg.head_dim, positions, cfg.rope_theta,
                                    cfg.rope_condense)
        cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        new_caches = []
        remat = cfg.remat and kv_caches is None and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks()):
            if remat:
                # the block's tensors go in explicitly, so the recompute
                # uses the ones in use now (torch.func.functional_call
                # swaps them back before the backward runs)
                x, cache = checkpoint(_call_block, block,
                                      block.state_dict(keep_vars=True), x, cos,
                                      sin, kv_valid, use_reentrant=False)
            else:
                x, cache = block(x, cos, sin,
                                 kv_caches[i] if kv_caches is not None else None,
                                 cache_index, kv_valid)
            new_caches.append(cache)
        x = self.final_norm(x)
        caches = new_caches if kv_caches is not None else None
        if return_hidden:
            return x, caches
        return self.head_logits(x), caches

    def init_kv_cache(self, batch_size: int, max_len: int):
        cfg = self.cfg
        shape = (batch_size, max_len, self.layer_0.attn.n_kv_heads
                 if cfg.n_layers else cfg.n_kv_heads, cfg.head_dim)
        dev = self.tok_emb.weight.device
        return [(torch.zeros(shape, dtype=_dtype(cfg), device=dev),
                 torch.zeros(shape, dtype=_dtype(cfg), device=dev))
                for _ in range(cfg.n_layers)]


def _call_block(block: Block, state, x, cos, sin, kv_valid):
    return torch.func.functional_call(block, state, (x, cos, sin, None, None,
                                                     kv_valid))


def init_llama_(model: LlamaLM, seed: int) -> LlamaLM:
    """Flax's default initialisers, drawn from a generator on the model's
    device: projections lecun-normal (truncated at 2 sigma, fan-in scaled),
    the embedding normal with std 1/sqrt(dim), norm scales 1. (An int8
    model's projections keep zeros: its weights come from
    ``quant.quantize_state_dict``.)"""
    dev = model.tok_emb.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, TLinear):
                nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0, generator=gen)
                m.weight.mul_(math.sqrt(1.0 / m.in_features) / 0.87962566103423978)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, 1.0 / math.sqrt(m.embedding_dim),
                                generator=gen)
            elif isinstance(m, RMSNorm):
                m.scale.fill_(1.0)
    return model


def build_llama(cfg: LlamaConfig, seed: int = 0, device="cuda") -> LlamaLM:
    """LlamaLM with flax-family random weights from ``seed``, float32
    parameters on ``device``."""
    with torch.device(device):
        model = LlamaLM(cfg)
    return init_llama_(model, seed)
