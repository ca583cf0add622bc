"""NN modules of the retrievers: attention pooling, gated fusion, query
reformulation, relation-typed entity init, instruction generation and the
question encoders (LSTM, transformer).

Ports of ``gnn_rag_tpu.models.encoders`` (reference: gnn/modules/
query_update.py:6-61, layer_init.py:25-62, question_encoding/*). Submodule
and parameter names follow the flax modules so that ``bridge`` maps flax
parameter trees by name. Parameters that flax creates with ``self.param``
keep flax's ``[in, out]`` layout; ``nn.Linear`` weights are ``[out, in]``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gate_scatter import gate_scatter_both
from ..ops.segment import (gather_rows, layout_fact_keep,
                           scatter_facts_to_entities)
from ..ops.softmax import VERY_NEG_NUMBER

LN_EPS = 1e-6   # flax.linen.LayerNorm default (torch's is 1e-5)


class RowShard:
    """A dropout generator for a process that holds rows ``index * rows`` to
    ``(index + 1) * rows`` of a batch of ``parts * rows``: each mask over
    this process's rows is drawn for the whole batch and sliced, so the
    processes of a data-parallel run draw the masks of one process
    (``parallel.mesh``); a mask whose first axis is not ``rows`` is drawn
    whole."""

    def __init__(self, generator: torch.Generator, parts: int, index: int,
                 rows: int):
        self.generator, self.parts, self.index, self.rows = (
            generator, parts, index, rows)


def bernoulli_keep(shape, keep_prob: float, generator, device) -> torch.Tensor:
    """A float 0/1 mask of ``shape``, 1 with probability ``keep_prob``,
    drawn from ``generator`` (a ``torch.Generator`` or a ``RowShard``)."""
    if isinstance(generator, RowShard) and shape[0] == generator.rows:
        full = (generator.rows * generator.parts,) + tuple(shape[1:])
        lo = generator.index * generator.rows
        return torch.empty(full, device=device).bernoulli_(
            keep_prob, generator=generator.generator)[lo:lo + generator.rows]
    if isinstance(generator, RowShard):
        generator = generator.generator
    return torch.empty(shape, device=device).bernoulli_(keep_prob,
                                                        generator=generator)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``, the mask drawn from
    ``generator`` (on ``x``'s device; ``bernoulli_keep``). The identity when
    ``generator`` is None (eval) or ``rate`` is 0."""
    if generator is None or rate == 0.0:
        return x
    keep = bernoulli_keep(x.shape, 1.0 - rate, generator, x.device)
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0)


def flax_like_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter with flax's default families, drawn from
    ``generator``: lecun_normal (truncated at 2 sigma, fan-in scaled) for
    dense kernels, zeros for biases, flax's embedding init (normal with std
    1/sqrt(features)) for embeddings, ones/zeros for LayerNorm, and
    ``OptimizedLSTMCell``'s for an ``nn.LSTM``: lecun_normal input kernels,
    an orthogonal recurrent kernel for each gate, zero bias."""
    def lecun_(w: torch.Tensor, fan_in: int):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(std)

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.LSTM):
                lecun_(m.weight_ih_l0, m.input_size)
                for gate in m.weight_hh_l0.chunk(4, dim=0):
                    nn.init.orthogonal_(gate, generator=generator)
                m.bias_hh_l0.zero_()
                continue
            if isinstance(m, nn.Linear):
                lecun_(m.weight, m.in_features)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, 1.0 / math.sqrt(m.embedding_dim),
                                generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            for name, p in m.named_parameters(recurse=False):
                if isinstance(m, (nn.Linear, nn.Embedding, nn.LayerNorm)):
                    continue
                if name.endswith("_bias") or p.dim() == 1:
                    p.zero_()
                else:                       # [in, out] kernel
                    lecun_(p, p.shape[0])
    return module


class AttnEncoder(nn.Module):
    """Masked attention pooling over a token axis (query_update.py:46-61)."""

    def __init__(self, d_hid: int):
        super().__init__()
        self.attn_linear = nn.Linear(d_hid, 1, bias=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # x: [..., L, D]; mask: [..., L]
        attn = self.attn_linear(x)
        attn = attn - (1.0 - mask[..., None]) * 1e8      # ref uses 1e8 here
        attn = torch.softmax(attn, dim=-2)
        return (x * attn).sum(dim=-2)


class Fusion(nn.Module):
    """Gated residual fusion (query_update.py:6-16)."""

    def __init__(self, d_hid: int):
        super().__init__()
        self.r = nn.Linear(3 * d_hid, d_hid, bias=False)
        self.g = nn.Linear(3 * d_hid, d_hid, bias=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        cat = torch.cat([x, y, x - y], dim=-1)
        g = torch.sigmoid(self.g(cat))
        return g * self.r(cat) + (1.0 - g) * x


class QueryReform(nn.Module):
    """Instruction reformulation from the seed entities' GNN state
    (query_update.py:18-44; only the seed-retrieve branch feeds the output)."""

    def __init__(self, h_dim: int):
        super().__init__()
        self.fusion = Fusion(h_dim)

    def forward(self, q_node: torch.Tensor, ent_emb: torch.Tensor,
                seed_info: torch.Tensor) -> torch.Tensor:
        # q_node: [B, D]; ent_emb: [B, E, D]; seed_info: [B, E]
        seed_retrieve = torch.einsum("be,bed->bd", seed_info, ent_emb)
        return self.fusion(q_node, seed_retrieve)


class TypeLayer(nn.Module):
    """Entity init from incident relation types (layer_init.py:25-62):
    relu(scatter_tails(W r + b) + scatter_heads(W r + b)), each fact
    weighted by its mask, or with ``norm_rel`` by its 1/count(head, rel)
    weight too. With a kernel layout both directions run in one gate-scatter
    launch (unit instructions, no relu inside; with ``norm_rel`` the
    layout's ``weight`` is the prior); without one, as index-adds over the
    COO facts."""

    def __init__(self, din: int, entity_dim: int, norm_rel: bool = False):
        super().__init__()
        self.norm_rel = norm_rel
        self.kb_self_linear = nn.Parameter(torch.empty(din, entity_dim))
        self.kb_self_linear_bias = nn.Parameter(torch.empty(entity_dim))

    def forward(self, rel_features: torch.Tensor, layout, num_entities: int,
                drop_keep: Optional[torch.Tensor] = None, *, batch=None,
                fact_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``drop_keep``: the fact-dropout keep mask ``[B, F]`` in canonical
        fact order, or None; a dropped fact gets a zero prior. With ``layout``
        None, the COO path over ``batch``'s heads, rels and tails with
        ``fact_mask`` (default the batch's; dropout already applied)."""
        D = self.kb_self_linear.shape[1]
        rl_tab = rel_features @ self.kb_self_linear + self.kb_self_linear_bias
        if layout is None:
            fact_val = gather_rows(rl_tab, batch.rels)
            wgt = batch.fact_mask if fact_mask is None else fact_mask
            if self.norm_rel and batch.fact_rel_weight is not None:
                wgt = wgt * batch.fact_rel_weight
            return torch.relu(
                scatter_facts_to_entities(fact_val, batch.tails, num_entities, wgt)
                + scatter_facts_to_entities(fact_val, batch.heads, num_entities,
                                            wgt))
        B = layout.fwd.rels.shape[0]
        ones_ins = torch.ones((B, 1, D), dtype=rl_tab.dtype, device=rl_tab.device)

        def prior(direction):
            p = (direction.weight if self.norm_rel
                 else (direction.scatter >= 0).to(rl_tab.dtype))
            if drop_keep is not None:
                p = p * layout_fact_keep(direction, drop_keep)
            return p

        out_f, out_i = gate_scatter_both(
            gather_rows(rl_tab, layout.fwd.rels),
            gather_rows(rl_tab, layout.inv.rels), ones_ins, prior(layout.fwd),
            prior(layout.inv), layout, num_entities, apply_relu=False)
        return torch.relu(out_f + out_i)


class InstructionDecoder(nn.Module):
    """Instruction-attention decoder (base_encoder.py:82-101): num_ins
    instruction vectors by iterated attention over the question tokens, each
    conditioned on the previous instruction."""

    def __init__(self, entity_dim: int, num_ins: int, dropout: float = 0.0):
        super().__init__()
        self.num_ins = num_ins
        self.dropout = dropout
        self.cq_linear = nn.Linear(4 * entity_dim, entity_dim)
        self.ca_linear = nn.Linear(entity_dim, 1)
        for i in range(num_ins):
            self.add_module(f"question_linear{i}", nn.Linear(entity_dim, entity_dim))

    def forward(self, query_hidden: torch.Tensor, query_node: torch.Tensor,
                query_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """query_hidden: [B, L, D]; query_node: [B, D]; query_mask: [B, L];
        ``generator`` draws the dropout masks in training (None: eval)."""
        def drop(x):
            return dropout(x, self.dropout, generator)

        ins = torch.zeros_like(query_node)
        instructions, attns = [], []
        for i in range(self.num_ins):
            q_i = getattr(self, f"question_linear{i}")(drop(query_node))
            cq = self.cq_linear(drop(torch.cat([ins, q_i, q_i - ins, q_i * ins],
                                               dim=-1)))
            ca = self.ca_linear(drop(cq[:, None, :] * query_hidden))  # [B, L, 1]
            attn = torch.softmax(
                ca + (1.0 - query_mask[..., None]) * VERY_NEG_NUMBER, dim=1)
            ins = (attn * query_hidden).sum(dim=1)
            instructions.append(ins)
            attns.append(attn)
        return torch.stack(instructions, dim=1), torch.stack(attns, dim=1)


class LSTMQuestionEncoder(nn.Module):
    """Single-layer unidirectional LSTM over word embeddings
    (lstm_encoder.py:25-46): the per-token hidden states and, as the query
    node, the state at the last position, pads included, as the flax module
    takes it (``hidden[:, -1, :]``, not the last real token).

    ``nn.LSTM`` (cuDNN on the card) in flax's ``OptimizedLSTMCell`` form:
    gates i, f, g, o from ``x @ W_ih^T + h @ W_hh^T + b_hh``. Flax has no
    input bias, so ``bias_ih_l0`` is a zero buffer: no optimizer moves it and
    no state_dict holds it. The words come from ``word_embedding`` or, with
    ``pretrained_dim`` set, from a frozen table given to ``forward``
    (e.g. GloVe, base_model.py:79-89), ids clamped to its last row."""

    def __init__(self, entity_dim: int, num_word: int, word_dim: int,
                 dropout: float = 0.0, pretrained_dim: Optional[int] = None):
        super().__init__()
        self.dropout = dropout
        if pretrained_dim is None:
            self.word_embedding = nn.Embedding(num_word + 1, word_dim)
        self.lstm = nn.LSTM(word_dim if pretrained_dim is None else pretrained_dim,
                            entity_dim, batch_first=True)
        del self.lstm.bias_ih_l0
        self.lstm.register_buffer("bias_ih_l0", torch.zeros(4 * entity_dim),
                                  persistent=False)
        self.lstm._init_flat_weights()

    def forward(self, tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                pretrained: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, L] -> (hidden [B, L, D], node [B, D]); ``generator``
        draws the dropout mask on the embeddings (None: eval)."""
        tokens = tokens.long()
        if pretrained is not None:
            emb = pretrained[tokens.clamp(max=pretrained.shape[0] - 1)]
        else:
            emb = self.word_embedding(tokens)
        # the models run in eval mode and train through their ``training``
        # argument; cuDNN's RNN backward needs the module's training flag
        # (one layer: the flag changes nothing else), so it follows autograd
        self.lstm.training = torch.is_grad_enabled()
        hidden, _ = self.lstm(dropout(emb, self.dropout, generator))
        return hidden, hidden[:, -1, :]


class TransformerQuestionEncoder(nn.Module):
    """BERT-style encoder (embeddings + post-LN blocks) with the flax
    module's widths and numerics: LayerNorm eps 1e-6, exact GELU, additive
    mask bias ``(1 - mask) * VERY_NEG_NUMBER``, positions clamped to
    ``max_len - 1``: BERT's ``0..L-1``, or with ``position_style="roberta"``
    the pad-aware ``cumsum(mask) * mask + pad_idx`` (HF roberta's
    create_position_ids_from_input_ids). ``q_/k_/v_`` are ``[hidden,
    hidden]`` linears holding the flax ``[hidden, heads, head_dim]``
    DenseGeneral kernels."""

    def __init__(self, vocab_size: int = 30522, hidden: int = 384,
                 layers: int = 6, heads: int = 12, intermediate: int = 1536,
                 max_len: int = 512, position_style: str = "bert",
                 pad_idx: int = 0):
        super().__init__()
        self.vocab_size, self.intermediate = vocab_size, intermediate
        self.hidden, self.layers, self.heads = hidden, layers, heads
        self.max_len = max_len
        self.position_style, self.pad_idx = position_style, pad_idx
        self.tok_emb = nn.Embedding(vocab_size, hidden)
        self.pos_emb = nn.Embedding(max_len, hidden)
        self.type_emb = nn.Parameter(torch.empty(hidden))
        self.emb_ln = nn.LayerNorm(hidden, eps=LN_EPS)
        for i in range(layers):
            for name in ("q", "k", "v", "attn_out"):
                self.add_module(f"{name}_{i}", nn.Linear(hidden, hidden))
            self.add_module(f"ln1_{i}", nn.LayerNorm(hidden, eps=LN_EPS))
            self.add_module(f"ffn1_{i}", nn.Linear(hidden, intermediate))
            self.add_module(f"ffn2_{i}", nn.Linear(intermediate, hidden))
            self.add_module(f"ln2_{i}", nn.LayerNorm(hidden, eps=LN_EPS))

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L = tokens.shape
        H, hd = self.heads, self.hidden // self.heads
        if self.position_style == "roberta":
            m = mask.long()
            pos = torch.cumsum(m, dim=1) * m + self.pad_idx
        else:
            pos = torch.arange(L, device=tokens.device)[None].expand(B, L)
        pos = pos.clamp(max=self.max_len - 1)
        x = self.tok_emb(tokens.long()) + self.pos_emb(pos) + self.type_emb
        x = self.emb_ln(x)
        bias = (1.0 - mask[:, None, None, :]) * VERY_NEG_NUMBER
        for i in range(self.layers):
            lyr = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            q = lyr("q")(x).reshape(B, L, H, hd)
            k = lyr("k")(x).reshape(B, L, H, hd)
            v = lyr("v")(x).reshape(B, L, H, hd)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            probs = torch.softmax(scores + bias, dim=-1)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, self.hidden)
            x = lyr("ln1")(x + lyr("attn_out")(ctx))
            h = lyr("ffn2")(F.gelu(lyr("ffn1")(x), approximate="none"))
            x = lyr("ln2")(x + h)
        return x


def make_inmodel_lm(cfg) -> TransformerQuestionEncoder:
    """The in-model trainable question encoder of ``lm_frozen=0``
    (bert_encoder.py:80-83). ``cfg.lm_spec`` (the CLI pins it from the
    loaded encoder) fixes vocab, layers, heads, intermediate and positions,
    so ``Trainer.seed_submodule`` always matches; None keeps MiniLM-class
    widths at ``cfg.word_dim_effective``."""
    if cfg.lm_spec is None:
        return TransformerQuestionEncoder(hidden=cfg.word_dim_effective)
    (vocab, hidden, layers, heads, intermediate, max_len,
     position_style, pad_idx) = cfg.lm_spec
    return TransformerQuestionEncoder(
        vocab_size=vocab, hidden=hidden, layers=layers, heads=heads,
        intermediate=intermediate, max_len=max_len,
        position_style=position_style, pad_idx=pad_idx)
