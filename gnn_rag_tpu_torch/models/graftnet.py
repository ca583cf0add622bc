"""GraftNet — layer-wise GNN with question->fact attention and
personalized-pagerank distribution propagation.

Port of ``gnn_rag_tpu.models.graftnet`` (reference: gnn/models/GraftNet/
graftnet.py:21-183, gnn/modules/kg_reasoning/graft_gnn.py:14-153): the
reference's batched sparse entity2fact / fact2entity matrices are gathers at
the heads and index-adds at the tails of the padded COO facts, plain segment
ops with no kernel (the JAX model calls no Pallas kernel either). Only the
TypeLayer entity init uses the kernel layout, when the batch has one.

Padded fact slots stay out of the attention softmax (masked with -inf, its
normaliser kept at least 1e-10) and out of every scatter through
``fact_mask``. Fact dropout drops self loops too, as the JAX model does;
its keep mask reaches the TypeLayer, the other layers read ``fact_mask``.
The loss is BCE on the last layer's raw scores when ``loss_type`` is
``bce`` (graftnet.py:28, 170), else KL on the answer distribution.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..ops.segment import gather_entities_to_facts, gather_rows, scatter_facts_to_entities
from ..ops.softmax import VERY_NEG_NUMBER, masked_softmax
from . import base
from .encoders import dropout
from .retriever import Retriever

VERY_SMALL_NUMBER = 1e-10


class GraftReasoning(nn.Module):
    """num_layer Graft layers (graft_gnn.py:27-153)."""

    def __init__(self, entity_dim: int, num_layer: int, pagerank_lambda: float,
                 fact_scale: float, dropout: float = 0.0):
        super().__init__()
        D = entity_dim
        self.entity_dim, self.num_layer = D, num_layer
        self.pagerank_lambda, self.fact_scale = pagerank_lambda, fact_scale
        self.dropout = dropout
        self.score_func = nn.Linear(D, 1)
        for s in range(num_layer):
            for name in ("kb_self_linear", "kb_head_linear", "kb_tail_linear",
                         "q2e_linear"):
                self.add_module(f"{name}{s}", nn.Linear(D, D))
            for name in ("e2q_linear", "e2e_linear"):   # over [ent, q2e, f2e]
                self.add_module(f"{name}{s}", nn.Linear(3 * D, D))

    def forward(self, batch, ent_emb, seed_dist, query_hidden, query_node,
                query_mask, rel_features, candidate_mask, fact_mask,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Returns (last layer's raw scores [B, E], each layer's answer
        distribution)."""
        D = self.entity_dim
        B, E = seed_dist.shape
        heads, tails = batch.heads, batch.tails

        def drop(x):
            return dropout(x, self.dropout, generator)

        def lin(name, s, x):
            return getattr(self, f"{name}{s}")(x)

        div = math.sqrt(D)
        local_fact_emb = gather_rows(rel_features, batch.rels)           # [B, F, D]
        # question->fact attention, computed once (graft_gnn.py:64-87)
        sim = torch.einsum("bld,bfd->blf", query_hidden, local_fact_emb) / div
        sim = torch.softmax(
            sim + (1.0 - query_mask[:, :, None]) * VERY_NEG_NUMBER, dim=1)
        fact2query_att = torch.einsum("blf,bld->bfd", sim, query_hidden)
        W = (fact2query_att * local_fact_emb).sum(dim=2) / div          # [B, F]
        kept = fact_mask > 0
        W = torch.where(kept, W, -math.inf)
        W_max = W.amax(dim=1, keepdim=True)
        W_tilde = torch.where(kept, torch.exp(W - W_max), 0.0)
        e2f_softmax = scatter_facts_to_entities(W_tilde[..., None], heads,
                                                E)[..., 0]
        e2f_softmax = e2f_softmax.clamp_min(VERY_SMALL_NUMBER)

        curr_dist = seed_dist
        score_history = []
        score_tp = None
        for s in range(self.num_layer):
            # fact states gated by the attention-normalised distribution
            e2f_emb = torch.relu(
                lin("kb_self_linear", s, local_fact_emb)
                + gather_entities_to_facts(lin("kb_head_linear", s, drop(ent_emb)),
                                           heads))
            e2f_norm = W_tilde * gather_entities_to_facts(
                curr_dist / e2f_softmax, heads)                          # [B, F]
            e2f_emb = e2f_emb * e2f_norm[..., None]
            f2e_emb = torch.relu(
                lin("kb_self_linear", s, ent_emb)
                + scatter_facts_to_entities(lin("kb_tail_linear", s, drop(e2f_emb)),
                                            tails, E, fact_mask))
            next_dist = (self.pagerank_lambda
                         * scatter_facts_to_entities(
                             (e2f_norm * fact_mask)[..., None], tails, E)[..., 0]
                         + (1 - self.pagerank_lambda) * curr_dist)
            q2e_emb = lin("q2e_linear", s, drop(query_node))[:, None, :].expand(B, E, D)
            next_emb = torch.cat([ent_emb, q2e_emb, self.fact_scale * f2e_emb],
                                 dim=2)
            query_node = torch.einsum("be,bed->bd", next_dist,
                                      lin("e2q_linear", s, drop(next_emb)))
            ent_emb = torch.relu(lin("e2e_linear", s, drop(next_emb)))
            score_tp = self.score_func(drop(ent_emb))[..., 0]
            score_history.append(masked_softmax(score_tp, candidate_mask, dim=1))
            curr_dist = next_dist
        return score_tp, score_history


class GraftNet(Retriever):
    """Full GraftNet model over a GraphBatch (the inputs it is built for:
    ``models.retriever``)."""

    def __init__(self, cfg, num_entity: int, num_relation: int,
                 word_dim: Optional[int] = None, **inputs):
        super().__init__(cfg, num_entity, num_relation, word_dim, **inputs)
        D = cfg.entity_dim
        self.init_relation_features()
        self.reasoning = GraftReasoning(D, cfg.num_layer, cfg.pagerank_lambda,
                                        cfg.fact_scale, cfg.linear_dropout)

    def forward(self, batch, rel_hidden: Optional[torch.Tensor] = None,
                rel_hidden_inv: Optional[torch.Tensor] = None,
                rel_text_mask: Optional[torch.Tensor] = None,
                entity_emb: Optional[torch.Tensor] = None,
                word_emb: Optional[torch.Tensor] = None,
                relation_emb: Optional[torch.Tensor] = None, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                drop_keep: Optional[torch.Tensor] = None,
                return_attn: bool = False) -> Tuple[torch.Tensor, ...]:
        """As ``ReaRev.forward`` (``rel_hidden_inv`` is not read); GraftNet
        has no instruction attention, so ``return_attn`` raises (the
        reference's GraftNet returns tp_list=None too)."""
        if return_attn:
            raise ValueError("GraftNet has no instruction attention to export")
        cfg = self.cfg
        generator = self.check_generator(training, generator)
        fact_mask, drop_keep = self.fact_dropout(batch, generator, drop_keep,
                                                 keep_self_loops=False)
        query_hidden, query_node = self.encode_question(batch, word_emb,
                                                        generator)
        rel_features = self.relation_features(rel_hidden, rel_text_mask,
                                              relation_emb)
        ent_emb = self.init_entities(batch, rel_features, entity_emb,
                                     fact_mask, drop_keep)
        candidate_mask = batch.candidate_mask(self.num_entity)
        score_tp, score_history = self.reasoning(
            batch, ent_emb, batch.seed_dist, query_hidden, query_node,
            batch.q_mask, rel_features, candidate_mask, fact_mask, generator)
        pred_dist = score_history[-1]
        loss = base.calc_loss_label(
            score_tp if cfg.loss_type == "bce" else pred_dist,
            batch.answer_dist, cfg.loss_type)
        return loss, torch.argmax(pred_dist, dim=1), pred_dist
