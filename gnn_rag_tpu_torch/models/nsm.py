"""NSM — sequential instruction-per-step GNN reasoner.

Port of ``gnn_rag_tpu.models.nsm`` (reference: gnn/models/NSM/nsm.py:19-254,
gnn/modules/kg_reasoning/nsm_gnn.py):

* num_step reasoning steps, ONE instruction each, forward message direction
  only (nsm_gnn.py:87-112);
* optional ``reason_kb`` candidate restriction: the softmax support shrinks
  to entities reachable from the current distribution (possible_tail,
  nsm_gnn.py:101-103);
* optional backward teacher (``lambda_back`` / ``lambda_constrain``): reasons
  from the normalised answer distribution with the instructions reversed,
  over the inverse direction, adding a KL term and a JS-divergence
  consistency loss (nsm.py:142-170, 227-246). The reference's backward layer
  reads a ``rel_features_inv`` that default flags never initialise; the JAX
  package, and so this port, uses the one relation table in both directions
  (a documented deviation).

On the kernel-layout path each step is one gate-scatter launch of one
direction with J = 1 (``ops.gate_scatter.gate_scatter_projected``: the
forward kernel K4f, its backward K4b); the teacher runs on ``layout.inv``.
Without a layout (``batch.layout`` None) the steps gather and index-add over
the COO facts.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..ops.gate_scatter import gate_scatter_projected
from ..ops.segment import (batched_segment_sum, gather_entities_to_facts,
                           gather_rows, layout_fact_keep,
                           scatter_facts_to_entities)
from ..ops.softmax import masked_softmax
from . import base
from .encoders import InstructionDecoder, dropout
from .retriever import Retriever

VERY_SMALL_NUMBER = 1e-10


class NSMReasoning(nn.Module):
    """num_step NSM layers (nsm_gnn.py:14-112); ``backward=True`` swaps the
    message direction (NSMLayer_back, nsm_gnn.py:114-142)."""

    def __init__(self, entity_dim: int, num_step: int, reason_kb: bool = False,
                 dropout: float = 0.0, backward: bool = False):
        super().__init__()
        D = entity_dim
        self.num_step, self.reason_kb = num_step, reason_kb
        self.dropout, self.backward = dropout, backward
        self.score_func = nn.Linear(D, 1)
        for s in range(num_step):
            self.register_parameter(f"rel_linear{s}", nn.Parameter(torch.empty(D, D)))
            self.register_parameter(f"rel_linear{s}_bias", nn.Parameter(torch.empty(D)))
            self.add_module(f"e2e_linear{s}", nn.Linear(2 * D, D))

    def forward(self, batch, ent_emb: torch.Tensor, seed_dist: torch.Tensor,
                instructions: torch.Tensor, rel_features: torch.Tensor,
                candidate_mask: torch.Tensor, fact_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                drop_keep: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Runs every step; returns (distribution history, ent_emb), the
        history starting with ``seed_dist``."""
        E = seed_dist.shape[1]
        layout = batch.layout
        if layout is not None:
            direction = layout.inv if self.backward else layout.fwd
            valid = (direction.scatter >= 0).to(seed_dist.dtype)
            if drop_keep is not None:   # fact dropout on the layout path
                valid = valid * layout_fact_keep(direction, drop_keep)
            fact_rel = gather_rows(rel_features, direction.rels)    # [B, Fp, D]
            # padded slots (prior 0) add to row 0 (nsm.py:90-91)
            scatter0 = direction.scatter.clamp_min(0)
        else:
            src, dst = ((batch.tails, batch.heads) if self.backward
                        else (batch.heads, batch.tails))
            fact_rel = gather_rows(rel_features, batch.rels)        # [B, F, D]

        curr_dist = seed_dist
        history = [curr_dist]
        for step in range(self.num_step):
            ins = instructions[:, step, :]
            w = getattr(self, f"rel_linear{step}")
            b = getattr(self, f"rel_linear{step}_bias")
            if layout is not None:
                prior = gather_entities_to_facts(curr_dist, direction.gather) * valid
                neighbor = gate_scatter_projected(fact_rel @ w + b, ins[:, None, :],
                                                  prior, direction, E)[:, 0]
                possible = (batched_segment_sum(prior, scatter0, E)
                            if self.reason_kb else None)
            else:
                gate = torch.relu((fact_rel @ w + b) * ins[:, None, :])
                prior = gather_entities_to_facts(curr_dist, src) * fact_mask
                neighbor = scatter_facts_to_entities(gate * prior[..., None],
                                                     dst, E, fact_mask)
                possible = (batched_segment_sum(prior * fact_mask, dst, E)
                            if self.reason_kb else None)
            nxt = torch.cat([ent_emb, neighbor], dim=2)
            ent_emb = torch.relu(getattr(self, f"e2e_linear{step}")(
                dropout(nxt, self.dropout, generator)))
            score = self.score_func(dropout(ent_emb, self.dropout, generator))[..., 0]
            mask = candidate_mask
            if self.reason_kb:
                mask = mask * (possible > VERY_SMALL_NUMBER).to(mask.dtype)
            curr_dist = masked_softmax(score, mask, dim=1)
            history.append(curr_dist)
        return history, ent_emb


class NSM(Retriever):
    """Full NSM model over a GraphBatch (the inputs it is built for:
    ``models.retriever``)."""

    def __init__(self, cfg, num_entity: int, num_relation: int,
                 word_dim: Optional[int] = None, **inputs):
        super().__init__(cfg, num_entity, num_relation, word_dim, **inputs)
        D = cfg.entity_dim
        self.init_relation_features()
        self.instruction_decoder = InstructionDecoder(D, cfg.num_step,
                                                      cfg.linear_dropout)
        self.reasoning = NSMReasoning(D, cfg.num_step, cfg.reason_kb,
                                      cfg.linear_dropout)
        if cfg.lambda_back != 0.0 or cfg.lambda_constrain != 0.0:
            self.reasoning_back = NSMReasoning(D, cfg.num_step, cfg.reason_kb,
                                               cfg.linear_dropout, backward=True)

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
        """As ``ReaRev.forward`` (``rel_hidden_inv`` is not read). Returns
        (loss, pred_top1, pred_dist)[, instruction attention [B, num_step,
        L]: one instruction a step, so each row is its `.info` slot]."""
        cfg = self.cfg
        generator = self.check_generator(training, generator)
        fact_mask, drop_keep = self.fact_dropout(batch, generator, drop_keep,
                                                 keep_self_loops=True)
        query_hidden, query_node = self.encode_question(batch, word_emb,
                                                        generator)
        rel_features = self.relation_features(rel_hidden, rel_text_mask,
                                              relation_emb)
        instructions, ins_attn = self.instruction_decoder(
            query_hidden, query_node, batch.q_mask, generator)
        ent_emb = self.init_entities(batch, rel_features, entity_emb,
                                     fact_mask, drop_keep)
        candidate_mask = batch.candidate_mask(self.num_entity)
        history, _ = self.reasoning(batch, ent_emb, batch.seed_dist,
                                    instructions, rel_features, candidate_mask,
                                    fact_mask, generator, drop_keep)
        pred_dist = history[-1]
        loss = base.calc_loss_label(pred_dist, batch.answer_dist, cfg.loss_type)

        if hasattr(self, "reasoning_back"):   # the teacher (nsm.py:219-246)
            answer_len = batch.answer_dist.sum(dim=1, keepdim=True)
            answer_prob = batch.answer_dist / torch.where(
                answer_len == 0, torch.ones_like(answer_len), answer_len)
            back_history, _ = self.reasoning_back(
                batch, ent_emb, answer_prob, instructions.flip(1), rel_features,
                candidate_mask, fact_mask, generator, drop_keep)
            case_valid = (answer_len > 0).to(pred_dist.dtype)
            # the reference pairing (nsm.py:151-170): i = 0 compares the
            # backward chain's start (the answer distribution itself) with
            # the seed distribution
            back_loss = base.masked_mean_loss(
                base.kl_loss_vec(back_history[0], history[0]), case_valid)
            constrain_loss = 0.0
            for i in range(1, cfg.num_step):
                constrain_loss = constrain_loss + base.masked_mean_loss(
                    base.js_div_vec(history[i], back_history[i]), case_valid)
            loss = (loss + cfg.lambda_back * back_loss
                    + cfg.lambda_constrain * constrain_loss)

        out = (loss, torch.argmax(pred_dist, dim=1), pred_dist)
        return out + (ins_attn[..., 0],) if return_attn else out
