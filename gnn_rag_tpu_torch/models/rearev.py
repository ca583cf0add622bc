"""ReaRev — instruction-conditioned iterative GNN reasoner, forward in eval
and in training mode.

Port of ``gnn_rag_tpu.models.rearev`` (reference: gnn/models/ReaRev/
rearev.py:19-243, gnn/modules/kg_reasoning/reasongnn.py): encode question
-> num_ins instructions -> num_iter outer iterations of (num_gnn GNN steps
from the seed distribution + instruction reformulation) -> masked softmax
answer distribution; KL (or BCE) loss against the answers.

On the kernel-layout path each GNN step projects the relation features of
every fact slot with ``rel_linear{s}`` and runs one gate-scatter launch for
both message directions (``ops.gate_scatter.gate_scatter_both``,
differentiable through its backward kernel); the neighbour features are
interleaved fwd_0, inv_0, fwd_1, ... as the reference does
(reasongnn.py:150-156). The environment variable ``GNN_RAG_GATE_SCATTER``
picks the op as the JAX model does, when the model runs: ``v4`` (the
default) and ``v3`` as above (on the TPU the two differ only in how the
output fits VMEM; they compute the same function); any other value one
``gate_scatter`` launch per direction with the ``rel_linear{s}`` projection
inside the kernel. All of them use the same parameters.

Without a layout (a batch whose ``layout`` is None), or with ``pos_emb``
(its per-relation tables force it, gnn_rag_tpu/models/rearev.py:66), the
steps run the COO path: gathers at each fact's head or tail and index-adds
into its tail or head. ``normalized_gnn`` weighs each fact by its head's
1/out-degree after fact dropout (``ops.degree.head_degree_weight``; on the
layout path the same weight per direction, squared, on the prior).

Options (each as the JAX model takes it; ``models.retriever``): the LSTM
question encoder (``lm lstm``: ``question_emb`` then projects only the
relation texts), an in-model trainable transformer (``lm_frozen 0``), a
frozen KG entity table (``entity_linear``), a frozen KG relation table
(``relation_linear`` / ``relation_linear_inv_proj``, when relation texts are
off), or trainable relation tables (``relation_embedding[_inv]``), and
``norm_rel`` in the TypeLayer.

Training mode (``training=True``) adds the JAX model's dropout: linear
dropout inside the instruction decoder and before ``e2e_linear{s}`` and
``score_func``, LSTM dropout on the word embeddings, and fact dropout as a
keep mask over the canonical facts (self loops always kept) that zeroes
dropped facts' priors through each direction's ``perm`` map. Masks are drawn
from an explicit ``torch.Generator`` on the model's device; ``drop_keep``
passes a fact mask in instead (tests give both packages the same mask).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.degree import head_degree_weight
from ..ops.gate_scatter import gate_scatter, gate_scatter_both
from ..ops.segment import (batched_segment_sum, gather_entities_to_facts,
                           gather_rows, layout_fact_keep,
                           scatter_facts_to_entities)
from ..ops.softmax import masked_softmax
from . import base
from .encoders import AttnEncoder, InstructionDecoder, QueryReform, dropout
from .retriever import COMPUTE_DTYPES, Retriever



class ReasonGNN(nn.Module):
    """One stack of num_gnn reasoning steps (reasongnn.py:11-174).
    ``num_relation_rows``: rows of the ``pos_emb{s}`` tables (num_kb_relation
    + 1)."""

    def __init__(self, entity_dim: int, num_ins: int, num_gnn: int,
                 compute_dtype: str = "float32", dropout: float = 0.0, *,
                 num_relation_rows: int = 0, normalized_gnn: bool = False,
                 pos_emb: bool = False):
        super().__init__()
        D, J = entity_dim, num_ins
        self.entity_dim, self.num_ins, self.num_gnn = D, J, num_gnn
        self.dropout = dropout
        self.normalized_gnn, self.pos_emb = normalized_gnn, pos_emb
        self.cdt = COMPUTE_DTYPES[compute_dtype]
        self.score_func = nn.Linear(D, 1)
        for s in range(num_gnn):
            self.register_parameter(f"rel_linear{s}", nn.Parameter(torch.empty(D, D)))
            self.register_parameter(f"rel_linear{s}_bias", nn.Parameter(torch.empty(D)))
            if pos_emb:   # reasongnn.py:41-43
                self.add_module(f"pos_emb{s}", nn.Embedding(num_relation_rows, D))
                self.add_module(f"pos_emb_inv{s}", nn.Embedding(num_relation_rows, D))
            self.add_module(f"e2e_linear{s}", nn.Linear((1 + 2 * J) * D, D))

    def forward(self, batch, ent_emb: torch.Tensor, curr_dist: torch.Tensor,
                instructions: torch.Tensor, rel_features: torch.Tensor,
                rel_features_inv: torch.Tensor, candidate_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                drop_keep: Optional[torch.Tensor] = None,
                fact_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``generator`` draws the linear-dropout masks (None: eval);
        ``drop_keep`` is the fact-dropout keep mask ``[B, F]`` in canonical
        fact order, or None; ``fact_mask`` the COO path's fact mask with the
        dropout applied (default the batch's)."""
        layout = None if self.pos_emb else batch.layout
        if layout is None:
            return self._coo(batch, ent_emb, curr_dist, instructions,
                             rel_features, rel_features_inv, candidate_mask,
                             generator, batch.fact_mask if fact_mask is None
                             else fact_mask)
        B, E = curr_dist.shape
        J, D = self.num_ins, self.entity_dim
        cdt = self.cdt
        fact_rel_f = gather_rows(rel_features, layout.fwd.rels).to(cdt)  # [B, Fp, D]
        fact_rel_i = gather_rows(rel_features_inv, layout.inv.rels).to(cdt)
        valid_f = (layout.fwd.scatter >= 0).to(curr_dist.dtype)
        valid_i = (layout.inv.scatter >= 0).to(curr_dist.dtype)
        if drop_keep is not None:   # gnn_rag_tpu/models/rearev.py:87-92
            valid_f = valid_f * layout_fact_keep(layout.fwd, drop_keep)
            valid_i = valid_i * layout_fact_keep(layout.inv, drop_keep)
        if self.normalized_gnn:
            # 1/out-degree(gather entity), squared: the reference applies the
            # weight on both the prior and the scatter (base_gnn.py:38-48)
            def w2(direction, valid):
                per = gather_entities_to_facts(
                    batched_segment_sum(valid, direction.gather, E),
                    direction.gather)
                w = torch.where(per > 0, 1.0 / per.clamp_min(1.0), 0.0)
                return w * w * valid
            valid_f, valid_i = w2(layout.fwd, valid_f), w2(layout.inv, valid_i)
        ins_c = instructions.to(cdt)
        # the message-passing op, as the JAX model picks it
        # (gnn_rag_tpu/models/rearev.py:80-82)
        variant = os.environ.get("GNN_RAG_GATE_SCATTER", "v4")
        for step in range(self.num_gnn):
            w = getattr(self, f"rel_linear{step}").to(cdt)
            b = getattr(self, f"rel_linear{step}_bias").to(cdt)
            # the prior of each direction is the current distribution at the
            # fact's gather entity (rearev.py:125-126)
            prior_f = gather_entities_to_facts(curr_dist, layout.fwd.gather) * valid_f
            prior_i = gather_entities_to_facts(curr_dist, layout.inv.gather) * valid_i
            if variant in ("v3", "v4"):   # v3: a TPU schedule of the same op
                out_f, out_i = gate_scatter_both(fact_rel_f @ w + b,
                                                 fact_rel_i @ w + b, ins_c,
                                                 prior_f, prior_i, layout, E)
                neighbors = torch.cat([out_f.reshape(B, E, J, 1, D),
                                       out_i.reshape(B, E, J, 1, D)],
                                      dim=3).reshape(B, E, 2 * J * D)
            else:   # rel_linear inside the kernel
                nb_f = gate_scatter(fact_rel_f, w, b, ins_c, prior_f,
                                    layout.fwd, E)
                nb_i = gate_scatter(fact_rel_i, w, b, ins_c, prior_i,
                                    layout.inv, E)
                # [B, J, E, D] each -> fwd_0, inv_0, fwd_1, ...
                neighbors = torch.stack([nb_f, nb_i], dim=2).permute(
                    0, 3, 1, 2, 4).reshape(B, E, 2 * J * D)
            ent_emb, curr_dist = self._update(step, ent_emb, neighbors,
                                              candidate_mask, generator)
        return curr_dist, ent_emb

    def _update(self, step, ent_emb, neighbors, candidate_mask, generator):
        nxt = torch.cat([ent_emb, neighbors], dim=2)
        ent_emb = torch.relu(getattr(self, f"e2e_linear{step}")(
            dropout(nxt, self.dropout, generator)))
        score = self.score_func(dropout(ent_emb, self.dropout, generator))[..., 0]
        return ent_emb, masked_softmax(score, candidate_mask, dim=1)

    def _coo(self, batch, ent_emb, curr_dist, instructions, rel_features,
             rel_features_inv, candidate_mask, generator, fact_mask):
        """The steps over the COO facts (gnn_rag_tpu/models/rearev.py:
        105-111, 166-189): both directions as gathers and index-adds."""
        B, E = curr_dist.shape
        J, D = self.num_ins, self.entity_dim
        fact_w = (head_degree_weight(batch.heads, fact_mask, E)
                  if self.normalized_gnn else fact_mask)
        fact_rel = gather_rows(rel_features, batch.rels)          # [B, F, D]
        fact_rel_inv = gather_rows(rel_features_inv, batch.rels)
        for step in range(self.num_gnn):
            w = getattr(self, f"rel_linear{step}")
            b = getattr(self, f"rel_linear{step}_bias")
            rl_fwd = fact_rel @ w + b
            rl_inv = fact_rel_inv @ w + b
            if self.pos_emb:   # reasongnn.py:41-43, 74-77
                rl_fwd = rl_fwd + getattr(self, f"pos_emb{step}")(batch.rels.long())
                rl_inv = rl_inv + getattr(self, f"pos_emb_inv{step}")(batch.rels.long())
            # gates relu(rel_linear(rel) * instruction_j) for every j, times
            # the fact priors from the current distribution (reasongnn.py:80,
            # 106), one scatter per direction weighted by fact_w again
            gate_fwd = torch.relu(rl_fwd[:, :, None, :] * instructions[:, None, :, :])
            gate_inv = torch.relu(rl_inv[:, :, None, :] * instructions[:, None, :, :])
            prior_fwd = gather_entities_to_facts(curr_dist, batch.heads) * fact_w
            prior_inv = gather_entities_to_facts(curr_dist, batch.tails) * fact_w
            val_fwd = (gate_fwd * prior_fwd[:, :, None, None]).reshape(B, -1, J * D)
            val_inv = (gate_inv * prior_inv[:, :, None, None]).reshape(B, -1, J * D)
            nb_fwd = scatter_facts_to_entities(val_fwd, batch.tails, E, fact_w)
            nb_inv = scatter_facts_to_entities(val_inv, batch.heads, E, fact_w)
            # reference order: fwd_0, inv_0, ... (reasongnn.py:150-156)
            neighbors = torch.stack([nb_fwd.reshape(B, E, J, D),
                                     nb_inv.reshape(B, E, J, D)],
                                    dim=3).reshape(B, E, 2 * J * D)
            ent_emb, curr_dist = self._update(step, ent_emb, neighbors,
                                              candidate_mask, generator)
        return curr_dist, ent_emb


class ReaRev(Retriever):
    """Full ReaRev model over a GraphBatch (the inputs it is built for:
    ``models.retriever``)."""

    def __init__(self, cfg, num_entity: int, num_relation: int,
                 word_dim: Optional[int] = None, **inputs):
        super().__init__(cfg, num_entity, num_relation, word_dim, **inputs)
        D = cfg.entity_dim
        if self.rel_text:
            self.self_att_r = AttnEncoder(D)
        else:
            din = self.relation_emb_dim
            if din is None:   # trainable tables (rearev.py:95-99)
                din = D
                self.relation_embedding = nn.Embedding(num_relation + 1, D)
                self.relation_embedding_inv = nn.Embedding(num_relation + 1, D)
            self.relation_linear = nn.Linear(din, D)
            self.relation_linear_inv_proj = nn.Linear(din, D)
        self.instruction_decoder = InstructionDecoder(D, cfg.num_ins,
                                                      cfg.linear_dropout)
        self.reasoning = ReasonGNN(D, cfg.num_ins, cfg.num_gnn, cfg.compute_dtype,
                                   cfg.linear_dropout,
                                   num_relation_rows=num_relation + 1,
                                   normalized_gnn=cfg.normalized_gnn,
                                   pos_emb=cfg.pos_emb)
        # the reforms run between outer iterations only (as in flax, no
        # parameters exist for them when num_iter == 1)
        for j in range(cfg.num_ins if cfg.num_iter > 1 else 0):
            self.add_module(f"reform{j}", QueryReform(D))

    def relation_features_both(self, rel_hidden, rel_hidden_inv,
                               rel_text_mask, relation_emb):
        """(rel_features, rel_features_inv), each [R+1, D]
        (rearev.py:91-111)."""
        if self.rel_text:
            return (self.self_att_r(self.question_emb(rel_hidden), rel_text_mask),
                    self.self_att_r(self.question_emb(rel_hidden_inv),
                                    rel_text_mask))
        if relation_emb is not None:
            # the frozen table, one projection per direction (the reference
            # dereferences a relation_embedding_inv it never creates there)
            return (self.relation_linear(relation_emb),
                    self.relation_linear_inv_proj(relation_emb))
        return (self.relation_linear(self.relation_embedding.weight),
                self.relation_linear_inv_proj(self.relation_embedding_inv.weight))

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
        """batch: a GraphBatch of tensors; rel_hidden[_inv]: [R+1, Lr,
        word_dim] frozen-LM relation token states, rel_text_mask: [R+1, Lr];
        the frozen tables the model was built for. Returns (loss, pred_top1,
        pred_dist).

        ``training``: apply linear dropout and fact dropout, with masks drawn
        from ``generator`` (a ``torch.Generator`` on the batch's device,
        needed when a dropout rate is not 0). ``drop_keep`` ``[B, F]``
        overrides the fact-dropout draw (in eval too). ``return_attn`` also
        returns the instruction attention over the question tokens
        ``[B, num_ins, L]`` (the `.info` slots of ``--info_attention``,
        gnn_rag_tpu/models/rearev.py:216-220)."""
        cfg = self.cfg
        generator = self.check_generator(training, generator)
        fact_mask, drop_keep = self.fact_dropout(batch, generator, drop_keep,
                                                 keep_self_loops=True)
        query_hidden, query_node = self.encode_question(batch, word_emb,
                                                        generator)
        rel_features, rel_features_inv = self.relation_features_both(
            rel_hidden, rel_hidden_inv, rel_text_mask, relation_emb)
        instructions, ins_attn = self.instruction_decoder(
            query_hidden, query_node, batch.q_mask, generator)
        ent_emb = self.init_entities(batch, rel_features, entity_emb,
                                     fact_mask, drop_keep)
        candidate_mask = batch.candidate_mask(self.num_entity)

        # iterative reasoning (rearev.py:206-221)
        pred_dist = batch.seed_dist
        for t in range(cfg.num_iter):
            pred_dist, ent_emb = self.reasoning(
                batch, ent_emb, batch.seed_dist, instructions, rel_features,
                rel_features_inv, candidate_mask, generator, drop_keep,
                fact_mask)
            if t < cfg.num_iter - 1:
                instructions = torch.stack(
                    [getattr(self, f"reform{j}")(instructions[:, j, :], ent_emb,
                                                 batch.query_entities)
                     for j in range(cfg.num_ins)], dim=1)

        loss = base.calc_loss_label(pred_dist, batch.answer_dist, cfg.loss_type)
        out = (loss, torch.argmax(pred_dist, dim=1), pred_dist)
        return out + (ins_attn[..., 0],) if return_attn else out
