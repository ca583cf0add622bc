"""ReaRev — instruction-conditioned iterative GNN reasoner, forward in eval
and in training mode.

Port of ``gnn_rag_tpu.models.rearev`` (reference: gnn/models/ReaRev/
rearev.py:19-243, gnn/modules/kg_reasoning/reasongnn.py) on the kernel-layout
path: encode question -> num_ins instructions -> num_iter outer iterations of
(num_gnn GNN steps from the seed distribution + instruction reformulation)
-> masked softmax answer distribution; KL loss against the answers.

Each GNN step projects the relation features of every fact slot with
``rel_linear{s}`` and runs one gate-scatter launch for both message
directions (``ops.gate_scatter.gate_scatter_both``, differentiable through
its backward kernel); the neighbour features are interleaved fwd_0, inv_0,
fwd_1, ... as the reference does (reasongnn.py:150-156). The environment
variable ``GNN_RAG_GATE_SCATTER`` picks the op as the JAX model does, when
the model runs: ``v4`` (the default) and ``v3`` as above (on the TPU the two
differ only in how the output fits VMEM; they compute the same function);
any other value one ``gate_scatter`` launch per direction with the
``rel_linear{s}`` projection inside the kernel. All of them use the same
parameters.

Training mode (``training=True``) adds the JAX model's dropout: linear
dropout inside the instruction decoder and before ``e2e_linear{s}`` and
``score_func``, and fact dropout as a keep mask over the canonical facts
(self loops always kept) that zeroes dropped facts' priors through each
direction's ``perm`` map. Masks are drawn from an explicit
``torch.Generator`` on the model's device; ``drop_keep`` passes a fact mask
in instead (tests give both packages the same mask).

Only the configuration of the WebQSP/CWQ ReaRev runs (frozen LM with
relation texts, layout path); every other option raises
``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.gate_scatter import gate_scatter, gate_scatter_both
from ..ops.segment import (gather_entities_to_facts, gather_rows,
                           layout_fact_keep)
from ..ops.softmax import masked_softmax
from . import base
from .encoders import (AttnEncoder, InstructionDecoder, QueryReform, TypeLayer,
                       dropout, flax_like_init_)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ReasonGNN(nn.Module):
    """One stack of num_gnn reasoning steps (reasongnn.py:11-174)."""

    def __init__(self, entity_dim: int, num_ins: int, num_gnn: int,
                 compute_dtype: str = "float32", dropout: float = 0.0):
        super().__init__()
        D, J = entity_dim, num_ins
        self.entity_dim, self.num_ins, self.num_gnn = D, J, num_gnn
        self.dropout = dropout
        self.cdt = _DTYPES[compute_dtype]
        self.score_func = nn.Linear(D, 1)
        for s in range(num_gnn):
            self.register_parameter(f"rel_linear{s}", nn.Parameter(torch.empty(D, D)))
            self.register_parameter(f"rel_linear{s}_bias", nn.Parameter(torch.empty(D)))
            self.add_module(f"e2e_linear{s}", nn.Linear((1 + 2 * J) * D, D))

    def forward(self, batch, ent_emb: torch.Tensor, curr_dist: torch.Tensor,
                instructions: torch.Tensor, rel_features: torch.Tensor,
                rel_features_inv: torch.Tensor, candidate_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                drop_keep: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``generator`` draws the linear-dropout masks (None: eval);
        ``drop_keep`` is the fact-dropout keep mask ``[B, F]`` in canonical
        fact order, or None."""
        B, E = curr_dist.shape
        J, D = self.num_ins, self.entity_dim
        layout = batch.layout
        cdt = self.cdt
        fact_rel_f = gather_rows(rel_features, layout.fwd.rels).to(cdt)  # [B, Fp, D]
        fact_rel_i = gather_rows(rel_features_inv, layout.inv.rels).to(cdt)
        valid_f = (layout.fwd.scatter >= 0).to(curr_dist.dtype)
        valid_i = (layout.inv.scatter >= 0).to(curr_dist.dtype)
        if drop_keep is not None:   # gnn_rag_tpu/models/rearev.py:87-92
            valid_f = valid_f * layout_fact_keep(layout.fwd, drop_keep)
            valid_i = valid_i * layout_fact_keep(layout.inv, drop_keep)
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
            nxt = torch.cat([ent_emb, neighbors], dim=2)
            ent_emb = torch.relu(getattr(self, f"e2e_linear{step}")(
                dropout(nxt, self.dropout, generator)))
            score = self.score_func(dropout(ent_emb, self.dropout, generator))[..., 0]
            curr_dist = masked_softmax(score, candidate_mask, dim=1)
        return curr_dist, ent_emb


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for any model option outside the ported
    configuration (ReaRev, frozen transformer LM with relation texts, layout
    path, KL/BCE loss)."""
    unsupported = {
        "model_name != ReaRev": cfg.model_name != "ReaRev",
        "lm lstm": cfg.lm == "lstm",
        "lm_frozen 0": not cfg.lm_frozen,
        "pos_emb": cfg.pos_emb,
        "norm_rel": cfg.norm_rel,
        "normalized_gnn": cfg.normalized_gnn,
        f"compute_dtype {cfg.compute_dtype}": cfg.compute_dtype not in _DTYPES,
        f"loss_type {cfg.loss_type}": cfg.loss_type not in ("kl", "bce"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"gnn_rag_tpu_torch runs the ReaRev WebQSP/CWQ configuration only; "
            f"not ported: {', '.join(bad)}")


class ReaRev(nn.Module):
    """Full ReaRev model over a GraphBatch."""

    def __init__(self, cfg, num_entity: int, num_relation: int, word_dim: int):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.num_entity = num_entity
        self.num_relation = num_relation   # num_kb_relation
        D = cfg.entity_dim
        self.question_emb = nn.Linear(word_dim, D)         # bert_encoder.py:69
        self.self_att_r = AttnEncoder(D)
        self.instruction_decoder = InstructionDecoder(D, cfg.num_ins,
                                                      cfg.linear_dropout)
        self.type_layer = TypeLayer(D, D)
        self.reasoning = ReasonGNN(D, cfg.num_ins, cfg.num_gnn, cfg.compute_dtype,
                                   cfg.linear_dropout)
        # the reforms run between outer iterations only (as in flax, no
        # parameters exist for them when num_iter == 1)
        for j in range(cfg.num_ins if cfg.num_iter > 1 else 0):
            self.add_module(f"reform{j}", QueryReform(D))

    def forward(self, batch, rel_hidden: torch.Tensor,
                rel_hidden_inv: torch.Tensor, rel_text_mask: torch.Tensor, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                drop_keep: Optional[torch.Tensor] = None,
                return_attn: bool = False) -> Tuple[torch.Tensor, ...]:
        """batch: a GraphBatch of tensors with ``q_hidden`` and ``layout``;
        rel_hidden[_inv]: [R+1, Lr, word_dim] frozen-LM relation token
        states, rel_text_mask: [R+1, Lr]. Returns (loss, pred_top1, pred_dist).

        ``training``: apply linear dropout and fact dropout, with masks drawn
        from ``generator`` (a ``torch.Generator`` on the batch's device,
        needed when a dropout rate is not 0). ``drop_keep`` ``[B, F]``
        overrides the fact-dropout draw (in eval too). ``return_attn`` also
        returns the instruction attention over the question tokens
        ``[B, num_ins, L]`` (the `.info` slots of ``--info_attention``,
        gnn_rag_tpu/models/rearev.py:216-220)."""
        cfg = self.cfg
        if batch.q_hidden is None or batch.layout is None:
            raise NotImplementedError("ReaRev needs precomputed q_hidden (frozen "
                                      "LM) and the kernel layout")
        E = batch.seed_dist.shape[1]
        if not training:
            generator = None
        elif generator is None and (cfg.linear_dropout > 0 or cfg.fact_drop > 0):
            raise ValueError("ReaRev training with dropout needs a generator")
        if drop_keep is None and generator is not None and cfg.fact_drop > 0:
            # fact dropout (dataset_load.py:489-490); self loops, appended
            # after dropout in the reference, are never dropped
            keep = torch.empty(batch.fact_mask.shape,
                               device=batch.fact_mask.device).bernoulli_(
                1.0 - cfg.fact_drop, generator=generator)
            drop_keep = torch.where(batch.rels == self.num_relation - 1, 1.0, keep)

        # question encoding: projected frozen-LM states, CLS as the node
        # (bert_encoder.py:102-104)
        query_hidden = self.question_emb(batch.q_hidden)
        query_node = self.question_emb(batch.q_hidden[:, 0, :])

        # relation features (rearev.py:91-111)
        rel_features = self.self_att_r(self.question_emb(rel_hidden), rel_text_mask)
        rel_features_inv = self.self_att_r(self.question_emb(rel_hidden_inv),
                                           rel_text_mask)

        instructions, ins_attn = self.instruction_decoder(
            query_hidden, query_node, batch.q_mask, generator)
        ent_emb = self.type_layer(rel_features, batch.layout, E, drop_keep)
        candidate_mask = batch.candidate_mask(self.num_entity)

        # iterative reasoning (rearev.py:206-221)
        pred_dist = batch.seed_dist
        for t in range(cfg.num_iter):
            pred_dist, ent_emb = self.reasoning(
                batch, ent_emb, batch.seed_dist, instructions, rel_features,
                rel_features_inv, candidate_mask, generator, drop_keep)
            if t < cfg.num_iter - 1:
                instructions = torch.stack(
                    [getattr(self, f"reform{j}")(instructions[:, j, :], ent_emb,
                                                 batch.query_entities)
                     for j in range(cfg.num_ins)], dim=1)

        loss = base.calc_loss_label(pred_dist, batch.answer_dist, cfg.loss_type)
        out = (loss, torch.argmax(pred_dist, dim=1), pred_dist)
        return out + (ins_attn[..., 0],) if return_attn else out


def build_model(cfg, num_entity: int, num_kb_relation: int, *, word_dim: int,
                seed: int = 0, device="cuda") -> ReaRev:
    """ReaRev with flax-family random weights from ``seed``, on ``device``,
    in eval mode (``cfg``: a ``gnn_rag_tpu.config.Config``)."""
    model = ReaRev(cfg.model, num_entity, num_kb_relation, word_dim)
    flax_like_init_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
