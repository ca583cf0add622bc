"""What the three retrievers (ReaRev, NSM, GraftNet) share: fact dropout,
the question encoder and the entity init, as each JAX model builds them
(gnn_rag_tpu/models/rearev.py:246-317, nsm.py:137-182,
graftnet.py:128-171; reference: base_model.py:79-134).

Flax creates a parameter when a module is first called, so which
parameters a JAX model has follows from the inputs it is given. A torch
module declares its parameters up front, so ``Retriever`` takes that
information at construction:

* ``word_dim``: the width of the frozen-LM states it is given
  (``q_hidden`` and the relation texts' ``rel_hidden``), or None;
* ``rel_text``: ``rel_hidden`` is given (relation features from texts);
* ``inmodel_lm``: the questions come as tokens to a trainable in-model
  transformer (``lm_frozen=0``, or no precomputed ``q_hidden``), named
  ``lm`` as in flax (default: ``lm_frozen=0`` with a transformer ``lm``);
* ``word_emb_dim``: the LSTM reads a frozen word table of that width
  (``word_emb``) instead of its ``word_embedding``;
* ``entity_emb_dim``: the entity init projects a frozen KG entity table
  through ``entity_linear`` instead of running ``type_layer``;
* ``relation_emb_dim``: relation features project a frozen KG relation
  table (used only when ``rel_text`` is off, as in JAX).

``forward`` of every model takes the JAX model's inputs in its order:
``(batch, rel_hidden, rel_hidden_inv, rel_text_mask, entity_emb, word_emb,
relation_emb)``, each None where not given.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .encoders import (AttnEncoder, LSTMQuestionEncoder, TypeLayer,
                       bernoulli_keep, make_inmodel_lm)

# the gate values' type on ReaRev's layout path (ModelConfig.compute_dtype)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a model option the port does not
    take: an unknown model, compute_dtype or loss_type."""
    unsupported = {
        f"model_name {cfg.model_name}":
            cfg.model_name not in ("ReaRev", "NSM", "GraftNet"),
        f"compute_dtype {cfg.compute_dtype}":
            cfg.compute_dtype not in COMPUTE_DTYPES,
        f"loss_type {cfg.loss_type}": cfg.loss_type not in ("kl", "bce"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"gnn_rag_tpu_torch: not ported: "
                                  f"{', '.join(bad)}")


class Retriever(nn.Module):
    def __init__(self, cfg, num_entity: int, num_relation: int,
                 word_dim: Optional[int] = None, *, num_word: int = 0,
                 rel_text: bool = True, inmodel_lm: Optional[bool] = None,
                 word_emb_dim: Optional[int] = None,
                 entity_emb_dim: Optional[int] = None,
                 relation_emb_dim: Optional[int] = None):
        super().__init__()
        check_supported(cfg)
        if rel_text and word_dim is None:
            raise ValueError("relation texts need the frozen LM's width (word_dim)")
        self.cfg = cfg
        self.num_entity = num_entity
        self.num_relation = num_relation   # num_kb_relation
        self.rel_text = rel_text
        self.relation_emb_dim = relation_emb_dim
        D = cfg.entity_dim
        if inmodel_lm is None:
            inmodel_lm = cfg.lm != "lstm" and not cfg.lm_frozen
        if cfg.lm == "lstm":
            self.instruction_encoder = LSTMQuestionEncoder(
                D, num_word, cfg.word_dim, cfg.lm_dropout, word_emb_dim)
            if rel_text:   # projects the relation texts only
                self.question_emb = nn.Linear(word_dim, D)
        else:
            if inmodel_lm:
                self.lm = make_inmodel_lm(cfg)
            width = self.lm.hidden if inmodel_lm else word_dim
            if width is None:
                raise ValueError("a frozen-LM question encoder needs word_dim")
            self.question_emb = nn.Linear(width, D)       # bert_encoder.py:69
        if entity_emb_dim is not None:
            self.entity_linear = nn.Linear(entity_emb_dim, D)
        else:
            self.type_layer = TypeLayer(D, D, cfg.norm_rel)

    def init_relation_features(self) -> None:
        """The one relation-feature table of NSM and GraftNet
        (nsm.py:97-111; ReaRev has one a direction): attention pooling over
        the projected relation texts, else ``relation_linear1`` over the
        frozen KG table or the trainable ``relation_embedding``."""
        D = self.cfg.entity_dim
        if self.rel_text:
            self.self_att_r = AttnEncoder(D)
        else:
            din = self.relation_emb_dim
            if din is None:
                din = D
                self.relation_embedding = nn.Embedding(self.num_relation + 1, D)
            self.relation_linear1 = nn.Linear(din, D)

    def relation_features(self, rel_hidden, rel_text_mask, relation_emb):
        """[R+1, D] features of ``init_relation_features``'s table."""
        if self.rel_text:
            return self.self_att_r(self.question_emb(rel_hidden), rel_text_mask)
        if relation_emb is not None:   # frozen table (base_model.py:122-134)
            return self.relation_linear1(relation_emb)
        return self.relation_linear1(self.relation_embedding.weight)

    def fact_dropout(self, batch, generator: Optional[torch.Generator],
                     drop_keep: Optional[torch.Tensor], keep_self_loops: bool
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(fact_mask, drop_keep): fact dropout as a keep mask over the
        canonical facts (dataset_load.py:489-490), drawn from ``generator``
        in training unless ``drop_keep`` is given. ReaRev and NSM keep self
        loops (the reference appends them after dropout); GraftNet drops them
        too (gnn_rag_tpu/models/graftnet.py:136-141)."""
        if drop_keep is None and generator is not None and self.cfg.fact_drop > 0:
            drop_keep = bernoulli_keep(batch.fact_mask.shape,
                                       1.0 - self.cfg.fact_drop, generator,
                                       batch.fact_mask.device)
            if keep_self_loops:
                drop_keep = torch.where(batch.rels == self.num_relation - 1,
                                        1.0, drop_keep)
        fact_mask = batch.fact_mask if drop_keep is None else batch.fact_mask * drop_keep
        return fact_mask, drop_keep

    def check_generator(self, training: bool,
                        generator: Optional[torch.Generator]
                        ) -> Optional[torch.Generator]:
        """The dropout generator of this call: None in eval; in training a
        generator is needed when a dropout rate is not 0."""
        if not training:
            return None
        cfg = self.cfg
        if generator is None and (cfg.linear_dropout > 0 or cfg.fact_drop > 0
                                  or (cfg.lm == "lstm" and cfg.lm_dropout > 0)):
            raise ValueError(f"{type(self).__name__} training with dropout "
                             "needs a generator")
        return generator

    def encode_question(self, batch, word_emb: Optional[torch.Tensor],
                        generator: Optional[torch.Generator]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(query_hidden [B, L, D], query_node [B, D]): the LSTM's states
        and last state, or the projected transformer states and their CLS
        (bert_encoder.py:102-104) from ``q_hidden`` or the in-model LM."""
        if self.cfg.lm == "lstm":
            return self.instruction_encoder(batch.q_tokens, generator, word_emb)
        if batch.q_hidden is not None:
            raw = batch.q_hidden
        elif hasattr(self, "lm"):
            raw = self.lm(batch.q_tokens, batch.q_mask)
        else:
            raise ValueError("the batch has no q_hidden and the model no "
                             "in-model LM")
        return self.question_emb(raw), self.question_emb(raw[:, 0, :])

    def init_entities(self, batch, rel_features: torch.Tensor,
                      entity_emb: Optional[torch.Tensor],
                      fact_mask: torch.Tensor,
                      drop_keep: Optional[torch.Tensor]) -> torch.Tensor:
        """[B, E, D] entity states: ``entity_linear`` over the frozen KG
        table (pad row = last; encode_type=False, base_model.py:96-114), or
        ``type_layer`` over the incident relations (layout path when the
        batch has one)."""
        if hasattr(self, "entity_linear"):
            gids = batch.entity_gids.long().clamp(max=entity_emb.shape[0] - 1)
            return self.entity_linear(entity_emb[gids])
        return self.type_layer(rel_features, batch.layout,
                               batch.seed_dist.shape[1], drop_keep,
                               batch=batch, fact_mask=fact_mask)
