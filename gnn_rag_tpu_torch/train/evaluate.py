"""Evaluator: batched inference, retrieval metrics, and `.info` export.

Port of ``gnn_rag_tpu.train.evaluate``. The `.info` JSONL is the contract
between the GNN retriever and the LLM reader (reference: gnn/evaluate.py:
140-240 writes it; predict_answer.py consumes it by line order). One line
per question:

    {"question": <question>, "0": {}, ..., "<num_iter-1>": {},
     "answers": [<mid>...], "precison": p, "recall": r, "f1": f,
     "hit": h, "em": em, "cand": [[<mid>, prob], ...]}

(the "precison" misspelling is part of the format, evaluate.py:213). With
an ``attn_forward_fn`` the slots "j" < min(num_iter, num_ins) hold
``{"attention": [...]}``, instruction j's attention over the question's
real tokens, each rounded to 6 decimals (gnn_rag_tpu/train/evaluate.py:
56-135).
"""

from __future__ import annotations

import json
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data.loader import KGQADataset
from .metrics import extract_candidates, f1_and_hits_eval


class Evaluator:
    """Runs a forward over a dataset split and scores retrieval.

    forward_fn(batch) -> (loss, pred, pred_dist), with ``batch`` the numpy
    GraphBatch the loader made — typically
    ``lambda b: model(b.to(device), *rel_args)``.
    """

    def __init__(self, *, eps: float, num_entity: int, id2entity: dict,
                 id2relation: Optional[dict] = None, num_iter: int = 3,
                 entity_names: Optional[Sequence[str]] = None):
        """``entity_names``: on 'sr-' datasets, the names that the
        ``id2entity`` values index (evaluate.py:81-86); ``id2relation`` is
        kept as the JAX Evaluator keeps it."""
        self.eps = eps
        self.num_entity = num_entity
        self.id2entity = id2entity
        self.id2relation = id2relation or {}
        self.num_iter = num_iter
        self.entity_names = entity_names

    def _name(self, gid: int):
        ent = self.id2entity.get(gid, gid)
        if self.entity_names is not None:
            return self.entity_names[ent] if isinstance(ent, int) else ent
        return ent

    def evaluate(self, data: KGQADataset, forward_fn: Callable,
                 test_batch_size: int = 20, write_info: bool = False,
                 info_path: Optional[str] = None,
                 decode_question: Optional[Callable[[np.ndarray], str]] = None,
                 attn_forward_fn: Optional[Callable] = None,
                 batch_pad_to: Optional[int] = None):
        """Returns (mean_f1, mean_hit, mean_em, mean_loss); optionally writes
        `.info` to ``info_path``, one line per question in the split's order
        (sequential order is restored first: a split that training shuffled
        keeps its order otherwise). ``decode_question(q_token_ids)`` gives
        the `.info` "question" when set (the CLI decodes the tokenizer's
        word pieces, the reference's evaluate.py:143-156), else the raw
        question. ``attn_forward_fn(batch)`` -> (loss, pred, pred_dist,
        attn [B, J, L]) runs in place of ``forward_fn`` when writing the
        `.info` and fills its per-iteration slots. ``batch_pad_to``: pad
        every batch to that many rows (a data-parallel forward needs rows
        that divide over dp; the padded rows are not scored)."""
        data.reset_batches(is_sequential=True)
        num_batches = math.ceil(len(data) / test_batch_size)
        if num_batches == 0:
            return 0.0, 0.0, 0.0, 0.0
        ignore_prob = (1 - self.eps) / data.max_local_entity  # evaluate.py:156
        f1s, hits, ems, losses = [], [], [], []

        # phase 1 — queue every forward; the device runs them back to back
        staged = []
        with torch.inference_mode():
            for it in range(num_batches):
                idx = data.batch_indices(it, test_batch_size)
                batch = data.make_batch(idx, batch_pad_to=batch_pad_to)
                attn = None
                if write_info and attn_forward_fn is not None:
                    loss, _, pred_dist, attn = attn_forward_fn(batch)
                else:
                    loss, _, pred_dist = forward_fn(batch)
                staged.append((idx, batch, loss, pred_dist, attn))

        # phase 2 — host-side metric extraction
        fout = open(info_path, "w") if (write_info and info_path) else None
        try:
            for idx, batch, loss, pred_dist, attn in staged:
                pred_dist = pred_dist.float().cpu().numpy()
                if attn is not None:
                    attn = attn.float().cpu().numpy()
                losses.append(float(loss))
                answers_batch = data.answers_for(idx)
                for b in range(len(idx)):
                    cand2prob = extract_candidates(
                        pred_dist[b], batch.entity_gids[b],
                        batch.query_entities[b], self.num_entity, ignore_prob)
                    answers = answers_batch[b]
                    p, r, f1, hit, em, _, retrieved = f1_and_hits_eval(
                        answers, cand2prob, self.eps)
                    f1s.append(f1); hits.append(hit); ems.append(em)
                    if fout is None:
                        continue
                    rec = data.records[idx[b]]
                    obj = {"question": (decode_question(rec.q_token_ids)
                                        if decode_question else rec.question)}
                    for j in range(self.num_iter):
                        obj[str(j)] = {}
                    if attn is not None:
                        # over the question's real tokens only
                        L = len(rec.q_token_ids)
                        for j in range(min(self.num_iter, attn.shape[1])):
                            obj[str(j)] = {"attention": [
                                round(float(a), 6) for a in attn[b, j, :L]]}
                    obj["answers"] = [self._name(a) for a in answers]
                    obj["precison"] = p
                    obj["recall"] = r
                    obj["f1"] = f1
                    obj["hit"] = hit
                    obj["em"] = em
                    obj["cand"] = [[self._name(c), prob] for c, prob in retrieved]
                    fout.write(json.dumps(obj) + "\n")
        finally:
            if fout is not None:
                fout.close()
        return (float(np.mean(f1s)), float(np.mean(hits)), float(np.mean(ems)),
                float(np.mean(losses)))
