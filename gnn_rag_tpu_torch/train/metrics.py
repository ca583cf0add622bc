"""Retrieval metrics: eps-cumulative candidate extraction and
precision/recall/F1/Hit@1/EM on the host, and the training F1 on the device.

Ports of three functions of ``gnn_rag_tpu.train.metrics``. Exact ports of
the candidate semantics the LLM half depends on:
* candidate filtering (reference: gnn/evaluate.py:188-208): drop seed
  entities, padding slots, and probs below (1 - eps) / max_local_entity
  (dataset-global max, parsing.py:62 eps=0.95);
* cumulative-probability cutoff: candidates sorted by prob desc are taken
  until the running prob mass exceeds eps (evaluate.py:40-50,
  base_model.py:217-246).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def extract_candidates(probs: np.ndarray, entity_gids: np.ndarray,
                       query_entities: np.ndarray, pad_ent_id: int,
                       ignore_prob: float) -> List[Tuple[int, float]]:
    """Per-sample candidate list in local slot order (evaluate.py:195-208):
    seed entities, padding slots, and probs below the eps floor are dropped.
    Vectorised; slot order is preserved so downstream stable sorts match the
    reference's tie-breaking."""
    keep = ((query_entities != 1.0) & (entity_gids != pad_ent_id)
            & (probs >= ignore_prob))
    idx = np.nonzero(keep)[0]
    gids = entity_gids[idx].tolist()
    ps = probs[idx].tolist()
    return list(zip(gids, ps))


def f1_and_hits_eval(answers: Sequence[int],
                     candidate2prob: Sequence[Tuple[int, float]],
                     eps: float = 0.95):
    """Returns (precision, recall, f1, hit, em, case, retrieved) with the
    reference's exact edge-case conventions (evaluate.py:25-67). ``retrieved``
    keeps raw global ids; callers map to mids/names."""
    cand_list = sorted(candidate2prob, key=lambda x: x[1], reverse=True)
    best_ans = cand_list[0][0] if cand_list else -1
    answers_set = set(answers)
    retrieved: List[Tuple[int, float]] = []
    correct = 0
    tp_prob = 0.0
    for c, prob in cand_list:
        retrieved.append((c, prob))
        tp_prob += prob
        if c in answers_set:
            correct += 1
        if tp_prob > eps:
            break
    em = 1 if correct > 0 else 0
    if len(answers) == 0:
        if len(retrieved) == 0:
            return 1.0, 1.0, 1.0, 1.0, 1.0, 0, retrieved
        return 0.0, 1.0, 0.0, 1.0, 1.0, 1, retrieved
    hits = float(best_ans in answers_set)
    if len(retrieved) == 0:
        return 1.0, 0.0, 0.0, hits, hits, 2, retrieved
    p = correct / len(retrieved)
    r = correct / len(answers)
    f1 = 2.0 / (1.0 / p + 1.0 / r) if p != 0 and r != 0 else 0.0
    return p, r, f1, hits, em, 3, retrieved


def train_f1_device(pred_dist: torch.Tensor, answer_dist: torch.Tensor,
                    h1_vec: torch.Tensor, entity_gids: torch.Tensor,
                    seed_dist: torch.Tensor, pad_ent_id: int,
                    eps: float) -> torch.Tensor:
    """Per-sample training F1 ``[B]`` on the device, the twin of the JAX
    package's ``train_f1_device`` (base_model.py:249-285): seed and pad slots
    skipped, candidates below ``(1 - eps) / E`` dropped (E the padded entity
    count, not the dataset's max), a stable prob-descending sort (ties keep
    slot order), the cumulative cutoff that includes the first crossing, and
    the reference's empty/zero cases; 0 where Hit@1 is 0."""
    E = pred_dist.shape[1]
    ignore_prob = (1.0 - eps) / E
    skip = (seed_dist > 0) | (entity_gids == pad_ent_id)
    is_ans = ~skip & (answer_dist > 0)
    cand = ~skip & (pred_dist >= ignore_prob)
    # non-candidates sort after every candidate (probs >= ignore_prob > -1)
    sort_key = torch.where(cand, pred_dist, -1.0)
    order = torch.sort(-sort_key, dim=1, stable=True).indices
    sorted_p = torch.gather(torch.where(cand, pred_dist, 0.0), 1, order)
    sorted_cand = torch.gather(cand, 1, order)
    sorted_ans = torch.gather(is_ans, 1, order)
    cum = torch.cumsum(sorted_p, dim=1)
    # retrieved iff the mass before this candidate is <= eps
    in_retr = sorted_cand & ((cum - sorted_p) <= eps)
    n_retr = in_retr.sum(dim=1).float()
    correct = (in_retr & sorted_ans).sum(dim=1).float()
    n_ans = is_ans.sum(dim=1).float()
    p = correct / n_retr.clamp_min(1.0)
    r = correct / n_ans.clamp_min(1.0)
    f1 = torch.where((p > 0) & (r > 0), 2.0 * p * r / (p + r), 0.0)
    f1 = torch.where(n_ans == 0, torch.where(n_retr == 0, 1.0, 0.0), f1)
    return torch.where(h1_vec > 0, f1, 0.0)
