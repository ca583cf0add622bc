"""Host-side retrieval metrics: eps-cumulative candidate extraction and
precision/recall/F1/Hit@1/EM.

Numpy copy of the two functions of ``gnn_rag_tpu.train.metrics`` that the
serving path runs. Exact ports of the candidate semantics the LLM half
depends on:
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
