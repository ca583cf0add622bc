"""Relation surface-form tokenization (reference: gnn/dataset_load.py:354-430).

Freebase relations like ``people.person.place_of_birth`` are verbalised from
their last two dot-fields split on underscores; metaqa relations split on
underscores directly. Both the forward and the word-reversed ("inverse")
token sequences are produced, matching ``build_rel_words``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def relation_words(relations: Sequence[str], metaqa: bool = False) -> List[List[str]]:
    out: List[List[str]] = []
    for rel in relations:
        rel = rel.strip()
        if metaqa:
            out.append(rel.split("_"))
            continue
        fields = rel.split(".")
        if len(fields) >= 2:
            out.append(fields[-2].split("_") + fields[-1].split("_"))
        else:
            out.append(["UNK"])  # reference: dataset_load.py:376-379
    return out


def tokenize_relations(relations: Sequence[str], tokenizer, num_rows: int,
                       metaqa: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (rel_tokens, rel_tokens_inv) of shape [num_rows, max_rel_words].

    ``num_rows`` is num_kb_relation + 1 so that the pad/self-loop relation
    row exists (reference: dataset_load.py:384-385, 413-414); rows past the
    named relations stay all-padding.
    """
    words = relation_words(relations, metaqa=metaqa)
    max_rel_words = max((len(w) for w in words), default=1)
    fwd_texts = [" ".join(w) for w in words]
    inv_texts = [" ".join(w[::-1]) for w in words]
    pad_id = tokenizer.pad_id
    fwd = np.full((num_rows, max_rel_words), pad_id, dtype=np.int32)
    inv = np.full((num_rows, max_rel_words), pad_id, dtype=np.int32)
    fwd[: len(words)] = tokenizer.encode(fwd_texts, max_rel_words)
    inv[: len(words)] = tokenizer.encode(inv_texts, max_rel_words)
    return fwd, inv
