"""Degree normalisation weights on the device, port of
``gnn_rag_tpu.ops.degree``.

The reference computes 1/out-degree(head) per fact on the host for every
batch (dataset_load.py:509-511); here it is a segment sum and a gather after
fact dropout, so it stays exact under dropout.
"""

from __future__ import annotations

import torch

from .segment import batched_segment_sum, gather_entities_to_facts


def head_degree_weight(heads: torch.Tensor, fact_mask: torch.Tensor,
                       num_entities: int) -> torch.Tensor:
    """[B, F] weights = 1 / (#kept facts sharing this head in this sample)."""
    counts = batched_segment_sum(fact_mask, heads, num_entities)   # [B, E]
    per_fact = gather_entities_to_facts(counts, heads)             # [B, F]
    return torch.where(per_fact > 0, 1.0 / per_fact.clamp_min(1.0),
                       0.0) * fact_mask
