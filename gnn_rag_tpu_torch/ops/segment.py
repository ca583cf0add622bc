"""Batched gather/scatter message-passing primitives.

The reference's per-batch ``torch.sparse.mm`` products (base_gnn.py:45-54,
reasongnn.py:80-111) as plain gathers and index-adds over the padded arrays
of a GraphBatch:

* ``head2fact_mat @ dist``  ->  gather: ``dist[b, heads[b, f]]``
* ``fact2tail_mat @ vals``  ->  scatter-add of fact values into tail slots
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gather_entities_to_facts(ent_values: torch.Tensor,
                             index: torch.Tensor) -> torch.Tensor:
    """ent_values: [B, E] or [B, E, D]; index: int [B, F] -> [B, F(, D)]."""
    index = index.long()
    if ent_values.dim() == 3:
        index = index[..., None].expand(-1, -1, ent_values.shape[-1])
    return torch.gather(ent_values, 1, index)


def gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]``: rows of a ``[R, D]`` table at an int index of any
    shape. Through ``F.embedding``, whose gradient (a segmented sum over the
    sorted index) stays fast when one row is repeated many times, as the pad
    relation is across a batch's pad slots; the gradient of ``table[index]``
    adds each row's repeats one after another."""
    return F.embedding(index.long(), table)


def batched_segment_sum(values: torch.Tensor, index: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Per-row scatter-add: out[b, index[b, f]] += values[b, f].

    values: [B, F] or [B, F, D]; index: int [B, F]; -> [B, num_segments(, D)].
    One flattened index_add over ids ``b * num_segments + idx``, the
    linearisation of the reference's block-diagonal batch matrices
    (dataset_load.py:483)."""
    B, F = index.shape
    offsets = (torch.arange(B, device=index.device) * num_segments)[:, None]
    flat_ids = (index.long() + offsets).reshape(B * F)
    tail = values.shape[2:]
    out = values.new_zeros((B * num_segments,) + tail)
    out.index_add_(0, flat_ids, values.reshape((B * F,) + tail))
    return out.reshape((B, num_segments) + tail)


def layout_fact_keep(direction, keep: torch.Tensor) -> torch.Tensor:
    """Gather a canonical per-fact mask ``keep [B, F]`` onto a
    DirectionLayout's tile-sorted slots ``[B, Fp]`` via its ``perm`` map. Pad
    slots (perm == -1) return 0."""
    perm = direction.perm.long()
    k = torch.gather(keep, 1, perm.clamp_min(0))
    return k * (perm >= 0).to(keep.dtype)


def scatter_facts_to_entities(fact_values: torch.Tensor, index: torch.Tensor,
                              num_entities: int,
                              fact_mask: torch.Tensor | None = None) -> torch.Tensor:
    """``sparse.mm(fact2tail_mat, fact_val)`` (reasongnn.py:84) when ``index
    = tails``: ``[B, F(, D)]`` fact values added into their ``[B, E(, D)]``
    entity rows. Padded facts must carry zero values: pass ``fact_mask`` (a
    per-fact weight) or zero them first."""
    if fact_mask is not None:
        fact_values = fact_values * (fact_mask[..., None] if fact_values.dim() == 3
                                     else fact_mask)
    return batched_segment_sum(fact_values, index, num_entities)
