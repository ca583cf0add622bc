"""GraphBatch — a padded batch of question subgraphs.

Same fields and layout as ``gnn_rag_tpu.data.batch.GraphBatch`` (B = batch,
E = padded local entities, F = padded facts, L = question tokens), as a plain
dataclass. The loader fills it with numpy arrays; ``to(device)`` returns the
same batch with every array (the kernel layout included) as a torch tensor on
``device``.

* ``heads/rels/tails[B, F]`` — COO triples in *local* entity ids; padded fact
  slots carry ``heads=tails=0`` and ``fact_mask=0``.
* ``entity_gids[B, E]`` — global entity id per local slot, ``num_entity`` for
  padding and, on non-CWQ data, for the question entities
  (dataset_load.py:249-257).
* ``layout`` — the tile-sorted ``KernelLayout`` the gate-scatter kernel walks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .kernel_layout import DirectionLayout, KernelLayout


def _to(x, device):
    if x is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


@dataclasses.dataclass
class GraphBatch:
    heads: object               # int32 [B, F]
    rels: object                # int32 [B, F]
    tails: object               # int32 [B, F]
    fact_mask: object           # float32 [B, F]
    entity_gids: object         # int32 [B, E]  (num_entity == padding / masked seed)
    ent_present: object         # float32 [B, E]
    seed_dist: object           # float32 [B, E]
    query_entities: object      # float32 [B, E]
    answer_dist: object         # float32 [B, E]
    q_tokens: object            # int32 [B, L]
    q_mask: object              # float32 [B, L]
    q_hidden: Optional[object] = None         # float32 [B, L, word_dim]
    fact_rel_weight: Optional[object] = None  # float32 [B, F] 1/count(head, rel)
    layout: Optional[KernelLayout] = None

    @property
    def batch_size(self) -> int:
        return self.heads.shape[0]

    @property
    def max_entities(self) -> int:
        return self.entity_gids.shape[1]

    @property
    def max_facts(self) -> int:
        return self.heads.shape[1]

    def candidate_mask(self, num_entity: int):
        """Softmax support mask == reference local_entity_mask (reasongnn.py:48)."""
        m = self.entity_gids != num_entity
        return m.float() if isinstance(m, torch.Tensor) else m.astype(np.float32)

    def to(self, device) -> "GraphBatch":
        """The same batch with every numpy array as a tensor on ``device``."""
        fields = {f.name: _to(getattr(self, f.name), device)
                  for f in dataclasses.fields(self) if f.name != "layout"}
        layout = None
        if self.layout is not None:
            layout = KernelLayout(
                fwd=DirectionLayout(*(_to(a, device) for a in self.layout.fwd)),
                inv=DirectionLayout(*(_to(a, device) for a in self.layout.inv)),
                num_entities=self.layout.num_entities)
        return GraphBatch(**fields, layout=layout)


def pad_to(x: np.ndarray, size: int, axis: int, fill=0) -> np.ndarray:
    """Pad `x` along `axis` up to `size` with `fill`."""
    cur = x.shape[axis]
    if cur == size:
        return x
    if cur > size:
        raise ValueError(f"cannot pad axis {axis} of size {cur} down to {size}")
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, size - cur)
    return np.pad(x, widths, constant_values=fill)


DEFAULT_ENTITY_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)
DEFAULT_FACT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536,
                        131072)


def bucketize(n: int, buckets) -> int:
    """Smallest bucket >= n; if none fits (or no buckets), round up to a
    multiple of 128. Coarse bucket ladders bound the number of distinct batch
    shapes."""
    for b in buckets:
        if n <= b:
            return int(b)
    return int(-(-n // 128) * 128) if n > 0 else 128
