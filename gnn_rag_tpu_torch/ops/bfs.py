"""Batched BFS levels on the device, the port of gnn_rag_tpu/ops/bfs.py.

Shortest-path extraction from question entities to predicted answers
(BASELINE.json's north-star op), replacing the reference's per-question
networkx.all_shortest_paths host loop (llm/src/utils/graph_utils.py:49-75).

The device computes, for every (sample, source) pair at once, the BFS level
of every node by masked frontier expansion over the padded undirected edge
list: each hop gathers the frontier at every edge's source
(``torch.gather`` on the flattened ``[B*S, F]``) and counts the hits at
every edge's target (``scatter_add_``). Path enumeration (output-bound,
tiny) stays on the host: a node u precedes v on a shortest path iff
dist[u] == dist[v] - 1 and (u, v) is an edge.

The loop stops when a hop reaches no new node, or at ``max_hops``; the
unbounded case is capped at E, as in JAX. Whether a hop reached a new node
is read on the host, one sync a hop (JAX's ``lax.while_loop`` condition
reads the same flag on the device); ``return_hops`` gives the count.
"""

from __future__ import annotations

from typing import Optional

import torch

UNREACHED = 2**30


def bfs_levels(heads: torch.Tensor, tails: torch.Tensor,
               fact_mask: torch.Tensor, src_onehot: torch.Tensor, *,
               num_entities: int, max_hops: Optional[int] = None,
               return_hops: bool = False):
    """heads/tails: int [B, F] (already symmetrised for undirected graphs);
    fact_mask: [B, F]; src_onehot: [B, S, E] one-hot source sets, all on one
    device. Returns dist int32 [B, S, E] with UNREACHED where not reachable
    (and the number of hops run, with ``return_hops``).

    With ``max_hops=None`` the expansion runs until no new node is reached
    (the reference's unbounded nx shortest paths, graph_utils.py:49-75)."""
    B, S, E = src_onehot.shape
    assert E == num_entities, (E, num_entities)
    F = heads.shape[1]
    reach = (src_onehot > 0).reshape(B * S, E)
    dist = torch.where(reach, 0, UNREACHED).to(torch.int32)

    def flat(x):
        return x[:, None, :].expand(B, S, F).reshape(B * S, F)

    h_f = flat(heads).long()
    t_f = flat(tails).long()
    m_f = flat(fact_mask) > 0
    bound = max_hops if max_hops is not None else E  # diameter <= E - 1
    hop = 0
    while hop < bound:
        # frontier values at edge sources -> hit counts at edge targets
        at_src = (torch.gather(reach, 1, h_f) & m_f).to(torch.float32)
        hit = torch.zeros((B * S, E), dtype=torch.float32,
                          device=reach.device).scatter_add_(1, t_f, at_src) > 0
        new = hit & ~reach
        reach = reach | hit
        dist = torch.where(new, hop + 1, dist)
        hop += 1
        if not bool(new.any()):
            break
    dist = dist.reshape(B, S, E)
    return (dist, hop) if return_hops else dist
