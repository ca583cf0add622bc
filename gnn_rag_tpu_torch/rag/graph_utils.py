"""Host graph/path utilities for the RAG stage.

Re-implements the reference's networkx-based helpers
(llm/src/utils/graph_utils.py:10-153) on a lightweight insertion-ordered
adjacency map, with two faithful quirks of the reference:

* the graph is UNDIRECTED and collapses parallel edges — for repeated
  (h, t) pairs the LAST triple's relation wins (nx.Graph.add_edge overwrite,
  graph_utils.py:10-21);
* shortest paths are enumerated between every (question entity, answer
  candidate) pair; pairs with no path are skipped (graph_utils.py:49-75).

A C++ enumerator (``gnn_rag_tpu_torch.native``) accelerates all-shortest-paths when the
shared library is built; this module is the always-available fallback and the
semantic oracle for its tests. Copy of ``gnn_rag_tpu.rag.graph_utils``.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Triple = Tuple[str, str, str]


class UndirectedGraph:
    """Insertion-ordered undirected graph with one relation per edge.

    With ``keep_parallel=True`` parallel edges KEEP all their relations,
    joined as ``"r1 | r2"`` in insertion order, instead of the reference's
    last-write-wins collapse (nx.Graph.add_edge, graph_utils.py:10-21).
    The collapse is a real information loss: on the synthetic benchmarks
    ~50% of gold answers sit on parallel-edge pairs (docs/DATA.md), so the
    displayed relation is wrong for about half of them. Opt-in because the
    collapsed format is the byte-parity contract with the reference's
    prompts."""

    __slots__ = ("adj", "keep_parallel")

    def __init__(self, keep_parallel: bool = False):
        self.adj: Dict[str, Dict[str, str]] = {}
        self.keep_parallel = keep_parallel

    def add_edge(self, h, t, relation: str):
        if self.keep_parallel:
            cur = self.adj.get(h, {}).get(t)
            if cur is not None and relation not in cur.split(" | "):
                relation = cur + " | " + relation
            elif cur is not None:
                relation = cur
        self.adj.setdefault(h, {})[t] = relation
        self.adj.setdefault(t, {})[h] = relation

    def __contains__(self, node) -> bool:
        return node in self.adj

    def __len__(self) -> int:
        return len(self.adj)

    def nodes(self):
        return self.adj.keys()

    def neighbors(self, node):
        return self.adj[node].keys()

    def relation(self, u, v) -> str:
        return self.adj[u][v]


def build_graph(triples: Iterable[Triple], entities: Optional[Sequence] = None,
                encrypt: bool = False,
                names_entities: Optional[Dict[str, str]] = None,
                keep_parallel: bool = False) -> UndirectedGraph:
    """graph_utils.py:10-21; with encrypt, entity names that are question
    entities are swapped back to their mids."""
    g = UndirectedGraph(keep_parallel)
    for h, r, t in triples:
        if encrypt and names_entities is not None and entities is not None:
            if h in names_entities and names_entities[h] in entities:
                h = names_entities[h]
            if t in names_entities and names_entities[t] in entities:
                t = names_entities[t]
        g.add_edge(h, t, r.strip())
    return g


def bfs_with_rule(graph: UndirectedGraph, start_node, target_rule: Sequence[str],
                  max_p: int = 10) -> List[List[Triple]]:
    """BFS constrained to a relation sequence (graph_utils.py:24-47)."""
    result_paths: List[List[Triple]] = []
    queue = deque([(start_node, [])])
    while queue:
        node, path = queue.popleft()
        if len(path) == len(target_rule):
            result_paths.append(path)
        if len(path) < len(target_rule):
            if node not in graph:
                continue
            want = target_rule[len(path)]
            for nb in graph.neighbors(node):
                rel = graph.relation(node, nb)
                if rel != want and (" | " not in rel
                                    or want not in rel.split(" | ")):
                    continue
                queue.append((nb, path + [(node, rel, nb)]))
    return result_paths


def all_shortest_node_paths(graph: UndirectedGraph, src, dst,
                            max_paths: Optional[int] = None) -> List[List]:
    """All shortest node paths src -> dst (BFS levels + backward DFS).
    Returns [] when unreachable (the reference's except-skip,
    graph_utils.py:61-65). src == dst yields the single zero-length path."""
    if src not in graph or dst not in graph:
        return []
    if src == dst:
        return [[src]]
    dist = {src: 0}
    parents: Dict[object, List] = {}
    frontier = [src]
    found = False
    d = 0
    while frontier and not found:
        d += 1
        nxt = []
        for u in frontier:
            for v in graph.neighbors(u):
                if v not in dist:
                    dist[v] = d
                    parents[v] = [u]
                    nxt.append(v)
                elif dist[v] == d:
                    parents[v].append(u)
            # (u's neighbors fully expanded before moving on: BFS level order)
        if dst in dist and dist[dst] == d:
            found = True
        frontier = nxt
    if not found:
        return []
    # backward DFS over the predecessor DAG
    paths: List[List] = []
    stack = [(dst, [dst])]
    while stack:
        node, path = stack.pop()
        if node == src:
            paths.append(path[::-1])
            if max_paths is not None and len(paths) >= max_paths:
                break
            continue
        for p in parents[node]:
            stack.append((p, path + [p]))
    return paths


def get_truth_paths(q_entity: Sequence, a_entity: Sequence,
                    graph: UndirectedGraph,
                    max_paths_per_pair: Optional[int] = None
                    ) -> List[List[Triple]]:
    """Shortest paths question->answer, relation-annotated
    (graph_utils.py:49-75)."""
    result_paths: List[List[Triple]] = []
    for h in q_entity:
        if h not in graph:
            continue
        for t in a_entity:
            if t not in graph:
                continue
            for p in all_shortest_node_paths(graph, h, t, max_paths_per_pair):
                result_paths.append(
                    [(p[i], graph.relation(p[i], p[i + 1]), p[i + 1])
                     for i in range(len(p) - 1)])
    return result_paths


def get_truth_paths_fast(triples: Sequence[Triple], q_entity: Sequence,
                         a_entity: Sequence, entities: Optional[Sequence] = None,
                         encrypt: bool = False,
                         names_entities: Optional[Dict[str, str]] = None,
                         keep_parallel: bool = False) -> List[List[Triple]]:
    """get_truth_paths without a Python graph build: the C++ enumerator
    (``gnn_rag_tpu_torch.native``) when available, else the pure-Python path.
    keep_parallel is supported natively (composite relation ids)."""
    if encrypt and names_entities is not None and entities is not None:
        renamed = []
        for h, r, t in triples:
            if h in names_entities and names_entities[h] in entities:
                h = names_entities[h]
            if t in names_entities and names_entities[t] in entities:
                t = names_entities[t]
            renamed.append((h, r, t))
        triples = renamed
    try:
        from .. import native
        out = native.truth_paths_native(triples, q_entity, a_entity,
                                        keep_parallel=keep_parallel)
        if out is not None:
            return out
    except Exception:
        pass
    return get_truth_paths(q_entity, a_entity,
                           build_graph(triples, keep_parallel=keep_parallel))


def get_simple_paths(q_entity: Sequence, a_entity: Sequence,
                     graph: UndirectedGraph, hop: int = 2) -> List[List[Triple]]:
    """All simple paths within `hop` edges (graph_utils.py:77-98)."""
    out: List[List[Triple]] = []
    for h in q_entity:
        if h not in graph:
            continue
        for t in a_entity:
            if t not in graph:
                continue
            stack = [(h, [h], [])]
            while stack:
                node, visited, edges = stack.pop()
                if len(edges) > hop:
                    continue
                if node == t and edges:
                    out.append(list(edges))
                    continue
                if len(edges) == hop:
                    continue
                for nb in graph.neighbors(node):
                    if nb in visited:
                        continue
                    stack.append((nb, visited + [nb],
                                  edges + [(node, graph.relation(node, nb), nb)]))
    return out


def random_walks(graph: UndirectedGraph, n_walks: int, walk_len: int,
                 start_nodes: Sequence, rng=None) -> List[List]:
    """Uniform random walks (replaces the graph-walker C++ dependency,
    graph_utils.py:114,139)."""
    import random as _random
    rng = rng or _random.Random(0)
    nodes = list(graph.nodes())
    walks = []
    for start_idx in start_nodes:
        for _ in range(n_walks):
            node = nodes[start_idx]
            walk = [start_idx]
            for _ in range(walk_len):
                nbrs = list(graph.neighbors(node))
                if not nbrs:
                    break
                node = rng.choice(nbrs)
                walk.append(nodes.index(node))
            walks.append(walk)
    return walks


def get_negative_paths(q_entity: Sequence, a_entity: Sequence,
                       graph: UndirectedGraph, n_neg: int, hop: int = 2,
                       rng=None) -> List[List[Triple]]:
    """Random-walk paths that do NOT end at an answer (graph_utils.py:100-127)."""
    nodes = list(graph.nodes())
    start_nodes = [nodes.index(h) for h in q_entity if h in graph]
    end_nodes = {nodes.index(t) for t in a_entity if t in graph}
    out: List[List[Triple]] = []
    for walk in random_walks(graph, n_neg, hop, start_nodes, rng):
        if walk and walk[-1] in end_nodes:
            continue
        tmp = []
        for i in range(len(walk) - 1):
            u, v = nodes[walk[i]], nodes[walk[i + 1]]
            tmp.append((u, graph.relation(u, v), v))
        out.append(tmp)
    return out


def get_random_paths(q_entity: Sequence, graph: UndirectedGraph, n: int = 3,
                     hop: int = 2, rng=None):
    """Random paths + their relation rules (graph_utils.py:129-153)."""
    nodes = list(graph.nodes())
    start_nodes = [nodes.index(h) for h in q_entity if h in graph]
    paths, rules = [], []
    for walk in random_walks(graph, n, hop, start_nodes, rng):
        tmp, rule = [], []
        for i in range(len(walk) - 1):
            u, v = nodes[walk[i]], nodes[walk[i + 1]]
            rel = graph.relation(u, v)
            tmp.append((u, rel, v))
            rule.append(rel)
        paths.append(tmp)
        rules.append(rule)
    return paths, rules
