"""ctypes binding for the native graphpath library (the port's copy of
``gnn_rag_tpu.native``).

``csrc/graphpath.cpp`` is compiled with g++ at first use into
``build/gnn_rag_tpu_torch/`` (the file name carries the source hash);
callers handle ``available() == False`` (pure-Python fallback in
``rag.graph_utils``).
"""

from __future__ import annotations

import ctypes
import threading as _threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import build as _build

_lib = None
_lib_lock = _threading.Lock()

_TLS = _threading.local()


_ABI_VERSION = 3


def build() -> str:
    """Compile ``csrc/graphpath.cpp`` with g++ into ``build/gnn_rag_tpu_torch/``
    unless that library exists; returns its path."""
    return _build.library("graphpath.cpp")


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(build())
        except (OSError, RuntimeError):
            return None
        lib.gp_abi_version.restype = ctypes.c_int32
        if lib.gp_abi_version() != _ABI_VERSION:
            return None
        lib.gp_build.restype = ctypes.c_void_p
        lib.gp_build.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
        lib.gp_free.argtypes = [ctypes.c_void_p]
        lib.gp_n_base_rels.restype = ctypes.c_int32
        lib.gp_n_base_rels.argtypes = [ctypes.c_void_p]
        lib.gp_n_composite.restype = ctypes.c_int64
        lib.gp_n_composite.argtypes = [ctypes.c_void_p]
        lib.gp_composite_vals_len.restype = ctypes.c_int64
        lib.gp_composite_vals_len.argtypes = [ctypes.c_void_p]
        lib.gp_composite_table.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p]
        lib.gp_all_shortest_paths.restype = ctypes.c_int64
        lib.gp_all_shortest_paths.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64]
        lib.gp_paths_from_source.restype = ctypes.c_int64
        lib.gp_paths_from_source.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.gp_bfs_dist.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int32, ctypes.c_void_p]
        lib.gp_random_walks.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int32, ctypes.c_int32,
                                        ctypes.c_int32, ctypes.c_uint64,
                                        ctypes.c_void_p]
        lib.gp_intern.restype = ctypes.c_int64
        lib.gp_intern.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int32,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeGraph:
    """Integer-id undirected graph backed by the C++ CSR."""

    def __init__(self, heads: np.ndarray, rels: np.ndarray,
                 tails: np.ndarray, n_nodes: int,
                 keep_parallel: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("graphpath library unavailable")
        self._lib = lib
        heads = np.ascontiguousarray(heads, np.int32)
        rels = np.ascontiguousarray(rels, np.int32)
        tails = np.ascontiguousarray(tails, np.int32)
        self.n_nodes = int(n_nodes)
        self._handle = lib.gp_build(
            heads.ctypes.data_as(ctypes.c_void_p),
            rels.ctypes.data_as(ctypes.c_void_p),
            tails.ctypes.data_as(ctypes.c_void_p),
            len(heads), self.n_nodes, int(keep_parallel))

    def composite_rels(self) -> Tuple[int, List[List[int]]]:
        """keep_parallel mode: (n_base_rels, member base-rel ids per
        composite id). Rel ids >= n_base_rels returned by the path
        enumerators index this table (id - n_base_rels)."""
        n_base = self._lib.gp_n_base_rels(self._handle)
        n_comp = self._lib.gp_n_composite(self._handle)
        if n_comp <= 0:
            return n_base, []
        ptr = np.empty(n_comp + 1, np.int64)
        vals = np.empty(self._lib.gp_composite_vals_len(self._handle),
                        np.int32)
        self._lib.gp_composite_table(self._handle,
                                     ptr.ctypes.data_as(ctypes.c_void_p),
                                     vals.ctypes.data_as(ctypes.c_void_p))
        return n_base, [vals[ptr[i]:ptr[i + 1]].tolist()
                        for i in range(n_comp)]

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.gp_free(self._handle)
            self._handle = None

    def all_shortest_paths(self, src: int, dst: int, max_paths: int = 10_000
                           ) -> List[Tuple[List[int], List[int]]]:
        """Returns [(node_seq, rel_seq), ...]."""
        nodes_cap, rels_cap = 1 << 16, 1 << 16
        while True:
            out_nodes = np.empty(nodes_cap, np.int32)
            out_rels = np.empty(rels_cap, np.int32)
            out_lens = np.empty(max_paths, np.int32)
            n = self._lib.gp_all_shortest_paths(
                self._handle, int(src), int(dst), max_paths,
                out_nodes.ctypes.data_as(ctypes.c_void_p), nodes_cap,
                out_rels.ctypes.data_as(ctypes.c_void_p), rels_cap,
                out_lens.ctypes.data_as(ctypes.c_void_p), max_paths)
            if n >= 0:
                break
            nodes_cap *= 4
            rels_cap *= 4
        paths = []
        npos = rpos = 0
        for i in range(n):
            L = int(out_lens[i])
            paths.append((out_nodes[npos:npos + L + 1].tolist(),
                          out_rels[rpos:rpos + L].tolist()))
            npos += L + 1
            rpos += L
        return paths

    def paths_from_source(self, src: int, dsts: Sequence[int],
                          max_paths_per_pair: int = 10_000
                          ) -> List[List[Tuple[List[int], List[int]]]]:
        """ONE BFS from src, all shortest paths to every dst. Returns, per
        dst, a list of (node_seq, rel_seq) — the amortised fast path for a
        question's full candidate set."""
        dsts_a = np.ascontiguousarray(list(dsts), np.int32)
        n_dst = len(dsts_a)
        # thread-local scratch buffers, grown on demand (a fresh np.empty
        # per call is a measurable share of a question's path time;
        # thread-local because serve_http handles requests concurrently)
        scratch = getattr(_TLS, "scratch", None)
        if scratch is None:
            scratch = _TLS.scratch = [np.empty(1 << 16, np.int32),
                                      np.empty(1 << 16, np.int32),
                                      np.empty(1 << 14, np.int32)]
        nodes_cap, rels_cap, lens_cap = (len(scratch[0]), len(scratch[1]),
                                         len(scratch[2]))
        while True:
            if len(scratch[0]) < nodes_cap:
                scratch[0] = np.empty(nodes_cap, np.int32)
            if len(scratch[1]) < rels_cap:
                scratch[1] = np.empty(rels_cap, np.int32)
            if len(scratch[2]) < lens_cap:
                scratch[2] = np.empty(lens_cap, np.int32)
            out_nodes, out_rels, out_lens = scratch
            counts = np.empty(max(n_dst, 1), np.int32)
            n = self._lib.gp_paths_from_source(
                self._handle, int(src),
                dsts_a.ctypes.data_as(ctypes.c_void_p), n_dst,
                max_paths_per_pair,
                out_nodes.ctypes.data_as(ctypes.c_void_p), nodes_cap,
                out_rels.ctypes.data_as(ctypes.c_void_p), rels_cap,
                out_lens.ctypes.data_as(ctypes.c_void_p), lens_cap,
                counts.ctypes.data_as(ctypes.c_void_p))
            if n >= 0:
                break
            nodes_cap *= 4
            rels_cap *= 4
            lens_cap *= 4
        per_dst: List[List[Tuple[List[int], List[int]]]] = []
        npos = rpos = p = 0
        for j in range(n_dst):
            paths = []
            for _ in range(int(counts[j])):
                L = int(out_lens[p])
                paths.append((out_nodes[npos:npos + L + 1].tolist(),
                              out_rels[rpos:rpos + L].tolist()))
                npos += L + 1
                rpos += L
                p += 1
            per_dst.append(paths)
        return per_dst

    def random_walks(self, sources: Sequence[int], n_walks: int,
                     walk_len: int, seed: int = 0) -> np.ndarray:
        """[n_sources * n_walks, walk_len + 1] node ids, -1 padded
        (graph-walker replacement)."""
        src = np.ascontiguousarray(list(sources), np.int32)
        out = np.empty((len(src) * n_walks, walk_len + 1), np.int32)
        self._lib.gp_random_walks(self._handle,
                                  src.ctypes.data_as(ctypes.c_void_p),
                                  len(src), n_walks, walk_len,
                                  ctypes.c_uint64(seed or 1),
                                  out.ctypes.data_as(ctypes.c_void_p))
        return out

    def bfs_dist(self, sources: Sequence[int]) -> np.ndarray:
        src = np.ascontiguousarray(list(sources), np.int32)
        dist = np.empty(self.n_nodes, np.int32)
        self._lib.gp_bfs_dist(self._handle,
                              src.ctypes.data_as(ctypes.c_void_p),
                              len(src), dist.ctypes.data_as(ctypes.c_void_p))
        return dist


def _intern_native(strs: List[str], strip: bool = False):
    """(values_in_first_occurrence_order, int32 id_per_element) via
    gp_intern — the native equivalent of sequential
    `dict.setdefault(v, len(dict))` interning. With strip=True ASCII
    whitespace is trimmed (in C++) before hashing AND from the returned
    unique values. Raises TypeError on non-string items and ValueError on
    embedded NULs (callers fall back to the Python dict loop)."""
    lib = _load()
    buf = "\0".join(strs).encode("utf-8") + b"\0"
    out_ids = np.empty(len(strs), np.int32)
    out_first = np.empty(len(strs), np.int32)
    n_uniq = lib.gp_intern(buf, len(buf), len(strs), int(strip),
                           out_ids.ctypes.data_as(ctypes.c_void_p),
                           out_first.ctypes.data_as(ctypes.c_void_p),
                           len(strs))
    if n_uniq < 0:
        raise ValueError("gp_intern failed")  # -1 cap, -2 embedded NUL
    if strip:
        # gp_intern strips ASCII whitespace only; Python str.strip() also
        # strips Unicode whitespace. If two ids collapse to one string
        # after the Python strip (e.g. 'r ' vs 'r\xa0'), the C ids diverge
        # from the oracle's — fall back to dict interning for correctness.
        survivors = [strs[i].strip() for i in out_first[:n_uniq]]
        if len(set(survivors)) != len(survivors):
            raise ValueError("unicode-whitespace relation variants")
        return survivors, out_ids
    return [strs[i] for i in out_first[:n_uniq]], out_ids


def truth_paths_native(triples: Sequence[Tuple[str, str, str]],
                       q_entities: Sequence[str], answers: Sequence[str],
                       max_paths_per_pair: int = 10_000,
                       keep_parallel: bool = False
                       ) -> Optional[List[List[Tuple[str, str, str]]]]:
    """Native fast path for rag.graph_utils.get_truth_paths. Returns None when
    the library is unavailable. keep_parallel verbalizes parallel edges as
    "r1 | r2" (first-seen order, deduped) instead of the reference's
    last-write-wins collapse — same semantics as the Python oracle's
    UndirectedGraph(keep_parallel=True)."""
    if not available():
        return None
    n = len(triples)
    n_q, n_a = len(q_entities), len(answers)
    try:
        # C++ interning (gp_intern): join every string into one
        # NUL-separated utf-8 buffer, hash string_views into it natively.
        # First-occurrence id order — bitwise-identical ids (and therefore
        # path enumeration order) to the old per-edge dict loop, which at
        # 8k triples cost ~3x the actual C++ BFS. The question entities and
        # answers ride the SAME intern call: their ids are graph node ids
        # iff < the graph's unique count (no per-question str->id dict).
        # Relation whitespace-stripping happens inside gp_intern (ASCII ws;
        # exotic unicode ws falls back to the Python oracle's semantics
        # only via the dict path below).
        node_strs = [t[0] for t in triples] + [t[2] for t in triples]
        node_strs += list(q_entities)
        node_strs += list(answers)
        rel_strs = [t[1] for t in triples]
        id_node, node_ids = _intern_native(node_strs)
        id_rel, rel_ids = _intern_native(rel_strs, strip=True)
        heads_a = node_ids[:n]
        tails_a = node_ids[n:2 * n]
        rels_a = rel_ids
        ng = int(node_ids[:2 * n].max()) + 1 if n else 0
        src_ids = node_ids[2 * n:2 * n + n_q]
        dst_all = node_ids[2 * n + n_q:]
    except (TypeError, AttributeError, ValueError):
        # non-uniformly-typed keys (unsortable mix) — dict interning
        node_id = {}
        rel_id: Dict[str, int] = {}
        heads_a = np.empty(n, np.int32)
        rels_a = np.empty(n, np.int32)
        tails_a = np.empty(n, np.int32)
        ng = nr = 0
        for i, (h, r, t) in enumerate(triples):
            v = node_id.get(h)
            if v is None:
                v = node_id[h] = ng
                ng += 1
            heads_a[i] = v
            r = r.strip() if isinstance(r, str) else r
            v = rel_id.get(r)
            if v is None:
                v = rel_id[r] = nr
                nr += 1
            rels_a[i] = v
            v = node_id.get(t)
            if v is None:
                v = node_id[t] = ng
                ng += 1
            tails_a[i] = v
        id_node = list(node_id)
        id_rel = list(rel_id)
        src_ids = [node_id.get(h, ng) for h in q_entities]
        dst_all = [node_id.get(t, ng) for t in answers]
    g = NativeGraph(heads_a, rels_a, tails_a, ng, keep_parallel=keep_parallel)
    rel_str = id_rel
    if keep_parallel:
        n_base, members = g.composite_rels()
        rel_str = list(id_rel[:n_base])
        rel_str += [" | ".join(id_rel[m] for m in ms) for ms in members]
    out: List[List[Tuple[str, str, str]]] = []
    dst_ids = [int(d) for d in dst_all if d < ng]
    for s in src_ids:
        if s >= ng:
            continue
        # one BFS per question entity, paths to ALL candidates at once
        for paths in g.paths_from_source(int(s), dst_ids,
                                         max_paths_per_pair):
            for node_seq, rel_seq in paths:
                out.append([(id_node[node_seq[i]], rel_str[rel_seq[i]],
                             id_node[node_seq[i + 1]])
                            for i in range(len(rel_seq))])
    return out
