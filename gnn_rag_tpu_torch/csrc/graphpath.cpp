// graphpath — native shortest-path enumeration for the RAG stage.
//
// Replaces the reference's per-question networkx hot loop
// (llm/src/utils/graph_utils.py:49-75: nx.all_shortest_paths between every
// (question entity, GNN candidate) pair) with a CSR BFS + predecessor-DAG
// enumerator. Semantics match rag/graph_utils.py (the Python oracle):
// undirected graph, parallel edges collapse to the LAST triple's relation,
// src == dst yields one zero-length path, unreachable pairs yield none.
//
// C ABI only (ctypes-friendly). Build: `make` in this directory.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <queue>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Graph {
  int32_t n_nodes = 0;
  // CSR over the deduplicated undirected adjacency
  std::vector<int64_t> row_ptr;
  std::vector<int32_t> col;
  std::vector<int32_t> rel;
  // keep_parallel mode: rel ids >= n_base_rels are COMPOSITE — parallel
  // edges keep every distinct relation (first-seen order) instead of the
  // reference's last-write-wins collapse. comp_ptr/comp_vals is a CSR of
  // member base-rel ids for composite id c at index (c - n_base_rels).
  int32_t n_base_rels = 0;
  std::vector<int64_t> comp_ptr{0};
  std::vector<int32_t> comp_vals;
};

struct Workspace {
  std::vector<int32_t> dist;
  std::vector<int64_t> parent_ptr;   // offsets into parents
  std::vector<int32_t> parents;      // flattened predecessor lists
  std::vector<int32_t> frontier, next_frontier;
};

}  // namespace

extern "C" {

void* gp_build(const int32_t* heads, const int32_t* rels, const int32_t* tails,
               int64_t n_edges, int32_t n_nodes, int32_t keep_parallel) {
  auto* g = new Graph();
  g->n_nodes = n_nodes;
  // Two-pass counting-sort CSR build (O(E + V), replaces the r03 std::sort
  // O(E log E) which was ~40% of truth_paths time at 8k-triple graphs),
  // with last-wins dedup of undirected parallel edges. Neighbor order
  // within a row is first-occurrence input order (deterministic; the
  // Python oracle's dict order is likewise insertion order).
  std::vector<int32_t> cnt(n_nodes + 1, 0);
  for (int64_t i = 0; i < n_edges; ++i) {
    int32_t h = heads[i], t = tails[i];
    if (h < 0 || h >= n_nodes || t < 0 || t >= n_nodes) continue;
    ++cnt[h + 1];
    ++cnt[t + 1];
  }
  for (int32_t u = 0; u < n_nodes; ++u) cnt[u + 1] += cnt[u];
  int64_t total = cnt[n_nodes];
  std::vector<int32_t> col(total), rel(total);
  std::vector<int32_t> cursor(cnt.begin(), cnt.end() - 1);
  for (int64_t i = 0; i < n_edges; ++i) {
    int32_t h = heads[i], t = tails[i], r = rels[i];
    if (h < 0 || h >= n_nodes || t < 0 || t >= n_nodes) continue;
    col[cursor[h]] = t; rel[cursor[h]] = r; ++cursor[h];
    col[cursor[t]] = h; rel[cursor[t]] = r; ++cursor[t];
  }
  // per-row dedup keeping the LAST input occurrence's relation (reference
  // collapse) or, with keep_parallel, ALL distinct relations in first-seen
  // order; epoch-stamped slot map avoids clearing an n_nodes array per row
  std::vector<int32_t> stamp(n_nodes, -1);
  std::vector<int64_t> slot_of(n_nodes, 0);
  // keep_parallel: g->rel[slot] holds the FIRST relation; only slots that
  // see a second distinct relation get a list here (parallel edges are a
  // small minority — allocating a vector per slot cost ~40% of the build)
  std::unordered_map<int64_t, std::vector<int32_t>> extra;
  g->row_ptr.assign(n_nodes + 1, 0);
  g->col.reserve(total);
  g->rel.reserve(total);
  for (int32_t u = 0; u < n_nodes; ++u) {
    int64_t row_start = static_cast<int64_t>(g->col.size());
    for (int64_t k = cnt[u]; k < cnt[u + 1]; ++k) {
      int32_t v = col[k];
      if (stamp[v] == u) {
        int64_t s = slot_of[v];
        if (keep_parallel) {
          if (rel[k] != g->rel[s]) {
            auto& L = extra[s];
            if (L.empty()) L.push_back(g->rel[s]);
            if (std::find(L.begin(), L.end(), rel[k]) == L.end())
              L.push_back(rel[k]);
          }
        } else {
          g->rel[s] = rel[k];  // parallel edge: last one wins
        }
      } else {
        stamp[v] = u;
        slot_of[v] = static_cast<int64_t>(g->col.size());
        g->col.push_back(v);
        g->rel.push_back(rel[k]);
      }
    }
    g->row_ptr[u + 1] = g->row_ptr[u]
        + (static_cast<int64_t>(g->col.size()) - row_start);
  }
  if (keep_parallel) {
    int32_t max_rel = -1;
    for (int32_t r : g->rel) max_rel = std::max(max_rel, r);
    g->n_base_rels = max_rel + 1;
    std::map<std::vector<int32_t>, int32_t> comp_ids;
    for (auto& [s, L] : extra) {
      auto [it, inserted] = comp_ids.emplace(
          L, g->n_base_rels + static_cast<int32_t>(comp_ids.size()));
      if (inserted) {
        g->comp_vals.insert(g->comp_vals.end(), L.begin(), L.end());
        g->comp_ptr.push_back(static_cast<int64_t>(g->comp_vals.size()));
      }
      g->rel[s] = it->second;
    }
  }
  return g;
}

// keep_parallel accessors: composite-id table (see Graph).
int32_t gp_n_base_rels(void* graph) {
  return static_cast<Graph*>(graph)->n_base_rels;
}

int64_t gp_n_composite(void* graph) {
  return static_cast<int64_t>(static_cast<Graph*>(graph)->comp_ptr.size()) - 1;
}

int64_t gp_composite_vals_len(void* graph) {
  return static_cast<int64_t>(static_cast<Graph*>(graph)->comp_vals.size());
}

void gp_composite_table(void* graph, int64_t* out_ptr, int32_t* out_vals) {
  const Graph& g = *static_cast<Graph*>(graph);
  std::copy(g.comp_ptr.begin(), g.comp_ptr.end(), out_ptr);
  std::copy(g.comp_vals.begin(), g.comp_vals.end(), out_vals);
}

void gp_free(void* graph) { delete static_cast<Graph*>(graph); }

// Enumerate all shortest paths src -> dst.
// Output layout: for each path p, out_lens[p] = L (edge count) and the node
// sequence (L+1 int32 values) is appended to out_nodes. Relations are
// recoverable from the graph, but for convenience out_rels receives the L
// relation ids per path, appended contiguously.
// Returns the number of paths written (<= max_paths); -1 if the output
// buffers are too small.
int64_t gp_all_shortest_paths(void* graph, int32_t src, int32_t dst,
                              int64_t max_paths, int32_t* out_nodes,
                              int64_t nodes_cap, int32_t* out_rels,
                              int64_t rels_cap, int32_t* out_lens,
                              int64_t lens_cap) {
  const Graph& g = *static_cast<Graph*>(graph);
  if (src < 0 || src >= g.n_nodes || dst < 0 || dst >= g.n_nodes) return 0;
  if (src == dst) {
    if (lens_cap < 1 || nodes_cap < 1) return -1;
    out_lens[0] = 0;
    out_nodes[0] = src;
    return 1;
  }

  thread_local Workspace ws;
  ws.dist.assign(g.n_nodes, -1);
  ws.parent_ptr.assign(g.n_nodes + 1, 0);
  std::vector<std::vector<int32_t>> preds(g.n_nodes);

  ws.frontier.clear();
  ws.frontier.push_back(src);
  ws.dist[src] = 0;
  int32_t d = 0;
  bool found = false;
  while (!ws.frontier.empty() && !found) {
    ++d;
    ws.next_frontier.clear();
    for (int32_t u : ws.frontier) {
      for (int64_t k = g.row_ptr[u]; k < g.row_ptr[u + 1]; ++k) {
        int32_t v = g.col[k];
        if (ws.dist[v] == -1) {
          ws.dist[v] = d;
          preds[v].push_back(u);
          ws.next_frontier.push_back(v);
        } else if (ws.dist[v] == d) {
          preds[v].push_back(u);
        }
      }
    }
    if (ws.dist[dst] == d) found = true;
    ws.frontier.swap(ws.next_frontier);
  }
  if (!found) return 0;

  // backward DFS over the predecessor DAG
  int64_t n_paths = 0, node_pos = 0, rel_pos = 0;
  std::vector<std::pair<int32_t, std::vector<int32_t>>> stack;
  stack.push_back({dst, {dst}});
  while (!stack.empty()) {
    auto [node, path] = std::move(stack.back());
    stack.pop_back();
    if (node == src) {
      int32_t L = static_cast<int32_t>(path.size()) - 1;
      if (n_paths >= lens_cap || node_pos + L + 1 > nodes_cap ||
          rel_pos + L > rels_cap)
        return -1;
      out_lens[n_paths] = L;
      // path is dst..src; reverse to src..dst
      for (int64_t i = path.size() - 1; i >= 0; --i)
        out_nodes[node_pos++] = path[i];
      // relations along the reversed path
      for (int64_t i = path.size() - 1; i >= 1; --i) {
        int32_t u = path[i], v = path[i - 1];
        int32_t r = -1;
        for (int64_t k = g.row_ptr[u]; k < g.row_ptr[u + 1]; ++k)
          if (g.col[k] == v) { r = g.rel[k]; break; }
        out_rels[rel_pos++] = r;
      }
      ++n_paths;
      if (n_paths >= max_paths) break;
      continue;
    }
    for (int32_t p : preds[node]) {
      auto np = path;
      np.push_back(p);
      stack.push_back({p, std::move(np)});
    }
  }
  return n_paths;
}

// One BFS from `src`, then enumerate all shortest paths to EVERY
// destination in `dsts` — amortises the BFS the per-pair entry point
// (gp_all_shortest_paths) repeats for each GNN candidate of a question.
// Packed output: paths appear grouped by destination (out_pair_counts[j]
// paths for dsts[j]); layout of out_nodes/out_rels/out_lens matches
// gp_all_shortest_paths. Returns total paths, or -1 if buffers are too
// small.
int64_t gp_paths_from_source(void* graph, int32_t src, const int32_t* dsts,
                             int32_t n_dst, int64_t max_paths_per_pair,
                             int32_t* out_nodes, int64_t nodes_cap,
                             int32_t* out_rels, int64_t rels_cap,
                             int32_t* out_lens, int64_t lens_cap,
                             int32_t* out_pair_counts) {
  const Graph& g = *static_cast<Graph*>(graph);
  std::fill(out_pair_counts, out_pair_counts + n_dst, 0);
  if (src < 0 || src >= g.n_nodes) return 0;

  // full-graph BFS with predecessor lists
  std::vector<int32_t> dist(g.n_nodes, -1);
  std::vector<std::vector<int32_t>> preds(g.n_nodes);
  std::vector<int32_t> frontier{src}, next_frontier;
  dist[src] = 0;
  int32_t d = 0;
  while (!frontier.empty()) {
    ++d;
    next_frontier.clear();
    for (int32_t u : frontier) {
      for (int64_t k = g.row_ptr[u]; k < g.row_ptr[u + 1]; ++k) {
        int32_t v = g.col[k];
        if (dist[v] == -1) {
          dist[v] = d;
          preds[v].push_back(u);
          next_frontier.push_back(v);
        } else if (dist[v] == d) {
          preds[v].push_back(u);
        }
      }
    }
    frontier.swap(next_frontier);
  }

  int64_t n_paths = 0, node_pos = 0, rel_pos = 0;
  std::vector<std::pair<int32_t, std::vector<int32_t>>> stack;
  for (int32_t j = 0; j < n_dst; ++j) {
    int32_t dst = dsts[j];
    if (dst < 0 || dst >= g.n_nodes) continue;
    if (dst == src) {
      if (n_paths >= lens_cap || node_pos + 1 > nodes_cap) return -1;
      out_lens[n_paths] = 0;
      out_nodes[node_pos++] = src;
      ++n_paths;
      out_pair_counts[j] = 1;
      continue;
    }
    if (dist[dst] == -1) continue;
    int64_t pair_paths = 0;
    stack.clear();
    stack.push_back({dst, {dst}});
    while (!stack.empty()) {
      auto [node, path] = std::move(stack.back());
      stack.pop_back();
      if (node == src) {
        int32_t L = static_cast<int32_t>(path.size()) - 1;
        if (n_paths >= lens_cap || node_pos + L + 1 > nodes_cap ||
            rel_pos + L > rels_cap)
          return -1;
        out_lens[n_paths] = L;
        for (int64_t i = path.size() - 1; i >= 0; --i)
          out_nodes[node_pos++] = path[i];
        for (int64_t i = path.size() - 1; i >= 1; --i) {
          int32_t u = path[i], v = path[i - 1];
          int32_t r = -1;
          for (int64_t k = g.row_ptr[u]; k < g.row_ptr[u + 1]; ++k)
            if (g.col[k] == v) { r = g.rel[k]; break; }
          out_rels[rel_pos++] = r;
        }
        ++n_paths;
        ++pair_paths;
        if (pair_paths >= max_paths_per_pair) break;
        continue;
      }
      for (int32_t p : preds[node]) {
        auto np = path;
        np.push_back(p);
        stack.push_back({p, std::move(np)});
      }
    }
    out_pair_counts[j] = static_cast<int32_t>(pair_paths);
  }
  return n_paths;
}

// Uniform random walks (native replacement for the reference's graph-walker
// pybind11 dependency, llm/src/utils/graph_utils.py:114,139). For each
// source, n_walks walks of up to walk_len steps; out receives
// (walk_len + 1) node ids per walk, -1 padded when a walk dead-ends.
void gp_random_walks(void* graph, const int32_t* sources, int32_t n_sources,
                     int32_t n_walks, int32_t walk_len, uint64_t seed,
                     int32_t* out) {
  const Graph& g = *static_cast<Graph*>(graph);
  uint64_t state = seed ? seed : 0x9E3779B97F4A7C15ull;
  auto next_rand = [&state]() {
    // xorshift64*
    state ^= state >> 12;
    state ^= state << 25;
    state ^= state >> 27;
    return state * 0x2545F4914F6CDD1Dull;
  };
  int64_t pos = 0;
  const int64_t stride = walk_len + 1;
  for (int32_t s = 0; s < n_sources; ++s) {
    for (int32_t wi = 0; wi < n_walks; ++wi) {
      int32_t node = sources[s];
      int64_t base = pos * stride;
      for (int64_t k = 0; k < stride; ++k) out[base + k] = -1;
      out[base] = node;
      for (int32_t step = 1; step <= walk_len; ++step) {
        int64_t deg = g.row_ptr[node + 1] - g.row_ptr[node];
        if (deg <= 0) break;
        node = g.col[g.row_ptr[node] + static_cast<int64_t>(next_rand() % deg)];
        out[base + step] = node;
      }
      ++pos;
    }
  }
}

// Batched convenience: BFS distances from a set of sources (used by the
// retrieval-recall tooling). dist must hold n_nodes int32.
void gp_bfs_dist(void* graph, const int32_t* sources, int32_t n_sources,
                 int32_t* dist) {
  const Graph& g = *static_cast<Graph*>(graph);
  std::fill(dist, dist + g.n_nodes, -1);
  std::queue<int32_t> q;
  for (int32_t i = 0; i < n_sources; ++i) {
    int32_t s = sources[i];
    if (s >= 0 && s < g.n_nodes && dist[s] == -1) {
      dist[s] = 0;
      q.push(s);
    }
  }
  while (!q.empty()) {
    int32_t u = q.front();
    q.pop();
    for (int64_t k = g.row_ptr[u]; k < g.row_ptr[u + 1]; ++k) {
      int32_t v = g.col[k];
      if (dist[v] == -1) {
        dist[v] = dist[u] + 1;
        q.push(v);
      }
    }
  }
}

// Binding handshake: the ctypes loader rebuilds the library when this does
// not match its expected value (a stale libgraphpath.so from an older
// checkout would otherwise be called with the wrong signatures).
int32_t gp_abi_version() { return 3; }

// String interning for the truth_paths wrapper: `buf` holds n_items
// NUL-terminated utf-8 strings back to back. Writes the first-occurrence-
// order id of every item to out_ids[n_items] and, for each new id, the item
// index of its first occurrence to out_first (so the caller can map ids
// back to its own string objects without copies). With strip_ws, ASCII
// whitespace is trimmed from both ends BEFORE hashing, so "a" and "a "
// intern to one id (the truth-paths relation semantics; callers re-strip
// the unique survivors for display — ~200 strips instead of 8k per
// question). Returns the number of unique strings, -1 if out_first
// (capacity cap_first) is too small, or -2 on a malformed buffer (embedded
// NULs shift the item boundaries, detected by the final p != end check).
// Python-side dict interning of a question's strings costs more than the
// BFS itself; hashing string_views into the caller's buffer is far cheaper.
int64_t gp_intern(const char* buf, int64_t buf_len, int64_t n_items,
                  int32_t strip_ws, int32_t* out_ids, int32_t* out_first,
                  int64_t cap_first) {
  // open-addressing FNV-1a table (cheaper than std::unordered_map of
  // string_views, which cost more than the whole BFS)
  size_t cap = 16;
  while (cap < static_cast<size_t>(n_items) * 2) cap <<= 1;
  const size_t mask = cap - 1;
  struct Slot { const char* s; size_t len; uint64_t hash; int32_t id; };
  std::vector<Slot> table(cap, Slot{nullptr, 0, 0, -1});

  const char* p = buf;
  const char* end = buf + buf_len;
  int32_t next_id = 0;
  auto is_ws = [](char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
           c == '\f' || c == '\v';
  };
  for (int64_t i = 0; i < n_items; ++i) {
    if (p >= end) return -2;  // malformed buffer
    size_t len = strnlen(p, static_cast<size_t>(end - p));
    const char* s = p;
    size_t slen = len;
    if (strip_ws) {
      while (slen > 0 && is_ws(s[0])) { ++s; --slen; }
      while (slen > 0 && is_ws(s[slen - 1])) --slen;
    }
    uint64_t h = 0xCBF29CE484222325ull;  // FNV-1a 64
    for (size_t k = 0; k < slen; ++k) {
      h ^= static_cast<unsigned char>(s[k]);
      h *= 0x100000001B3ull;
    }
    size_t pos = static_cast<size_t>(h) & mask;
    while (true) {
      Slot& sl = table[pos];
      if (sl.id < 0) {  // new string
        if (next_id >= cap_first) return -1;
        sl = Slot{s, slen, h, next_id};
        out_first[next_id] = static_cast<int32_t>(i);
        out_ids[i] = next_id;
        ++next_id;
        break;
      }
      if (sl.hash == h && sl.len == slen && memcmp(sl.s, s, slen) == 0) {
        out_ids[i] = sl.id;
        break;
      }
      pos = (pos + 1) & mask;
    }
    p += len + 1;
  }
  if (p != end) return -2;  // embedded NULs left unconsumed segments
  return next_id;
}

}  // extern "C"
