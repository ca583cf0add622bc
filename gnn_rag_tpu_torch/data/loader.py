"""JSONL KGQA dataset ingestion -> padded GraphBatch assembly.

Numpy copy of ``gnn_rag_tpu.data.loader`` (``ingest_question``,
``KGQADataset``, ``load_split``, ``load_dataset_dir``) with the same
semantics, ported from the reference loader (gnn/dataset_load.py:18-691):

* skip questions with zero query entities (dataset_load.py:50-52);
* global->local entity map: question entities first, then subgraph entities,
  insertion-ordered (dataset_load.py:536-557);
* candidate entity slots hold the *global* id, except (a) padding and (b) on
  non-CWQ datasets the question-entity slots, which are masked out of the
  candidate set (dataset_load.py:249-257);
* seed distribution uniform over query entities, falling back to uniform over
  all local entities (dataset_load.py:293-298);
* answers resolved from 'answers_cid' ints or 'answers' dicts with the
  text/kb_id keyword quirk (dataset_load.py:314-330);
* optional inverse relations double the fact list with rel+|R|
  (dataset_load.py:287-291); optional self loops append (e, selfloop, e) per
  real local entity with the last relation id (dataset_load.py:499-506);
* per-(head,rel) inverse-count weights (dataset_load.py:514-517).

Every batch carries the tile-sorted kernel layout, which the models' kernel
path walks (their COO path runs on a batch whose layout is set to None).
``load_split`` can ingest in a process pool and caches its records in a
pickle beside the split; ``load_relation_emb`` reads a pretrained relation
table.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .batch import (DEFAULT_ENTITY_BUCKETS, DEFAULT_FACT_BUCKETS, GraphBatch,
                    bucketize)
from .kernel_layout import TILE_E, TILE_F, build_sample_direction, pack_samples
from .rel_text import tokenize_relations
from .tokenizers import make_tokenizer
from .vocab import Vocab


@dataclass
class QuestionRecord:
    """One ingested question (host-side, unpadded)."""

    qid: object
    question: str
    heads: np.ndarray        # int32 [n_facts] local ids (incl. inverse + self loops)
    rels: np.ndarray         # int32 [n_facts]
    tails: np.ndarray        # int32 [n_facts]
    droppable: np.ndarray    # bool  [n_facts] False for self loops
    rel_pair_weight: np.ndarray  # float32 [n_facts] 1/count(head, rel)
    entity_gids: np.ndarray  # int64 [n_entities] local -> global
    seed_locals: np.ndarray  # int32 [n_seeds]
    candidate_masked_seeds: bool  # True on non-CWQ: seeds excluded from candidates
    answer_gids: List[int]   # global answer entity ids
    answer_locals: np.ndarray  # int32 local ids of in-graph answers
    q_token_ids: np.ndarray  # int32 [q_len]
    # per-E cache of tile-sorted kernel layouts (built lazily at batch time)
    kl_cache: dict = field(default_factory=dict, repr=False)

    @property
    def n_entities(self) -> int:
        return len(self.entity_gids)

    @property
    def n_facts(self) -> int:
        return len(self.heads)


def _resolve_entity(e, entity2id):
    """Entity field may be a raw id, a name, or {'text': name}
    (dataset_load.py:227-246, 561-575)."""
    if isinstance(e, dict) and "text" in e:
        e = e["text"]
    if e in entity2id:
        return entity2id[e]
    return e  # already a global id (dataset_load.py:237-238)


def _resolve_relation(r, relation2id):
    if isinstance(r, dict) and "text" in r:
        r = r["text"]
    if r in relation2id:
        return relation2id[r]
    return int(r)


def ingest_question(sample: dict, vocab: Vocab, *, data_name: str,
                    use_inverse_relation: bool, use_self_loop: bool,
                    num_kb_relation: int) -> Optional[QuestionRecord]:
    """Convert one JSONL line into a QuestionRecord, or None to skip."""
    key_ent = "entities_cid" if "entities_cid" in sample else "entities"
    if len(sample[key_ent]) == 0:
        return None  # dataset_load.py:50-52

    entity2id = vocab.entity2id
    relation2id = vocab.relation2id

    # global -> local map: question entities first, then subgraph entities
    g2l: Dict[int, int] = {}
    for e in sample[key_ent]:
        g = _resolve_entity(e, entity2id)
        if g not in g2l:
            g2l[g] = len(g2l)
    for e in sample["subgraph"]["entities"]:
        g = _resolve_entity(e, entity2id)
        if g not in g2l:
            g2l[g] = len(g2l)
    if not g2l:
        return None

    seed_locals = sorted({g2l[_resolve_entity(e, entity2id)]
                          for e in sample[key_ent]
                          if _resolve_entity(e, entity2id) in g2l})

    heads: List[int] = []
    rels: List[int] = []
    tails: List[int] = []
    for (s, r, o) in sample["subgraph"]["tuples"]:
        h = g2l[_resolve_entity(s, entity2id)]
        rel = _resolve_relation(r, relation2id)
        t = g2l[_resolve_entity(o, entity2id)]
        heads.append(h); rels.append(rel); tails.append(t)
        if use_inverse_relation:
            heads.append(t); rels.append(rel + len(relation2id)); tails.append(h)
    n_real = len(heads)
    if use_self_loop:
        self_rel = num_kb_relation - 1
        for le in range(len(g2l)):
            heads.append(le); rels.append(self_rel); tails.append(le)

    heads_a = np.asarray(heads, dtype=np.int32)
    rels_a = np.asarray(rels, dtype=np.int32)
    tails_a = np.asarray(tails, dtype=np.int32)
    droppable = np.zeros(len(heads), dtype=bool)
    droppable[:n_real] = True

    # 1 / count(head, rel) among this question's facts (dataset_load.py:514-517)
    pair_keys = heads_a.astype(np.int64) * (num_kb_relation + 1) + rels_a
    _, inv, counts = np.unique(pair_keys, return_inverse=True, return_counts=True)
    rel_pair_weight = (1.0 / counts[inv]).astype(np.float32)

    # answers (dataset_load.py:314-330)
    answer_gids: List[int] = []
    if "answers_cid" in sample:
        answer_gids = list(sample["answers_cid"])
    else:
        for ans in sample.get("answers", []):
            if isinstance(ans, str):
                # serving payloads send bare answer strings — or none at all;
                # unknown entities are skipped because answers only feed
                # metrics, not retrieval
                if ans in entity2id:
                    answer_gids.append(entity2id[ans])
                continue
            keyword = "text" if isinstance(ans.get("kb_id"), int) else "kb_id"
            answer_gids.append(entity2id[ans[keyword]])
    answer_locals = np.asarray([g2l[a] for a in answer_gids if a in g2l],
                               dtype=np.int32)

    entity_gids = np.empty(len(g2l), dtype=np.int64)
    for g, l in g2l.items():
        entity_gids[l] = g

    return QuestionRecord(
        qid=sample.get("id"),
        question=sample["question"],
        heads=heads_a, rels=rels_a, tails=tails_a,
        droppable=droppable, rel_pair_weight=rel_pair_weight,
        entity_gids=entity_gids,
        seed_locals=np.asarray(seed_locals, dtype=np.int32),
        candidate_masked_seeds=(data_name != "cwq"),
        answer_gids=answer_gids, answer_locals=answer_locals,
        q_token_ids=np.zeros(0, dtype=np.int32),
    )


class KGQADataset:
    """One split (train/dev/test) of ingested questions plus batch assembly."""

    def __init__(self, records: Sequence[QuestionRecord], *, num_entity: int,
                 num_kb_relation: int, entity_buckets=None, fact_buckets=None,
                 pad_token_id: int = 0):
        self.records = list(records)
        self.num_entity = num_entity
        self.num_kb_relation = num_kb_relation
        self.entity_buckets = tuple(entity_buckets or DEFAULT_ENTITY_BUCKETS)
        self.fact_buckets = tuple(fact_buckets or DEFAULT_FACT_BUCKETS)
        self.pad_token_id = pad_token_id
        self._order = np.arange(len(self.records))
        # optional per-record precomputed frozen-LM hidden states
        self.q_hidden: Optional[List[np.ndarray]] = None

    def __len__(self):
        return len(self.records)

    @property
    def num_data(self):
        return len(self.records)

    @property
    def max_local_entity(self) -> int:
        return max((r.n_entities for r in self.records), default=0)

    def reset_batches(self, is_sequential: bool = True,
                      rng: Optional[np.random.Generator] = None,
                      bucket_size: Optional[int] = None):
        """Shuffle (or restore) the iteration order. With ``bucket_size``,
        shuffled questions are grouped into batches of similar fact counts
        (random jitter keeps epochs distinct), cutting padding waste on
        skewed datasets like CWQ; batch order is then shuffled. The reference
        shuffles uniformly and pads everything to the dataset max
        (dataset_load.py:530-534, 54)."""
        if is_sequential:
            self._order = np.arange(len(self.records))
            return
        rng = rng or np.random.default_rng()
        if not bucket_size:
            self._order = rng.permutation(len(self.records))
            return
        sizes = np.asarray([r.n_facts for r in self.records], np.float64)
        jitter = rng.random(len(sizes)) * 0.5  # random tie-breaks + mixing
        order = np.argsort(sizes * (1.0 + jitter), kind="stable")
        batches = [order[i:i + bucket_size]
                   for i in range(0, len(order), bucket_size)]
        rng.shuffle(batches)
        self._order = np.concatenate(batches)

    def tokenize_questions(self, tokenizer, max_len: Optional[int] = None,
                           add_special: bool = True):
        texts = [r.question for r in self.records]
        if max_len is None:
            max_len = max((len(t.split(" ")) for t in texts), default=1)
            if add_special:
                max_len += 2  # CLS/SEP (dataset_load.py:206)
        ids = tokenizer.encode(texts, max_len)
        for r, row in zip(self.records, ids):
            r.q_token_ids = np.asarray(row, dtype=np.int32)
        self.pad_token_id = tokenizer.pad_id
        return max_len

    def batch_indices(self, iteration: int, batch_size: int) -> np.ndarray:
        start = batch_size * iteration
        end = min(batch_size * (iteration + 1), len(self.records))
        return self._order[start:end]

    def make_batch(self, indices: Sequence[int], *,
                   batch_pad_to: Optional[int] = None) -> GraphBatch:
        recs = [self.records[i] for i in indices]
        B = batch_pad_to or len(recs)
        E = bucketize(max(r.n_entities for r in recs), self.entity_buckets)
        E = -(-E // TILE_E) * TILE_E  # kernel tiles need a 128-multiple
        F = bucketize(max(r.n_facts for r in recs), self.fact_buckets)
        L = bucketize(max(len(r.q_token_ids) for r in recs),
                      (16, 32, 64, 128))  # question-length buckets too

        heads = np.zeros((B, F), np.int32)
        rels = np.full((B, F), self.num_kb_relation, np.int32)  # pad rel row
        tails = np.zeros((B, F), np.int32)
        fact_mask = np.zeros((B, F), np.float32)
        rel_pair_w = np.zeros((B, F), np.float32)
        entity_gids = np.full((B, E), self.num_entity, np.int64)
        ent_present = np.zeros((B, E), np.float32)
        seed_dist = np.zeros((B, E), np.float32)
        query_entities = np.zeros((B, E), np.float32)
        answer_dist = np.zeros((B, E), np.float32)
        q_tokens = np.full((B, L), self.pad_token_id, np.int32)

        for i, r in enumerate(recs):
            nf, ne = r.n_facts, r.n_entities
            heads[i, :nf] = r.heads
            rels[i, :nf] = r.rels
            tails[i, :nf] = r.tails
            fact_mask[i, :nf] = 1.0
            rel_pair_w[i, :nf] = r.rel_pair_weight
            entity_gids[i, :ne] = r.entity_gids
            if r.candidate_masked_seeds:
                entity_gids[i, r.seed_locals] = self.num_entity  # dataset_load.py:249-257
            ent_present[i, :ne] = 1.0
            if len(r.seed_locals) > 0:
                seed_dist[i, r.seed_locals] = 1.0 / len(r.seed_locals)
            else:
                seed_dist[i, :ne] = 1.0 / ne  # dataset_load.py:296-298
            query_entities[i, r.seed_locals] = 1.0
            answer_dist[i, r.answer_locals] = 1.0
            q_tokens[i, : len(r.q_token_ids)] = r.q_token_ids

        empty = np.zeros(0, np.int32)
        empty_w = np.zeros(0, np.float32)
        fwd_s, inv_s = [], []
        for r in recs:
            if E not in r.kl_cache:
                r.kl_cache[E] = (
                    build_sample_direction(r.tails, r.heads, r.rels,
                                           r.rel_pair_weight, E,
                                           self.num_kb_relation),
                    build_sample_direction(r.heads, r.tails, r.rels,
                                           r.rel_pair_weight, E,
                                           self.num_kb_relation))
            f, iv = r.kl_cache[E]
            fwd_s.append(f)
            inv_s.append(iv)
        if B > len(recs):  # batch padding rows cover every tile, empty
            pad_sample = build_sample_direction(
                empty, empty, empty, empty_w, E, self.num_kb_relation)
            fwd_s.extend([pad_sample] * (B - len(recs)))
            inv_s.extend([pad_sample] * (B - len(recs)))
        # chunk count padded to the (E, F) bucket bound so the batch shape
        # depends only on the bucket, never on batch content (rounded to a
        # multiple of 8 like the JAX loader, so both build the same arrays)
        nc_bucket = F // TILE_F + E // TILE_E
        nc_bucket = -(-nc_bucket // 8) * 8
        layout = pack_samples(fwd_s, inv_s, E, self.num_kb_relation,
                              num_chunks=nc_bucket)

        q_hidden = None
        if self.q_hidden is not None:
            D = self.q_hidden[0].shape[-1]
            q_hidden = np.zeros((B, L, D), np.float32)
            for i, idx in enumerate(indices):
                h = self.q_hidden[idx]
                q_hidden[i, : h.shape[0]] = h[:L]

        return GraphBatch(
            heads=heads, rels=rels, tails=tails, fact_mask=fact_mask,
            entity_gids=entity_gids.astype(np.int32) if self.num_entity < 2**31 - 1 else entity_gids,
            ent_present=ent_present, seed_dist=seed_dist,
            query_entities=query_entities, answer_dist=answer_dist,
            q_tokens=q_tokens, q_mask=(q_tokens != self.pad_token_id).astype(np.float32),
            q_hidden=q_hidden, fact_rel_weight=rel_pair_w, layout=layout,
        )

    def answers_for(self, indices: Sequence[int]) -> List[List[int]]:
        return [self.records[i].answer_gids for i in indices]


def num_kb_relation(num_relation: int, use_inverse_relation: bool,
                    use_self_loop: bool) -> int:
    """dataset_load.py:119-124."""
    n = 2 * num_relation if use_inverse_relation else num_relation
    if use_self_loop:
        n += 1
    return n


_INGEST_CTX: dict = {}


def _ingest_worker_init(vocab, kwargs):
    _INGEST_CTX["vocab"] = vocab
    _INGEST_CTX["kwargs"] = kwargs


def _ingest_worker(line: str):
    return ingest_question(json.loads(line), _INGEST_CTX["vocab"],
                           **_INGEST_CTX["kwargs"])


def load_split(path: str, vocab: Vocab, *, data_name: str,
               use_inverse_relation: bool, use_self_loop: bool,
               max_questions: Optional[int] = None, num_workers: int = 0,
               cache: bool = True) -> List[QuestionRecord]:
    """Ingest one JSONL split; ``num_workers > 0`` parallelises over forked
    processes (the vocab is shared through the fork, not pickled per task).

    With ``cache`` the ingested records are pickled next to the JSONL and
    reused while the source file (mtime, size) and the ingest options are
    unchanged (gnn_rag_tpu/data/loader.py:370-444): JSON parsing of a
    reference-scale split takes minutes of one core otherwise. The file is
    ``<split>.json.ingest.torch.pkl``, not the JAX package's
    ``<split>.json.ingest.pkl``: each holds its own package's record class,
    and unpickling the other's would import that package."""
    nkr = num_kb_relation(vocab.num_relation, use_inverse_relation, use_self_loop)
    kwargs = dict(data_name=data_name,
                  use_inverse_relation=use_inverse_relation,
                  use_self_loop=use_self_loop, num_kb_relation=nkr)
    meta = (os.path.getmtime(path), os.path.getsize(path), data_name,
            use_inverse_relation, use_self_loop, max_questions)
    cpath = path + ".ingest.torch.pkl"
    if cache and os.path.exists(cpath):
        try:
            with open(cpath, "rb") as f:
                saved = pickle.load(f)
            if saved.get("meta") == meta:
                return saved["records"]
        except Exception:
            pass  # stale or corrupt cache: ingest again

    def finish(recs: List[QuestionRecord]) -> List[QuestionRecord]:
        if cache:
            for r in recs:
                r.kl_cache.clear()   # layouts are rebuilt lazily per E bucket
            tmp = cpath + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    pickle.dump({"meta": meta, "records": recs}, f,
                                protocol=pickle.HIGHEST_PROTOCOL)
                os.replace(tmp, cpath)
            except OSError:
                pass  # read-only data dir: no cache
        return recs

    records: List[QuestionRecord] = []
    if num_workers > 0:
        import multiprocessing as mp
        with open(path) as f:
            lines = f.readlines()
        with mp.get_context("fork").Pool(num_workers,
                                         initializer=_ingest_worker_init,
                                         initargs=(vocab, kwargs)) as pool:
            for rec in pool.imap(_ingest_worker, lines, chunksize=64):
                if rec is not None:
                    records.append(rec)
                if max_questions is not None and len(records) >= max_questions:
                    break
        return finish(records[:max_questions] if max_questions else records)
    with open(path) as f:
        for line in f:
            if max_questions is not None and len(records) >= max_questions:
                break
            rec = ingest_question(json.loads(line), vocab, **kwargs)
            if rec is not None:
                records.append(rec)
    return finish(records)


def load_relation_emb(path: str, num_kb_relation: int,
                      use_inverse_relation: bool,
                      use_self_loop: bool) -> Optional[np.ndarray]:
    """Load a pretrained KG relation table (.npy of [R, d]) with the
    reference's row conventions (base_model.py:122-134, 153-162): inverse
    relations reuse the forward rows (concat), self-loop + pad rows are
    zero-appended. Returns [num_kb_relation + 1, d] float32, or None (and
    the models fall back to a trainable table) when the row count does not
    match — the reference's 'Random Init' branch."""
    if not path or not os.path.exists(path):
        return None
    half = np.load(path)
    emb = np.concatenate([half, half]) if use_inverse_relation else half
    num_pad = 2 if use_self_loop else 1   # self-loop row + pad row
    emb = np.pad(emb, ((0, num_pad), (0, 0)))
    if emb.shape[0] != num_kb_relation + 1:
        return None
    return emb.astype(np.float32)


def load_dataset_dir(cfg, num_workers: int = 0) -> dict:
    """Load train/dev/test like the reference load_data (dataset_load.py:648-685).

    cfg: a ``config.Config``; ``num_workers``: ingest processes of
    ``load_split``. Returns dict with KGQADataset splits, Vocab, relation
    token arrays and the tokenizer.
    """
    d = cfg.data
    vocab = Vocab.from_dir(d.data_folder, d.entity2id, d.relation2id, d.word2id)
    nkr = num_kb_relation(vocab.num_relation, d.use_inverse_relation, d.use_self_loop)

    tokenizer = make_tokenizer(d.lm, vocab.word2id or None)
    splits = {}
    for split, fname, cap in (("train", "train.json", d.max_train),
                              ("valid", "dev.json", None),
                              ("test", "test.json", None)):
        path = os.path.join(d.data_folder, fname)
        if cfg.train.is_eval and split == "train":
            splits[split] = None
            continue
        recs = load_split(path, vocab, data_name=d.name,
                          use_inverse_relation=d.use_inverse_relation,
                          use_self_loop=d.use_self_loop, max_questions=cap,
                          num_workers=num_workers)
        ds = KGQADataset(recs, num_entity=vocab.num_entity, num_kb_relation=nkr,
                         entity_buckets=d.entity_buckets, fact_buckets=d.fact_buckets)
        ds.tokenize_questions(tokenizer, add_special=(d.lm != "lstm"))
        splits[split] = ds

    rel_tokens = rel_tokens_inv = None
    if d.relation_word_emb:
        rel_tokens, rel_tokens_inv = tokenize_relations(
            list(vocab.relation2id.keys()), tokenizer, nkr + 1,
            metaqa="metaqa" in d.data_folder)

    return {
        **splits,
        "vocab": vocab,
        "num_kb_relation": nkr,
        "rel_tokens": rel_tokens,
        "rel_tokens_inv": rel_tokens_inv,
        "tokenizer": tokenizer,
    }
