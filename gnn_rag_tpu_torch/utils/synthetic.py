"""Synthetic KGQA subgraph generation for tests and benchmarks, the port of
gnn_rag_tpu/utils/synthetic.py (numpy only; the port's ``GraphBatch``,
``QuestionRecord`` and ``KGQADataset``).

Generates random question subgraphs with the same statistical shape as
WebQSP/CWQ batches (padded COO, seeds, answer distributions) so the whole
pipeline can run without the (unshipped) datasets. The port's
``GraphBatch`` has no ``fact_weight`` field (the JAX one leaves it None
here); everything else is the JAX generator's, draw for draw.
"""

from __future__ import annotations

import numpy as np

from ..data.batch import GraphBatch


def random_graph_batch(rng: np.random.Generator, *, batch_size: int = 8,
                       n_entities: int = 256, n_facts: int = 1024,
                       num_relation: int = 64, num_entity_global: int = 100_000,
                       q_len: int = 16, word_dim: int | None = 384,
                       use_self_loop: bool = True,
                       cwq_style: bool = False,
                       build_layout: bool = False) -> GraphBatch:
    """num_relation = num_kb_relation (incl. self-loop row if enabled)."""
    B, E, F, L = batch_size, n_entities, n_facts, q_len

    ent_count = rng.integers(E // 2, E + 1, size=B)
    heads = np.zeros((B, F), np.int32)
    tails = np.zeros((B, F), np.int32)
    rels = np.full((B, F), num_relation, np.int32)
    fact_mask = np.zeros((B, F), np.float32)
    entity_gids = np.full((B, E), num_entity_global, np.int64)
    ent_present = np.zeros((B, E), np.float32)
    seed_dist = np.zeros((B, E), np.float32)
    query_entities = np.zeros((B, E), np.float32)
    answer_dist = np.zeros((B, E), np.float32)

    self_rel = num_relation - 1
    for b in range(B):
        ne = int(ent_count[b])
        n_loops = ne if use_self_loop else 0
        nf = int(rng.integers(F // 2, F - n_loops + 1))
        heads[b, :nf] = rng.integers(0, ne, nf)
        tails[b, :nf] = rng.integers(0, ne, nf)
        rels[b, :nf] = rng.integers(0, max(1, num_relation - 1), nf)
        if use_self_loop:
            ar = np.arange(ne, dtype=np.int32)
            heads[b, nf:nf + ne] = ar
            tails[b, nf:nf + ne] = ar
            rels[b, nf:nf + ne] = self_rel
            nf += ne
        fact_mask[b, :nf] = 1.0
        entity_gids[b, :ne] = rng.choice(num_entity_global, size=ne, replace=False)
        ent_present[b, :ne] = 1.0
        n_seed = int(rng.integers(1, min(3, ne) + 1))
        seeds = rng.choice(ne, size=n_seed, replace=False)
        seed_dist[b, seeds] = 1.0 / n_seed
        query_entities[b, seeds] = 1.0
        if not cwq_style:
            entity_gids[b, seeds] = num_entity_global  # WebQSP candidate quirk
        n_ans = int(rng.integers(1, 4))
        answer_dist[b, rng.choice(ne, size=min(n_ans, ne), replace=False)] = 1.0

    q_tokens = rng.integers(3, 1000, size=(B, L)).astype(np.int32)
    q_mask = np.ones((B, L), np.float32)
    q_hidden = None
    if word_dim:
        q_hidden = rng.standard_normal((B, L, word_dim)).astype(np.float32) * 0.1

    layout = None
    if build_layout:
        from ..data.kernel_layout import build_kernel_layout
        layout = build_kernel_layout(heads, rels, tails, fact_mask, E,
                                     pad_rel=num_relation)

    return GraphBatch(
        heads=heads, rels=rels, tails=tails, fact_mask=fact_mask,
        entity_gids=entity_gids.astype(np.int32), ent_present=ent_present,
        seed_dist=seed_dist, query_entities=query_entities,
        answer_dist=answer_dist, q_tokens=q_tokens, q_mask=q_mask,
        q_hidden=q_hidden,
        fact_rel_weight=np.ones((B, F), np.float32) * fact_mask,
        layout=layout,
    )


def random_records(rng: np.random.Generator, *, n_questions: int = 16,
                   n_entities_max: int = 24, n_facts_max: int = 64,
                   num_relation: int = 16, num_entity_global: int = 1000,
                   use_self_loop: bool = True, cwq_style: bool = False,
                   learnable: bool = True):
    """Random QuestionRecords + KGQADataset for end-to-end tests.

    With ``learnable=True`` every question's answer is a 1-hop neighbour of
    the seed through a question-specific relation, so a trained model can
    actually fit the data."""
    from ..data.loader import KGQADataset, QuestionRecord

    self_rel = num_relation - 1
    records = []
    for qi in range(n_questions):
        ne = int(rng.integers(6, n_entities_max + 1))
        nf = int(rng.integers(ne, max(ne + 1, n_facts_max - ne)))
        heads = rng.integers(0, ne, nf).astype(np.int32)
        tails = rng.integers(0, ne, nf).astype(np.int32)
        rels = rng.integers(0, num_relation - 1, nf).astype(np.int32)
        seed = int(rng.integers(0, ne))
        answer_local = int(rng.integers(0, ne))
        while answer_local == seed:
            answer_local = int(rng.integers(0, ne))
        rel_q = qi % max(1, num_relation - 1)
        if learnable:
            # plant the discriminative edge seed --rel_q--> answer
            heads[0], rels[0], tails[0] = seed, rel_q, answer_local
        if use_self_loop:
            ar = np.arange(ne, dtype=np.int32)
            heads = np.concatenate([heads, ar])
            tails = np.concatenate([tails, ar])
            rels = np.concatenate([rels, np.full(ne, self_rel, np.int32)])
        droppable = np.ones(len(heads), bool)
        if use_self_loop:
            droppable[-ne:] = False
        pair_keys = heads.astype(np.int64) * (num_relation + 1) + rels
        _, inv, counts = np.unique(pair_keys, return_inverse=True,
                                   return_counts=True)
        gids = rng.choice(num_entity_global, size=ne, replace=False)
        records.append(QuestionRecord(
            qid=f"q{qi}", question=f"synthetic question {qi} rel {rel_q}",
            heads=heads, rels=rels, tails=tails, droppable=droppable,
            rel_pair_weight=(1.0 / counts[inv]).astype(np.float32),
            entity_gids=gids.astype(np.int64),
            seed_locals=np.asarray([seed], np.int32),
            candidate_masked_seeds=not cwq_style,
            answer_gids=[int(gids[answer_local])],
            answer_locals=np.asarray([answer_local], np.int32),
            q_token_ids=np.asarray([1, 3 + qi, 3 + rel_q, 2], np.int32),
        ))
    ds = KGQADataset(records, num_entity=num_entity_global,
                     num_kb_relation=num_relation)
    return ds


def multihop_records(rng: np.random.Generator, *, n_questions: int = 32,
                     n_entities: int = 20, num_relation: int = 10,
                     num_entity_global: int = 2000, n_distractors: int = 30):
    """2-hop compositional fixture: the answer is reached from the seed via a
    question-specific relation PAIR (seed -r1-> mid -r2-> answer) among
    distractor edges sharing r1/r2 — solvable only by composing two hops."""
    from ..data.loader import KGQADataset, QuestionRecord

    self_rel = num_relation - 1
    n_pairs = (num_relation - 1) // 2
    records = []
    for qi in range(n_questions):
        ne = n_entities
        pair = qi % n_pairs
        r1, r2 = 2 * pair, 2 * pair + 1
        seed, mid, ans = 0, 1, 2
        heads = [seed, mid]
        rels = [r1, r2]
        tails = [mid, ans]
        # distractors: r1 edges to wrong mids, r2 edges from wrong mids
        for _ in range(n_distractors):
            a, b = rng.integers(3, ne, 2)
            rels.append(int(rng.integers(0, num_relation - 1)))
            heads.append(int(a)); tails.append(int(b))
        # a decoy r2 edge NOT reachable via r1 from the seed
        decoy = int(rng.integers(3, ne))
        heads.append(decoy); rels.append(r2); tails.append(int(rng.integers(3, ne)))
        ar = np.arange(ne, dtype=np.int32)
        heads = np.concatenate([np.asarray(heads, np.int32), ar])
        tails = np.concatenate([np.asarray(tails, np.int32), ar])
        rels = np.concatenate([np.asarray(rels, np.int32),
                               np.full(ne, self_rel, np.int32)])
        droppable = np.ones(len(heads), bool)
        droppable[-ne:] = False
        pair_keys = heads.astype(np.int64) * (num_relation + 1) + rels
        _, inv, counts = np.unique(pair_keys, return_inverse=True,
                                   return_counts=True)
        gids = rng.choice(num_entity_global, size=ne, replace=False)
        records.append(QuestionRecord(
            qid=f"mh{qi}", question=f"two hop question pair {pair}",
            heads=heads, rels=rels, tails=tails, droppable=droppable,
            rel_pair_weight=(1.0 / counts[inv]).astype(np.float32),
            entity_gids=gids.astype(np.int64),
            seed_locals=np.asarray([seed], np.int32),
            candidate_masked_seeds=True,
            answer_gids=[int(gids[ans])],
            answer_locals=np.asarray([ans], np.int32),
            q_token_ids=np.asarray([1, 3 + pair, 2], np.int32),
        ))
    ds = KGQADataset(records, num_entity=num_entity_global,
                     num_kb_relation=num_relation)
    return ds


def random_rel_hidden(rng: np.random.Generator, num_relation_rows: int,
                      rel_len: int = 8, word_dim: int = 384):
    """Random frozen-LM relation token states + mask."""
    h = rng.standard_normal((num_relation_rows, rel_len, word_dim)).astype(np.float32) * 0.1
    hinv = rng.standard_normal((num_relation_rows, rel_len, word_dim)).astype(np.float32) * 0.1
    mask = np.ones((num_relation_rows, rel_len), np.float32)
    return h, hinv, mask
