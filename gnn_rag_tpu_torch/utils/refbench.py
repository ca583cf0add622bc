"""SynthQSP — a reference-scale KGQA proxy benchmark generator.

The reference's WebQSP/CWQ data files are not shipped (gnn/README.md points at
an external download). To prove training quality and throughput at the
reference's scale (WebQSP: 1,639 test questions; subgraphs ~2,000 entities /
~8,000 facts; CWQ: skewed larger), this module synthesises a dataset with the
same statistical shape **in the reference's exact JSONL format**
(dataset_load.py:31-60 field contract), so the ordinary CLI/loader path
ingests it unchanged:

* lognormal subgraph sizes (CWQ-style skew), mean ~E2000 with facts ~2.2x
  entities before self-loops;
* a 1..4-hop answer mix: every question plants a relation path
  ``seed -r1-> m1 ... -r_h-> answers`` and the question text verbalises the
  relation sequence, so the task is solvable exactly by instruction-
  conditioned multi-hop reasoning (what ReaRev is built to do) and NOT by
  any single-edge shortcut;
* same-relation decoy edges and wrong-continuation branches so hop
  composition (not relation spotting) is required;
* multiple answers per question (all tails of the final hop relation from
  the last intermediate node), like Freebase CVT fan-outs.

Determinism: one integer seed fixes the whole dataset.

Copy of ``gnn_rag_tpu.utils.refbench`` (numpy only), run as
``python -m gnn_rag_tpu_torch.utils.refbench --out DIR [--seed N]``; the
same seed writes the same files byte for byte.
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass

import numpy as np

HOP_MIX = ((1, 0.45), (2, 0.35), (3, 0.15), (4, 0.05))


@dataclass
class Scale:
    n_train: int = 1500
    n_dev: int = 150
    n_test: int = 350
    num_global_entities: int = 100_000
    num_relations: int = 200
    ent_log_mean: float = 7.45     # exp(7.45) ~ 1720 -> mean ~2050 w/ sigma
    ent_log_sigma: float = 0.55
    ent_min: int = 256
    ent_max: int = 4000
    facts_per_entity: float = 2.2
    n_decoys_per_hop: int = 3
    max_answers: int = 4
    hop_mix: tuple = HOP_MIX
    multi_token_rels: bool = False


TINY = Scale(n_train=48, n_dev=8, n_test=16, num_global_entities=2000,
             num_relations=24, ent_log_mean=3.3, ent_log_sigma=0.4,
             ent_min=12, ent_max=64, facts_per_entity=2.0,
             n_decoys_per_hop=2, max_answers=2)

# SynthFB: the Freebase-vocabulary-scale proxy (VERDICT r2 #6) — same
# subgraph shapes as SynthQSP but with a ~6k-relation vocabulary carrying
# MULTI-TOKEN surface forms (the [R+1, Lr, 384] rel_hidden table and the
# rel-text attention run at real WebQSP size; WebQSP's Freebase split uses
# ~6k distinct relations) and a 1M-entity global vocabulary. Scale runs on
# it additionally enable --fact_drop 0.1 and --lm_frozen 0, matching the
# reference's training regularisers (gnn/parsing.py:51).
FB_WORDS_A = ("inner", "outer", "prime", "dual", "meta", "core", "left",
              "right", "upper", "lower", "first", "last", "main", "side",
              "twin", "base", "peak", "edge", "apex", "root")
FB_WORDS_B = ("origin", "target", "member", "holder", "partner", "region",
              "artifact", "agent", "basis", "unit", "event", "place",
              "title", "group", "order", "series", "field", "stage",
              "branch", "node")


# SynthCWQ: the CWQ-flavoured proxy — more questions, bigger/more-skewed
# subgraphs, compositional-heavy hop mix (CWQ is built by composing WebQSP
# questions, so 2-4 hops dominate; reference trains it with num_iter 2 /
# num_ins 3, scripts/rearev_cwq.sh)
CWQ = Scale(n_train=2000, n_dev=200, n_test=500,
            ent_log_mean=7.3, ent_log_sigma=0.75, ent_max=6000,
            facts_per_entity=2.6, n_decoys_per_hop=4,
            hop_mix=((1, 0.12), (2, 0.45), (3, 0.30), (4, 0.13)))

FB = Scale(n_train=1500, n_dev=150, n_test=350,
           num_global_entities=1_000_000, num_relations=6000,
           multi_token_rels=True)


def rel_name(r: int, multi: bool = False) -> str:
    if multi:
        # Freebase-like dotted path whose last two fields carry distinct
        # multi-word surface forms (e.g. syn.field_12.inner_origin_417):
        # the loader's last-two-dot-fields rule (rel_text.relation_words)
        # verbalises it to 5 word tokens, exercising the real [R+1, Lr, D]
        # rel_hidden attention instead of a near-degenerate 4-token form
        a = FB_WORDS_A[r % len(FB_WORDS_A)]
        b = FB_WORDS_B[(r // len(FB_WORDS_A)) % len(FB_WORDS_B)]
        return f"syn.{FB_WORDS_B[r % 7]}_{r % 40}.{a}_{b}_{r}"
    # verbalises to words ["domain", str(d), "rel", str(r)] via the loader's
    # last-two-dot-fields rule (rel_text.relation_words)
    return f"syn.domain_{r % 20}.rel_{r}"


def ent_name(g: int) -> str:
    return f"m.{g:07d}"


def question_text(path) -> str:
    # one word per hop relation; the instruction decoder can attend hop j's
    # relation token (matches how real questions name their relation chain)
    return "what is " + " then ".join(f"rel {r}" for r in path) + " of seed"


def gen_question(rng: np.random.Generator, qid: int, sc: Scale) -> dict:
    ne = int(np.clip(rng.lognormal(sc.ent_log_mean, sc.ent_log_sigma),
                     sc.ent_min, sc.ent_max))
    hops = rng.choice([h for h, _ in sc.hop_mix],
                      p=[p for _, p in sc.hop_mix])
    hops = int(min(hops, max(1, ne // 4)))
    n_answers = int(rng.integers(1, sc.max_answers + 1))

    # local node ids: 0 = seed, 1..hops-1 = path intermediates,
    # then answers, then background entities
    n_path_mid = hops - 1
    first_ans = 1 + n_path_mid
    n_core = first_ans + n_answers
    assert ne > n_core + 2

    path = rng.choice(sc.num_relations, size=hops, replace=False).astype(int)

    heads, rels, tails = [], [], []

    def edge(h, r, t):
        heads.append(int(h)); rels.append(int(r)); tails.append(int(t))

    # ---- planted answer path ----
    prev = 0
    for j in range(hops - 1):
        edge(prev, path[j], 1 + j)
        prev = 1 + j
    for a in range(n_answers):
        edge(prev, path[-1], first_ans + a)

    # ---- decoys: same relation, wrong place ----
    for j in range(hops):
        for _ in range(sc.n_decoys_per_hop):
            # an edge with the hop's relation from a non-path node: relation
            # spotting alone would follow these too
            h = int(rng.integers(n_core, ne))
            t = int(rng.integers(n_core, ne))
            edge(h, path[j], t)
        if j > 0:
            # wrong-continuation branch: correct prefix node, wrong relation
            wrong = int(rng.integers(0, sc.num_relations))
            if wrong == path[j]:
                wrong = (wrong + 1) % sc.num_relations
            edge(j - 1 if j > 1 else 0, wrong, int(rng.integers(n_core, ne)))

    # ---- background graph with hub-skewed degrees ----
    n_bg = max(0, int(ne * sc.facts_per_entity) - len(heads))
    w = 1.0 / np.sqrt(np.arange(1, ne + 1, dtype=np.float64))
    w /= w.sum()
    bg_h = rng.choice(ne, size=n_bg, p=w)
    bg_t = rng.choice(ne, size=n_bg, p=w)
    bg_r = rng.integers(0, sc.num_relations, size=n_bg)
    # background edges must not accidentally extend/shortcut the answer path:
    # re-roll any edge that lands on an answer with the final relation
    bad = (bg_r == path[-1]) & np.isin(bg_t, np.arange(first_ans, n_core))
    bg_t[bad] = (bg_t[bad] + n_core) % ne
    heads.extend(bg_h.tolist()); rels.extend(bg_r.tolist()); tails.extend(bg_t.tolist())

    # ---- local -> global entity names ----
    gids = rng.choice(sc.num_global_entities, size=ne, replace=False)
    names = [ent_name(int(g)) for g in gids]
    tuples = [[names[h], rel_name(r, sc.multi_token_rels), names[t]]
              for h, r, t in zip(heads, rels, tails)]
    answers = [{"kb_id": names[first_ans + a], "text": names[first_ans + a]}
               for a in range(n_answers)]
    return {
        "id": f"synthqsp-{qid}",
        "question": question_text(path),
        "entities": [names[0]],
        "subgraph": {"entities": names, "tuples": tuples},
        "answers": answers,
        "hops": int(hops),           # extra field; the loader ignores it
    }


def generate(out_dir: str, sc: Scale = Scale(), seed: int = 0,
             log=print) -> None:
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    with open(os.path.join(out_dir, "entities.txt"), "w") as f:
        f.write("\n".join(ent_name(g) for g in range(sc.num_global_entities)) + "\n")
    with open(os.path.join(out_dir, "relations.txt"), "w") as f:
        f.write("\n".join(rel_name(r, sc.multi_token_rels)
                           for r in range(sc.num_relations)) + "\n")
    words = sorted({"what", "is", "then", "of", "seed", "rel"}
                   | {str(r) for r in range(sc.num_relations)})
    with open(os.path.join(out_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(words) + "\n")

    qid = 0
    stats = []
    for split, n in (("train", sc.n_train), ("dev", sc.n_dev),
                     ("test", sc.n_test)):
        with open(os.path.join(out_dir, f"{split}.json"), "w") as f:
            for _ in range(n):
                q = gen_question(rng, qid, sc)
                stats.append((len(q["subgraph"]["entities"]),
                              len(q["subgraph"]["tuples"]), q["hops"]))
                f.write(json.dumps(q) + "\n")
                qid += 1
        log(f"{split}: {n} questions")
    ents = np.asarray([s[0] for s in stats])
    facts = np.asarray([s[1] for s in stats])
    hop_arr = np.asarray([s[2] for s in stats])
    log(f"entities mean={ents.mean():.0f} p50={np.median(ents):.0f} "
        f"p95={np.percentile(ents, 95):.0f} max={ents.max()}")
    log(f"tuples   mean={facts.mean():.0f} p95={np.percentile(facts, 95):.0f} "
        f"(facts incl self-loops ~= tuples + entities)")
    log("hop mix  " + " ".join(f"{h}:{int((hop_arr == h).sum())}"
                               for h in sorted(set(hop_arr.tolist()))))


def main(argv=None):
    ap = argparse.ArgumentParser(description="Generate the SynthQSP "
                                 "reference-scale proxy dataset")
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="micro scale for tests")
    ap.add_argument("--cwq", action="store_true",
                    help="CWQ-flavoured scale (bigger, compositional-heavy)")
    ap.add_argument("--fb", action="store_true",
                    help="Freebase-vocabulary scale (6k multi-token "
                         "relations, 1M entities)")
    ap.add_argument("--n_train", type=int, default=None)
    ap.add_argument("--n_dev", type=int, default=None)
    ap.add_argument("--n_test", type=int, default=None)
    args = ap.parse_args(argv)
    sc = (TINY if args.tiny else CWQ if args.cwq
          else FB if args.fb else Scale())
    for k in ("n_train", "n_dev", "n_test"):
        v = getattr(args, k)
        if v is not None:
            setattr(sc, k, v)
    generate(args.out, sc, seed=args.seed)


if __name__ == "__main__":
    main()
