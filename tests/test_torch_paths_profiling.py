"""The port's device BFS path backend and its profiling hooks on the CPU.

* ``ops.bfs.bfs_levels`` against JAX's ``bfs_levels``: exact int32
  distances on the chain/star case of tests/test_path_extract.py and on 3
  seeds of its random questions, with and without ``max_hops``; the hop
  count it reports.
* ``rag.path_extract.BatchedPathExtractor`` against JAX's extractor and the
  ``graph_utils.get_truth_paths`` oracle (the same paths), and its corner
  cases (unbounded depth, a cap, self loops, zero-length paths, parallel
  edges).
* ``RetrieverService(path_backend="device")`` against the native backend on
  a SynthQSP split: the same candidates and paths; ``auto`` never picks it,
  ``keep_parallel`` sends it to the host.
* ``utils.profiling``: ``trace`` writes a Chrome trace (a no-op without a
  directory), ``StepTimer.report()`` equals JAX's on the same phases, and
  the CLI's ``--profile_dir`` traces the first epoch.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from gnn_rag_tpu.ops import bfs as jbfs
from gnn_rag_tpu.rag import graph_utils as jgraph
from gnn_rag_tpu.rag.path_extract import BatchedPathExtractor as JExtractor
from gnn_rag_tpu.utils import profiling as jprofiling
from gnn_rag_tpu_torch.ops import bfs
from gnn_rag_tpu_torch.rag import text_utils
from gnn_rag_tpu_torch.rag.path_extract import BatchedPathExtractor
from gnn_rag_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chain_and_star():
    heads = np.array([[0, 1, 1, 2, 2, 3], [0, 1, 0, 2, 0, 3]], np.int32)
    tails = np.array([[1, 0, 2, 1, 3, 2], [1, 0, 2, 0, 3, 0]], np.int32)
    src = np.zeros((2, 1, 4), np.float32)
    src[0, 0, 0] = 1
    src[1, 0, 1] = 1
    return heads, tails, np.ones((2, 6), np.float32), src


def random_questions(rng, n_q=6):
    """tests/test_path_extract.py's generator."""
    qs = []
    for _ in range(n_q):
        n_nodes = int(rng.integers(8, 30))
        n_edges = int(rng.integers(n_nodes, 3 * n_nodes))
        triples = [(f"e{rng.integers(n_nodes)}", f"r{rng.integers(5)}",
                    f"e{rng.integers(n_nodes)}") for _ in range(n_edges)]
        nodes = sorted({x for h, _, t in triples for x in (h, t)})
        q_entity = [str(rng.choice(nodes)) for _ in range(2)]
        cand = [str(rng.choice(nodes)) for _ in range(3)]
        qs.append({"graph": triples, "q_entity": q_entity, "cand": cand})
    return qs


def random_graph_arrays(seed):
    """Padded symmetrised edge lists of random questions: [B, F] heads,
    tails, mask and [B, S, E] one-hot sources (several per sample)."""
    rng = np.random.default_rng(seed)
    B, S, E, F = 4, 3, 32, 96
    heads = np.zeros((B, F), np.int32)
    tails = np.zeros((B, F), np.int32)
    mask = np.zeros((B, F), np.float32)
    src = np.zeros((B, S, E), np.float32)
    for b in range(B):
        n = int(rng.integers(8, E + 1))
        k = int(rng.integers(n // 2, F // 2))
        h, t = rng.integers(0, n, k), rng.integers(0, n, k)
        heads[b, :2 * k] = np.concatenate([h, t])
        tails[b, :2 * k] = np.concatenate([t, h])
        mask[b, :2 * k] = 1.0
        for s in range(S - b % 2):
            src[b, s, rng.integers(0, n)] = 1.0
    return heads, tails, mask, src


def both(arrays, E, max_hops):
    want = np.asarray(jbfs.bfs_levels(*arrays, num_entities=E,
                                      max_hops=max_hops))
    got, hops = bfs.bfs_levels(*map(torch.from_numpy, arrays), num_entities=E,
                               max_hops=max_hops, return_hops=True)
    return got.numpy(), want, hops


@pytest.mark.parametrize("max_hops", [None, 1, 2, 4])
def test_bfs_levels_chain_and_star_match_jax(max_hops):
    got, want, hops = both(chain_and_star(), 4, max_hops)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if max_hops is None:
        assert got[0, 0].tolist() == [0, 1, 2, 3]
        assert got[1, 0].tolist() == [1, 0, 2, 2]
        assert hops == 4          # 3 hops reach new nodes, the 4th none
    else:
        assert hops == max_hops
        assert (got[got != bfs.UNREACHED] <= max_hops).all()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("max_hops", [None, 2])
def test_bfs_levels_random_graphs_match_jax(seed, max_hops):
    got, want, _ = both(random_graph_arrays(seed), 32, max_hops)
    np.testing.assert_array_equal(got, want)
    assert (got == bfs.UNREACHED).any() and (got == 0).any()
    assert bfs.UNREACHED == int(jbfs.UNREACHED)


def key(paths):
    return sorted(text_utils.path_to_string(p) for p in paths)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("max_hops", [None, 6, 2])
def test_extractor_matches_jax_and_the_oracle(seed, max_hops):
    questions = random_questions(np.random.default_rng(seed))
    got = BatchedPathExtractor(max_hops=max_hops, device="cpu").extract(questions)
    want = JExtractor(max_hops=max_hops).extract(questions)
    assert got == want
    if max_hops != 2:
        for q, paths in zip(questions, got):
            g = jgraph.build_graph(q["graph"])
            exp = jgraph.get_truth_paths([h for h in q["q_entity"] if h in g],
                                         q["cand"], g)
            assert key(paths) == key(exp)


def test_extractor_corner_cases():
    chain = [[f"n{i}", f"r{i}", f"n{i + 1}"] for i in range(10)]
    q = {"graph": chain, "q_entity": ["n0"], "cand": ["n10"]}
    ex = BatchedPathExtractor(device="cpu")
    paths = ex.extract([q])[0]
    assert len(paths) == 1 and len(paths[0]) == 10 and ex.last_hops == 11
    assert BatchedPathExtractor(max_hops=4, device="cpu").extract([q])[0] == []
    triples = [["a", "r.self", "a"], ["a", "r1", "b"], ["a", "r2", "b"],
               ["b", "r3", "c"], ["x", "r4", "y"]]
    q = {"graph": triples, "q_entity": ["a"], "cand": ["a", "b", "c", "y"]}
    paths = ex.extract([q])[0]
    g = jgraph.build_graph(triples)
    assert key(paths) == key(jgraph.get_truth_paths(["a"], q["cand"], g))
    assert [] in paths                             # a -> a, zero length
    assert not any(p and p[-1][2] == "y" for p in paths)   # unreachable
    ab = [p for p in paths if len(p) == 1 and p[0][2] == "b"]
    assert ab[0][0][1] == g.relation("a", "b") == "r2"     # last relation
    assert ex.extract([q, {"graph": [], "q_entity": ["a"], "cand": ["a"]}])[1] == []


def test_the_extractor_defaults_to_the_card():
    assert BatchedPathExtractor().device == torch.device("cuda")


@pytest.fixture(scope="module")
def synth_service(tmp_path_factory):
    """A ReaRev RetrieverService over a SynthQSP split, and its questions."""
    from gnn_rag_tpu_torch.config import Config, DataConfig, ModelConfig
    from gnn_rag_tpu_torch.data.vocab import Vocab
    from gnn_rag_tpu_torch.train.trainer import build_model, model_inputs
    from gnn_rag_tpu_torch.utils import refbench
    from gnn_rag_tpu_torch.utils.synthetic import random_rel_hidden
    root = tmp_path_factory.mktemp("synth_paths")
    refbench.generate(str(root), refbench.TINY, seed=5, log=lambda *a: None)
    ents = {e: i for i, e in enumerate(
        (root / "entities.txt").read_text().split("\n")) if e}
    rels = {r: i for i, r in enumerate(
        (root / "relations.txt").read_text().split("\n")) if r}
    cfg = Config(data=DataConfig(name="webqsp"),
                 model=ModelConfig(entity_dim=16, num_iter=2, num_ins=2,
                                   num_gnn=2, linear_dropout=0.0))
    nkr = len(rels) + 1
    rel = random_rel_hidden(np.random.default_rng(0), nkr + 1, 4, 32)
    model = build_model(cfg, len(ents), nkr, device="cpu", **model_inputs(
        cfg, q_hidden=True, rel_hidden=rel[0], word_dim=32))
    with open(root / "test.json") as f:
        questions = [json.loads(line) for line in f]

    def make(**kw):
        from gnn_rag_tpu_torch.serve import RetrieverService
        return RetrieverService(
            cfg, Vocab(ents, rels, {}), model, rel_hidden=rel[0],
            rel_hidden_inv=rel[1], rel_text_mask=rel[2],
            question_encoder=lambda ids: np.ones((len(ids), 32), np.float32),
            **kw)
    return make, questions


def test_retriever_device_backend_matches_native(synth_service):
    make, questions = synth_service
    native = make(path_backend="native")
    device = make(path_backend="device", max_hops=None)
    assert native.path_backend == "native" and device.path_backend == "device"
    assert device.extractor.device == torch.device("cpu")
    want, got = native.retrieve(questions), device.retrieve(questions)
    assert sum(bool(r["paths"]) for r in want) >= len(questions) // 2
    for a, b in zip(got, want):
        assert a["cand"] == b["cand"]
        assert sorted(a["paths"]) == sorted(b["paths"])
    capped = make(path_backend="device", max_hops=1).retrieve(questions)
    for a, b in zip(capped, want):
        assert set(a["paths"]) <= set(b["paths"])
        assert all(p.count(" -> ") <= 2 for p in a["paths"])


def test_retriever_backend_choice(synth_service):
    make, _ = synth_service
    assert make(path_backend="auto").path_backend in ("native", "python")
    assert make(path_backend="device", keep_parallel=True).path_backend in (
        "native", "python")
    assert make(path_backend="device", max_hops=3).extractor.max_hops == 3
    with pytest.raises(ValueError, match="unknown path backend"):
        make(path_backend="gpu")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.annotate("port/region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "port/region" in names and "aten::mm" in names


def test_step_timer_reports_like_jax(monkeypatch):
    def run(mod):
        clock = iter(range(100))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock) * 0.25)
        t = mod.StepTimer()
        for name in ("fwd", "bwd", "fwd", "data"):
            with t.phase(name):
                pass
        return t.report()
    assert run(profiling) == run(jprofiling) == {
        "bwd": (0.25, 1), "data": (0.25, 1), "fwd": (0.5, 2)}


def test_cli_profile_dir_traces_the_first_epoch(tmp_path):
    from test_cli_e2e import write_micro_dataset

    from gnn_rag_tpu_torch import cli
    (tmp_path / "data").mkdir()
    write_micro_dataset(tmp_path / "data")
    prof = tmp_path / "prof"
    ctx = cli.run(["ReaRev", "--data_folder", str(tmp_path / "data") + "/",
                   "--checkpoint_dir", str(tmp_path / "ckpt"), "--lm", "lstm",
                   "--relation_word_emb", "False", "--entity_dim", "16",
                   "--num_iter", "2", "--num_ins", "2", "--num_gnn", "2",
                   "--batch_size", "4", "--test_batch_size", "4",
                   "--num_epoch", "2", "--eval_every", "2", "--device", "cpu",
                   "--experiment_name", "p", "--profile_dir", str(prof)])
    assert len(ctx["history"]) == 2
    files = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    log = (tmp_path / "ckpt" / "gnn_rag_tpu_torch.log").read_text()
    assert log.count("profiler trace written to " + str(prof)) == 1
