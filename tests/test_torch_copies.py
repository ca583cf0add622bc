"""The port's own copies of the JAX package's framework-free modules
(config, CLI flags, logging, rag.text_utils, rag.graph_utils, the native
graphpath library, the SynthQSP generator, the prompt builder, SFT data
prep (explanation distillation too), the byte/word tokenizers, and the
RAG half's answer scorers, predict driver, multi-hop scorer, reader
interface, mock reader and OpenAI-protocol server and proxy, the loader's
relation table, ingest workers and id helpers, the Evaluator's entity
names) against the originals: same configurations, same paths, same prompt text, same
generated files byte for byte from one seed, and the copied RAG functions
the same source line for line (tests/test_torch_rag.py runs them on the
same files)."""

import dataclasses
import filecmp
import inspect
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from gnn_rag_tpu import cli as jcli
from gnn_rag_tpu import config as jconfig
from gnn_rag_tpu import native as jnative
from gnn_rag_tpu.data import loader as jloader
from gnn_rag_tpu.finetune import data_prep as jprep
from gnn_rag_tpu.llm_tpu import sft as jsft
from gnn_rag_tpu.rag import evaluate_multi_hop as jmulti
from gnn_rag_tpu.rag import evaluate_results as jeval
from gnn_rag_tpu.rag import gen_rule_path as jgen
from gnn_rag_tpu.rag import graph_utils as jgraph
from gnn_rag_tpu.rag import predict as jpredict
from gnn_rag_tpu.rag import text_utils as jtext
from gnn_rag_tpu.rag.llms import base as jbase
from gnn_rag_tpu.rag.llms import llama_tpu as jllama
from gnn_rag_tpu.rag.llms import mock as jmock
from gnn_rag_tpu.rag.llms import serving as jserving
from gnn_rag_tpu.train import evaluate as jevaluate
from gnn_rag_tpu.utils import logging as jlogging
from gnn_rag_tpu.utils import refbench as jrefbench
from gnn_rag_tpu_torch import cli, config, native
from gnn_rag_tpu_torch.data import loader
from gnn_rag_tpu_torch.finetune import data_prep
from gnn_rag_tpu_torch.llm import sft, tokenizers
from gnn_rag_tpu_torch.rag import (evaluate_multi_hop, evaluate_results,
                                   gen_rule_path, graph_utils, predict,
                                   text_utils)
from gnn_rag_tpu_torch.rag.llms import base, mock, serving
from gnn_rag_tpu_torch.train import evaluate
from gnn_rag_tpu_torch.utils import build, refbench
from gnn_rag_tpu_torch.utils.logging import create_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A tiny SynthQSP split from each generator, same seed."""
    root = tmp_path_factory.mktemp("synth")
    refbench.generate(str(root / "port"), refbench.TINY, seed=3)
    jrefbench.generate(str(root / "jax"), jrefbench.TINY, seed=3)
    with open(root / "port" / "train.json") as f:
        questions = [json.loads(line) for line in f]
    return root, questions


@pytest.mark.parametrize("name", ["Config", "DataConfig", "ModelConfig",
                                  "TrainConfig"])
def test_config_dataclasses_match(name):
    port, ref = getattr(config, name), getattr(jconfig, name)
    assert ([(f.name, f.type) for f in dataclasses.fields(port)]
            == [(f.name, f.type) for f in dataclasses.fields(ref)])
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref())
    assert port.__module__ == "gnn_rag_tpu_torch.config"


@pytest.mark.parametrize("argv", [
    ["ReaRev", "--experiment_name", "x"],
    ["ReaRev", "--experiment_name", "x", "--entity_dim", "50", "--num_iter",
     "3", "--lm", "sbert", "--relation_word_emb", "False", "--lr", "1e-3",
     "--compute_dtype", "bfloat16", "--pos_emb", "--is_eval"],
    ["NSM", "--experiment_name", "y", "--num_step", "2",
     "--use_inverse_relation"],
    ["GraftNet", "--experiment_name", "z", "--num_layer", "2"],
])
def test_cli_flags_and_config_match(argv):
    port = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    ref = jcli.build_parser().parse_args(argv)
    assert vars(port) == dict(vars(ref), device="cpu")
    assert (dataclasses.asdict(cli.args_to_config(port))
            == dataclasses.asdict(jcli.args_to_config(ref)))
    assert cli.build_parser().parse_args(argv).device == "cuda"


def test_logger_writes_the_same_lines(tmp_path):
    cfg = config.ModelConfig(entity_dim=7)
    for mod, name in ((jlogging, "ref"), (None, "port")):
        make = mod.create_logger if mod else create_logger
        log = make(name, str(tmp_path), config=cfg)
        log.info("hello %s", 1)
        for h in log.handlers:
            h.close()
    strip = lambda p: [ln.split(" ", 2)[2] for ln in open(p).read().splitlines()]
    assert strip(tmp_path / "port.log") == strip(tmp_path / "ref.log")


def test_refbench_writes_the_same_files(synth):
    root, _ = synth
    names = sorted(os.listdir(root / "jax"))
    assert names == sorted(os.listdir(root / "port")) and "train.json" in names
    for name in names:
        assert filecmp.cmp(root / "jax" / name, root / "port" / name,
                           shallow=False), name


def test_refbench_module_entry(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-m", "gnn_rag_tpu_torch.utils.refbench",
                    "--out", str(tmp_path / "p"), "--tiny", "--seed", "1",
                    "--n_train", "3", "--n_dev", "1", "--n_test", "1"],
                   cwd=REPO, env=env, check=True, capture_output=True)
    jrefbench.main(["--out", str(tmp_path / "j"), "--tiny", "--seed", "1",
                    "--n_train", "3", "--n_dev", "1", "--n_test", "1"])
    for name in os.listdir(tmp_path / "j"):
        assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "p" / name,
                           shallow=False), name


def test_build_digest_covers_included_headers(tmp_path):
    """A library is named after its source and the csrc headers it
    includes, so an edited header rebuilds it instead of loading a stale
    one."""
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "h.cuh"\n'
                                   '#include "absent.h"\n')
    (tmp_path / "h.cuh").write_text('#include "k.cu"\nint x;\n')
    src = str(tmp_path / "k.cu")
    assert build._with_headers(src) == [src, str(tmp_path / "h.cuh")]
    before = build.digest(src, build.NVCC_FLAGS)
    (tmp_path / "h.cuh").write_text('#include "k.cu"\nint y;\n')
    assert build.digest(src, build.NVCC_FLAGS) != before
    assert build.digest(src, build.CXX_FLAGS) != build.digest(src, build.NVCC_FLAGS)
    flash = os.path.join(build.CSRC, "flash_attention.cu")
    assert os.path.join(build.CSRC, "sm90.cuh") in build._with_headers(flash)


def test_native_builds_in_build_dir_and_matches(synth):
    _, questions = synth
    path = native.build()
    assert os.path.dirname(path) == build.BUILD_DIR
    assert not path.startswith(os.path.join(REPO, "gnn_rag_tpu") + os.sep)
    assert native.available()
    for q in questions[:12]:
        triples = [tuple(t) for t in q["subgraph"]["tuples"]]
        ans = [a["text"] for a in q["answers"]]
        for keep in (False, True):
            got = native.truth_paths_native(triples, q["entities"], ans,
                                            keep_parallel=keep)
            want = jnative.truth_paths_native(triples, q["entities"], ans,
                                              keep_parallel=keep)
            assert got == want and got


def test_graph_and_text_utils_match(synth):
    _, questions = synth
    for q in questions[:12]:
        triples = q["subgraph"]["tuples"]
        ans = [a["text"] for a in q["answers"]]
        g, jg = graph_utils.build_graph(triples), jgraph.build_graph(triples)
        paths = graph_utils.get_truth_paths(q["entities"], ans, g)
        assert paths == jgraph.get_truth_paths(q["entities"], ans, jg)
        assert (graph_utils.get_truth_paths_fast(triples, q["entities"], ans)
                == jgraph.get_truth_paths_fast(triples, q["entities"], ans))
        rule = [r for _, r, _ in paths[0]]
        assert (graph_utils.bfs_with_rule(g, q["entities"][0], rule)
                == jgraph.bfs_with_rule(jg, q["entities"][0], rule))
        assert ([text_utils.path_to_string(p) for p in paths]
                == [jtext.path_to_string(p) for p in paths])
        assert (text_utils.rule_to_string(rule)
                == jtext.rule_to_string(rule))
    for s in ("The  Answer!", "m.0abc", "Él"):
        assert text_utils.normalize(s) == jtext.normalize(s)


def test_prompt_and_sft_texts_match(synth, tmp_path):
    """preprocess_qa / preprocess_align texts of RoG-schema questions, and
    the packed tokens and completion masks, byte for byte."""
    _, questions = synth
    rog = [data_prep.rog_example(q) for q in questions[:10]]
    assert rog[0]["q_entity"] == questions[0]["entities"]
    tok = tokenizers.ByteTokenizer()
    count = lambda s: len(tok.encode(s))
    for mod, name in ((data_prep, "port"), (jprep, "ref")):
        random.seed(0)      # the budget's shuffle-truncation draws from it
        mod.preprocess_qa(rog, str(tmp_path / f"{name}_qa.jsonl"),
                          model_max_length=400, tokenize=count)
        mod.build_align_dataset(rog, str(tmp_path / f"{name}_raw.jsonl"))
        raw = mod.load_multiple_datasets([str(tmp_path / f"{name}_raw.jsonl")])
        mod.preprocess_align(raw, str(tmp_path / f"{name}_align.jsonl"))
    for kind in ("qa", "raw", "align"):
        assert filecmp.cmp(tmp_path / f"port_{kind}.jsonl",
                           tmp_path / f"ref_{kind}.jsonl", shallow=False), kind
    texts = [d["text"] for d in data_prep.load_multiple_datasets(
        [str(tmp_path / "port_qa.jsonl")], shuffle=True, seed=2)]
    assert texts == [d["text"] for d in jprep.load_multiple_datasets(
        [str(tmp_path / "ref_qa.jsonl")], shuffle=True, seed=2)]
    template = tok.encode(sft.RESPONSE_TEMPLATE, add_bos=False)
    got = sft.pack_examples(texts, tok.encode, template, 300, tok.pad_id)
    want = jsft.pack_examples(texts, jllama.ByteTokenizer().encode, template,
                              300, 0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].sum() > 0 and (got[1][:, :5] == 0).all()


def test_tokenizers_match():
    texts = ["Question:\nwhat is m.0abc? [/INST]", "héllo  world\tx"]
    b, jb = tokenizers.ByteTokenizer(), jllama.ByteTokenizer()
    w = tokenizers.WordTokenizer.from_texts(texts[:1])
    jw = jllama.WordTokenizer.from_texts(texts[:1])
    for text in texts:
        assert b.encode(text) == jb.encode(text)
        assert b.decode(b.encode(text)) == text
        assert w.encode(text) == jw.encode(text)
        assert w.decode(w.encode(text)) == jw.decode(jw.encode(text)) == text
    assert w.vocab_size == jw.vocab_size


# (port module, JAX module, the names copied unchanged)
RAG_COPIES = {
    "evaluate_results": (evaluate_results, jeval, (
        "eval_acc", "eval_hit", "eval_hit1", "eval_f1",
        "extract_topk_prediction", "eval_result")),
    "predict": (predict, jpredict, (
        "load_qa_dataset", "load_gnn_rag", "cand2_list", "get_output_file",
        "merge_rule_result", "prepare_input", "prediction",
        "predict_answers")),
    "evaluate_multi_hop": (evaluate_multi_hop, jmulti,
                           ("eval_result_multi_hop",)),
    "llms.base": (base, jbase, ("BaseLanguageModel",)),
    "llms.mock": (mock, jmock, ("MockLLM",)),
    "llms.serving": (serving, jserving, ("OpenAIProtocolServer", "LLMProxy")),
    "gen_rule_path": (gen_rule_path, jgen, (
        "INSTRUCTION", "PATH_RE", "parse_prediction", "GenRulePathConfig",
        "gen_prediction")),
}


@pytest.mark.parametrize("name", list(RAG_COPIES))
def test_rag_copies_keep_the_original_source(name):
    port, ref, names = RAG_COPIES[name]
    for n in names:
        a, b = getattr(port, n), getattr(ref, n)
        if isinstance(a, str):
            assert a == b, n
        else:
            assert inspect.getsource(a) == inspect.getsource(b), n
    assert port.__name__.startswith("gnn_rag_tpu_torch.rag.")


# the functions of finetune/data_prep.py copied unchanged (load_multiple_datasets
# imports its helper at the top instead; its output is held above)
DATA_PREP_COPIES = ("PLANNING_INSTRUCTION", "extract_relation_paths",
                    "build_align_dataset", "format_align_example",
                    "format_qa_example", "preprocess_align", "preprocess_qa",
                    "EXPLAIN_INSTRUCTION", "generate_explanations",
                    "load_new_tokens")


@pytest.mark.parametrize("name", DATA_PREP_COPIES)
def test_data_prep_copies_keep_the_original_source(name):
    a, b = getattr(data_prep, name), getattr(jprep, name)
    assert (a == b) if isinstance(a, str) else (
        inspect.getsource(a) == inspect.getsource(b))
    assert data_prep.__name__ == "gnn_rag_tpu_torch.finetune.data_prep"


def test_predict_config_adds_only_the_device():
    port = {f.name: f.default for f in dataclasses.fields(predict.PredictConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jpredict.PredictConfig)}
    assert port == dict(ref, device="cuda")


# functions of the retrievers' data path copied unchanged: the loader's
# relation table, ingest workers and id helpers, the Evaluator's names
# (tests/test_torch_retrievers.py and test_torch_rearev_options.py run them)
RETRIEVER_COPIES = {
    "load_relation_emb": (loader, jloader),
    "num_kb_relation": (loader, jloader),
    "_ingest_worker_init": (loader, jloader),
    "_ingest_worker": (loader, jloader),
    "_resolve_entity": (loader, jloader),
    "_resolve_relation": (loader, jloader),
    "Evaluator._name": (evaluate, jevaluate),
}


@pytest.mark.parametrize("name", list(RETRIEVER_COPIES))
def test_retriever_copies_keep_the_original_source(name):
    port, ref = RETRIEVER_COPIES[name]

    def get(mod):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    assert inspect.getsource(get(port)) == inspect.getsource(get(ref))
    assert port.__name__.startswith("gnn_rag_tpu_torch.")


# the reader backends, the profiling timer and the synthetic generator,
# copied unchanged (tests/test_torch_readers_hf.py and
# test_torch_paths_profiling.py run them against the JAX package)
from gnn_rag_tpu.rag import path_extract as jpath_extract  # noqa: E402
from gnn_rag_tpu.rag.llms import flan_t5 as jflan_t5  # noqa: E402
from gnn_rag_tpu.rag.llms import hf_causal as jhf_causal  # noqa: E402
from gnn_rag_tpu.rag.llms import openai_chat as jopenai_chat  # noqa: E402
from gnn_rag_tpu.utils import profiling as jprofiling  # noqa: E402
from gnn_rag_tpu.utils import synthetic as jsynthetic  # noqa: E402
from gnn_rag_tpu_torch.rag import path_extract  # noqa: E402
from gnn_rag_tpu_torch.rag.llms import flan_t5, hf_causal, openai_chat  # noqa: E402
from gnn_rag_tpu_torch.utils import profiling, synthetic  # noqa: E402

LATER_COPIES = {
    "hf_causal": (hf_causal, jhf_causal, ("Llama", "Alpaca", "Longchat")),
    "flan_t5": (flan_t5, jflan_t5, ("FlanT5",)),
    "openai_chat": (openai_chat, jopenai_chat, ("TOKEN_LIMITS",
                                                "get_token_limit", "ChatGPT")),
    "profiling": (profiling, jprofiling, ("StepTimer",)),
    "synthetic": (synthetic, jsynthetic, ("random_records", "multihop_records",
                                          "random_rel_hidden")),
}


@pytest.mark.parametrize("name", list(LATER_COPIES))
def test_later_copies_keep_the_original_source(name):
    port, ref, names = LATER_COPIES[name]
    for n in names:
        a, b = getattr(port, n), getattr(ref, n)
        if isinstance(a, dict):
            assert a == b, n
        else:
            assert inspect.getsource(a) == inspect.getsource(b), n
    assert port.__name__.startswith("gnn_rag_tpu_torch.")


def test_path_extract_changes_only_the_bfs_call():
    """BatchedPathExtractor is the JAX one but for its device and the call
    of the port's bfs_levels (tensors on that device, the hop count kept)."""
    import difflib
    a = inspect.getsource(jpath_extract.BatchedPathExtractor).splitlines()
    b = inspect.getsource(path_extract.BatchedPathExtractor).splitlines()
    changed = [line for line in difflib.unified_diff(a, b, lineterm="", n=0)
               if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    assert changed == [
        "-    def __init__(self, max_hops: int | None = None, max_sources: int = 4):",
        "+    def __init__(self, max_hops: int | None = None, max_sources: int = 4,",
        "+                 device=\"cuda\"):",
        "+        self.device = torch.device(device)",
        "+        self.last_hops = 0       # BFS hops of the last extract() (one sync each)",
        "-        dist = np.asarray(bfs_levels(heads, tails, mask, src_onehot,",
        "-                                     num_entities=E, max_hops=self.max_hops))",
        "+        dist, self.last_hops = bfs_levels(",
        "+            *(torch.from_numpy(a).to(self.device)",
        "+              for a in (heads, tails, mask, src_onehot)),",
        "+            num_entities=E, max_hops=self.max_hops, return_hops=True)",
        "+        dist = dist.cpu().numpy()",
    ]


@pytest.mark.parametrize("kw", [dict(), dict(cwq_style=True, build_layout=True,
                                             word_dim=None, use_self_loop=False)])
def test_synthetic_graph_batch_draws_like_jax(kw):
    """The same arrays, draw for draw (the port's GraphBatch has no
    ``fact_weight``; the JAX generator leaves it None)."""
    kw = dict(batch_size=3, n_entities=128, n_facts=256, num_relation=9,
              num_entity_global=500, q_len=6, **kw)
    got = synthetic.random_graph_batch(np.random.default_rng(2), **kw)
    want = jsynthetic.random_graph_batch(np.random.default_rng(2), **kw)
    assert want.fact_weight is None
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "layout":
            assert (a is None) == (b is None)
            if a is not None:
                for x, y in zip(a.fwd + a.inv, b.fwd + b.inv):
                    np.testing.assert_array_equal(x, np.asarray(y))
        elif a is None:
            assert b is None, f.name
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
    recs = synthetic.random_records(np.random.default_rng(5), n_questions=3)
    jrecs = jsynthetic.random_records(np.random.default_rng(5), n_questions=3)
    for r, jr in zip(recs.records, jrecs.records):
        np.testing.assert_array_equal(r.heads, jr.heads)
        assert r.answer_gids == jr.answer_gids
