"""The RAG half of gnn_rag_tpu_torch against the JAX package on the CPU.

The same files and the same numpy-seeded weights go through both packages
(flax weights cross over through ``bridge``). Tolerances:

* the answer scorers and the predict driver with the mock reader: the same
  files byte for byte, the same numbers;
* ``LlamaTorch`` against ``LlamaTPU`` on one tiny float32 model: the same
  prompt budget and the same generated strings, also with ``--quant int8``
  and with a ``--draft_path`` draft (speculative decoding);
* the OpenAI-protocol server and proxy over the mock reader and over
  ``LlamaTorch``: the backend's own strings; ``generate_explanations`` and
  ``load_new_tokens`` with the mock teacher: the JAX package's files byte
  for byte;
* ``QAService``: the same prompts and predictions, the same candidate names,
  their probabilities within 1e-5;
* ``--info_attention``: the `.info` attention slots within 1e-5 of the JAX
  Evaluator's (the two frameworks sum in other orders), every other field
  the same (probabilities within 1e-5);
* ``gen_prediction``: the same file from the same generator; with the two
  decoders, the same paths and scores within 1e-5.
"""

import argparse
import dataclasses
import filecmp
import json
import os
import shutil
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cli_e2e import write_micro_dataset
from test_rag_predict import GRAPH, make_dataset
from test_serve import make_question

from gnn_rag_tpu import cli as jcli
from gnn_rag_tpu.config import Config, DataConfig, ModelConfig
from gnn_rag_tpu.data.loader import load_dataset_dir as jax_load_dataset_dir
from gnn_rag_tpu.data.vocab import Vocab
from gnn_rag_tpu.finetune import data_prep as jprep
from gnn_rag_tpu.llm_tpu.model import LlamaConfig as JLlamaConfig
from gnn_rag_tpu.llm_tpu.model import LlamaLM as JLlamaLM
from gnn_rag_tpu.models.rearev import ReaRev as JReaRev
from gnn_rag_tpu.rag import evaluate_multi_hop as jmulti
from gnn_rag_tpu.rag import evaluate_results as jeval
from gnn_rag_tpu.rag import gen_rule_path as jgen
from gnn_rag_tpu.rag import llms as jllms
from gnn_rag_tpu.rag import predict as jpredict
from gnn_rag_tpu.rag.llms.llama_tpu import LlamaTPU
from gnn_rag_tpu.rag.llms.llama_tpu import WordTokenizer as JWordTokenizer
from gnn_rag_tpu.serve import QAService as JQAService
from gnn_rag_tpu.serve import RetrieverService as JRetrieverService
from gnn_rag_tpu.train.evaluate import Evaluator as JEvaluator
from gnn_rag_tpu.utils.checkpoint import save_pytree
from gnn_rag_tpu.utils.synthetic import random_rel_hidden
from gnn_rag_tpu_torch import bridge, cli, serve_qa
from gnn_rag_tpu_torch.finetune import data_prep
from gnn_rag_tpu_torch.llm.model import LlamaConfig, LlamaLM
from gnn_rag_tpu_torch.llm.tokenizers import ByteTokenizer
from gnn_rag_tpu_torch.models.rearev import ReaRev
from gnn_rag_tpu_torch.rag import evaluate_multi_hop, evaluate_results
from gnn_rag_tpu_torch.rag import gen_rule_path, llms, predict
from gnn_rag_tpu_torch.rag.llms.llama_torch import LlamaTorch
from gnn_rag_tpu_torch.rag.llms.mock import MockLLM
from gnn_rag_tpu_torch.rag.llms.serving import LLMProxy, OpenAIProtocolServer
from gnn_rag_tpu_torch.serve import QAService, RetrieverService
from gnn_rag_tpu_torch.utils.checkpoint import save_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = os.path.join(REPO, "prompts", "llama2_predict.txt")
TINY = dict(vocab_size=259, dim=32, n_layers=2, n_heads=4, n_kv_heads=4,
            intermediate=64, max_seq_len=128, dtype="float32")


def lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# ------------------------------------------------------------ answer scoring
PREDICTIONS = [
    {"id": "a", "prediction": "English\nPatois", "ground_truth": ["English"]},
    {"id": "b", "prediction": ["Kingston", "Kingston", "Jamaica", "x"],
     "ground_truth": ["Jamaica", "Caribbean"]},
    {"id": "c", "prediction": "", "ground_truth": ["The Answer"]},
    {"id": "d", "prediction": ["the  answer!"], "ground_truth": ["The Answer"]},
]


@pytest.mark.parametrize("cal_f1,topk", [(True, -1), (True, 1), (False, -1)])
def test_eval_result_writes_the_same_files(tmp_path, cal_f1, topk):
    out = {}
    for name, mod in (("jax", jeval), ("port", evaluate_results)):
        (tmp_path / name).mkdir()
        path = tmp_path / name / "predictions.jsonl"
        with open(path, "w") as f:
            for row in PREDICTIONS:
                f.write(json.dumps(row) + "\n")
            f.write("not json\n")
        out[name] = mod.eval_result(str(path), cal_f1=cal_f1, topk=topk)
    assert out["port"] == out["jax"] and "Hit: " in out["port"]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    for name in names:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name


def rule_file(tmp_path):
    path = tmp_path / "rules.jsonl"
    with open(path, "w") as f:
        for qid, rel in (("q1", "official_language"), ("q2", "located_in")):
            f.write(json.dumps({"id": qid, "prediction": [[rel]],
                                "ground_paths": [[rel]]}) + "\n")
    return str(path)


@pytest.mark.parametrize("model_name,batch_size,add_rule", [
    ("mock", 1, False), ("mock", 4, False), ("mock", 1, True),
    ("no-llm", 1, True)])
def test_predict_answers_writes_the_same_predictions(tmp_path, model_name,
                                                     batch_size, add_rule):
    """predict_answers over a `.info` (and a rule file for "+RA"), with the
    mock reader one question at a time or in batches of 4, or with no
    reader: the same predictions.jsonl and scores, and a second run
    resumes without writing a line."""
    qa_path, info_path = make_dataset(tmp_path)
    files = {}
    for name, mod in (("jax", jpredict), ("port", predict)):
        cfg = mod.PredictConfig(
            data_path=str(qa_path), model_name=model_name,
            predict_path=str(tmp_path / name), prompt_path=PROMPT,
            rule_path_g1=str(info_path), entities_names_path=None,
            batch_size=batch_size, add_rule=add_rule,
            rule_path=rule_file(tmp_path) if add_rule else None)
        files[name] = mod.predict_answers(cfg)
        assert mod.predict_answers(cfg) == files[name]   # resumes
    assert files["port"].replace(str(tmp_path / "port"), "") == \
        files["jax"].replace(str(tmp_path / "jax"), "")
    for stem in ("predictions.jsonl", "eval_result.txt",
                 "detailed_eval_result.jsonl"):
        assert filecmp.cmp(files["jax"].replace("predictions.jsonl", stem),
                           files["port"].replace("predictions.jsonl", stem),
                           shallow=False), stem
    rows = lines(files["port"])
    assert len(rows) == 2
    if model_name == "mock":
        assert "Reasoning Paths:" in rows[0]["input"]
        assert "English" in rows[0]["prediction"]


def test_load_gnn_rag_unions_two_runs_the_same_way(tmp_path):
    _, info_path = make_dataset(tmp_path)
    gnn2 = tmp_path / "gnn2"
    gnn2.mkdir()
    shutil.copy(info_path.parent / "test.json", gnn2 / "test.json")
    with open(gnn2 / "test.info", "w") as f:
        for cand in ([["English", 0.9], ["Kingston", 0.2]], [["Caribbean", 0.5]]):
            f.write(json.dumps({"cand": cand}) + "\n")
    got = predict.load_gnn_rag(str(info_path), str(gnn2 / "test.info"))
    assert got == jpredict.load_gnn_rag(str(info_path), str(gnn2 / "test.info"))
    assert got["q1"]["cand"] == [["English", 0.9], ["Patois", 0.3],
                                 ["Kingston", 0.2]]
    assert predict.load_gnn_rag(str(info_path)) == jpredict.load_gnn_rag(
        str(info_path))


def test_multi_hop_scores_match(tmp_path):
    qa_path, _ = make_dataset(tmp_path)
    rows = [{"id": "q1", "prediction": "English\nAmericas",
             "ground_truth": ["English", "Americas"],
             "input": "Jamaica -> located_in -> Caribbean -> part_of -> Americas"},
            {"id": "q2", "prediction": ["Caribbean"],
             "ground_truth": ["Americas"], "input": "nothing"}]
    path = tmp_path / "predictions.jsonl"
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    dataset = predict.load_qa_dataset(str(qa_path))
    for q in dataset:
        q["graph"] = GRAPH
    got = evaluate_multi_hop.eval_result_multi_hop(str(path), dataset=dataset)
    assert got == jmulti.eval_result_multi_hop(str(path), dataset=dataset)
    assert got["n_multi_hop"] == 2 and got["coverage"] == 0.5


# ------------------------------------------------------------------ registry
NAMES = list(jllms.registed_language_models) + [
    "llama_tpu", "tpu-reader", "RoG", "meta-llama/Llama-2-7b-chat-hf"]


def test_registry_keys_keep_their_order():
    assert (list(llms.registed_language_models)
            == list(jllms.registed_language_models))


@pytest.mark.parametrize("name", NAMES)
def test_registry_resolves_every_jax_name(name, tmp_path):
    want = jllms.get_registed_model(name)
    got = llms.get_registed_model(name)
    if want is LlamaTPU:
        assert got is LlamaTorch
    elif want is jllms.MockLLM:
        assert got is MockLLM
    else:
        # the HF and OpenAI backends: the port's copies, built without
        # touching transformers, openai or a network, with the JAX token
        # budgets (tests/test_torch_readers_hf.py runs them)
        assert got.__name__ == want.__name__
        assert got.__module__.startswith("gnn_rag_tpu_torch.rag.llms.")
        args = argparse.Namespace(model_path=str(tmp_path), retry=1,
                                  model_name=name, max_new_tokens=8,
                                  dtype="fp32")
        assert got(args).maximun_token == want(args).maximun_token
    with pytest.raises(ValueError):
        llms.get_registed_model("no-such-reader")


# ------------------------------------------------------- LlamaTorch backend
PROMPTS = ["what do they speak in jamaica?",
           "Reasoning Paths:\nJamaica -> official_language -> English\n\n"
           "Question:\nwhat language?",
           "q", "where is the Caribbean, and what is part of the Americas?"]


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """One tiny float32 reader in a JAX bundle (orbax ``checkpoint/``) and
    in the port's (``checkpoint.pt``), with and without a word vocabulary,
    and a 1-layer byte-token draft for it (``*_draft``)."""
    root = tmp_path_factory.mktemp("bundles")
    words = JWordTokenizer.from_texts(PROMPTS[:2])
    for tok in ("byte", "word", "draft"):
        mcfg = dict(TINY, vocab_size=words.vocab_size if tok == "word" else 259,
                    n_layers=1 if tok == "draft" else TINY["n_layers"])
        jm = JLlamaLM(JLlamaConfig(**mcfg))
        params = jm.init(jax.random.PRNGKey(int(tok == "draft")),
                         jnp.zeros((1, 8), jnp.int32))
        for kind in ("jax", "port"):
            d = root / f"{kind}_{tok}"
            d.mkdir()
            with open(d / "config.json", "w") as f:
                json.dump(mcfg, f)
            if kind == "jax":
                save_pytree(str(d / "checkpoint"), params)
            else:
                save_state(str(d / "checkpoint.pt"),
                           bridge.llama_from_flax(params))
            if tok == "word":
                words.save(str(d / "vocab.json"))
    return root


@dataclasses.dataclass
class ReaderArgs:
    model_path: str
    max_new_tokens: int = 12
    device: str = "cpu"
    quant: str = None
    draft_path: str = None
    spec_gamma: int = 4


@pytest.mark.parametrize("tok", ["byte", "word"])
def test_llama_torch_generates_what_llama_tpu_does(bundles, tok):
    ref = LlamaTPU(ReaderArgs(str(bundles / f"jax_{tok}")))
    ref.prepare_for_inference()
    got = llms.get_registed_model("llama_tpu")(
        ReaderArgs(str(bundles / f"port_{tok}")))
    got.prepare_for_inference()
    assert got.maximun_token == ref.maximun_token == 128 - 12 - 8
    assert type(got.tok).__name__ == type(ref.tok).__name__
    assert [got.tokenize(p) for p in PROMPTS] == [ref.tokenize(p) for p in PROMPTS]
    for p in PROMPTS[:2]:
        assert got.generate_sentence(p) == ref.generate_sentence(p)
    assert got.generate_batch(PROMPTS) == ref.generate_batch(PROMPTS)
    assert len(set(got.generate_batch(PROMPTS))) > 1


def test_llama_torch_reads_the_sft_checkpoint(bundles, tmp_path):
    """A bundle of the SFT CLI's checkpoint-<step>.pt files: the newest."""
    src = bundles / "port_byte"
    shutil.copy(src / "config.json", tmp_path / "config.json")
    shutil.copy(src / "checkpoint.pt", tmp_path / "checkpoint-20.pt")
    state = torch.load(src / "checkpoint.pt", weights_only=True)
    save_state(str(tmp_path / "checkpoint-3.pt"),
               {k: torch.zeros_like(v) for k, v in state.items()})
    reader = LlamaTorch(ReaderArgs(str(tmp_path)))
    reader.prepare_for_inference()
    want = LlamaTorch(ReaderArgs(str(src)))
    want.prepare_for_inference()
    assert reader.generate_batch(PROMPTS) == want.generate_batch(PROMPTS)


@pytest.mark.parametrize("flag", [dict(quant="int8"), dict(draft_path="draft")])
def test_llama_torch_unported_options_raise(bundles, flag):
    """``--quant int8`` and ``--draft_path`` (now ported) give LlamaTPU's
    strings and budget with the same flags; the draft decodes the plain
    greedy tokens."""
    def reader(cls, kind):
        kw = dict(flag)
        if "draft_path" in kw:
            kw["draft_path"] = str(bundles / f"{kind}_draft")
        r = cls(ReaderArgs(str(bundles / f"{kind}_byte"), **kw))
        r.prepare_for_inference()
        return r

    ref, got = reader(LlamaTPU, "jax"), reader(LlamaTorch, "port")
    extra = 4 + 1 if "draft_path" in flag else 0
    assert got.maximun_token == ref.maximun_token == 128 - 12 - extra - 8
    assert (got.spec is None) == (ref.spec is None) == ("draft_path" not in flag)
    if "quant" in flag:
        assert got.model.cfg.quant == "int8" and got.model.layer_0.attn.q_proj.weight_q.dtype == torch.int8
    for p in PROMPTS:
        assert got.generate_sentence(p) == ref.generate_sentence(p)
    assert got.generate_batch(PROMPTS) == ref.generate_batch(PROMPTS)
    if "draft_path" in flag:
        plain = LlamaTorch(ReaderArgs(str(bundles / "port_byte")))
        plain.prepare_for_inference()
        assert [got.generate_sentence(p) for p in PROMPTS] == [
            plain.generate_sentence(p) for p in PROMPTS]


def test_llama_torch_int8_with_draft_matches_llama_tpu(bundles):
    kw = lambda kind: ReaderArgs(str(bundles / f"{kind}_byte"), quant="int8",
                                 draft_path=str(bundles / f"{kind}_draft"),
                                 spec_gamma=2)
    ref, got = LlamaTPU(kw("jax")), LlamaTorch(kw("port"))
    ref.prepare_for_inference()
    got.prepare_for_inference()
    assert got.maximun_token == ref.maximun_token == 128 - 12 - 3 - 8
    assert got.spec.gamma == 2
    for p in PROMPTS:
        assert got.generate_sentence(p) == ref.generate_sentence(p)
        assert got.spec.last_stats["target_forwards"] >= 2


def test_llama_torch_spec_gamma_0_warns_and_decodes_plain(bundles, caplog):
    args = ReaderArgs(str(bundles / "port_byte"), spec_gamma=0,
                      draft_path=str(bundles / "port_draft"))
    got = LlamaTorch(args)
    with caplog.at_level("WARNING"):
        got.prepare_for_inference()
    assert got.spec is None and "spec_gamma=0" in caplog.text
    assert got.maximun_token == 128 - 12 - 8
    plain = LlamaTorch(ReaderArgs(str(bundles / "port_byte")))
    plain.prepare_for_inference()
    assert got.generate_sentence(PROMPTS[1]) == plain.generate_sentence(PROMPTS[1])


# ------------------------------------------------- serving, explanations
@pytest.mark.parametrize("backend", ["mock", "llama_torch"])
def test_openai_protocol_round_trip(bundles, backend):
    if backend == "mock":
        model = MockLLM(argparse.Namespace())
    else:
        model = LlamaTorch(ReaderArgs(str(bundles / "port_byte"), quant="int8"))
        model.prepare_for_inference()
    server = OpenAIProtocolServer(model, model_name="reader", port=0).start()
    try:
        proxy = LLMProxy(port=server.port, model_name="reader")
        for p in PROMPTS[:2]:
            assert proxy.query(p, max_retry=1) == model.generate_sentence(p).strip()
        with urllib.request.urlopen(
                f"http://localhost:{server.port}/v1/models", timeout=30) as r:
            assert json.loads(r.read()) == {"data": [{"id": "reader"}]}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://localhost:{server.port}/v1/other",
                                   timeout=30)
    finally:
        server.stop()


def test_explanations_and_new_tokens_write_the_same_files(tmp_path):
    """``generate_explanations`` with the mock teacher (each package's), a
    few-shot prefix and a sample cap; ``load_new_tokens`` over two dict
    files."""
    dataset = [{"id": f"q{i}", "question": f"what is near jamaica {i}",
                "answer": [ans], "q_entity": ["Jamaica"], "a_entity": [ans],
                "graph": GRAPH, "choices": []}
               for i, ans in enumerate(("English", "Caribbean", "Patois", "x"))]
    for name, mod, teacher in (("jax", jprep, jllms.MockLLM),
                               ("port", data_prep, MockLLM)):
        n = mod.generate_explanations(
            dataset, str(tmp_path / name / "explain.jsonl"),
            teacher(argparse.Namespace()),
            prompt_path=os.path.join(REPO, "prompts", "general_prompt.txt"),
            max_samples=3, few_shot="Q: x?\nA: y")
        assert n == 3
    assert filecmp.cmp(tmp_path / "jax" / "explain.jsonl",
                       tmp_path / "port" / "explain.jsonl", shallow=False)
    rows = lines(tmp_path / "port" / "explain.jsonl")
    assert all(r["explanation"] and "Reasoning Paths" in r["input"] for r in rows)
    assert data_prep.EXPLAIN_INSTRUCTION == jprep.EXPLAIN_INSTRUCTION
    for i, rels in enumerate((["a.b", "c.d"], ["e.f"])):
        with open(tmp_path / f"rel{i}.txt", "w") as f:
            f.write("".join(f"{j}\t{r}\n" for j, r in enumerate(rels)))
    paths = [str(tmp_path / "rel0.txt"), str(tmp_path / "rel1.txt")]
    want = jprep.load_new_tokens(["<PAD>"], paths)
    assert data_prep.load_new_tokens(["<PAD>"], paths) == want == [
        "<PAD>", "a.b", "c.d", "e.f"]
    assert data_prep.load_new_tokens([], paths[1]) == jprep.load_new_tokens(
        [], paths[1])


def test_readers_default_to_the_card(bundles, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LlamaTorch(argparse.Namespace(model_path=str(bundles / "port_byte")))
    with pytest.raises(RuntimeError, match="cuda"):
        predict.predict_answers(predict.PredictConfig(
            data_path="no.jsonl", model_name="llama_tpu",
            predict_path=str(tmp_path), model_path=str(bundles / "port_byte")),
            dataset=[])
    with pytest.raises(RuntimeError, match="cuda"):
        gen_rule_path.TorchSeqGenerator(LlamaLM(LlamaConfig(**TINY)),
                                        ByteTokenizer())
    assert predict.PredictConfig().device == "cuda"


# ---------------------------------------------------------------- QAService
def qa_question(i):
    return {"id": f"q{i}", "question": f"where was m0{i} born",
            "entities": [f"m.0{i}"],
            "subgraph": {"entities": [f"m.{j:02d}" for j in range(6)],
                         "tuples": [[f"m.0{i}", "people.person.place_of_birth",
                                     "m.01"],
                                    ["m.01", "location.location.contains", "m.02"],
                                    ["m.03", "location.location.contains", "m.04"],
                                    ["m.00", "location.location.contains",
                                     "m.05"]]},
            "answers": []}


@pytest.fixture(scope="module")
def services():
    """The JAX and the port's QAService over one ReaRev (flax weights
    bridged) with the mock reader, the retriever of tests/test_serve.py
    (its question, and two more)."""
    ents = {f"m.{i:02d}": i for i in range(20)}
    rels = {"people.person.place_of_birth": 0, "location.location.contains": 1}
    vocab = Vocab(ents, rels, {})
    cfg = Config(data=DataConfig(name="webqsp"),
                 model=ModelConfig(entity_dim=16, num_iter=2, num_ins=2,
                                   num_gnn=1, linear_dropout=0.0))
    rel = random_rel_hidden(np.random.default_rng(0), 3 + 1, 4, 32)

    def qenc(token_ids):
        r = np.random.default_rng(int(token_ids.sum()))
        return r.standard_normal((len(token_ids), 32)).astype(np.float32)

    from gnn_rag_tpu.data.loader import KGQADataset, ingest_question
    rec = ingest_question(qa_question(0), vocab, data_name="webqsp",
                          use_inverse_relation=False, use_self_loop=True,
                          num_kb_relation=3)
    ds = KGQADataset([rec], num_entity=20, num_kb_relation=3)
    rec.q_token_ids = np.zeros(4, np.int32)
    ds.q_hidden = [qenc(rec.q_token_ids)]
    params = JReaRev(cfg=cfg.model, num_entity=20, num_relation=3).init(
        jax.random.PRNGKey(0), ds.make_batch([0], build_layout=True), *rel)
    model = ReaRev(cfg.model, 20, 3, 32)
    model.load_state_dict(bridge.from_flax(params))
    kw = dict(rel_hidden=rel[0], rel_hidden_inv=rel[1], rel_text_mask=rel[2],
              question_encoder=qenc, path_backend="python")
    args = argparse.Namespace(max_new_tokens=8)
    jsvc = JQAService(JRetrieverService(cfg, vocab, params, **kw),
                      jllms.MockLLM(args), prompt_path=PROMPT)
    svc = QAService(RetrieverService(cfg, vocab, model.eval(), **kw),
                    MockLLM(args), prompt_path=PROMPT)
    return jsvc, svc


def test_qa_service_answers_as_jax_does(services):
    jsvc, svc = services
    qs = [make_question(), qa_question(3), qa_question(1)]
    for batch in (qs[:1], qs):
        want, got = jsvc.answer(batch), svc.answer(batch)
        assert len(got) == len(batch)
        for w, g in zip(want, got):
            assert g["prompt"] == w["prompt"] and "Reasoning Paths:" in g["prompt"]
            assert g["prediction"] == w["prediction"]
            assert [c for c, _ in g["cand"]] == [c for c, _ in w["cand"]]
            np.testing.assert_allclose([p for _, p in g["cand"]],
                                       [p for _, p in w["cand"]], atol=1e-5)
    assert "m.01" in got[0]["prediction"]


def post(url, body: bytes):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, None


def test_answer_and_retrieve_over_http(services):
    jsvc, svc = services
    httpd = svc.serve_http(port=0)
    url = f"http://localhost:{httpd.server_port}"
    q = qa_question(0)
    try:
        status, ans = post(url + "/answer", json.dumps({"questions": [q]}).encode())
        assert status == 200
        assert ans["results"][0]["prediction"] == jsvc.answer([q])[0]["prediction"]
        status, ret = post(url + "/retrieve",
                           json.dumps({"questions": [q]}).encode())
        assert status == 200 and ret["results"][0]["paths"]
        assert post(url + "/answer", b"{not json")[0] == 400
        assert post(url + "/answer", b"[1, 2]")[0] == 400
        bad = dict(q, subgraph={})                  # no tuples: handler raises
        assert post(url + "/answer", json.dumps({"questions": [bad]}).encode()
                    )[0] == 500
        assert post(url + "/nowhere", b"{}")[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


# ----------------------------------------------------------- --info_attention
MICRO_FLAGS = ["ReaRev", "--lm", "sbert", "--entity_dim", "16", "--num_iter",
               "2", "--num_ins", "2", "--num_gnn", "2", "--batch_size", "4",
               "--test_batch_size", "4", "--experiment_name", "micro",
               "--linear_dropout", "0.0", "--device", "cpu"]


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    root = tmp_path_factory.mktemp("rag_micro")
    (root / "data").mkdir()
    write_micro_dataset(root / "data")
    return root, MICRO_FLAGS + ["--data_folder", str(root / "data") + "/",
                                "--checkpoint_dir", str(root / "ckpt")]


def test_info_attention_matches_the_jax_evaluator(micro):
    """``--is_eval --info_attention`` through the port's CLI: the `.info`
    slots hold each instruction's attention over the question's real
    tokens, within 1e-5 of the JAX Evaluator's on the same weights,
    frozen-LM states and questions."""
    root, flags = micro
    ctx = cli.run(flags + ["--is_eval", "--info_attention"])
    got = lines(root / "ckpt" / "micro_test.info")
    tr, cfg = ctx["trainer"], ctx["cfg"]
    jcfg = jcli.args_to_config(jcli.build_parser().parse_args(
        [a for a in flags if a not in ("--device", "cpu")]))
    jb = jax_load_dataset_dir(jcfg)
    jds, tds = jb["test"], tr.test_data
    for jr, tr_ in zip(jds.records, tds.records):
        jr.q_token_ids = tr_.q_token_ids
    jds.q_hidden = tds.q_hidden
    rel = (ctx["rel_hidden"], ctx["rel_hidden_inv"], ctx["rel_mask"])
    jmodel = JReaRev(cfg=jcfg.model, num_entity=tr.num_entity,
                     num_relation=ctx["bundle"]["num_kb_relation"])
    params = bridge.to_flax(tr.model.state_dict())

    def forward(b, **kw):
        return jmodel.apply(params, b, *rel, **kw)

    path = root / "jax.info"
    JEvaluator(eps=cfg.model.eps, num_entity=tr.num_entity,
               id2entity=ctx["bundle"]["vocab"].id2entity,
               num_iter=cfg.model.num_iter).evaluate(
        jds, forward, 4, write_info=True, info_path=str(path),
        decode_question=tr.decode_question, build_layout=True,
        attn_forward_fn=lambda b: forward(b, return_attn=True))
    want = lines(path)
    assert len(got) == len(want) == tds.num_data
    for g, w, rec in zip(got, want, tds.records):
        assert list(g) == list(w)
        for j in ("0", "1"):
            att = g[j]["attention"]
            assert len(att) == len(rec.q_token_ids)
            np.testing.assert_allclose(att, w[j]["attention"], atol=1e-5)
            assert abs(sum(att) - 1.0) <= 1e-5 + 5e-7 * len(att)
        assert [c for c, _ in g["cand"]] == [c for c, _ in w["cand"]]
        np.testing.assert_allclose([p for _, p in g["cand"]],
                                   [p for _, p in w["cand"]], atol=1e-5)
        for k in ("question", "answers", "precison", "recall", "f1", "hit", "em"):
            assert g[k] == w[k], k


def test_serve_qa_entry_point(micro, monkeypatch):
    """``python -m gnn_rag_tpu_torch.serve_qa ... --reader mock --device
    cpu``: /retrieve and /answer on one server; without ``--device cpu``
    it asks for the card."""
    root, flags = micro
    httpd = serve_qa.main(flags + ["--port", "0", "--reader", "mock"],
                          block=False)
    url = f"http://localhost:{httpd.server_port}"
    q = {"question": "who is born in 3", "entities": ["m.003"],
         "subgraph": {"entities": ["m.003", "m.004", "m.005"],
                      "tuples": [["m.003", "people.person.place_of_birth", "m.004"],
                                 ["m.004", "location.location.contains", "m.005"]]},
         "answers": []}
    try:
        assert isinstance(httpd.service, QAService)
        status, ret = post(url + "/retrieve", json.dumps({"questions": [q]}).encode())
        assert status == 200 and any(p.startswith("m.003 ->")
                                     for p in ret["results"][0]["paths"])
        status, ans = post(url + "/answer", json.dumps({"questions": [q]}).encode())
        assert status == 200 and "m.004" in ans["results"][0]["prediction"]
    finally:
        httpd.shutdown()
        httpd.server_close()
    on_card = [a for a in flags if a not in ("--device", "cpu")]
    args = serve_qa.build_parser().parse_args(on_card)
    assert args.device == "cuda" and args.reader is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        serve_qa.main(on_card + ["--port", "0", "--reader", "mock"],
                      block=False)


# ------------------------------------------------------------ gen_rule_path
class EosBytes(ByteTokenizer):
    """Byte tokens with HF's ``eos_token_id`` name, which the generators
    read, set to a token the tiny model emits."""
    eos_token_id = None


def stub_generate(text, num_beams=3, max_new_tokens=100, do_sample=False):
    return {"paths": ["<PATH>official_language<SEP>x</PATH>", "junk",
                      "<PATH> located_in </PATH>"][:num_beams],
            "scores": [-0.5, -1.0, -2.0][:num_beams],
            "norm_scores": [0.6, 0.3, 0.1][:num_beams]}


def test_gen_prediction_writes_the_same_file(tmp_path):
    qa_path, _ = make_dataset(tmp_path)
    files = {}
    for name, mod in (("jax", jgen), ("port", gen_rule_path)):
        cfg = mod.GenRulePathConfig(data_path=str(qa_path),
                                    output_path=str(tmp_path / name),
                                    prompt_path="prompts/llama2.txt", n_beam=3)
        files[name] = mod.gen_prediction(cfg, stub_generate)
    assert filecmp.cmp(files["jax"], files["port"], shallow=False)
    rows = lines(files["port"])
    assert rows[0]["prediction"] == [["official_language", "x"], ["located_in"]]
    assert gen_rule_path.parse_prediction(["<PATH>a<SEP> <SEP>b</PATH>"]) == [
        ["a", "b"]]


@pytest.mark.parametrize("n_beam", [1, 3])
def test_torch_seq_generator_matches_tpu_seq_generator(tmp_path, n_beam):
    """gen_prediction through each package's decoder on one tiny model
    (bridged weights): the same paths, scores within 1e-5."""
    qa_path, _ = make_dataset(tmp_path)
    jm = JLlamaLM(JLlamaConfig(**TINY))
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    model = LlamaLM(LlamaConfig(**TINY))
    model.load_state_dict(bridge.llama_from_flax(params))
    tok = EosBytes()
    seqs, _, _ = jgen.TpuSeqGenerator(jm, params, tok, max_len=256).decoder\
        .beam_search(tok.encode("what language do they speak in jamaica"),
                     num_beams=3, max_new_tokens=6)
    tok.eos_token_id = seqs[0][2]
    gens = {"jax": jgen.TpuSeqGenerator(jm, params, tok, max_len=256),
            "port": gen_rule_path.TorchSeqGenerator(model, tok, max_len=256,
                                                    device="cpu")}
    out = {}
    for name, mod in (("jax", jgen), ("port", gen_rule_path)):
        cfg = mod.GenRulePathConfig(data_path=str(qa_path),
                                    output_path=str(tmp_path / name),
                                    prompt_path="prompts/llama2.txt",
                                    n_beam=n_beam, max_new_tokens=12)
        out[name] = lines(mod.gen_prediction(cfg, gens[name]))
    for w, g in zip(out["jax"], out["port"]):
        assert g["raw_output"]["paths"] == w["raw_output"]["paths"]
        for key in ("scores", "norm_scores"):
            np.testing.assert_allclose(g["raw_output"][key],
                                       w["raw_output"][key], atol=1e-5)
        assert {k: v for k, v in g.items() if k != "raw_output"} == \
            {k: v for k, v in w.items() if k != "raw_output"}
