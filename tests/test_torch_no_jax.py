"""gnn_rag_tpu_torch runs without JAX and without the JAX package: a fresh
interpreter imports the port, serves one question, trains one ReaRev step,
one NSM step (LSTM encoder, teacher) and one GraftNet step and serves each
from its state_dict, ingests a split in a process pool through the cache,
runs one SFT step of the LLM reader and one greedy decode on the CPU, a
remat LoRA step, an int8 model's forward and a speculative decode, tries
the frozen LM's HF checkpoint loader (its loud fallback), then runs the RAG
half: the SFT checkpoint as a ``llama_tpu`` reader bundle (also int8 with
itself as draft), ``QAService`` answering through it, the OpenAI-protocol
server and proxy, explanation distillation, ``predict_answers`` and its
scorers with the mock reader, beam search through ``gen_prediction``, and
imports the HF LLaMA loader and the ``serve_qa`` entry, the HF and OpenAI
reader backends, the mesh and LLM sharding modules, the profiling hooks
and the synthetic generator, and extracts paths through the device BFS
backend; and it never loads jax, flax, optax, orbax, transformers, openai
or any module of ``gnn_rag_tpu``; and no file of the port, nor chip_smoke.py, imports or runs
the JAX package."""

import ast
import os
import re
import subprocess
import sys

SCRIPT = r"""
import sys
import numpy as np
from gnn_rag_tpu_torch.config import Config, DataConfig, ModelConfig
from gnn_rag_tpu_torch.data.vocab import Vocab
from gnn_rag_tpu_torch.train.trainer import build_model
from gnn_rag_tpu_torch.serve import RetrieverService

ents = {f"m.{i:02d}": i for i in range(20)}
rels = {"people.person.place_of_birth": 0, "location.location.contains": 1}
cfg = Config(data=DataConfig(name="webqsp"),
             model=ModelConfig(entity_dim=16, num_iter=2, num_ins=2, num_gnn=2))
rng = np.random.default_rng(0)
rel = [rng.standard_normal((4, 3, 24)).astype(np.float32) for _ in range(2)]
svc = RetrieverService(
    cfg, Vocab(ents, rels, {}), build_model(cfg, 20, 3, word_dim=24, seed=0, device="cpu"),
    rel_hidden=rel[0], rel_hidden_inv=rel[1],
    rel_text_mask=np.ones((4, 3), np.float32),
    question_encoder=lambda ids: np.ones((len(ids), 24), np.float32))
q = {"id": "q0", "question": "where was m00 born", "entities": ["m.00"],
     "subgraph": {"entities": [f"m.{i:02d}" for i in range(6)],
                  "tuples": [["m.00", "people.person.place_of_birth", "m.01"],
                             ["m.01", "location.location.contains", "m.02"]]}}
out = svc.retrieve([q])
assert out[0]["cand"] and out[0]["paths"], out
out_cand = out[0]["cand"]
dev = RetrieverService(
    cfg, Vocab(ents, rels, {}), svc.model, rel_hidden=rel[0],
    rel_hidden_inv=rel[1], rel_text_mask=np.ones((4, 3), np.float32),
    question_encoder=lambda ids: np.ones((len(ids), 24), np.float32),
    path_backend="device")
assert dev.retrieve([q])[0]["paths"] == out[0]["paths"]

from gnn_rag_tpu_torch.llm import sharding
from gnn_rag_tpu_torch.parallel import collectives, mesh
from gnn_rag_tpu_torch.rag.llms import flan_t5, hf_causal, openai_chat
from gnn_rag_tpu_torch.utils import profiling, synthetic
assert hf_causal.Llama(None).maximun_token == 3996

import logging
from gnn_rag_tpu_torch.data.loader import KGQADataset, ingest_question
from gnn_rag_tpu_torch.train.trainer import Trainer
rec = ingest_question(dict(q, answers=["m.01"]), svc.vocab, data_name="webqsp",
                      use_inverse_relation=False, use_self_loop=True,
                      num_kb_relation=3)
rec.q_token_ids = np.zeros(4, np.int32)
ds = KGQADataset([rec], num_entity=20, num_kb_relation=3)
ds.q_hidden = [np.ones((4, 24), np.float32)]
tr = Trainer(cfg, train_data=ds, valid_data=ds, test_data=ds, num_entity=20,
             num_kb_relation=3, rel_hidden=rel[0], rel_hidden_inv=rel[1],
             rel_text_mask=np.ones((4, 3), np.float32), word_dim=24,
             logger=logging.getLogger("no_jax"), device="cpu")
loss, h1, f1 = tr.train_epoch()
tr.close()
assert tr.step_count == 1 and np.isfinite(loss), loss
for name in ("NSM", "GraftNet"):
    rcfg = Config(data=DataConfig(name="webqsp"), model=ModelConfig(
        model_name=name, entity_dim=16, num_step=2, num_layer=2, lm="lstm",
        word_dim=8, lm_dropout=0.0, lambda_back=0.1, lambda_constrain=0.1))
    rtr = Trainer(rcfg, train_data=ds, valid_data=ds, test_data=ds,
                  num_entity=20, num_kb_relation=3, num_word=5,
                  logger=logging.getLogger("no_jax"), device="cpu")
    loss, h1, f1 = rtr.train_epoch()
    rtr.close()
    assert rtr.step_count == 1 and np.isfinite(loss), (name, loss)
    rsvc = RetrieverService(rcfg, Vocab(ents, rels, {w: i for i, w in
                                                     enumerate("abcde")}),
                            rtr.model.state_dict(), device="cpu")
    assert type(rsvc.model).__name__ == name and rsvc.retrieve([q])[0]["cand"]

import json, os, tempfile
from gnn_rag_tpu_torch.data.loader import load_split
with tempfile.TemporaryDirectory() as out:
    path = os.path.join(out, "train.json")
    with open(path, "w") as f:
        f.write(json.dumps(dict(q, answers=["m.01"])) + "\n")
    for workers in (2, 0):       # ingests in the pool, then reads the cache
        recs = load_split(path, svc.vocab, data_name="webqsp",
                          use_inverse_relation=False, use_self_loop=True,
                          num_workers=workers)
        assert len(recs) == 1 and recs[0].answer_gids == [1], recs
    assert os.path.exists(path + ".ingest.torch.pkl")

import dataclasses, tempfile
from gnn_rag_tpu_torch.llm.generate import Decoder
from gnn_rag_tpu_torch.llm.model import LlamaConfig
from gnn_rag_tpu_torch.llm.sft import SFTConfig, SFTTrainer, pack_examples
from gnn_rag_tpu_torch.llm.tokenizers import ByteTokenizer
bt = ByteTokenizer()
toks, mask = pack_examples(["[INST] q? [/INST] m.01</s>"] * 2, bt.encode,
                           bt.encode("[/INST]", add_bos=False), 32, bt.pad_id)
mcfg = LlamaConfig(vocab_size=bt.vocab_size, dim=32, n_layers=1, n_heads=2,
                   n_kv_heads=2, intermediate=64, dtype="float32")
with tempfile.TemporaryDirectory() as out:
    sft = SFTTrainer(mcfg, SFTConfig(output_dir=out, batch_size=2,
                                     total_steps=1), device="cpu")
    losses = sft.train(toks, mask)
assert len(losses) == 1 and np.isfinite(losses[0]), losses
ids = Decoder(sft.model.eval(), max_len=64).greedy(bt.encode("[INST] q?"), 4,
                                                   eos_id=bt.eos_id)
assert 1 <= len(ids) <= 4, ids

import torch
from gnn_rag_tpu_torch.llm.generate import SpeculativeDecoder
from gnn_rag_tpu_torch.llm.lora import LoRATrainer, init_lora
from gnn_rag_tpu_torch.llm.model import LlamaLM, build_llama
from gnn_rag_tpu_torch.llm.quant import quantize_state_dict
rcfg = dataclasses.replace(mcfg, remat=True)
lm = build_llama(rcfg, seed=1, device="cpu")
lt = LoRATrainer(lm, init_lora(lm, torch.Generator().manual_seed(0)), lr=1e-2)
assert torch.isfinite(lt.train_step(torch.from_numpy(toks).long(),
                                    torch.from_numpy(mask)))
qm = LlamaLM(dataclasses.replace(mcfg, quant="int8"))
qm.load_state_dict(quantize_state_dict(sft.model.state_dict()))
prompt = bt.encode("[INST] q?")
spec = SpeculativeDecoder(qm.eval(), sft.model, max_len=64, gamma=2)
assert spec.greedy(prompt, 4) == Decoder(qm, max_len=64).greedy(prompt, 4)

from gnn_rag_tpu_torch.models import encoder_variants
from gnn_rag_tpu_torch.models.frozen_lm import maybe_frozen_lm
from gnn_rag_tpu_torch.utils import hf_import
lm = maybe_frozen_lm("/no/such/checkpoint", word_dim=24, device="cpu")
assert lm.weight_source.startswith("random-init"), lm.weight_source

import argparse, json, os, shutil
from gnn_rag_tpu_torch import serve_qa
from gnn_rag_tpu_torch.llm import convert_hf
from gnn_rag_tpu_torch.rag import evaluate_multi_hop, gen_rule_path, predict
from gnn_rag_tpu_torch.rag.llms import get_registed_model
from gnn_rag_tpu_torch.serve import QAService
from gnn_rag_tpu_torch.utils.checkpoint import save_state
with tempfile.TemporaryDirectory() as out:
    save_state(os.path.join(out, "checkpoint-1.pt"), sft.model.state_dict())
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(mcfg), f)
    reader = get_registed_model("llama_tpu")(argparse.Namespace(
        model_path=out, max_new_tokens=4, device="cpu"))
    reader.prepare_for_inference()
    qa = QAService(svc, reader, prompt_path="prompts/llama2_predict.txt")
    ans = qa.answer([q, q])
    assert len(ans) == 2 and "Reasoning Paths:" in ans[0]["prompt"], ans
    from gnn_rag_tpu_torch.finetune.data_prep import generate_explanations
    from gnn_rag_tpu_torch.rag.llms.serving import LLMProxy, OpenAIProtocolServer
    fast = get_registed_model("llama_tpu")(argparse.Namespace(
        model_path=out, max_new_tokens=4, device="cpu", quant="int8",
        draft_path=out, spec_gamma=2))
    fast.prepare_for_inference()
    server = OpenAIProtocolServer(fast, port=0).start()
    try:
        text = LLMProxy(port=server.port).query("[INST] q?", max_retry=1)
    finally:
        server.stop()
    assert text == fast.generate_sentence("[INST] q?"), text
    rog = {"id": "q0", "question": q["question"], "answer": ["m.02"],
           "q_entity": ["m.00"], "a_entity": ["m.02"],
           "graph": q["subgraph"]["tuples"], "choices": []}
    with open(os.path.join(out, "qa.jsonl"), "w") as f:
        f.write(json.dumps(rog) + "\n")
    os.makedirs(os.path.join(out, "gnn"))
    shutil.copy(os.path.join(out, "qa.jsonl"), os.path.join(out, "gnn", "test.json"))
    with open(os.path.join(out, "gnn", "test.info"), "w") as f:
        f.write(json.dumps({"cand": out_cand}) + "\n")
    pred = predict.predict_answers(predict.PredictConfig(
        data_path=os.path.join(out, "qa.jsonl"), model_name="mock",
        predict_path=os.path.join(out, "res"),
        rule_path_g1=os.path.join(out, "gnn", "test.info"),
        entities_names_path=None, prompt_path="prompts/llama2_predict.txt"))
    assert "Hit" in open(pred.replace("predictions.jsonl", "eval_result.txt")).read()
    evaluate_multi_hop.eval_result_multi_hop(pred, dataset=[rog])
    assert generate_explanations([rog], os.path.join(out, "ex.jsonl"),
                                 get_registed_model("mock")(None),
                                 prompt_path="prompts/general_prompt.txt") == 1
    rules = gen_rule_path.gen_prediction(gen_rule_path.GenRulePathConfig(
        data_path=os.path.join(out, "qa.jsonl"), output_path=os.path.join(out, "r"),
        prompt_path="prompts/llama2.txt", n_beam=2, max_new_tokens=4),
        gen_rule_path.TorchSeqGenerator(sft.model, bt, max_len=256, device="cpu"))
    assert len(json.load(open(rules))["raw_output"]["scores"]) == 2
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                       "gnn_rag_tpu", "transformers", "openai"))
print("LOADED", loaded)
"""


def test_port_serves_without_jax():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]


def _python_files():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    yield os.path.join(repo, "chip_smoke.py")
    for root, _, files in os.walk(os.path.join(repo, "gnn_rag_tpu_torch")):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


def test_port_never_imports_or_runs_the_jax_package():
    """Static: no import of ``gnn_rag_tpu`` (or a module in it) and no
    ``-m gnn_rag_tpu.<module>`` in any file of the port or chip_smoke.py."""
    files = list(_python_files())
    assert len(files) > 30
    port = os.path.join(os.path.dirname(files[0]), "gnn_rag_tpu_torch")
    for new in ("llm/quant.py", "llm/lora.py", "rag/llms/serving.py",
                "models/nsm.py", "models/graftnet.py", "models/retriever.py",
                "ops/degree.py", "rag/llms/hf_causal.py", "rag/llms/flan_t5.py",
                "rag/llms/openai_chat.py", "utils/profiling.py", "ops/bfs.py",
                "rag/path_extract.py", "parallel/mesh.py",
                "parallel/collectives.py", "llm/sharding.py",
                "utils/synthetic.py"):
        assert os.path.join(port, new) in files, new
    for path in files:
        with open(path) as f:
            src = f.read()
        for node in ast.walk(ast.parse(src, path)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [n for n in names if n.split(".")[0] in
                   ("gnn_rag_tpu", "jax", "jaxlib", "flax", "optax", "orbax")]
            assert not bad, f"{path} imports {bad}"
        assert not re.search(r"""["']gnn_rag_tpu\.""", src), (
            f"{path} names a module of the JAX package as a string")
