"""RAG answer-prediction driver.

Copy of gnn_rag_tpu/rag/predict.py, a port of the reference driver
(llm/src/qa_prediction/predict_answer.py:43-337): loads the QA dataset, merges RoG rule paths, attaches GNN `.info` candidates
(optionally union-max over two GNN runs), builds prompts, queries the LLM,
appends resume-safe JSONL output, and scores with evaluate_results.

Dataset input accepts a HuggingFace dataset name/dir OR a local JSONL file
with the same fields (id, question, answer, q_entity, a_entity, graph,
choices) so the pipeline runs without hub access.

The port's ``PredictConfig`` adds ``device`` ("cuda", the default, or
"cpu"), which ``rag.llms.LlamaTorch`` builds its reader on.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from functools import partial
from typing import Optional

from .evaluate_results import eval_result
from .prompt_builder import PromptBuilder
from .text_utils import load_jsonl


def load_qa_dataset(path: str, split: str = "test"):
    """HF dataset (hub name or saved dir) or JSONL file -> list of dicts."""
    if path.endswith(".jsonl") or path.endswith(".json"):
        return load_jsonl(path)
    try:
        from datasets import load_dataset
        return load_dataset(path, split=split)
    except Exception:
        from datasets import load_from_disk
        ds = load_from_disk(path)
        return ds[split] if split in getattr(ds, "keys", lambda: [])() else ds


def load_gnn_rag(g_data_file: str, g_data_file2: Optional[str] = None) -> dict:
    """Zip `.info` lines with the sibling test.json by line order; with a
    second run, union candidates keeping the max score
    (predict_answer.py:43-80)."""
    data_file_gnn = {}
    data_file = os.path.join(os.path.dirname(g_data_file), "test.json")
    with open(data_file) as f_in, open(g_data_file) as fg:
        for line, lineg in zip(f_in, fg):
            line = json.loads(line)
            data_file_gnn[line["id"]] = json.loads(lineg)
    if g_data_file2 is not None:
        data_file2 = os.path.join(os.path.dirname(g_data_file2), "test.json")
        with open(data_file2) as f_in, open(g_data_file2) as fg:
            for line, lineg in zip(f_in, fg):
                line = json.loads(line)
                lineg = json.loads(lineg)
                cand1 = data_file_gnn[line["id"]]["cand"]
                for c2 in cand2_list(lineg):
                    for c1 in cand1:
                        if c2[0] == c1[0]:
                            if c2[1] > c1[1]:
                                c1[1] = c2[1]
                            break
                    else:
                        cand1.append(c2)
                data_file_gnn[line["id"]]["cand"] = sorted(
                    cand1, key=lambda x: x[1], reverse=True)
    return data_file_gnn


def cand2_list(lineg):
    return lineg["cand"]


def get_output_file(path: str, force: bool = False):
    """Resume-safe output (predict_answer.py:83-97)."""
    if not os.path.exists(path) or force:
        return open(path, "w"), []
    processed = []
    with open(path) as f:
        for line in f:
            processed.append(json.loads(line)["id"])
    return open(path, "a"), processed


def merge_rule_result(qa_dataset, rule_dataset, filter_empty: bool = False):
    """Attach predicted/ground rule paths per question id
    (predict_answer.py:100-124)."""
    question_to_rule = {
        d["id"]: {"predicted_paths": d["prediction"],
                  "ground_paths": d["ground_paths"]}
        for d in rule_dataset}

    merged = []
    for sample in qa_dataset:
        sample = dict(sample)
        rule = question_to_rule[sample["id"]]
        sample["predicted_paths"] = rule["predicted_paths"]
        sample["ground_paths"] = rule["ground_paths"]
        if filter_empty and len(sample["ground_paths"]) == 0:
            continue
        merged.append(sample)
    return merged


def prepare_input(data, processed_list, input_builder: PromptBuilder,
                  entities_names: Optional[dict] = None, data_file_gnn=None):
    """Candidate naming + prompt build, shared by the per-question and the
    device-batched paths. Returns the record minus the prediction, or None
    for already-processed ids."""
    qid = data["id"]
    data = dict(data)
    data["cand"] = None
    if data_file_gnn is not None:
        cand = data_file_gnn[qid]["cand"]
        named = []
        for c in cand:
            if entities_names and c[0] in entities_names:
                named.append(entities_names[c[0]])
            else:
                named.append(c[0])
        data["cand"] = named
    if qid in processed_list:
        return None
    return data


def prediction(data, processed_list, input_builder: PromptBuilder, model,
               entities_names: Optional[dict] = None, data_file_gnn=None):
    """Per-question prediction (predict_answer.py:127-171)."""
    data = prepare_input(data, processed_list, input_builder,
                         entities_names, data_file_gnn)
    if data is None:
        return None
    qid = data["id"]
    if model is None:
        return {"id": qid, "question": data["question"],
                "prediction": input_builder.direct_answer(data),
                "ground_truth": data["answer"], "input": data["question"]}
    llm_input = input_builder.process_input(data)
    pred = model.generate_sentence(llm_input)
    if pred is None:
        return None
    return {"id": qid, "question": data["question"],
            "prediction": pred.strip(), "ground_truth": data["answer"],
            "input": llm_input}


@dataclass
class PredictConfig:
    data_path: str = "rmanluo"
    d: str = "RoG-webqsp"
    split: str = "test"
    predict_path: str = "results/KGQA"
    model_name: str = "mock"
    model_path: Optional[str] = None
    prompt_path: str = "prompts/llama2_predict.txt"
    add_rule: bool = False
    use_true: bool = False
    cot: bool = False
    explain: bool = False
    use_random: bool = False
    each_line: bool = False
    rule_path: Optional[str] = None
    rule_path_g1: Optional[str] = None
    rule_path_g2: Optional[str] = None
    force: bool = False
    n: int = 1
    filter_empty: bool = False
    debug: bool = False
    encrypt: bool = False
    entities_names_path: Optional[str] = "entities_names.json"
    max_new_tokens: int = 512
    dtype: str = "fp16"
    retry: int = 5
    # verbalize parallel edges as "r1 | r2" in cand reasoning paths
    # (opt-in; see PromptBuilder.keep_parallel)
    keep_parallel: bool = False
    # >1: feed the card `batch_size` prompts per generate call when the
    # backend exposes generate_batch (the kv-cache decoder prefills and
    # decodes the batch together). The reference parallelises with a host
    # Pool (predict_answer.py:244-265) instead. Resume semantics are
    # unchanged: processed ids are skipped at prompt-build time and rows are
    # flushed per batch.
    batch_size: int = 1
    # the port's: where the llama_tpu / LlamaTorch reader runs ("cuda"
    # raises without a card; "cpu" must be asked for)
    device: str = "cuda"


def predict_answers(cfg: PredictConfig, LLM=None, dataset=None) -> str:
    """Main driver (predict_answer.py:174-276). Returns the output file path."""
    if dataset is None:
        input_file = (cfg.data_path if cfg.data_path.endswith((".jsonl", ".json"))
                      else os.path.join(cfg.data_path, cfg.d))
        dataset = load_qa_dataset(input_file, cfg.split)

    rule_postfix = "no_rule"
    if cfg.add_rule and cfg.rule_path:
        rule_postfix = cfg.rule_path.replace("/", "_").replace(".", "_")
        rule_dataset = load_jsonl(cfg.rule_path)
        dataset = merge_rule_result(dataset, rule_dataset, cfg.filter_empty)
        if cfg.use_true:
            rule_postfix = "ground_rule"
        elif cfg.use_random:
            rule_postfix = "random_rule"

    data_file_gnn = None
    if cfg.rule_path_g1 and os.path.exists(cfg.rule_path_g1):
        if cfg.rule_path_g2 and os.path.exists(cfg.rule_path_g2):
            data_file_gnn = load_gnn_rag(cfg.rule_path_g1, cfg.rule_path_g2)
        else:
            data_file_gnn = load_gnn_rag(cfg.rule_path_g1)

    if cfg.cot:
        rule_postfix += "_cot"
    if cfg.explain:
        rule_postfix += "_explain"
    if cfg.filter_empty:
        rule_postfix += "_filter_empty"
    if cfg.each_line:
        rule_postfix += "_each_line"

    entities_names = None
    if cfg.entities_names_path and os.path.exists(cfg.entities_names_path):
        with open(cfg.entities_names_path) as f:
            entities_names = json.load(f)

    output_dir = os.path.join(cfg.predict_path, cfg.d, cfg.model_name,
                              cfg.split, rule_postfix, str(cfg.encrypt))
    os.makedirs(output_dir, exist_ok=True)

    if LLM is None and cfg.model_name != "no-llm":
        from .llms import get_registed_model
        LLM = get_registed_model(cfg.model_name)

    names_entities = ({v: k for k, v in entities_names.items()}
                      if entities_names else None)
    if LLM is not None:
        model = LLM(cfg)
        input_builder = PromptBuilder(
            cfg.prompt_path, cfg.encrypt, cfg.add_rule, use_true=cfg.use_true,
            cot=cfg.cot, explain=cfg.explain, use_random=cfg.use_random,
            each_line=cfg.each_line, maximun_token=model.maximun_token,
            tokenize=model.tokenize, names_entities=names_entities,
            keep_parallel=cfg.keep_parallel)
        model.prepare_for_inference()
    else:
        model = None
        input_builder = PromptBuilder(cfg.prompt_path, cfg.encrypt,
                                      cfg.add_rule, use_true=cfg.use_true,
                                      names_entities=names_entities)

    with open(os.path.join(output_dir, "args.txt"), "w") as f:
        json.dump({k: str(v) for k, v in cfg.__dict__.items()}, f, indent=2)

    output_file = os.path.join(output_dir, "predictions.jsonl")
    fout, processed_list = get_output_file(output_file, force=cfg.force)

    pred_fn = partial(prediction, processed_list=processed_list,
                      input_builder=input_builder, model=model,
                      entities_names=entities_names,
                      data_file_gnn=data_file_gnn)
    if (cfg.batch_size > 1 and model is not None
            and hasattr(model, "generate_batch")):
        def flush(buf):
            outs = model.generate_batch([b["input"] for b in buf])
            for b, pred in zip(buf, outs):
                if pred is None:
                    continue
                b["prediction"] = pred.strip()
                fout.write(json.dumps(b) + "\n")
            fout.flush()

        buf = []
        for data in dataset:
            prep = prepare_input(data, processed_list, input_builder,
                                 entities_names, data_file_gnn)
            if prep is None:
                continue
            buf.append({"id": prep["id"], "question": prep["question"],
                        "input": input_builder.process_input(prep),
                        "ground_truth": prep["answer"]})
            if len(buf) == cfg.batch_size:
                flush(buf)
                buf = []
        if buf:
            flush(buf)
    elif cfg.n > 1:
        from multiprocessing.pool import ThreadPool
        with ThreadPool(cfg.n) as p:
            for res in p.imap(pred_fn, dataset):
                if res is not None:
                    fout.write(json.dumps(res) + "\n")
                    fout.flush()
    else:
        for data in dataset:
            res = pred_fn(data)
            if res is not None:
                if cfg.debug:
                    print(json.dumps(res))
                fout.write(json.dumps(res) + "\n")
                fout.flush()
    fout.close()

    eval_result(output_file, encrypt=cfg.encrypt)
    return output_file
