"""SFT dataset preparation for the RoG-style joint finetune (the port's copy
of gnn_rag_tpu/finetune/data_prep.py, same texts byte for byte).

Ports the reference preprocessors:
* build_align_dataset — (question, relation-path) pairs from ground-truth
  shortest paths (llm/src/align_kg/build_align_qa_dataset.py:35-50);
* format_align_example — planning SFT text with <PATH>/<SEP>/</PATH> labels
  (llm/src/joint_training/preprocess_align.py:29-36);
* format_qa_example — QA SFT text with ground-truth reasoning paths in the
  prompt (llm/src/joint_training/preprocess_qa.py:36-50);
* explanation distillation harness (generate_explanation_results.py) —
  ``generate_explanations``, few-shot prompting of a teacher backend (any
  ``rag.llms`` reader), and ``load_new_tokens``;
* ``rog_example`` — a SynthQSP / GNN-schema question (``question``,
  ``entities``, ``answers``, ``subgraph``) in the RoG schema these take
  (``question, q_entity, a_entity, answer, graph``), as
  scripts/train_reader.py:60-70 builds it inline.

All functions are hub-free: they take iterables of question dicts and write
JSONL.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable, List, Optional

from ..rag.graph_utils import get_truth_paths_fast
from ..rag.prompt_builder import PromptBuilder
from ..rag.text_utils import (InstructFormatter, load_multiple_jsonl,
                              rule_to_string)

PLANNING_INSTRUCTION = ("Please generate a valid relation path that can be "
                        "helpful for answering the following question: ")
SEP, BOP, EOP = "<SEP>", "<PATH>", "</PATH>"


def rog_example(q: dict) -> dict:
    """A GNN-schema question (SynthQSP / WebQSP JSONL: ``question``,
    ``entities``, ``answers`` as ``{"kb_id", "text"}`` records, ``subgraph``
    ``{"tuples"}``) -> the RoG schema of ``format_qa_example``."""
    answers = [a["text"] for a in q["answers"]]
    return {"id": q["id"], "question": q["question"], "answer": answers,
            "q_entity": q["entities"], "a_entity": answers,
            "graph": q["subgraph"]["tuples"], "choices": []}


def extract_relation_paths(sample: dict, remove_duplicate: bool = False
                           ) -> List[dict]:
    """(question, relation path) records from ground shortest paths
    (build_align_qa_dataset.py:35-50)."""
    paths = get_truth_paths_fast(sample["graph"], sample["q_entity"],
                                 sample["a_entity"])
    rel_paths = []
    for path in paths:
        rel_path = tuple(p[1] for p in path)
        if remove_duplicate and rel_path in rel_paths:
            continue
        rel_paths.append(rel_path)
    return [{"question": sample["question"], "path": list(rp)}
            for rp in rel_paths]


def build_align_dataset(dataset: Iterable[dict], out_path: str,
                        remove_duplicate: bool = False) -> int:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    n = 0
    with open(out_path, "w") as f:
        for sample in dataset:
            for rec in extract_relation_paths(sample, remove_duplicate):
                f.write(json.dumps(rec) + "\n")
                n += 1
    return n


def format_align_example(example: dict, prompter: InstructFormatter,
                         eos_token: str = "</s>") -> dict:
    label = rule_to_string(example["path"], sep_token=SEP, bop=BOP, eop=EOP)
    text = (prompter.format(instruction=PLANNING_INSTRUCTION,
                            message=example["question"])
            + " " + label + eos_token)
    return {"text": text}


def format_qa_example(example: dict, input_builder: PromptBuilder,
                      eos_token: str = "</s>") -> dict:
    example = dict(example)
    example["cand"] = None
    paths = get_truth_paths_fast(example["graph"], example["q_entity"],
                                 example["a_entity"])
    ground_paths = {tuple(p[1] for p in path) for path in paths}
    example["ground_paths"] = [list(g) for g in ground_paths]
    text = (input_builder.process_input(example)
            + " " + "\n".join(example["answer"]) + eos_token)
    return {"text": text}


def preprocess_align(dataset: Iterable[dict], out_path: str,
                     prompt_path: str = "prompts/llama2.txt",
                     eos_token: str = "</s>") -> int:
    prompter = InstructFormatter(prompt_path)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    n = 0
    with open(out_path, "w") as f:
        for ex in dataset:
            f.write(json.dumps(format_align_example(ex, prompter, eos_token))
                    + "\n")
            n += 1
    return n


def preprocess_qa(dataset: Iterable[dict], out_path: str,
                  prompt_path: str = "prompts/llama2_predict.txt",
                  model_max_length: int = 2048 - 200,
                  tokenize: Callable = len, eos_token: str = "</s>") -> int:
    input_builder = PromptBuilder(prompt_path, add_rule=True, use_true=True,
                                  maximun_token=model_max_length,
                                  tokenize=tokenize)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    n = 0
    with open(out_path, "w") as f:
        for ex in dataset:
            f.write(json.dumps(format_qa_example(ex, input_builder, eos_token))
                    + "\n")
            n += 1
    return n


EXPLAIN_INSTRUCTION = ("Based on the reasoning paths, please answer the given "
                       "question and explain why")


def generate_explanations(dataset: Iterable[dict], out_path: str, teacher,
                          prompt_path: str = "prompts/general_prompt.txt",
                          max_samples: int = 1000,
                          few_shot: Optional[str] = None) -> int:
    """Distil answer explanations from a teacher LLM
    (generate_explanation_results.py). `teacher` is any rag.llms backend."""
    prompter = InstructFormatter(prompt_path)
    builder = PromptBuilder(prompt_path, add_rule=True, use_true=True,
                            maximun_token=teacher.maximun_token,
                            tokenize=teacher.tokenize)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    n = 0
    with open(out_path, "w") as f:
        for ex in dataset:
            if n >= max_samples:
                break
            ex = dict(ex)
            ex["cand"] = None
            paths = get_truth_paths_fast(ex["graph"], ex["q_entity"],
                                         ex["a_entity"])
            ex["ground_paths"] = [list({tuple(p[1] for p in pa)
                                        for pa in paths})]
            question_input = builder.process_input(ex)
            msg = (few_shot + "\n\n" if few_shot else "") + question_input
            result = teacher.generate_sentence(
                prompter.format(instruction=EXPLAIN_INSTRUCTION, message=msg))
            if result is None:
                continue
            f.write(json.dumps({"question": ex["question"],
                                "input": question_input,
                                "explanation": result}) + "\n")
            n += 1
    return n


def load_new_tokens(default_new_tokens: List[str], rel_dict_paths) -> List[str]:
    """Relation tokens from tab-separated dict files (align_kg/data_loader.py:10-18)."""
    if isinstance(rel_dict_paths, str):
        rel_dict_paths = [rel_dict_paths]
    for rel_path in rel_dict_paths:
        with open(rel_path) as f:
            for line in f:
                _, r = line.strip().split("\t")
                default_new_tokens.append(r)
    return default_new_tokens


def load_multiple_datasets(data_path_list, shuffle: bool = False, seed: int = 0):
    """Concatenate JSONL SFT datasets (align_kg/data_loader.py:21-37)."""
    data = load_multiple_jsonl(data_path_list)
    if shuffle:
        import random
        random.Random(seed).shuffle(data)
    return data
