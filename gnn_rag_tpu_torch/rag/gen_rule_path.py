"""RoG planning: beam-generate relation paths per question.

Copy of gnn_rag_tpu/rag/gen_rule_path.py, a port of the reference generator
(llm/src/qa_prediction/gen_rule_path.py): prompt = planning instruction +
question; the model emits ``<PATH>rel1<SEP>rel2</PATH>`` strings which are
parsed into relation-path rules; output JSONL is resume-safe and includes
ground-truth relation paths for evaluation. The "+RA" prediction
(``PredictConfig.add_rule``) reads this file as its ``rule_path``.

Generation backends:
* a ``generate_seq(text, num_beams, max_new_tokens) -> {paths, scores,
  norm_scores}`` callable (e.g. an HF model wrapper, or a test stub);
* the port's kv-cache decoder (``llm.generate.Decoder``) via
  ``TorchSeqGenerator``, in place of the JAX package's ``TpuSeqGenerator``.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Callable, List

from .graph_utils import get_truth_paths_fast
from .predict import get_output_file, load_qa_dataset
from .text_utils import InstructFormatter

INSTRUCTION = ("Please generate a valid relation path that can be helpful "
               "for answering the following question: ")
PATH_RE = r"<PATH>(.*)<\/PATH>"


def parse_prediction(prediction: List[str]) -> List[List[str]]:
    """<PATH>r1<SEP>r2</PATH> strings -> relation lists
    (gen_rule_path.py:42-68)."""
    results = []
    for p in prediction:
        m = re.search(PATH_RE, p)
        if m is None:
            continue
        rules = [rel.strip() for rel in m.group(1).split("<SEP>")
                 if rel.strip() != ""]
        results.append(rules)
    return results


class TorchSeqGenerator:
    """generate_seq over the port's kv-cache decoder (``llm.generate``), on
    the card unless ``device="cpu"`` is asked for (``model``, a
    ``LlamaLM``, is moved there)."""

    def __init__(self, model, tokenizer, max_len: int = 1024,
                 device: str = "cuda"):
        import torch

        from ..llm.generate import Decoder
        if device != "cpu" and not torch.cuda.is_available():
            raise RuntimeError("TorchSeqGenerator on cuda: "
                               "torch.cuda.is_available() is false (pass "
                               "device='cpu' to run on the CPU)")
        self.decoder = Decoder(model.to(device).eval(), max_len=max_len)
        self.tokenizer = tokenizer
        self.eos_id = getattr(tokenizer, "eos_token_id", None)

    def __call__(self, input_text: str, num_beams: int = 3,
                 max_new_tokens: int = 100, do_sample: bool = False) -> dict:
        ids = self.tokenizer.encode(input_text)
        if num_beams > 1:
            seqs, scores, norm = self.decoder.beam_search(
                ids, num_beams=num_beams, max_new_tokens=max_new_tokens,
                eos_id=self.eos_id)
            paths = [self.tokenizer.decode(s).strip() for s in seqs]
            return {"paths": paths, "scores": scores.tolist(),
                    "norm_scores": norm.tolist()}
        out = self.decoder.greedy(ids, max_new_tokens=max_new_tokens,
                                  eos_id=self.eos_id)
        return {"paths": [self.tokenizer.decode(out).strip()],
                "scores": [1], "norm_scores": [1]}


@dataclass
class GenRulePathConfig:
    data_path: str = "rmanluo"
    d: str = "RoG-webqsp"
    split: str = "test"
    output_path: str = "results/gen_rule_path"
    model_name: str = "RoG"
    prompt_path: str = "prompts/llama2.txt"
    n_beam: int = 3
    do_sample: bool = False
    max_new_tokens: int = 100
    force: bool = False
    debug: bool = False


def gen_prediction(cfg: GenRulePathConfig, generate_seq: Callable,
                   dataset=None) -> str:
    """Driver (gen_rule_path.py:102-187). Returns the prediction file path."""
    if dataset is None:
        input_file = (cfg.data_path if cfg.data_path.endswith((".jsonl", ".json"))
                      else os.path.join(cfg.data_path, cfg.d))
        dataset = load_qa_dataset(input_file, cfg.split)

    prompter = InstructFormatter(cfg.prompt_path)
    output_dir = os.path.join(cfg.output_path, cfg.d, cfg.model_name,
                              cfg.split)
    os.makedirs(output_dir, exist_ok=True)
    prediction_file = os.path.join(
        output_dir, f"predictions_{cfg.n_beam}_{cfg.do_sample}.jsonl")
    f, processed = get_output_file(prediction_file, force=cfg.force)

    for data in dataset:
        qid = data["id"]
        if qid in processed:
            continue
        input_text = prompter.format(instruction=INSTRUCTION,
                                     message=data["question"])
        paths = get_truth_paths_fast(data["graph"], data["q_entity"],
                                     data["a_entity"])
        ground_paths = list({tuple(p[1] for p in path) for path in paths})
        raw_output = generate_seq(input_text, num_beams=cfg.n_beam,
                                  max_new_tokens=cfg.max_new_tokens,
                                  do_sample=cfg.do_sample)
        rel_paths = parse_prediction(raw_output["paths"])
        if cfg.debug:
            print("ID:", qid, "Prediction:", rel_paths)
        f.write(json.dumps({
            "id": qid, "question": data["question"], "prediction": rel_paths,
            "ground_paths": [list(g) for g in ground_paths],
            "input": input_text, "raw_output": raw_output}) + "\n")
        f.flush()
    f.close()
    return prediction_file
