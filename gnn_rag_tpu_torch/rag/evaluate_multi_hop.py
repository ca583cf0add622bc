"""Multi-hop answer scoring + retrieval coverage.

Copy of gnn_rag_tpu/rag/evaluate_multi_hop.py, a port of the reference
(llm/src/qa_prediction/evaluate_multi_hop.py:84-168): restricts metrics to
questions whose ground-truth shortest path is >1 hop and additionally
reports the median input length (chars/4) and "coverage" — the fraction of
questions whose prompt already contains an answer string (the
retrieval-recall proxy). Dataset rows are zipped with predictions by line
order like the reference.
"""

from __future__ import annotations

import json
import statistics
from typing import Optional

from .evaluate_results import eval_f1, eval_hit, eval_hit1
from .graph_utils import get_truth_paths_fast
from .predict import load_qa_dataset


def eval_result_multi_hop(predict_file: str, dataset=None,
                          dataset_path: Optional[str] = None,
                          split: str = "test") -> dict:
    if dataset is None:
        dataset = load_qa_dataset(dataset_path, split)

    hit_list, hit1_list, f1_list = [], [], []
    input_len, all_found = [], []
    counter = 0
    with open(predict_file) as fg:
        for lineg in fg:
            data = json.loads(lineg)
            prediction = data["prediction"]
            if not isinstance(prediction, list):
                prediction = prediction.split("\n")
            prediction_str = " ".join(prediction)
            answer = data["ground_truth"]
            example = dataset[counter]
            counter += 1
            reasoning_paths = get_truth_paths_fast(example["graph"],
                                                   example["q_entity"],
                                                   answer)
            found = 0
            for ans in answer:
                if ans in data["input"]:
                    found = 1
            hop = 1
            for path in reasoning_paths:
                hop = max(hop, len(path))
            if hop > 1:
                all_found.append(found)
                input_len.append(len(data["input"]) / 4)
                f1_score, _, _ = eval_f1(prediction, answer)
                f1_list.append(f1_score)
                hit1_list.append(eval_hit1(prediction, answer))
                hit_list.append(eval_hit(prediction_str, answer))

    result = {
        "n_multi_hop": len(hit_list),
        "median_input_len": statistics.median(input_len) if input_len else 0,
        "coverage": statistics.mean(all_found) if all_found else 0.0,
        "hit": sum(hit_list) * 100 / len(hit_list) if hit_list else 0.0,
        "hit1": sum(hit1_list) * 100 / len(hit1_list) if hit1_list else 0.0,
        "f1": sum(f1_list) * 100 / len(f1_list) if f1_list else 0.0,
    }
    print("Input len: ", result["median_input_len"])
    print("Coverage: ", result["coverage"])
    print(f" Hit: {result['hit']} Hit1: {result['hit1']} F1: {result['f1']}",
          result["n_multi_hop"])
    return result
