"""Answer scoring: accuracy / Hit / Hit@1 / F1 over prediction lines.

Copy of gnn_rag_tpu/rag/evaluate_results.py, a port of the reference scorer
(llm/src/qa_prediction/evaluate_results.py:32-141): string-normalized
containment matching, newline-split predictions, detailed per-question JSONL
plus a one-line summary (``eval_result.txt``) whose format matches the shipped
goldens byte-for-byte.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

from .text_utils import match


def eval_acc(prediction: str, answer: Sequence[str]) -> float:
    matched = 0.0
    for a in answer:
        if match(prediction, a):
            matched += 1
    return matched / len(answer)


def eval_hit(prediction: str, answer: Sequence[str]) -> int:
    for a in answer:
        if match(prediction, a):
            return 1
    return 0


def eval_hit1(prediction: Sequence[str], answer: Sequence[str]) -> int:
    for a in answer:
        if match(prediction[0], a):
            return 1
    return 0


def eval_f1(prediction: Sequence[str], answer: Sequence[str]):
    """Returns (f1, precision, recall) (evaluate_results.py:51-64)."""
    if len(prediction) == 0:
        return 0, 0, 0
    matched = 0
    prediction_str = " ".join(prediction)
    for a in answer:
        if match(prediction_str, a):
            matched += 1
    precision = matched / len(prediction)
    recall = matched / len(answer)
    if precision + recall == 0:
        return 0, precision, recall
    return 2 * precision * recall / (precision + recall), precision, recall


def extract_topk_prediction(prediction: Sequence[str], k: int = -1) -> List[str]:
    """Most-frequent k predictions (evaluate_results.py:66-76)."""
    results = {}
    for p in prediction:
        results[p] = results.get(p, 0) + 1
    if k > len(results) or k < 0:
        k = len(results)
    ranked = sorted(results.items(), key=lambda x: x[1], reverse=True)
    return [r[0] for r in ranked[:k]]


def eval_result(predict_file: str, cal_f1: bool = True, topk: int = -1,
                encrypt: bool = False) -> Optional[str]:
    """Score a predictions.jsonl; writes detailed_eval_result.jsonl and
    eval_result.txt next to it; returns the summary line."""
    eval_name = (f"detailed_eval_result_top_{topk}.jsonl" if topk > 0
                 else "detailed_eval_result.jsonl")
    detailed_eval_file = predict_file.replace("predictions.jsonl", eval_name)
    acc_list, hit_list, hit1_list = [], [], []
    f1_list, precission_list, recall_list = [], [], []
    with open(predict_file) as f, open(detailed_eval_file, "w") as f2:
        for line in f:
            try:
                data = json.loads(line)
            except Exception:
                continue
            qid = data["id"]
            prediction = data["prediction"]
            answer = data["ground_truth"]
            if cal_f1:
                if not isinstance(prediction, list):
                    prediction = prediction.strip().split("\n")
                else:
                    prediction = extract_topk_prediction(prediction, topk)
                f1_score, precision_score, recall_score = eval_f1(prediction,
                                                                  answer)
                f1_list.append(f1_score)
                precission_list.append(precision_score)
                recall_list.append(recall_score)
                prediction_str = " ".join(prediction)
                acc = eval_acc(prediction_str, answer)
                hit1 = eval_hit1(prediction, answer)
                hit = eval_hit(prediction_str, answer)
                acc_list.append(acc)
                hit1_list.append(hit1)
                hit_list.append(hit)
                f2.write(json.dumps({
                    "id": qid, "prediction": prediction,
                    "ground_truth": answer, "acc": acc, "hit": hit,
                    "hit1": hit1, "f1": f1_score,
                    "precission": precision_score,
                    "recall": recall_score}) + "\n")
            else:
                prediction_str = (prediction if isinstance(prediction, str)
                                  else " ".join(prediction)).strip()
                acc = eval_acc(prediction_str, answer)
                hit = eval_hit(prediction_str, answer)
                acc_list.append(acc)
                hit_list.append(hit)
                f2.write(json.dumps({
                    "id": qid, "prediction": prediction,
                    "ground_truth": answer, "acc": acc, "hit": hit}) + "\n")

    if not acc_list:
        return None
    if f1_list:
        result_str = (
            "Accuracy: " + str(sum(acc_list) * 100 / len(acc_list))
            + " Hit: " + str(sum(hit_list) * 100 / len(hit_list))
            + " Hit1: " + str(sum(hit1_list) * 100 / len(hit1_list))
            + " F1: " + str(sum(f1_list) * 100 / len(f1_list))
            + " Precision: " + str(sum(precission_list) * 100 / len(precission_list))
            + " Recall: " + str(sum(recall_list) * 100 / len(recall_list)))
    else:
        result_str = (
            "Accuracy: " + str(sum(acc_list) * 100 / len(acc_list))
            + " Hit: " + str(sum(hit_list) * 100 / len(hit_list)))
    result_name = (f"eval_result_top_{topk}.txt" if topk > 0
                   else "eval_result.txt")
    with open(predict_file.replace("predictions.jsonl", result_name), "w") as f:
        f.write(result_str)
    return result_str
