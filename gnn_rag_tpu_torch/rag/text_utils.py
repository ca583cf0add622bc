"""String utilities shared by the RAG stage
(reference: llm/src/utils/utils.py:5-58 and the normalize/match helpers
duplicated across predict_answer.py:25-40 / evaluate_results.py:15-30)."""

from __future__ import annotations

import json
import re
import string
from typing import List


def read_prompt(prompt_path: str) -> str:
    with open(prompt_path) as f:
        return f.read()


def load_jsonl(file_path: str) -> List[dict]:
    data = []
    with open(file_path) as f:
        for line in f:
            data.append(json.loads(line))
    return data


def load_multiple_jsonl(paths) -> List[dict]:
    out: List[dict] = []
    for p in paths:
        out.extend(load_jsonl(p))
    return out


def list_to_string(items: list) -> str:
    return ", ".join(f'"{i}"' for i in items)


def rule_to_string(rule: list, sep_token: str = "<SEP>", bop: str = "<PATH>",
                   eop: str = "</PATH>") -> str:
    body = rule[0] if len(rule) == 1 else sep_token.join(rule)
    return bop + body + eop


def path_to_string(path: list) -> str:
    """(h, r, t) triples -> 'h -> r -> t -> r2 -> t2' (utils.py:34-44)."""
    result = ""
    for i, (h, r, t) in enumerate(path):
        if i == 0:
            result += f"{h} -> {r} -> {t}"
        else:
            result += f" -> {r} -> {t}"
    return result.strip()


def normalize(s: str) -> str:
    """Lowercase, strip punctuation/articles/whitespace (evaluate_results.py:15-24)."""
    s = s.lower()
    exclude = set(string.punctuation)
    s = "".join(ch for ch in s if ch not in exclude)
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    s = re.sub(r"\b(<pad>)\b", " ", s)
    return " ".join(s.split())


def match(s1: str, s2: str) -> bool:
    """Normalized containment: s2 in s1 (evaluate_results.py:27-30)."""
    return normalize(s2) in normalize(s1)


class InstructFormatter:
    """Template renderer (utils.py:46-58)."""

    def __init__(self, prompt_path: str):
        self.prompt_template = read_prompt(prompt_path)

    def format(self, instruction: str, message: str) -> str:
        return self.prompt_template.format(instruction=instruction,
                                           input=message)
