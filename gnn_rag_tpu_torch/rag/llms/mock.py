"""Deterministic mock LLM for offline tests and pipeline dry-runs: a copy of
gnn_rag_tpu/rag/llms/mock.py (no reference counterpart — the reference has
no tests)."""

from __future__ import annotations

import re

from .base import BaseLanguageModel


class MockLLM(BaseLanguageModel):
    """Answers by echoing the tail entities of the reasoning paths in the
    prompt (one per line), which makes end-to-end RAG tests meaningful: if
    the retrieved paths contain the answer, the mock 'reader' returns it."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("--max_new_tokens", type=int, default=512)

    def __init__(self, args):
        self.args = args
        self.maximun_token = 4096 - 100

    def tokenize(self, text: str) -> int:
        return len(text.split())

    def prepare_for_inference(self, **model_kwargs):
        pass

    def generate_sentence(self, llm_input: str):
        m = re.search(r"Reasoning Paths:\n(.*?)\n\nQuestion:", llm_input,
                      re.DOTALL)
        if not m:
            return "unknown"
        answers = []
        for line in m.group(1).split("\n"):
            parts = [p.strip() for p in line.split("->")]
            if len(parts) >= 3 and parts[-1] not in answers:
                answers.append(parts[-1])
        return "\n".join(answers) if answers else "unknown"
