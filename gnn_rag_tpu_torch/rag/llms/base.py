"""Common LLM backend interface: a copy of gnn_rag_tpu/rag/llms/base.py
(reference: llm/src/llms/language_models/base_language_model.py:4-41)."""

from __future__ import annotations


class BaseLanguageModel:
    maximun_token: int = 4096

    @staticmethod
    def add_args(parser):
        return

    def __init__(self, args):
        self.args = args

    def load_model(self, **kwargs):
        raise NotImplementedError

    def prepare_for_inference(self, **model_kwargs):
        raise NotImplementedError

    def tokenize(self, text: str) -> int:
        """Token COUNT of text (used for prompt budgeting)."""
        raise NotImplementedError

    def generate_sentence(self, llm_input: str):
        raise NotImplementedError

    def generate_batch(self, llm_inputs):
        """Batched generation; backends with a device-batched decoder
        (llama_tpu) override this — the default just loops, so
        PredictConfig.batch_size>1 works against any backend."""
        return [self.generate_sentence(t) for t in llm_inputs]
