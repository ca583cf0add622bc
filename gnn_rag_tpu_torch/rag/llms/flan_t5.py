"""Flan-T5 text2text backend, the port of gnn_rag_tpu/rag/llms/flan_t5.py
(reference: llm/src/llms/language_models/flan_t5.py); ``transformers`` is
imported only in ``prepare_for_inference``."""

from __future__ import annotations

from .base import BaseLanguageModel


class FlanT5(BaseLanguageModel):
    @staticmethod
    def add_args(parser):
        parser.add_argument("--model_path", type=str, default="google/flan-t5-xl")
        parser.add_argument("--max_new_tokens", type=int, default=512)

    def __init__(self, args):
        self.args = args
        self.maximun_token = 512 - 5
        self.tokenizer = None
        self.generator = None

    def tokenize(self, text: str) -> int:
        return len(self.tokenizer.tokenize(text))

    def prepare_for_inference(self, **model_kwargs):
        from transformers import AutoTokenizer, pipeline
        self.tokenizer = AutoTokenizer.from_pretrained(self.args.model_path)
        self.generator = pipeline("text2text-generation",
                                  model=self.args.model_path,
                                  tokenizer=self.tokenizer,
                                  device_map="auto", model_kwargs=model_kwargs)

    def generate_sentence(self, llm_input: str):
        outputs = self.generator(llm_input,
                                 max_new_tokens=self.args.max_new_tokens)
        return outputs[0]["generated_text"]
