"""OpenAI chat backend with retry/backoff, the port of
gnn_rag_tpu/rag/llms/openai_chat.py (reference: llm/src/llms/
language_models/chatgpt.py:25-77).

Token counting uses tiktoken when available, else a chars/4 estimate (the
count only drives prompt truncation budgets). ``openai`` is imported only in
``prepare_for_inference``; ``OPENAI_BASE_URL`` points the client at any
server of the protocol, e.g. ``rag.llms.serving.OpenAIProtocolServer``.
"""

from __future__ import annotations

import os
import time

from .base import BaseLanguageModel

TOKEN_LIMITS = {
    "gpt-4": 8192, "gpt-4-0613": 8192,
    "gpt-3.5-turbo-16k": 16384, "gpt-3.5-turbo-16k-0613": 16384,
    "gpt-3.5-turbo": 4096, "gpt-3.5-turbo-0613": 4096,
    "text-davinci-003": 4096, "text-davinci-002": 4096,
}


def get_token_limit(model: str = "gpt-4") -> int:
    if model not in TOKEN_LIMITS:
        raise NotImplementedError(
            f"get_token_limit() is not implemented for model {model}.")
    return TOKEN_LIMITS[model]


class ChatGPT(BaseLanguageModel):
    @staticmethod
    def add_args(parser):
        parser.add_argument("--retry", type=int, default=5)

    def __init__(self, args):
        super().__init__(args)
        self.retry = args.retry
        self.model_name = args.model_name
        self.maximun_token = get_token_limit(self.model_name)
        self.redundant_tokens = 150
        self._encoding = None
        self._client = None

    def tokenize(self, text: str) -> int:
        if self._encoding is None:
            try:
                import tiktoken
                self._encoding = tiktoken.encoding_for_model(self.model_name)
            except Exception:
                self._encoding = False
        if self._encoding:
            return len(self._encoding.encode(text)) + self.redundant_tokens
        return len(text) // 4 + self.redundant_tokens

    def prepare_for_inference(self, **model_kwargs):
        import openai
        base_url = os.environ.get("OPENAI_BASE_URL")
        self._client = openai.OpenAI(
            api_key=os.environ.get("OPENAI_API_KEY", "EMPTY"),
            **({"base_url": base_url} if base_url else {}))

    def generate_sentence(self, llm_input: str):
        if self._client is None:
            self.prepare_for_inference()
        if self.tokenize(llm_input) > self.maximun_token:
            llm_input = llm_input[: self.maximun_token]
        for _ in range(self.retry + 1):
            try:
                response = self._client.chat.completions.create(
                    model=self.model_name,
                    messages=[{"role": "user", "content": llm_input}],
                    timeout=30)
                return response.choices[0].message.content.strip()
            except Exception as e:  # 30s backoff like the reference
                print(e)
                time.sleep(30)
        return None
